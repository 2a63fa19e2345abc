"""Expert parallelism: Mixture-of-Experts with all_to_all token dispatch.

The reference has no MoE subsystem (SURVEY.md §2.7: "EP (expert) ...
absent in this snapshot"); what it ships is the building block — the
generic S2S all-to-all collective (`eager_nccl_s2s`,
oneflow/user/kernels/eager_nccl_kernels.cu:93-205) and the ragged
id-shuffle exchange precedent (oneflow/user/kernels/data_shuffle_kernel.cu:
41-130), which partitions variable-length per-destination buffers and
exchanges them with send/recv pairs. This module is the JAX
realization of that pattern for expert routing, in the GShard/SPMD style:

- tokens live sharded S(token) on an `ep` mesh axis, experts sharded
  S(expert) on the same axis (each device owns n_experts/p experts);
- gating + capacity assignment is computed locally per shard with STATIC
  shapes: every (device, expert) pair gets a fixed-capacity slot buffer,
  overflow tokens are dropped (zero contribution) — the static-shape
  answer to the reference's ragged ncclSend/ncclRecv exchange;
- dispatch/combine are one-hot tensors so the route runs as matmul
  einsums;
- ONE `jax.lax.all_to_all` ships slot buffers to expert owners, a second
  ships results back; jax transposes both in the backward pass.

Communication per layer: 2 all-to-alls of (n_experts * capacity * d_model)
elements each way — the dense-equivalent of the reference's id-shuffle /
embedding-shuffle pair.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from of_spmm.utils.errors import check_shape


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count for a token block.

    ceil(top_k * n_tokens / n_experts * factor), floored at 1 — the
    GShard capacity rule; every (shard, expert) buffer has exactly this
    many slots so the exchange is a fixed-shape all_to_all.
    """
    return max(1, int(math.ceil(top_k * n_tokens * capacity_factor
                                / n_experts)))


def top_k_dispatch(probs: jnp.ndarray, top_k: int, capacity: int,
                   normalize: bool = True):
    """Greedy top-k routing with per-expert capacity, all-static shapes.

    Args:
      probs: (T, E) softmax gate probabilities.
      top_k: experts per token.
      capacity: slots per expert.
      normalize: rescale each token's kept gate weights to sum to 1.

    Returns:
      dispatch: (T, E, C) 0/1 routing tensor (token t occupies slot c of
        expert e).
      combine: (T, E, C) gate-weighted routing tensor.
      aux: scalar load-balancing loss (Switch/GShard form:
        E * sum_e mean_prob_e * mean_assign_e over the first choice).

    Tokens are assigned slots in token order (cumsum), matching the
    deterministic first-come ordering of the reference's id-shuffle
    partitioning; a token whose expert is full at its turn is dropped
    from that expert (zero row in dispatch).
    """
    T, E = probs.shape
    remaining = probs
    counts = jnp.zeros((E,), jnp.float32)
    dispatch = jnp.zeros((T, E, capacity), probs.dtype)
    gates = jnp.zeros((T, top_k), probs.dtype)
    slots = []
    first_choice = None
    for k in range(top_k):
        idx = jnp.argmax(remaining, axis=1)                     # (T,)
        onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)      # (T, E)
        if first_choice is None:
            first_choice = onehot
        # position of each token within its chosen expert's queue:
        # tokens routed in earlier k-rounds count first, then token order.
        pos = jnp.cumsum(onehot, axis=0) - 1.0 + counts[None, :]
        pos_t = jnp.sum(pos * onehot, axis=1)                   # (T,)
        keep = pos_t < capacity
        slot_oh = jax.nn.one_hot(pos_t.astype(jnp.int32), capacity,
                                 dtype=jnp.float32)             # (T, C)
        d_k = (onehot * keep[:, None].astype(jnp.float32))[:, :, None] \
            * slot_oh[:, None, :]
        dispatch = dispatch + d_k.astype(probs.dtype)
        gates = gates.at[:, k].set(
            jnp.sum(probs * onehot, axis=1) * keep.astype(probs.dtype))
        counts = counts + jnp.sum(onehot * keep[:, None], axis=0)
        remaining = remaining * (1.0 - onehot)
        slots.append(d_k)
    if normalize:
        denom = jnp.maximum(jnp.sum(gates, axis=1, keepdims=True), 1e-9)
        gates = gates / denom
    combine = sum(g[:, None, None] * d.astype(probs.dtype)
                  for g, d in zip(gates.T, slots))
    # Switch-transformer auxiliary loss on the first choice.
    me = jnp.mean(probs, axis=0)
    ce = jnp.mean(first_choice, axis=0)
    aux = E * jnp.sum(me * ce)
    return dispatch, combine, aux


@dataclasses.dataclass(frozen=True)
class MoELayer:
    """Top-k routed mixture of expert FFNs (GShard/Switch style).

    params:
      wg: (D, E) gate;  w1: (E, D, F), b1: (E, F);  w2: (E, F, D),
      b2: (E, D) — expert weights stacked along a leading expert axis so
      S(expert) sharding is a plain S(0) over the `ep` mesh axis.
    """

    embed_dim: int
    n_experts: int
    ffn_dim: int
    top_k: int = 2
    capacity_factor: float = 1.25
    normalize_gates: bool = True

    def init(self, key) -> dict:
        kg, k1, k2 = jax.random.split(key, 3)
        D, E, F = self.embed_dim, self.n_experts, self.ffn_dim
        s1 = 1.0 / math.sqrt(D)
        s2 = 1.0 / math.sqrt(F)
        return {
            "wg": jax.random.uniform(kg, (D, E), jnp.float32, -s1, s1),
            "w1": jax.random.uniform(k1, (E, D, F), jnp.float32, -s1, s1),
            "b1": jnp.zeros((E, F), jnp.float32),
            "w2": jax.random.uniform(k2, (E, F, D), jnp.float32, -s2, s2),
            "b2": jnp.zeros((E, D), jnp.float32),
        }

    def _route(self, params, x):
        """(T, D) tokens -> dispatch/combine/aux with local capacity."""
        T = x.shape[0]
        cap = expert_capacity(T, self.n_experts, self.top_k,
                              self.capacity_factor)
        logits = x @ params["wg"]
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        return top_k_dispatch(probs.astype(x.dtype), self.top_k, cap,
                              self.normalize_gates)

    def _expert_ffn(self, params, h):
        """(E_local, C, D) slot buffers -> (E_local, C, D)."""
        a = jnp.einsum("ecd,edf->ecf", h, params["w1"]) + params["b1"][:, None, :]
        a = jax.nn.gelu(a)
        return jnp.einsum("ecf,efd->ecd", a, params["w2"]) + params["b2"][:, None, :]

    def apply(self, params, x, *, return_aux: bool = False):
        """Single-shard reference path: (T, D) -> (T, D).

        All experts are local; routing and FFN run as dense einsums.
        """
        check_shape(x.ndim == 2 and x.shape[1] == self.embed_dim,
                    f"moe input must be (T, {self.embed_dim}), got {x.shape}")
        dispatch, combine, aux = self._route(params, x)
        h = jnp.einsum("tec,td->ecd", dispatch, x)      # (E, C, D)
        out = self._expert_ffn(params, h)
        y = jnp.einsum("tec,ecd->td", combine, out)
        return (y, aux) if return_aux else y

    def shard_params(self, params: dict, mesh: Mesh, axis: str = "ep") -> dict:
        """Place expert weights S(expert) over `axis`, gate replicated."""
        spec = {
            "wg": P(), "w1": P(axis), "b1": P(axis),
            "w2": P(axis), "b2": P(axis),
        }
        return {
            k: jax.device_put(v, NamedSharding(mesh, spec[k]))
            for k, v in params.items()
        }

    def make_sharded_apply(self, mesh: Mesh, axis: str = "ep",
                           return_aux: bool = False):
        """Expert-parallel apply: tokens S(token), experts S(expert).

        Inside shard_map each device routes its local tokens into
        (n_experts, C_local, D) slot buffers, one all_to_all regroups the
        buffers expert-major so each device holds (E_local, C_local * p, D)
        — every shard's slots for its own experts — and a second
        all_to_all sends results back for the local combine.
        """
        p = mesh.shape[axis]
        if self.n_experts % p:
            raise ValueError(
                f"n_experts={self.n_experts} not divisible by mesh axis "
                f"'{axis}' size {p}")

        def body(params, x):
            # routing uses only the replicated gate weight; expert
            # weights in `params` are local S(expert) shards
            dispatch, combine, aux = self._route(params, x)
            h = jnp.einsum("tec,td->ecd", dispatch, x)   # (E, C, D) local
            # ship slot buffers to expert owners: (E, C, D) -> (E/p, pC, D)
            h = jax.lax.all_to_all(h, axis, split_axis=0, concat_axis=1,
                                   tiled=True)
            out = self._expert_ffn(params, h)            # local experts
            # return results to token owners: (E/p, pC, D) -> (E, C, D)
            out = jax.lax.all_to_all(out, axis, split_axis=1, concat_axis=0,
                                     tiled=True)
            y = jnp.einsum("tec,ecd->td", combine, out)
            aux = jax.lax.pmean(aux, axis)
            return (y, aux) if return_aux else y

        param_specs = {
            "wg": P(), "w1": P(axis), "b1": P(axis),
            "w2": P(axis), "b2": P(axis),
        }
        out_specs = (P(axis), P()) if return_aux else P(axis)
        fn = jax.shard_map(body, mesh=mesh,
                           in_specs=(param_specs, P(axis)),
                           out_specs=out_specs, check_vma=False)
        return jax.jit(fn)
