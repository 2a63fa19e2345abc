"""Sequence parallelism: Ulysses-style attention over an all-to-all.

The reference has no sequence-parallel subsystem (SURVEY.md §5): what it
ships is the building block — the generic S2S (all-to-all) collective
(`eager_nccl_s2s`, oneflow/user/kernels/eager_nccl_kernels.cu:93-205, and
the `GlobalS2S` functor, oneflow/core/functional/impl/comm_functor.cpp:308)
plus SBP's ability to split any tensor axis including sequence. This module
is the JAX realization of the pattern that collective exists for:

- activations live sequence-sharded S(seq) on an `sp` mesh axis — every
  elementwise/MLP op runs on local sequence shards;
- attention needs the full sequence per head, so the shard axis is rotated
  head<->sequence with ONE `jax.lax.all_to_all` on each side of the
  softmax(QK^T)V core (the DeepSpeed-Ulysses recipe): S(seq) over p ranks
  becomes S(head), each rank holding H/p full-sequence heads;
- jax transposes the collectives in the backward pass automatically.

Communication per attention layer: 4 all-to-alls (q, k, v, out), each
moving B*T*E/p elements — the same volume the reference's s2s boxing
would move for an S(1)->S(2) SBP transition of the packed qkv tensor.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from of_spmm.nn.attention import (
    MultiheadAttention,
    scaled_dot_product_attention,
)
from of_spmm.utils.errors import check_shape


def head_to_sequence(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(B, H, T/p, hd) sequence-sharded -> (B, H/p, T, hd) head-sharded."""
    return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                              tiled=True)


def sequence_to_head(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(B, H/p, T, hd) head-sharded -> (B, H, T/p, hd) sequence-sharded."""
    return jax.lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                              tiled=True)


def ulysses_attention(qh, kh, vh, *, axis_name: str, is_causal: bool = False):
    """Attention over (B, H, T/p, hd) sequence-sharded head tensors.

    Rotates to head-sharding, runs the full-sequence softmax core on H/p
    local heads, rotates back. Must run inside shard_map/pmap over
    ``axis_name``.
    """
    q = head_to_sequence(qh, axis_name)
    k = head_to_sequence(kh, axis_name)
    v = head_to_sequence(vh, axis_name)
    o = scaled_dot_product_attention(q, k, v, is_causal=is_causal)
    return sequence_to_head(o, axis_name)


@dataclasses.dataclass(frozen=True)
class SequenceParallelAttention:
    """MultiheadAttention computed from sequence-sharded activations.

    Same parameter pytree as nn.MultiheadAttention (torch-convention
    packed in_proj / out_proj) — a state dict moves between the dense and
    sequence-parallel modules unchanged. ``num_heads`` must be divisible
    by the sp axis size.
    """

    embed_dim: int
    num_heads: int
    use_bias: bool = True

    def _dense(self) -> MultiheadAttention:
        return MultiheadAttention(self.embed_dim, self.num_heads,
                                  use_bias=self.use_bias)

    def init(self, key) -> dict:
        return self._dense().init(key)

    def apply_local(self, params, x_local, *, axis_name: str,
                    is_causal: bool = False):
        """Per-shard body: x_local is (B, T/p, E); returns (B, T/p, E)."""
        E, H = self.embed_dim, self.num_heads
        p = jax.lax.axis_size(axis_name)
        check_shape(H % p == 0,
                    f"num_heads={H} must divide the sp axis size {p}")
        hd = E // H
        wq, wk, wv = jnp.split(params["in_w"], 3, axis=0)
        bq = bk = bv = None
        if self.use_bias:
            bq, bk, bv = jnp.split(params["in_b"], 3, axis=0)

        def proj(w, b):
            y = x_local @ w.T
            if b is not None:
                y = y + b
            B, t, _ = y.shape
            return y.reshape(B, t, H, hd).transpose(0, 2, 1, 3)

        o = ulysses_attention(proj(wq, bq), proj(wk, bk), proj(wv, bv),
                              axis_name=axis_name, is_causal=is_causal)
        B, _, t, _ = o.shape
        o = o.transpose(0, 2, 1, 3).reshape(B, t, E)
        o = o @ params["out_w"].T
        if self.use_bias:
            o = o + params["out_b"]
        return o

    def make_sharded_apply(self, mesh: Mesh, axis_name: str = "sp",
                           is_causal: bool = False):
        """jit-ready (params, x) -> y with x, y sequence-sharded over
        ``axis_name`` (global shapes; shard_map handles the slicing)."""
        fn = partial(self.apply_local, axis_name=axis_name,
                     is_causal=is_causal)
        return jax.jit(jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(), P(None, axis_name, None)),
            out_specs=P(None, axis_name, None),
        ))
