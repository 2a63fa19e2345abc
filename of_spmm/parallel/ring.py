"""Ring attention: context parallelism with compute/communication overlap.

The second long-context strategy next to Ulysses ([[parallel/sp.py]]):
activations stay sequence-sharded the WHOLE time — no axis rotation — and
instead the K/V shards rotate around the device ring with
`jax.lax.ppermute` (point-to-point over ICI neighbors) while each shard
computes attention against the block currently in front of it, folding
results with online softmax. After N-1 rotations every query has seen
every key; XLA overlaps each step's ppermute with the next matmul.

The reference has no such subsystem (SURVEY.md §5 long-context: grep
negative for ring/blockwise attention); its nearest building block is the
NCCL send/recv pair (oneflow/user/kernels/eager_nccl_kernels.cu) that a
ring schedule would be hand-built from. Communication volume per chip is
O(seq/N x d) per step — an all-gather's total volume, but pipelined.

Scaling: memory per chip O(seq/N), so sequence length scales linearly
with ring size; Ulysses instead caps at num_heads devices. Use Ulysses
when heads >= ring size (fewer collectives), ring attention beyond that.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from of_spmm.nn.attention import MultiheadAttention


def ring_attention(q, k, v, *, axis_name: str, is_causal: bool = False):
    """Attention over sequence-sharded (B, H, T/p, hd) q/k/v blocks.

    Must run inside shard_map/pmap over ``axis_name``. Returns the
    (B, H, T/p, hd) output shard. fp32 softmax statistics.
    """
    n = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    B, H, Tl, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    perm = [(i, (i + 1) % n) for i in range(n)]

    q_pos = idx * Tl + jnp.arange(Tl)

    m = jnp.full((B, H, Tl, 1), -jnp.inf, jnp.float32)
    l = jnp.zeros((B, H, Tl, 1), jnp.float32)
    o = jnp.zeros((B, H, Tl, hd), jnp.float32)
    k_blk, v_blk = k, v

    for step in range(n):
        src = (idx - step) % n
        scores = jnp.einsum("bhqd,bhkd->bhqk", q, k_blk).astype(
            jnp.float32) * scale
        if is_causal:
            kv_pos = src * Tl + jnp.arange(Tl)
            mask = kv_pos[None, :] <= q_pos[:, None]  # (Tl_q, Tl_kv)
            scores = jnp.where(mask[None, None], scores, -jnp.inf)
        s_max = jnp.max(scores, axis=-1, keepdims=True)
        m_new = jnp.maximum(m, s_max)
        # fully-masked-so-far rows keep m=-inf; guard the nan exp(-inf+inf)
        safe_m = jnp.where(jnp.isneginf(m_new), 0.0, m_new)
        alpha = jnp.where(jnp.isneginf(m), 0.0, jnp.exp(m - safe_m))
        p = jnp.exp(scores - safe_m)
        if is_causal:
            p = jnp.where(mask[None, None], p, 0.0)
        l = alpha * l + jnp.sum(p, axis=-1, keepdims=True)
        o = alpha * o + jnp.einsum(
            "bhqk,bhkd->bhqd", p.astype(v_blk.dtype), v_blk).astype(
                jnp.float32)
        m = m_new
        if step < n - 1:
            k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
            v_blk = jax.lax.ppermute(v_blk, axis_name, perm)

    return (o / jnp.maximum(l, 1e-30)).astype(q.dtype)


@dataclasses.dataclass(frozen=True)
class RingAttention:
    """MultiheadAttention computed with ring context parallelism.

    Same parameter pytree as nn.MultiheadAttention; inputs/outputs stay
    sequence-sharded on the ring axis throughout (no head-count limit on
    the ring size, unlike Ulysses).
    """

    embed_dim: int
    num_heads: int
    use_bias: bool = True

    def init(self, key) -> dict:
        return MultiheadAttention(self.embed_dim, self.num_heads,
                                  use_bias=self.use_bias).init(key)

    def apply_local(self, params, x_local, *, axis_name: str,
                    is_causal: bool = False):
        """Per-shard body: (B, T/p, E) -> (B, T/p, E)."""
        E, H = self.embed_dim, self.num_heads
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

        o = ring_attention(proj(wq, bq), proj(wk, bk), proj(wv, bv),
                           axis_name=axis_name, is_causal=is_causal)
        B, _, t, _ = o.shape
        o = o.transpose(0, 2, 1, 3).reshape(B, t, E)
        o = o @ params["out_w"].T
        if self.use_bias:
            o = o + params["out_b"]
        return o

    def make_sharded_apply(self, mesh: Mesh, axis_name: str = "ring",
                           is_causal: bool = False):
        """jit-ready (params, x) -> y; x, y sequence-sharded globals."""
        fn = partial(self.apply_local, axis_name=axis_name,
                     is_causal=is_causal)
        return jax.jit(jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(), P(None, axis_name, None)),
            out_specs=P(None, axis_name, None),
        ))
