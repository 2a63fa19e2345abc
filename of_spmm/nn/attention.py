"""Attention modules (reference: fused attention kernels + nn modules).

MultiheadAttention with torch parameter conventions (packed in_proj,
out_proj); the scaled-dot-product core is a pair of batched matmuls +
softmax, or ``jax.nn.dot_product_attention`` (cuDNN's fused attention on
the GPU) with ``flash=True``. Causal masking supported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def scaled_dot_product_attention(
    q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    is_causal: bool = False,
) -> jnp.ndarray:
    """(..., T, d) attention with fp32-stabilized softmax."""
    d = q.shape[-1]
    scores = jnp.einsum("...qd,...kd->...qk", q, k) / np.sqrt(d)
    if is_causal:
        T, S = scores.shape[-2], scores.shape[-1]
        causal = jnp.tril(jnp.ones((T, S), bool))
        scores = jnp.where(causal, scores, -jnp.inf)
    if mask is not None:
        scores = jnp.where(mask, scores, -jnp.inf)
    w = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("...qk,...kd->...qd", w, v)


def flash_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                    is_causal: bool = False) -> jnp.ndarray:
    """Fused (B, H, T, d) attention through ``jax.nn.dot_product_attention``
    with the implementation the registry picks for this platform (cuDNN's
    fused kernel on the GPU, XLA's elsewhere)."""
    from of_spmm.ops.registry import lookup

    return lookup("dot_product_attention").impl("auto")(q, k, v, is_causal)


@dataclasses.dataclass(frozen=True)
class MultiheadAttention:
    """Torch-convention MHA over (B, T, E) inputs (batch_first).

    ``flash=True`` routes the softmax core through ``flash_attention``
    (fused, O(T*d) activation memory); masks other than is_causal are
    unsupported there.
    """

    embed_dim: int
    num_heads: int
    use_bias: bool = True
    flash: bool = False

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must divide num_heads")

    def init(self, key) -> dict:
        E = self.embed_dim
        k1, k2 = jax.random.split(key)
        bound = float(np.sqrt(1.0 / E))
        p = {
            "in_w": jax.random.uniform(k1, (3 * E, E), jnp.float32, -bound, bound),
            "out_w": jax.random.uniform(k2, (E, E), jnp.float32, -bound, bound),
        }
        if self.use_bias:
            p["in_b"] = jnp.zeros((3 * E,), jnp.float32)
            p["out_b"] = jnp.zeros((E,), jnp.float32)
        return p

    def apply(self, params, q, k=None, v=None, *, mask=None, is_causal=False,
              train=False, rng=None):
        k = q if k is None else k
        v = k if v is None else v
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = jnp.split(params["in_w"], 3, axis=0)
        bq = bk = bv = None
        if self.use_bias:
            bq, bk, bv = jnp.split(params["in_b"], 3, axis=0)

        def proj(x, w, b):
            y = x @ w.T
            if b is not None:
                y = y + b
            B, T, _ = y.shape
            return y.reshape(B, T, H, hd).transpose(0, 2, 1, 3)  # (B,H,T,hd)

        qh, kh, vh = proj(q, wq, bq), proj(k, wk, bk), proj(v, wv, bv)
        if self.flash:
            if mask is not None:
                raise ValueError("flash=True supports only is_causal masks")
            o = flash_attention(qh, kh, vh, is_causal=is_causal)
        else:
            o = scaled_dot_product_attention(qh, kh, vh, mask=mask,
                                             is_causal=is_causal)
        B, _, T, _ = o.shape
        o = o.transpose(0, 2, 1, 3).reshape(B, T, E)
        o = o @ params["out_w"].T
        if self.use_bias:
            o = o + params["out_b"]
        return o
