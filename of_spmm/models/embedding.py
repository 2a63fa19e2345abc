"""Embedding — gather-backed lookup table, mirroring the reference module.

The reference's nn.Embedding.forward is exactly flow._C.gather(weight,
indices, axis=0) (python/oneflow/nn/modules/sparse.py:171-182,253); its
backward is the segment-sum pairing. Here the same lookup uses the
framework's differentiable gather, whose custom_vjp *is* segment_sum —
so dW accumulates duplicate-index gradients exactly like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from of_spmm.ops.autograd import gather


@dataclasses.dataclass(frozen=True)
class Embedding:
    num_embeddings: int
    embedding_dim: int
    padding_idx: Optional[int] = None

    def init(self, key) -> dict:
        w = jax.random.normal(key, (self.num_embeddings, self.embedding_dim), jnp.float32)
        if self.padding_idx is not None:
            w = w.at[self.padding_idx].set(0.0)
        return {"weight": w}

    def apply(self, params: dict, indices: jnp.ndarray) -> jnp.ndarray:
        flat = indices.reshape(-1)
        out = gather(params["weight"], flat)
        return out.reshape(*indices.shape, self.embedding_dim)
