"""GCN — the flagship model: sparse aggregation + dense transform.

A GCN layer is H' = act(A_hat @ H @ W + b) where A_hat is the
symmetrically-normalized adjacency. The aggregation A_hat @ H is exactly
the framework's spmm (the reference builds the same layer from gather +
segment_sum; Embedding usage at python/oneflow/nn/modules/sparse.py:171-182).

Models are plain pytrees + pure functions (init / apply), the natural JAX
shape of the reference's nn.Module surface: params flow through jit, grad,
and shard_map unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.ops.autograd import SpmmOperator, spmm, spmm_internal
from of_spmm.sparse.formats import COO, CSR


def normalized_adjacency(csr: CSR, add_self_loops: bool = True) -> CSR:
    """A_hat = D^-1/2 (A + I) D^-1/2 — host-side graph preprocessing."""
    coo = csr.to_coo()
    rows = np.asarray(coo.rows)
    cols = np.asarray(coo.cols)
    vals = np.asarray(coo.vals)
    n = csr.shape[0]
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(n, dtype=rows.dtype)])
        cols = np.concatenate([cols, np.arange(n, dtype=cols.dtype)])
        vals = np.concatenate([vals, np.ones(n, dtype=vals.dtype)])
    # bincount (buffered) instead of np.add.at — ufunc.at is unbuffered and
    # takes minutes at 10^8 nnz.
    deg = np.bincount(rows, weights=vals.astype(np.float64), minlength=n)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vals = (vals * dinv[rows] * dinv[cols]).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows, cols, vals, csr.shape))


def _glorot(key, fan_in: int, fan_out: int, dtype=jnp.float32) -> jnp.ndarray:
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return jax.random.uniform(key, (fan_in, fan_out), dtype, -limit, limit)


@dataclasses.dataclass(frozen=True)
class GCN:
    """Configuration for an L-layer GCN. Params live in a separate pytree."""

    feature_dims: Tuple[int, ...]  # (in, hidden..., out)
    activation: Callable = jax.nn.relu
    dropout: float = 0.0

    def init(self, key) -> dict:
        params = {}
        dims = self.feature_dims
        keys = jax.random.split(key, len(dims) - 1)
        for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"layer_{i}"] = {
                "w": _glorot(keys[i], fi, fo),
                "b": jnp.zeros((fo,), jnp.float32),
            }
        return params

    def apply(
        self,
        params: dict,
        op: SpmmOperator,
        x: jnp.ndarray,
        *,
        impl: str = "auto",
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> jnp.ndarray:
        n_layers = len(self.feature_dims) - 1
        # convert once into the operator's internal row order (free for
        # non-relabeled operators) so every layer's spmm uses the fast
        # slice-concat finish; dense transforms are row-order agnostic.
        h = op.to_internal(x)
        for i in range(n_layers):
            p = params[f"layer_{i}"]
            # aggregate then transform: spmm result (n, fi) @ W (fi, fo)
            # keeps the dense matmul large.
            h = spmm_internal(op, h, impl=impl) @ p["w"] + p["b"]
            if i < n_layers - 1:
                h = self.activation(h)
                if train and self.dropout > 0.0:
                    if rng is None:
                        raise ValueError("dropout requires rng")
                    rng, sub = jax.random.split(rng)
                    keep = 1.0 - self.dropout
                    mask = jax.random.bernoulli(sub, keep, h.shape)
                    h = jnp.where(mask, h / keep, 0.0)
        return op.from_internal(h)

    def loss_fn(self, params, op, x, labels, mask=None, impl: str = "auto"):
        """Masked softmax cross-entropy (full-batch node classification)."""
        logits = self.apply(params, op, x, impl=impl)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
        if mask is not None:
            m = mask.astype(nll.dtype)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)
        return jnp.mean(nll)
