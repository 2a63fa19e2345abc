"""GraphSAGE (mean aggregator) — second model family over the same spmm.

SAGE layer: h' = act(W_self @ h + W_neigh @ mean_agg(h)) where mean
aggregation is spmm with a row-normalized adjacency (D^-1 A). Exercises a
different operator normalization and the two-matmul layer shape.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.models.gcn import _glorot
from of_spmm.ops.autograd import SpmmOperator, spmm, spmm_internal
from of_spmm.sparse.formats import COO, CSR


def mean_adjacency(csr: CSR) -> CSR:
    """D^-1 A — row-mean aggregation operator (host-side)."""
    coo = csr.to_coo()
    rows = np.asarray(coo.rows)
    vals = np.asarray(coo.vals).astype(np.float64)
    deg = np.bincount(rows, minlength=csr.shape[0]).astype(np.float64)
    scale = 1.0 / np.maximum(deg, 1.0)
    new_vals = (vals * scale[rows]).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows, coo.cols, new_vals, csr.shape))


@dataclasses.dataclass(frozen=True)
class GraphSAGE:
    feature_dims: Tuple[int, ...]
    activation: Callable = jax.nn.relu

    def init(self, key) -> dict:
        params = {}
        dims = self.feature_dims
        keys = jax.random.split(key, 2 * (len(dims) - 1))
        for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"layer_{i}"] = {
                "w_self": _glorot(keys[2 * i], fi, fo),
                "w_neigh": _glorot(keys[2 * i + 1], fi, fo),
                "b": jnp.zeros((fo,), jnp.float32),
            }
        return params

    def apply(self, params: dict, op: SpmmOperator, x: jnp.ndarray,
              *, impl: str = "auto") -> jnp.ndarray:
        n_layers = len(self.feature_dims) - 1
        h = op.to_internal(x)
        for i in range(n_layers):
            p = params[f"layer_{i}"]
            agg = spmm_internal(op, h, impl=impl)
            h = h @ p["w_self"] + agg @ p["w_neigh"] + p["b"]
            if i < n_layers - 1:
                h = self.activation(h)
        return op.from_internal(h)
