"""Indexed-slices (row-sparse) gradients and sparse optimizer updates.

The reference rewrites dense model updates into sparse ones when the
gradient comes from a gather: `indexed_slices_reduce_sum` dedups ids,
then IndexedSlices{SGD,Adam} kernels update only the touched rows
(oneflow/user/kernels/indexed_slices_reduce_sum_kernel_util.cpp,
model_update kernels; pass: core/job_rewriter/
indexed_slices_optimizer_rewrite_pass.cpp). The JAX expression:

- ``IndexedSlices``: (indices, values) row-sparse gradient for a (N, D)
  parameter; a pytree, so it flows through jit.
- ``reduce_ids``: the dedup — jnp.unique with a static size bound
  (XLA needs static shapes; the bound is the lookup batch size, which is
  static anyway) followed by segment-sum of duplicate rows.
- ``sparse_lookup``: an embedding forward that *produces* an
  IndexedSlices gradient via custom_vjp, avoiding the dense (N, D)
  scatter-add jax.grad would otherwise emit.
- ``apply_sparse``: applies an optimizer update to ONLY the touched rows
  of (param, state) — lazy Adam semantics: untouched rows' moments do not
  decay, exactly like the reference's IndexedSlices kernels.

grads pytrees may mix dense leaves and IndexedSlices leaves;
``apply_sparse_tree`` densifies nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from of_spmm.ops import reference as ref


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class IndexedSlices:
    """Row-sparse gradient: dense equivalent is
    zeros((n_rows, D)).at[indices].add(values)."""

    indices: jnp.ndarray  # (k,) int32
    values: jnp.ndarray  # (k, D)
    n_rows: int  # static

    def tree_flatten(self):
        return (self.indices, self.values), (self.n_rows,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indices, values = children
        return cls(indices=indices, values=values, n_rows=aux[0])

    def dense(self) -> jnp.ndarray:
        return ref.segment_sum(self.values, self.indices, self.n_rows)

    @property
    def shape(self):
        return (self.n_rows,) + tuple(self.values.shape[1:])


def reduce_ids(slices: IndexedSlices) -> IndexedSlices:
    """Dedup indices, summing duplicate rows (indexed_slices_reduce_sum).

    Output keeps the static length (XLA static shapes); surplus slots get
    the OUT-OF-RANGE sentinel ``n_rows`` with zero values — JAX scatter
    drops out-of-range updates, so downstream row updates are true no-ops.
    """
    k = slices.indices.shape[0]
    uniq, inv = jnp.unique(
        slices.indices, return_inverse=True, size=k, fill_value=slices.n_rows
    )
    # fill slots have no members, so their segment sums are exactly zero
    summed = ref.segment_sum(slices.values, inv.reshape(-1), k)
    return IndexedSlices(indices=uniq, values=summed, n_rows=slices.n_rows)


@jax.custom_vjp
def sparse_lookup(weight: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """Embedding forward (row gather). Under plain jax.grad the weight
    cotangent densifies (custom_vjp cotangents must match the primal);
    to keep it sparse, differentiate through ``sparse_value_and_grad``."""
    return jnp.take(weight, ids, axis=0)


def _sl_fwd(weight, ids):
    return jnp.take(weight, ids, axis=0), (ids, weight.shape[0])


def _sl_bwd(res, g):
    ids, n = res
    # dense scatter-add fallback (used only if someone jax.grad's directly)
    return ref.segment_sum(g, ids.reshape(-1), n).reshape(-1, g.shape[-1]), None


sparse_lookup.defvjp(_sl_fwd, _sl_bwd)


def sparse_value_and_grad(loss_fn, embedding_name: str = "weight"):
    """value_and_grad where the gradient of the embedding table is an
    IndexedSlices instead of a dense (N, D) array.

    ``loss_fn(rows, *args) -> loss`` must take the *gathered rows* as its
    first argument. Returns ``fn(weight, ids, *args) -> (loss, IndexedSlices)``.
    The caller gathers once; the (k, D) row-gradient never densifies —
    this is the rewrite the reference's IndexedSlicesOptimizerRewritePass
    performs on the job graph.
    """

    def fn(weight, ids, *args):
        flat = ids.reshape(-1)
        rows = jnp.take(weight, flat, axis=0)
        loss, g_rows = jax.value_and_grad(loss_fn)(rows, *args)
        return loss, IndexedSlices(
            indices=flat, values=g_rows, n_rows=weight.shape[0]
        )

    return fn


# ---------------------------------------------------------------------------
# sparse optimizer updates (lazy row updates)
# ---------------------------------------------------------------------------


def sparse_sgd_update(
    param: jnp.ndarray, g: IndexedSlices, lr: float
) -> jnp.ndarray:
    """p[ids] -= lr * values (duplicates accumulate, matching scatter-add)."""
    return param.at[g.indices].add(-lr * g.values)


def sparse_adam_update(
    param: jnp.ndarray,
    m: jnp.ndarray,
    v: jnp.ndarray,
    step: jnp.ndarray,
    g: IndexedSlices,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Lazy Adam on the touched rows only (reference IndexedSlicesAdam).

    Ids must be unique (run reduce_ids first); untouched rows' moments are
    left un-decayed, exactly like the reference kernel.
    """
    r = reduce_ids(g)
    ids, vals = r.indices, r.values
    m_rows = b1 * m[ids] + (1 - b1) * vals
    v_rows = b2 * v[ids] + (1 - b2) * vals * vals
    t = step.astype(jnp.float32)
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t
    upd = lr * (m_rows / c1) / (jnp.sqrt(v_rows / c2) + eps)
    # fill slots carry the out-of-range sentinel: scatter drops them, so
    # untouched rows' moments stay un-decayed (lazy-Adam semantics)
    m = m.at[ids].set(m_rows, mode="drop")
    v = v.at[ids].set(v_rows, mode="drop")
    param = param.at[ids].add(-upd, mode="drop")
    return param, m, v
