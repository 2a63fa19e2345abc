"""Core sparse formats: COO and CSR, registered as JAX pytrees.

The reference has no first-class sparse tensor type — it expresses sparse
aggregation as (indices, segment_ids) edge lists driving ``gather`` /
``unsorted_segment_sum`` (oneflow/user/ops/gather_op.cpp:21-90,
oneflow/user/ops/unsorted_segment_sum_op.cpp:21-171). Here the edge list view
is the COO format and the CSR format adds row pointers for row-binned
kernels. Both are immutable pytree dataclasses so they flow through jit /
grad / shard_map; the logical shape is static aux data.

Numerics contract (adopted from the reference's test harness tolerance
rtol=1e-4 / atol=1e-5,
python/oneflow/test_utils/automated_test_util/torch_flow_dual_object.py:1044):
out-of-range indices contribute zeros, matching the reference gather kernel's
bounds-checked read (oneflow/user/kernels/gather_kernel_util.cu:28-56).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Shape2 = Tuple[int, int]


def _as_index_array(x):
    """Coerce to int32 WITHOUT moving host data to the device.

    Plan-time code paths (graph loading, binning, partitioning) operate on
    hundreds of MB of numpy arrays; eagerly wrapping them in jnp.asarray
    would copy them to the device on every conversion. numpy leaves are valid pytree leaves and convert
    lazily at trace time, so formats keep whatever array type they receive.
    """
    if isinstance(x, jnp.ndarray):
        if not jnp.issubdtype(x.dtype, jnp.integer):
            raise TypeError(f"index array must be integer, got {x.dtype}")
        return x.astype(jnp.int32)
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.integer):
        raise TypeError(f"index array must be integer, got {x.dtype}")
    return x.astype(np.int32)


def _as_val_array(x):
    if isinstance(x, jnp.ndarray):
        return x
    return np.asarray(x)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix: (rows, cols, vals) triples.

    Equivalent to the reference's edge-list view: ``rows`` are the
    segment ids fed to unsorted_segment_sum, ``cols`` the gather indices.

    >>> import numpy as np
    >>> coo = COO.from_arrays([0, 1], [1, 0], [2.0, 1.0], (2, 2))
    >>> int(coo.nnz)
    2
    >>> np.allclose(CSR.from_coo(coo).to_dense(), [[0., 2.], [1., 0.]])
    True
    """

    rows: jnp.ndarray  # (nnz,) int32
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,) float
    shape: Shape2  # static (n_rows, n_cols)

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, cols, vals = children
        (shape,) = aux
        return cls(rows=rows, cols=cols, vals=vals, shape=shape)

    # -- properties ---------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_arrays(cls, rows, cols, vals, shape: Shape2) -> "COO":
        rows = _as_index_array(rows)
        cols = _as_index_array(cols)
        vals = _as_val_array(vals)
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError(
                f"rows/cols/vals must have equal shapes, got "
                f"{rows.shape}/{cols.shape}/{vals.shape}"
            )
        return cls(rows=rows, cols=cols, vals=vals, shape=tuple(shape))

    @classmethod
    def from_dense(cls, dense) -> "COO":
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("COO.from_dense expects a 2-D matrix")
        r, c = np.nonzero(dense)
        return cls.from_arrays(r, c, dense[r, c], dense.shape)

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, vals=None) -> "COO":
        """Adjacency matrix A[dst, src] = val from a directed edge list.

        Row i of A holds the in-neighborhood of node i, so ``A @ X``
        aggregates neighbor features into each destination node — the GNN
        aggregation the reference performs with gather + segment_sum
        (python/oneflow/nn/modules/sparse.py:171-182 usage pattern).
        """
        src = np.asarray(src)
        dst = np.asarray(dst)
        if vals is None:
            vals = np.ones(src.shape[0], dtype=np.float32)
        return cls.from_arrays(dst, src, vals, (n_nodes, n_nodes))

    # -- conversions --------------------------------------------------------
    def to_dense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, dtype=self.vals.dtype)
        return out.at[self.rows, self.cols].add(self.vals)

    def sort_by_row(self) -> "COO":
        """Sort triples by (row, col). Host-side (numpy) — plan time only."""
        rows = np.asarray(self.rows)
        cols = np.asarray(self.cols)
        vals = np.asarray(self.vals)
        order = np.lexsort((cols, rows))
        return COO.from_arrays(rows[order], cols[order], vals[order], self.shape)

    def transpose(self) -> "COO":
        return COO(rows=self.cols, cols=self.rows, vals=self.vals,
                   shape=(self.shape[1], self.shape[0]))

    def validate(self) -> None:
        rows = np.asarray(self.rows)
        cols = np.asarray(self.cols)
        n, m = self.shape
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise ValueError(f"row indices out of range [0, {n})")
        if cols.size and (cols.min() < 0 or cols.max() >= m):
            raise ValueError(f"col indices out of range [0, {m})")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix: (indptr, cols, vals).

    ``indptr`` has length n_rows + 1; row i owns the nnz slice
    [indptr[i], indptr[i+1]). Values within a row are stored in ascending
    column order by construction (from_coo lexsorts).

    >>> import numpy as np
    >>> csr = CSR.from_dense(np.array([[0., 2.], [1., 0.]], np.float32))
    >>> int(csr.nnz), csr.shape
    (2, (2, 2))
    >>> [int(c) for c in np.asarray(csr.cols)]
    [1, 0]
    >>> np.allclose(csr.to_dense(), [[0., 2.], [1., 0.]])
    True
    >>> t = csr.transpose()
    >>> np.allclose(t.to_dense(), [[0., 1.], [2., 0.]])
    True
    """

    indptr: jnp.ndarray  # (n_rows + 1,) int32
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,) float
    shape: Shape2

    def tree_flatten(self):
        return (self.indptr, self.cols, self.vals), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, cols, vals = children
        (shape,) = aux
        return cls(indptr=indptr, cols=cols, vals=vals, shape=shape)

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_coo(cls, coo: COO) -> "CSR":
        """Host-side conversion; plan time only. Uses the native parallel
        counting sort (of_spmm/native.py) for float32 values — ~7x over
        numpy lexsort at 10^7 nnz — with a numpy fallback."""
        rows = np.asarray(coo.rows)
        cols = np.asarray(coo.cols)
        vals = np.asarray(coo.vals)
        n = coo.shape[0]
        if vals.dtype == np.float32 and rows.shape[0] >= (1 << 18):
            from of_spmm import native

            if native.available():
                indptr, out_cols, out_vals = native.coo_to_csr(rows, cols, vals, n)
                return cls(indptr=indptr, cols=out_cols, vals=out_vals,
                           shape=coo.shape)
        s = coo.sort_by_row()
        counts = np.bincount(np.asarray(s.rows), minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(
            indptr=indptr,
            cols=s.cols,
            vals=s.vals,
            shape=coo.shape,
        )

    @classmethod
    def from_dense(cls, dense) -> "CSR":
        return cls.from_coo(COO.from_dense(dense))

    @classmethod
    def from_arrays(cls, indptr, cols, vals, shape: Shape2) -> "CSR":
        indptr = _as_index_array(indptr)
        cols = _as_index_array(cols)
        vals = _as_val_array(vals)
        if indptr.shape[0] != shape[0] + 1:
            raise ValueError(f"indptr length {indptr.shape[0]} != n_rows+1 ({shape[0] + 1})")
        return cls(indptr=indptr, cols=cols, vals=vals, shape=tuple(shape))

    # -- conversions --------------------------------------------------------
    def to_coo(self) -> COO:
        indptr = np.asarray(self.indptr)
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int32), counts)
        return COO.from_arrays(rows, self.cols, self.vals, self.shape)

    def to_dense(self) -> jnp.ndarray:
        return self.to_coo().to_dense()

    def transpose(self) -> "CSR":
        """A^T in CSR — the backward operator of spmm (reference pairing:
        gather's grad is unsorted_segment_sum_like,
        oneflow/core/autograd/gradient_funcs/gather.cpp:62-73)."""
        vals = np.asarray(self.vals)
        if vals.dtype == np.float32 and self.nnz >= (1 << 18):
            from of_spmm import native

            if native.available():
                ip, c, v = native.csr_transpose(
                    np.asarray(self.indptr), np.asarray(self.cols), vals,
                    self.shape,
                )
                return CSR(indptr=ip, cols=c, vals=v,
                           shape=(self.shape[1], self.shape[0]))
        return CSR.from_coo(self.to_coo().transpose())

    def row_degrees(self) -> np.ndarray:
        return np.diff(np.asarray(self.indptr))

    def validate(self) -> None:
        indptr = np.asarray(self.indptr)
        if indptr[0] != 0 or indptr[-1] != self.nnz:
            raise ValueError("indptr must start at 0 and end at nnz")
        if (np.diff(indptr) < 0).any():
            raise ValueError("indptr must be non-decreasing")
        cols = np.asarray(self.cols)
        if cols.size and (cols.min() < 0 or cols.max() >= self.shape[1]):
            raise ValueError(f"col indices out of range [0, {self.shape[1]})")
