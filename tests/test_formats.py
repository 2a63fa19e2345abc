"""Sparse format construction / conversion / validation tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.sparse.binned import bin_rows
from of_spmm.sparse.formats import COO, CSR


def _random_dense(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, m)) < density
    return mask * rng.standard_normal((n, m)).astype(np.float32)


def test_coo_roundtrip():
    dense = _random_dense(50, 40, 0.1)
    coo = COO.from_dense(dense)
    coo.validate()
    np.testing.assert_array_equal(np.asarray(coo.to_dense()), dense)


def test_csr_roundtrip():
    dense = _random_dense(50, 40, 0.1)
    csr = CSR.from_dense(dense)
    csr.validate()
    np.testing.assert_array_equal(np.asarray(csr.to_dense()), dense)
    # column order within a row is ascending
    indptr = np.asarray(csr.indptr)
    cols = np.asarray(csr.cols)
    for r in range(50):
        seg = cols[indptr[r] : indptr[r + 1]]
        assert (np.diff(seg) > 0).all()


def test_transpose():
    dense = _random_dense(30, 45, 0.15)
    csr = CSR.from_dense(dense)
    np.testing.assert_allclose(np.asarray(csr.transpose().to_dense()), dense.T)


def test_empty_matrix():
    csr = CSR.from_dense(np.zeros((10, 10), np.float32))
    assert csr.nnz == 0
    binned = bin_rows(csr)
    assert binned.buckets == ()


def test_coo_from_edges_aggregation_semantics():
    # A[dst, src] = 1: row i of A holds in-neighbors of i
    src = np.array([0, 1, 2])
    dst = np.array([2, 2, 0])
    coo = COO.from_edges(src, dst, 3)
    dense = np.asarray(coo.to_dense())
    assert dense[2, 0] == 1 and dense[2, 1] == 1 and dense[0, 2] == 1


def test_validation_errors():
    with pytest.raises(ValueError):
        COO.from_arrays([0, 99], [0, 1], [1.0, 1.0], (5, 5)).validate()
    with pytest.raises(ValueError):
        CSR.from_arrays([0, 1], [0], [1.0], (5, 5))  # bad indptr length


def test_pytree_flatten_roundtrip():
    csr = CSR.from_dense(_random_dense(20, 20, 0.2))
    leaves, treedef = jax.tree_util.tree_flatten(csr)
    csr2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert csr2.shape == csr.shape
    np.testing.assert_array_equal(np.asarray(csr2.cols), np.asarray(csr.cols))


def test_binned_covers_all_nnz():
    dense = _random_dense(200, 200, 0.05, seed=3)
    dense[7, :] = 1.0  # heavy row forces splitting
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8, 16, 32))
    assert binned.has_split_rows
    total_real = sum(
        int((np.asarray(b.vals) != 0).sum()) for b in binned.buckets
    )
    # all non-padding slots account for every nonzero exactly once
    assert total_real == csr.nnz
    # reconstruct the dense matrix from the binned layout
    recon = np.zeros(csr.shape, np.float32)
    for b in binned.buckets:
        rids = np.asarray(b.row_ids)
        cols = np.asarray(b.cols)
        vals = np.asarray(b.vals)
        for i in range(rids.shape[0]):
            for k in range(cols.shape[1]):
                recon[rids[i], cols[i, k]] += vals[i, k]
    np.testing.assert_allclose(recon, dense, rtol=1e-6, atol=1e-6)


def test_binned_rows_padded_to_sublanes():
    csr = CSR.from_dense(_random_dense(100, 100, 0.03, seed=1))
    binned = bin_rows(csr)
    for b in binned.buckets:
        assert b.n_ell_rows % 8 == 0
