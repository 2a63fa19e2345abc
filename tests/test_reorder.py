"""Locality reordering (sparse/reorder.py): BFS relabel recovers band
structure a random id shuffle destroys, and the binned and tiered layouts
stay exact through the operator's to_internal/from_internal boundary."""

import numpy as np
import pytest

from of_spmm.sparse.formats import COO, CSR
from of_spmm.sparse.reorder import (
    bfs_order, locality_stats, reorder_locality)

RTOL, ATOL = 1e-4, 1e-5


def _clustered_graph(n=1024, n_comm=16, p_in=0.15, p_out=0.002, seed=0,
                     shuffle=True):
    """Stochastic block model with strong communities, ids shuffled."""
    rng = np.random.default_rng(seed)
    comm = np.sort(rng.integers(0, n_comm, n))
    dense = (rng.random((n, n)) < p_out).astype(np.float32)
    same = comm[:, None] == comm[None, :]
    dense[same] = (rng.random(int(same.sum())) < p_in).astype(np.float32)
    np.fill_diagonal(dense, 0)
    dense *= rng.random((n, n)).astype(np.float32)
    if shuffle:
        perm = rng.permutation(n)
        dense = dense[perm][:, perm]
    return dense, CSR.from_dense(dense)


def test_bfs_order_is_permutation():
    _, csr = _clustered_graph(seed=1)
    order = bfs_order(csr)
    assert np.array_equal(np.sort(order), np.arange(csr.shape[0]))


def test_reorder_recovers_band_coverage():
    """A shuffled SBM has poor band coverage; label-propagation relabel
    (the default) restores nearly all of the unshuffled layout's coverage.
    BFS is kept as a cheaper fallback and must at least not hurt."""
    dense_c, csr_c = _clustered_graph(seed=2, shuffle=False)
    dense_s, csr_s = _clustered_graph(seed=2, shuffle=True)
    w = 128
    cov_clustered = locality_stats(csr_c, R=64, window=w)["band_coverage"]
    cov_shuffled = locality_stats(csr_s, R=64, window=w)["band_coverage"]
    re_csr, _, _ = reorder_locality(csr_s)  # lp default
    cov_reordered = locality_stats(re_csr, R=64, window=w)["band_coverage"]
    assert cov_shuffled < 0.7 * cov_clustered, (cov_shuffled, cov_clustered)
    assert cov_reordered > 0.9 * cov_clustered, (cov_reordered,
                                                 cov_clustered)
    bfs_csr, _, _ = reorder_locality(csr_s, method="bfs")
    cov_bfs = locality_stats(bfs_csr, R=64, window=w)["band_coverage"]
    assert cov_bfs >= cov_shuffled * 0.95


def test_reorder_preserves_spmm_semantics():
    dense, csr = _clustered_graph(seed=3)
    re_csr, ofn, nfo = reorder_locality(csr)
    x = np.random.default_rng(4).standard_normal(
        (csr.shape[0], 8)).astype(np.float32)
    # P A P^T (P x) = P (A x)
    y_int = np.zeros_like(x)
    rows = np.repeat(np.arange(csr.shape[0]),
                     np.diff(np.asarray(re_csr.indptr)))
    np.add.at(y_int, rows,
              np.asarray(re_csr.vals)[:, None]
              * x[ofn][np.asarray(re_csr.cols)])
    np.testing.assert_allclose(y_int[nfo], dense @ x, rtol=RTOL,
                               atol=ATOL * np.abs(dense @ x).max() + ATOL)


@pytest.mark.parametrize("layout", ["binned", "tiered"])
def test_operator_with_reorder_matches_dense(layout):
    import jax
    import jax.numpy as jnp

    from of_spmm.ops.autograd import make_operator, spmm

    dense, csr = _clustered_graph(n=640, seed=5)
    op = make_operator(csr, layout=layout, place=False, reorder="bfs")
    assert op.relabeled
    x = np.random.default_rng(6).standard_normal((640, 8)).astype(
        np.float32)
    w = np.random.default_rng(7).standard_normal((640, 8)).astype(
        np.float32)
    y = spmm(op, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=RTOL,
                               atol=ATOL * np.abs(dense @ x).max() + ATOL)
    g = jax.grad(lambda xx: jnp.sum(spmm(op, xx) * w))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g), dense.T @ w, rtol=RTOL,
                               atol=ATOL * np.abs(dense.T @ w).max() + ATOL)


def test_reorder_rejects_rectangular():
    rng = np.random.default_rng(8)
    csr = CSR.from_dense((rng.random((10, 20)) < 0.3).astype(np.float32))
    with pytest.raises(ValueError, match="square"):
        reorder_locality(csr)


def test_matching_order_is_permutation_and_recovers():
    """The r4 default ("match"): multilevel heavy-edge matching is a
    valid permutation and recovers most of the planted band coverage a
    shuffle destroys (native hem_order when the toolchain is present,
    numpy fallback otherwise)."""
    from of_spmm.sparse.reorder import matching_order

    dense, csr = _clustered_graph(n=1024, seed=21)
    order = matching_order(csr, coarse_n=64)
    n = csr.shape[0]
    assert np.array_equal(np.sort(order), np.arange(n))
    nfo = np.empty(n, np.int64)
    nfo[order] = np.arange(n)
    rel = dense[order][:, order]
    before = locality_stats(csr, window=128)["band_coverage"]
    after = locality_stats(CSR.from_dense(rel), window=128)["band_coverage"]
    assert after > before * 1.5, (before, after)


def test_matching_numpy_fallback_matches_contract():
    """The numpy fallback path (native unavailable) is also a valid
    permutation (qualities differ; the contract is correctness)."""
    import of_spmm.native as native
    from of_spmm.sparse.reorder import matching_order

    _, csr = _clustered_graph(n=512, seed=23)
    real = native.hem_order
    native.hem_order = lambda *a, **k: None
    try:
        order = matching_order(csr, coarse_n=32)
    finally:
        native.hem_order = real
    assert np.array_equal(np.sort(order), np.arange(csr.shape[0]))


def test_reorder_match_through_operator():
    """make_operator(reorder="match") keeps exactness through the
    relabel boundary on the binned layout (bench.py --shuffled)."""
    import jax
    import jax.numpy as jnp

    from of_spmm.ops.autograd import make_operator, spmm

    rng = np.random.default_rng(31)
    n = 640
    dense = (rng.random((n, n)) < 0.04).astype(np.float32)
    dr = dense.sum(1)
    with np.errstate(divide="ignore"):
        s = np.where(dr > 0, dr ** -0.5, 0.0).astype(np.float32)
    dense = dense * s[:, None] * s[None, :]
    csr = CSR.from_dense(dense)
    op = make_operator(csr, layout="binned", place=False, reorder="match")
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = spmm(op, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=RTOL,
                               atol=ATOL * np.abs(dense @ x).max() + ATOL)
