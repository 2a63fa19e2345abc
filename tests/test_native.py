"""Native plan-builder kernels vs numpy fallbacks (csrc/planner.cpp)."""

import numpy as np
import pytest

from of_spmm import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _coo(n, nnz, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, nnz).astype(np.int32),
        rng.integers(0, n, nnz).astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32),
    )


def test_coo_to_csr_matches_lexsort():
    rows, cols, vals = _coo(200, 5000)
    ip, c, v = native.coo_to_csr(rows, cols, vals, 200)
    order = np.lexsort((cols, rows))
    counts = np.bincount(rows, minlength=200)
    ip2 = np.zeros(201, np.int64)
    np.cumsum(counts, out=ip2[1:])
    np.testing.assert_array_equal(ip, ip2)
    np.testing.assert_array_equal(c, cols[order])
    np.testing.assert_allclose(v, vals[order])


def test_coo_to_csr_none_vals_ones():
    rows, cols, _ = _coo(50, 300, seed=1)
    ip, c, v = native.coo_to_csr(rows, cols, None, 50)
    np.testing.assert_array_equal(v, 1.0)


def test_symmetrize_dedup_matches_numpy():
    rows, cols, _ = _coo(100, 800, seed=2)
    s, d = native.symmetrize_dedup(rows, cols, 100)
    key = np.unique(np.concatenate([
        rows.astype(np.int64) * 100 + cols,
        cols.astype(np.int64) * 100 + rows,
    ]))
    np.testing.assert_array_equal(s.astype(np.int64) * 100 + d, key)
    # symmetric by construction
    k1 = set(zip(s.tolist(), d.tolist()))
    assert all((b, a) in k1 for a, b in k1)


def test_csr_transpose_matches_rebuild():
    rows, cols, vals = _coo(150, 4000, seed=3)
    ip, c, v = native.coo_to_csr(rows, cols, vals, 150)
    tp, tc, tv = native.csr_transpose(ip, c, v, (150, 150))
    ip2, c2, v2 = native.coo_to_csr(cols, rows, vals, 150)
    np.testing.assert_array_equal(tp, ip2)
    np.testing.assert_array_equal(tc, c2)
    # duplicate (col,row) pairs may order differently; compare per-cell sums
    np.testing.assert_allclose(np.sort(tv), np.sort(v2), rtol=1e-6)


def test_formats_use_native_consistently():
    """CSR built large enough to take the native path must equal numpy's."""
    from of_spmm.sparse.formats import COO, CSR

    n, nnz = 700, 1 << 19
    rows, cols, vals = _coo(n, nnz, seed=4)
    csr = CSR.from_coo(COO.from_arrays(rows, cols, vals, (n, n)))
    order = np.lexsort((cols, rows))
    np.testing.assert_array_equal(np.asarray(csr.cols), cols[order])
    np.testing.assert_allclose(np.asarray(csr.vals), vals[order])
    t = csr.transpose()
    assert t.nnz == csr.nnz
    # round trip transpose^2 == original
    t2 = t.transpose()
    np.testing.assert_array_equal(np.asarray(t2.cols), np.asarray(csr.cols))
    np.testing.assert_allclose(np.asarray(t2.vals), np.asarray(csr.vals))


def test_native_spgemm_matches_numpy():
    """Native Gustavson SPA SpGEMM == numpy expand/sort/reduce oracle."""
    import numpy as np
    from of_spmm import native
    from of_spmm.sparse.formats import CSR

    if not native.available():
        import pytest

        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    n, m, k = 60, 40, 50
    A = (rng.random((n, k)) < 0.1) * rng.random((n, k)).astype(np.float32)
    B = (rng.random((k, m)) < 0.15) * rng.random((k, m)).astype(np.float32)
    ca, cb = CSR.from_dense(A.astype(np.float32)), CSR.from_dense(B.astype(np.float32))
    got = native.spgemm(
        np.asarray(ca.indptr), np.asarray(ca.cols), np.asarray(ca.vals),
        np.asarray(cb.indptr), np.asarray(cb.cols), np.asarray(cb.vals),
        n, m,
    )
    assert got is not None
    indptr, cols, vals = got
    dense = np.zeros((n, m), np.float32)
    for r in range(n):
        for p in range(indptr[r], indptr[r + 1]):
            dense[r, cols[p]] = vals[p]
    np.testing.assert_allclose(dense, A @ B, rtol=1e-5, atol=1e-6)
    # per-row columns sorted and unique
    for r in range(n):
        c = cols[indptr[r]:indptr[r + 1]]
        assert np.all(np.diff(c) > 0)
