"""Oracle-op semantics tests: gather/segment_sum parity with the reference
definitions, spmv/spmm/sddmm/spgemm numerics vs dense math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.ops import reference as ref
from of_spmm.sparse.binned import bin_rows
from of_spmm.sparse.formats import COO, CSR
from tests.conftest import ATOL, RTOL


def _random_dense(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, m)) < density) * rng.standard_normal((n, m)).astype(np.float32)


def test_gather_basic_and_out_of_range():
    params = jnp.asarray(np.arange(20, dtype=np.float32).reshape(5, 4))
    idx = jnp.asarray([0, 4, 2])
    out = ref.gather(params, idx)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(params)[[0, 4, 2]])
    # out-of-range -> zeros (gather_kernel_util.cu bounds-check semantics)
    out = ref.gather(params, jnp.asarray([1, 7, -3]))
    np.testing.assert_array_equal(np.asarray(out[1]), np.zeros(4))
    np.testing.assert_array_equal(np.asarray(out[2]), np.zeros(4))


def test_segment_sum_semantics():
    data = jnp.asarray(np.ones((6, 3), np.float32))
    ids = jnp.asarray([0, 0, 2, 2, 2, 9])  # 9 out of range -> dropped
    out = ref.segment_sum(data, ids, num_segments=4)
    want = np.zeros((4, 3), np.float32)
    want[0] = 2
    want[2] = 3
    np.testing.assert_array_equal(np.asarray(out), want)


def test_segment_sum_bf16_accumulates_fp32():
    # many small increments: bf16 accumulation would lose them
    n = 4096
    data = jnp.full((n, 1), 1.0, jnp.bfloat16)
    ids = jnp.zeros((n,), jnp.int32)
    out = ref.segment_sum(data, ids, num_segments=1)
    assert out.dtype == jnp.bfloat16
    assert float(out[0, 0]) == pytest.approx(n, rel=0.01)


def test_spmv_matches_dense():
    dense = _random_dense(64, 48, 0.1)
    csr = CSR.from_dense(dense)
    x = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    y = ref.spmv(csr, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("shape,density", [((64, 48), 0.1), ((128, 128), 0.02), ((31, 77), 0.3)])
def test_spmm_coo_matches_dense(shape, density):
    dense = _random_dense(*shape, density)
    coo = COO.from_dense(dense)
    x = np.random.default_rng(1).standard_normal((shape[1], 16)).astype(np.float32)
    y = ref.spmm(coo, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=RTOL, atol=1e-4)


def test_spmm_binned_matches_dense_with_splits():
    dense = _random_dense(100, 90, 0.05, seed=2)
    dense[3, :] = np.random.default_rng(3).standard_normal(90)  # heavy row
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8, 16))
    x = np.random.default_rng(4).standard_normal((90, 32)).astype(np.float32)
    y = ref.spmm_binned_xla(binned, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=RTOL, atol=1e-3)
    y2 = ref.spmm_binned_xla(binned, jnp.asarray(x), row_chunk=8)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_sddmm_matches_dense():
    dense = _random_dense(40, 40, 0.1, seed=5)
    coo = COO.from_dense(dense)
    rng = np.random.default_rng(6)
    l = rng.standard_normal((40, 8)).astype(np.float32)
    r = rng.standard_normal((40, 8)).astype(np.float32)
    out = ref.sddmm(jnp.asarray(l), jnp.asarray(r), coo.rows, coo.cols)
    want = (l @ r.T)[np.asarray(coo.rows), np.asarray(coo.cols)]
    np.testing.assert_allclose(np.asarray(out), want, rtol=RTOL, atol=1e-4)


def test_spgemm_matches_dense():
    a = _random_dense(30, 40, 0.2, seed=7)
    b = _random_dense(40, 25, 0.2, seed=8)
    c = ref.spgemm(CSR.from_dense(a), CSR.from_dense(b))
    c.validate()
    np.testing.assert_allclose(np.asarray(c.to_dense()), a @ b, rtol=RTOL, atol=1e-4)


def test_spgemm_two_hop():
    a = _random_dense(50, 50, 0.1, seed=9)
    c = ref.spgemm(CSR.from_dense(a), CSR.from_dense(a))
    np.testing.assert_allclose(np.asarray(c.to_dense()), a @ a, rtol=RTOL, atol=1e-4)


def test_spgemm_empty():
    z = CSR.from_dense(np.zeros((5, 5), np.float32))
    c = ref.spgemm(z, z)
    assert c.nnz == 0
