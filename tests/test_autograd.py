"""Autograd pairing tests: gather<->segment_sum, spmm bwd = transpose spmm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.ops import autograd as ag
from of_spmm.sparse.formats import CSR
from tests.conftest import ATOL, RTOL


def _random_dense(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(np.float32)


def test_gather_grad_is_segment_sum():
    params = jnp.asarray(np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32))
    idx = jnp.asarray([1, 1, 3])

    def f(p):
        return jnp.sum(ag.gather(p, idx) * jnp.arange(12.0).reshape(3, 4))

    g = jax.grad(f)(params)
    want = np.zeros((6, 4), np.float32)
    cot = np.arange(12.0).reshape(3, 4)
    want[1] = cot[0] + cot[1]
    want[3] = cot[2]
    np.testing.assert_allclose(np.asarray(g), want, rtol=RTOL, atol=ATOL)


def test_segment_sum_grad_is_gather():
    data = jnp.asarray(np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32))
    ids = jnp.asarray([0, 2, 2, 1, 0])
    cot = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)

    def f(d):
        return jnp.sum(ag.segment_sum(d, ids, 3) * cot)

    g = jax.grad(f)(data)
    want = cot[np.asarray(ids)]
    np.testing.assert_allclose(np.asarray(g), want, rtol=RTOL, atol=ATOL)


def test_spmm_value_and_grad_vs_dense():
    dense = _random_dense(40, 30, 0.15)
    op = ag.make_operator(CSR.from_dense(dense))
    x = np.random.default_rng(3).standard_normal((30, 8)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((40, 8)).astype(np.float32)

    def f(xx):
        return jnp.sum(ag.spmm(op, xx, impl="xla") * w)

    val, grad = jax.value_and_grad(f)(jnp.asarray(x))
    assert np.asarray(val) == pytest.approx(float((dense @ x * w).sum()), rel=1e-4)
    want_grad = dense.T @ w  # d/dx (w . A x) = A^T w
    np.testing.assert_allclose(np.asarray(grad), want_grad, rtol=RTOL, atol=1e-3)


def test_spmm_pallas_impl_matches_xla_forward():
    dense = _random_dense(64, 64, 0.1, seed=5)
    op = ag.make_operator(CSR.from_dense(dense))
    x = jnp.asarray(np.random.default_rng(6).standard_normal((64, 128)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(ag.spmm(op, x, impl="pallas")),
        np.asarray(ag.spmm(op, x, impl="xla")),
        rtol=RTOL, atol=1e-3,
    )


def test_spmv_grad():
    dense = _random_dense(20, 20, 0.3, seed=7)
    op = ag.make_operator(CSR.from_dense(dense))
    x = jnp.asarray(np.random.default_rng(8).standard_normal(20).astype(np.float32))
    g = jax.grad(lambda xx: jnp.sum(ag.spmv(op, xx)))(x)
    want = dense.T @ np.ones(20, np.float32)
    np.testing.assert_allclose(np.asarray(g), want, rtol=RTOL, atol=1e-3)


def test_sddmm_grads():
    dense = _random_dense(15, 15, 0.4, seed=9)
    op = ag.make_operator(CSR.from_dense(dense))
    rng = np.random.default_rng(10)
    l = jnp.asarray(rng.standard_normal((15, 4)).astype(np.float32))
    r = jnp.asarray(rng.standard_normal((15, 4)).astype(np.float32))

    def f(ll, rr):
        return jnp.sum(ag.sddmm(op, ll, rr) ** 2)

    gl, gr = jax.grad(f, argnums=(0, 1))(l, r)
    # finite-difference spot check on one coordinate
    eps = 1e-3
    lp = np.asarray(l).copy()
    lp[2, 1] += eps
    lm = np.asarray(l).copy()
    lm[2, 1] -= eps
    fd = (float(f(jnp.asarray(lp), r)) - float(f(jnp.asarray(lm), r))) / (2 * eps)
    assert float(gl[2, 1]) == pytest.approx(fd, rel=2e-2, abs=1e-3)


def test_operator_transpose_property():
    dense = _random_dense(12, 18, 0.3, seed=11)
    op = ag.make_operator(CSR.from_dense(dense))
    x = jnp.asarray(np.random.default_rng(12).standard_normal((12, 5)).astype(np.float32))
    y = ag.spmm(op.T, x, impl="xla")
    np.testing.assert_allclose(np.asarray(y), dense.T @ np.asarray(x), rtol=RTOL, atol=1e-3)
