"""Relabeled-operator tests: slice-concat finish correctness + autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.models import GCN, normalized_adjacency
from of_spmm.ops import autograd as ag
from of_spmm.sparse.binned import bin_rows_relabeled
from of_spmm.sparse.formats import CSR
from of_spmm.ops import reference as ref
from tests.conftest import ATOL, RTOL


def _random_dense(n, m, density, seed=0, heavy=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in heavy:
        d[r, :] = rng.standard_normal(m)
    return d


def test_relabeled_binning_matches_dense():
    dense = _random_dense(80, 80, 0.08, seed=1, heavy=(2, 50))
    csr = CSR.from_dense(dense)
    binned, ofn, nfo = bin_rows_relabeled(csr, ladder=(4, 8, 16))
    assert binned.slice_counts is not None
    x = jnp.asarray(np.random.default_rng(2).standard_normal((80, 16)).astype(np.float32))
    # internal-space: A' = P A P^T, x' = P x, y' = A' x' = P y
    x_int = jnp.take(x, ofn, axis=0)
    y_int = ref.spmm_binned_xla(binned, x_int)
    y = jnp.take(y_int, nfo, axis=0)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)


def test_relabeled_with_empty_rows():
    dense = _random_dense(40, 40, 0.1, seed=3)
    dense[7, :] = 0.0
    dense[39, :] = 0.0
    csr = CSR.from_dense(dense)
    binned, ofn, nfo = bin_rows_relabeled(csr)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((40, 8)).astype(np.float32))
    y = jnp.take(ref.spmm_binned_xla(binned, jnp.take(x, ofn, axis=0)), nfo, axis=0)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(y[7]), np.zeros(8))


def test_operator_relabeled_public_spmm_node_space():
    dense = _random_dense(50, 50, 0.12, seed=5)
    op = ag.make_operator(CSR.from_dense(dense))
    assert op.relabeled
    x = jnp.asarray(np.random.default_rng(6).standard_normal((50, 8)).astype(np.float32))
    y = ag.spmm(op, x, impl="xla")
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)


def test_operator_relabeled_grad():
    dense = _random_dense(40, 40, 0.15, seed=7)
    op = ag.make_operator(CSR.from_dense(dense))
    w = np.random.default_rng(8).standard_normal((40, 8)).astype(np.float32)
    x = jnp.asarray(np.random.default_rng(9).standard_normal((40, 8)).astype(np.float32))
    g = jax.grad(lambda xx: jnp.sum(ag.spmm(op, xx, impl="xla") * w))(x)
    np.testing.assert_allclose(np.asarray(g), dense.T @ w, rtol=RTOL, atol=1e-3)


def test_operator_relabeled_nonsymmetric_transpose():
    dense = _random_dense(30, 30, 0.2, seed=10)  # not symmetric
    op = ag.make_operator(CSR.from_dense(dense))
    assert op.relabeled
    x = jnp.asarray(np.random.default_rng(11).standard_normal((30, 4)).astype(np.float32))
    y_t = ag.spmm(op.T, x, impl="xla")
    np.testing.assert_allclose(np.asarray(y_t), dense.T @ np.asarray(x), rtol=RTOL, atol=1e-3)


def test_symmetric_operator_aliases_transpose():
    dense = _random_dense(30, 30, 0.2, seed=12)
    sym = (dense + dense.T) / 2
    op = ag.make_operator(CSR.from_dense(sym))
    # containers are rebuilt by placement; sharing survives at leaf level
    assert op.transpose_aliased
    assert op.binned_t.buckets[0].vals is op.binned.buckets[0].vals


def test_gcn_with_relabeled_operator():
    dense = (np.random.default_rng(13).random((60, 60)) < 0.1).astype(np.float32)
    dense = np.maximum(dense, dense.T)  # undirected graph -> symmetric A_hat
    np.fill_diagonal(dense, 0)
    ahat = normalized_adjacency(CSR.from_dense(dense))
    op = ag.make_operator(ahat)
    assert op.relabeled and op.transpose_aliased  # ahat is symmetric
    model = GCN(feature_dims=(12, 8, 4))
    params = model.init(jax.random.key(0))
    x = jnp.asarray(np.random.default_rng(14).standard_normal((60, 12)).astype(np.float32))
    out = model.apply(params, op, x, impl="xla")
    a = np.asarray(ahat.to_dense())
    h = np.maximum(a @ np.asarray(x) @ np.asarray(params["layer_0"]["w"])
                   + np.asarray(params["layer_0"]["b"]), 0)
    want = a @ h @ np.asarray(params["layer_1"]["w"]) + np.asarray(params["layer_1"]["b"])
    np.testing.assert_allclose(np.asarray(out), want, rtol=RTOL, atol=1e-3)


def test_to_from_internal_roundtrip():
    dense = _random_dense(25, 25, 0.2, seed=15)
    op = ag.make_operator(CSR.from_dense(dense))
    x = jnp.asarray(np.arange(25 * 3, dtype=np.float32).reshape(25, 3))
    np.testing.assert_array_equal(
        np.asarray(op.from_internal(op.to_internal(x))), np.asarray(x)
    )
