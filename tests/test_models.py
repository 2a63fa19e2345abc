"""Model-layer tests: GCN / GraphSAGE / Embedding training smoke + numerics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.models import GCN, Embedding, GraphSAGE, mean_adjacency, normalized_adjacency
from of_spmm.ops.autograd import make_operator
from of_spmm.sparse.formats import CSR
from tests.conftest import ATOL, RTOL


def _graph(n=40, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    return CSR.from_dense(dense)


def test_normalized_adjacency_rows():
    csr = _graph()
    ahat = normalized_adjacency(csr)
    a = np.asarray(ahat.to_dense())
    # symmetric normalization of a symmetrizable pattern keeps values in (0, 1]
    assert (a >= 0).all() and a.max() <= 1.0 + 1e-6
    # self loops present
    assert (np.diag(a) > 0).all()


def test_mean_adjacency_row_sums():
    csr = _graph(seed=1)
    am = np.asarray(mean_adjacency(csr).to_dense())
    sums = am.sum(1)
    deg = np.asarray(csr.to_dense()).astype(bool).sum(1)
    np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-5)


def test_gcn_forward_matches_dense_math():
    csr = _graph(seed=2)
    ahat = normalized_adjacency(csr)
    op = make_operator(ahat)
    model = GCN(feature_dims=(12, 8, 4))
    params = model.init(jax.random.key(0))
    x = jnp.asarray(np.random.default_rng(3).standard_normal((40, 12)).astype(np.float32))
    out = model.apply(params, op, x, impl="xla")
    a = np.asarray(ahat.to_dense())
    h = np.asarray(x)
    h = np.maximum(a @ h @ np.asarray(params["layer_0"]["w"]) + np.asarray(params["layer_0"]["b"]), 0)
    want = a @ h @ np.asarray(params["layer_1"]["w"]) + np.asarray(params["layer_1"]["b"])
    np.testing.assert_allclose(np.asarray(out), want, rtol=RTOL, atol=1e-3)


def test_gcn_trains():
    csr = _graph(n=60, seed=4)
    op = make_operator(normalized_adjacency(csr))
    model = GCN(feature_dims=(16, 16, 5))
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((60, 16)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 5, 60).astype(np.int32))

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(model.loss_fn)(p, op, x, y, impl="xla")
        return loss, jax.tree_util.tree_map(lambda a, b: a - 0.5 * b, p, g)

    loss0, params = step(params)
    for _ in range(10):
        loss, params = step(params)
    assert float(loss) < float(loss0)


def test_sage_forward_shapes():
    csr = _graph(seed=6)
    op = make_operator(mean_adjacency(csr))
    model = GraphSAGE(feature_dims=(10, 8, 3))
    params = model.init(jax.random.key(2))
    x = jnp.asarray(np.random.default_rng(7).standard_normal((40, 10)).astype(np.float32))
    out = model.apply(params, op, x, impl="xla")
    assert out.shape == (40, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_embedding_matches_reference_semantics():
    emb = Embedding(num_embeddings=10, embedding_dim=6)
    params = emb.init(jax.random.key(3))
    idx = jnp.asarray([[1, 2], [2, 9]])
    out = emb.apply(params, idx)
    assert out.shape == (2, 2, 6)
    w = np.asarray(params["weight"])
    np.testing.assert_allclose(np.asarray(out[0, 0]), w[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(out[1, 0]), w[2], rtol=RTOL, atol=ATOL)

    # duplicate-index gradient accumulation (segment-sum pairing)
    def f(p):
        return jnp.sum(emb.apply(p, idx))

    g = jax.grad(f)(params)["weight"]
    assert float(g[2].sum()) == pytest.approx(2 * 6, rel=1e-5)  # index 2 twice
    assert float(g[0].sum()) == 0.0


def test_embedding_padding_idx():
    emb = Embedding(num_embeddings=5, embedding_dim=4, padding_idx=0)
    params = emb.init(jax.random.key(4))
    np.testing.assert_array_equal(np.asarray(params["weight"][0]), np.zeros(4))
