"""Expert parallelism (MoE): routing invariants + sharded/dense parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.parallel.ep import MoELayer, expert_capacity, top_k_dispatch


def _mesh(n, name="ep"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def test_dispatch_invariants():
    T, E, C, K = 64, 8, 12, 2
    probs = jax.nn.softmax(
        jax.random.normal(jax.random.key(0), (T, E)), axis=-1)
    dispatch, combine, aux = top_k_dispatch(probs, K, C)
    d = np.asarray(dispatch)
    # each token occupies at most K slots, each slot holds at most 1 token
    assert d.sum(axis=(1, 2)).max() <= K + 1e-6
    assert d.sum(axis=0).max() <= 1 + 1e-6
    # per-expert usage bounded by capacity
    assert d.sum(axis=(0, 2)).max() <= C + 1e-6
    # combine is supported only on dispatched slots, weights sum to <=1
    c = np.asarray(combine)
    assert (c[d == 0] == 0).all()
    np.testing.assert_array_less(c.sum(axis=(1, 2)), 1 + 1e-5)
    assert np.isfinite(float(aux))


def test_dense_moe_matches_per_token_reference():
    """With ample capacity nothing drops: y = sum_k gate_k * FFN_{e_k}(x)."""
    T, D, E, F, K = 16, 8, 4, 16, 2
    layer = MoELayer(D, E, F, top_k=K, capacity_factor=float(E))
    params = layer.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (T, D), jnp.float32)
    got = layer.apply(params, x)

    probs = np.asarray(jax.nn.softmax(x @ params["wg"], axis=-1))
    w1, b1 = np.asarray(params["w1"]), np.asarray(params["b1"])
    w2, b2 = np.asarray(params["w2"]), np.asarray(params["b2"])
    xs = np.asarray(x)
    want = np.zeros((T, D), np.float32)
    for t in range(T):
        order = np.argsort(-probs[t])[:K]
        g = probs[t][order]
        g = g / g.sum()
        for gk, e in zip(g, order):
            h = np.asarray(jax.nn.gelu(xs[t] @ w1[e] + b1[e]))
            want[t] += gk * (h @ w2[e] + b2[e])
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_matches_per_shard_dense(p):
    """EP all_to_all path == running the dense layer shard by shard."""
    D, E, F, K = 8, 8, 16, 2
    T = 8 * p
    layer = MoELayer(D, E, F, top_k=K, capacity_factor=1.5)
    params = layer.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (T, D), jnp.float32)

    mesh = _mesh(p)
    sharded = layer.make_sharded_apply(mesh)
    got = np.asarray(sharded(layer.shard_params(params, mesh), x))

    # reference: identical routing/capacity semantics, one shard at a time
    per = T // p
    want = np.concatenate([
        np.asarray(layer.apply(params, x[i * per:(i + 1) * per]))
        for i in range(p)
    ])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sharded_grads_finite_and_match_dense():
    p, D, E, F = 4, 8, 8, 16
    T = 4 * p
    layer = MoELayer(D, E, F, top_k=2, capacity_factor=2.0)
    params = layer.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (T, D), jnp.float32)
    mesh = _mesh(p)
    sharded = layer.make_sharded_apply(mesh)

    def loss_sharded(prm):
        return jnp.sum(sharded(prm, x) ** 2)

    def loss_dense(prm):
        per = T // p
        return sum(jnp.sum(layer.apply(prm, x[i * per:(i + 1) * per]) ** 2)
                   for i in range(p))

    gs = jax.grad(loss_sharded)(layer.shard_params(params, mesh))
    gd = jax.grad(loss_dense)(params)
    for k in gd:
        np.testing.assert_allclose(np.asarray(gs[k]), np.asarray(gd[k]),
                                   rtol=5e-4, atol=5e-5, err_msg=k)


def test_capacity_rule():
    assert expert_capacity(64, 8, 2, 1.0) == 16
    assert expert_capacity(64, 8, 2, 1.25) == 20
    assert expert_capacity(1, 64, 1, 1.0) == 1
