"""Tensor-parallel Linear pair: parity with single-device, hybrid DP x TP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.parallel import init_tp_mlp, make_tp_mlp, shard_tp_mlp, tp_mlp_block


def _ref(params, x, act=jax.nn.gelu):
    h = act(x @ params["w_in"] + params["b_in"])
    return h @ params["w_out"] + params["b_out"]


def _mesh(shape, names):
    devs = np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def test_tp_mlp_matches_single_device():
    params = init_tp_mlp(jax.random.key(0), 32, 64)
    x = jax.random.normal(jax.random.key(1), (16, 32), jnp.float32)
    want = _ref(params, x)
    mesh = _mesh((8,), ("tp",))
    sharded = shard_tp_mlp(params, mesh)
    got = make_tp_mlp(mesh)(sharded, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tp_mlp_hybrid_dp_tp():
    params = init_tp_mlp(jax.random.key(2), 32, 64)
    x = jax.random.normal(jax.random.key(3), (16, 32), jnp.float32)
    want = _ref(params, x)
    mesh = _mesh((4, 2), ("dp", "tp"))
    sharded = shard_tp_mlp(params, mesh)
    got = make_tp_mlp(mesh, dp_axis="dp")(sharded, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tp_mlp_grads_match():
    params = init_tp_mlp(jax.random.key(4), 16, 32)
    x = jax.random.normal(jax.random.key(5), (8, 16), jnp.float32)
    mesh = _mesh((8,), ("tp",))
    sharded = shard_tp_mlp(params, mesh)
    fwd = make_tp_mlp(mesh)

    g_want = jax.grad(lambda p: jnp.sum(_ref(p, x) ** 2))(params)
    g_got = jax.grad(lambda p: jnp.sum(fwd(p, x) ** 2))(sharded)
    for k in g_want:
        np.testing.assert_allclose(
            np.asarray(g_got[k]), np.asarray(g_want[k]), rtol=1e-4, atol=1e-4
        )


def test_tp_mlp_indivisible_hidden_raises():
    params = init_tp_mlp(jax.random.key(6), 16, 20)  # 20 % 8 != 0
    mesh = _mesh((8,), ("tp",))
    with pytest.raises(ValueError, match="not divisible"):
        shard_tp_mlp(params, mesh)
