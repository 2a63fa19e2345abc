"""Ulysses sequence parallelism: parity with dense MultiheadAttention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.nn.attention import MultiheadAttention
from of_spmm.parallel import SequenceParallelAttention


def _mesh(n, name="sp"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


@pytest.mark.parametrize("is_causal", [False, True])
def test_ulysses_matches_dense(is_causal):
    E, H, B, T = 32, 8, 2, 64
    dense = MultiheadAttention(E, H)
    sp = SequenceParallelAttention(E, H)
    params = dense.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)
    want = dense.apply(params, x, is_causal=is_causal)
    mesh = _mesh(8)
    got = sp.make_sharded_apply(mesh, is_causal=is_causal)(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_ulysses_grads_match_dense():
    E, H, B, T = 16, 4, 2, 32
    dense = MultiheadAttention(E, H)
    sp = SequenceParallelAttention(E, H)
    params = dense.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)

    def loss_dense(p):
        return jnp.sum(dense.apply(p, x) ** 2)

    mesh = _mesh(4)
    apply = sp.make_sharded_apply(mesh)

    def loss_sp(p):
        return jnp.sum(apply(p, x) ** 2)

    g_dense = jax.grad(loss_dense)(params)
    g_sp = jax.grad(loss_sp)(params)
    for k in g_dense:
        np.testing.assert_allclose(np.asarray(g_sp[k]), np.asarray(g_dense[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_ulysses_head_divisibility_error():
    sp = SequenceParallelAttention(32, 4)  # 4 heads on 8 ranks: invalid
    mesh = _mesh(8)
    params = sp.init(jax.random.key(0))
    x = jnp.zeros((1, 16, 32), jnp.float32)
    with pytest.raises(Exception, match="must divide"):
        sp.make_sharded_apply(mesh)(params, x)
