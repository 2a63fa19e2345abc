"""Ring attention (context parallelism) vs dense MultiheadAttention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.nn.attention import MultiheadAttention
from of_spmm.parallel import RingAttention


def _mesh(n, name="ring"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("n_dev", [4, 8])
def test_ring_matches_dense(is_causal, n_dev):
    E, H, B, T = 32, 4, 2, 64
    dense = MultiheadAttention(E, H)
    ring = RingAttention(E, H)
    params = dense.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)
    want = dense.apply(params, x, is_causal=is_causal)
    got = ring.make_sharded_apply(_mesh(n_dev), is_causal=is_causal)(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_ring_grads_match_dense():
    E, H, B, T = 16, 4, 1, 32
    dense = MultiheadAttention(E, H)
    ring = RingAttention(E, H)
    params = dense.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)
    apply = ring.make_sharded_apply(_mesh(4), is_causal=True)

    g_dense = jax.grad(lambda p: jnp.sum(
        dense.apply(p, x, is_causal=True) ** 2))(params)
    g_ring = jax.grad(lambda p: jnp.sum(apply(p, x) ** 2))(params)
    for k in g_dense:
        np.testing.assert_allclose(np.asarray(g_ring[k]),
                                   np.asarray(g_dense[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def test_ring_long_sequence_memory_shape():
    # ring size not limited by head count (unlike Ulysses): 8 ranks, 4 heads
    E, H, B, T = 16, 4, 1, 128
    ring = RingAttention(E, H)
    params = ring.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)
    y = ring.make_sharded_apply(_mesh(8))(params, x)
    assert y.shape == (B, T, E)
    assert np.isfinite(np.asarray(y)).all()
