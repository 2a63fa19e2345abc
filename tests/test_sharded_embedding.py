"""Sharded embedding: forward parity with dense lookup + gradient routing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.models.sharded_embedding import ShardedEmbedding


def test_forward_matches_dense_lookup(mesh8):
    emb = ShardedEmbedding(num_embeddings=100, embedding_dim=16)
    params = emb.init(jax.random.key(0), mesh8)
    assert params["weight"].shape == (104, 16)  # padded to multiple of 8
    w = np.asarray(params["weight"])
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 100, 64).astype(np.int32))
    out = emb.apply(params, ids, mesh8)
    np.testing.assert_allclose(np.asarray(out), w[np.asarray(ids)], rtol=1e-6)


def test_out_of_range_ids_zero(mesh8):
    emb = ShardedEmbedding(num_embeddings=40, embedding_dim=8)
    params = emb.init(jax.random.key(1), mesh8)
    ids = jnp.asarray([0, 39, 40, 1000, -1, 5, 6, 7], jnp.int32)
    out = np.asarray(emb.apply(params, ids, mesh8))
    w = np.asarray(params["weight"])
    np.testing.assert_allclose(out[0], w[0], rtol=1e-6)
    np.testing.assert_array_equal(out[3], 0.0)  # 1000 out of range
    np.testing.assert_array_equal(out[4], 0.0)  # negative


def test_gradients_route_to_owning_shards(mesh8):
    """dW accumulates duplicate-id cotangents (segment-sum pairing)."""
    emb = ShardedEmbedding(num_embeddings=32, embedding_dim=4)
    params = emb.init(jax.random.key(2), mesh8)
    ids = jnp.asarray([3, 3, 17, 31, 0, 3, 17, 8], jnp.int32)

    def loss(p):
        out = emb.apply(p, ids, mesh8)
        return jnp.sum(out * jnp.arange(1.0, 9.0)[:, None])

    g = jax.grad(loss)(params)["weight"]
    g = np.asarray(g)
    # id 3 referenced by batch items 0, 1, 5 with weights 1, 2, 6
    np.testing.assert_allclose(g[3], np.full(4, 1.0 + 2.0 + 6.0), rtol=1e-6)
    np.testing.assert_allclose(g[17], np.full(4, 3.0 + 7.0), rtol=1e-6)
    np.testing.assert_allclose(g[5], 0.0)  # untouched row


def test_batch_divisibility_error(mesh8):
    emb = ShardedEmbedding(num_embeddings=16, embedding_dim=4)
    params = emb.init(jax.random.key(3), mesh8)
    with pytest.raises(ValueError, match="divisible"):
        emb.apply(params, jnp.zeros(7, jnp.int32), mesh8)


def test_table_is_sharded(mesh8):
    emb = ShardedEmbedding(num_embeddings=64, embedding_dim=8)
    params = emb.init(jax.random.key(4), mesh8)
    assert "x" in str(params["weight"].sharding.spec)
    shards = params["weight"].addressable_shards
    assert len(shards) == 8 and shards[0].data.shape == (8, 8)
