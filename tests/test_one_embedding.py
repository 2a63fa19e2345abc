"""Tiered embedding store tests (reference: one_embedding + core/embedding
cache/persistent-table tests, e.g. cache_test.cpp, key_value_store_test.cpp)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from of_spmm.embedding import CachedEmbedding, MultiTableEmbedding, PersistentTable


def test_persistent_table_init_get_put(tmp_path):
    t = PersistentTable(str(tmp_path / "t"), dim=4, capacity=100)
    rows = t.get(np.asarray([5, 9, 5]))
    assert rows.shape == (3, 4)
    np.testing.assert_array_equal(rows[0], rows[2])  # same id, same row
    t.put(np.asarray([5]), np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(t.get(np.asarray([5]))[0], np.ones(4))
    assert t.n_rows == 2


def test_persistent_table_reopen(tmp_path):
    path = str(tmp_path / "t")
    t = PersistentTable(path, dim=3, capacity=10)
    t.put(np.asarray([7]), np.full((1, 3), 2.0, np.float32))
    t.save_snapshot()
    t2 = PersistentTable(path, dim=3, capacity=10)
    np.testing.assert_array_equal(t2.get(np.asarray([7]))[0], np.full(3, 2.0))


def test_snapshot_roundtrip(tmp_path):
    t = PersistentTable(str(tmp_path / "t"), dim=2, capacity=10)
    t.put(np.asarray([1, 2]), np.asarray([[1, 1], [2, 2]], np.float32))
    t.save_snapshot("s1")
    t.put(np.asarray([1]), np.asarray([[9, 9]], np.float32))
    t.load_snapshot("s1")
    np.testing.assert_array_equal(t.get(np.asarray([1]))[0], [1, 1])


def test_cached_embedding_lookup_and_update(tmp_path):
    table = PersistentTable(str(tmp_path / "t"), dim=4, capacity=1000,
                            initializer="zeros")
    emb = CachedEmbedding(table, capacity=8)
    cache, meta = emb.init_cache()

    ids = np.asarray([3, 3, 11, 42])
    slots, cache = emb.prepare(ids, cache, meta)
    rows = emb.lookup(cache, slots)
    assert rows.shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(rows), 0.0)

    # gradient step on the looked-up rows
    g = jnp.ones((4, 4))
    cache = emb.apply_grad(cache, slots, g, meta, lr=0.5)
    rows2 = emb.lookup(cache, slots)
    # id 3 appears twice -> accumulated twice
    np.testing.assert_allclose(np.asarray(rows2)[0], -1.0)
    np.testing.assert_allclose(np.asarray(rows2)[2], -0.5)

    # flush persists updates
    emb.flush(cache, meta)
    np.testing.assert_allclose(table.get(np.asarray([3]))[0], -1.0)
    np.testing.assert_allclose(table.get(np.asarray([42]))[0], -0.5)


def test_cached_embedding_lru_eviction_writeback(tmp_path):
    table = PersistentTable(str(tmp_path / "t"), dim=2, capacity=1000,
                            initializer="zeros")
    emb = CachedEmbedding(table, capacity=4)
    cache, meta = emb.init_cache()

    # fill the cache with ids 0..3 and dirty them
    slots, cache = emb.prepare(np.arange(4), cache, meta)
    cache = emb.apply_grad(cache, slots, jnp.ones((4, 2)), meta, lr=1.0)

    # touch 0 and 1 so 2,3 become LRU victims; then request 2 new ids
    slots, cache = emb.prepare(np.asarray([0, 1]), cache, meta)
    slots, cache = emb.prepare(np.asarray([100, 101]), cache, meta)

    # evicted dirty rows must have been written back
    np.testing.assert_allclose(table.get(np.asarray([2]))[0], -1.0)
    np.testing.assert_allclose(table.get(np.asarray([3]))[0], -1.0)
    # and 0,1 remain cached with their updates
    s01, cache = emb.prepare(np.asarray([0, 1]), cache, meta)
    np.testing.assert_allclose(np.asarray(emb.lookup(cache, s01)), -1.0)

    # re-requesting an evicted id refetches the written-back value
    s2, cache = emb.prepare(np.asarray([2]), cache, meta)
    np.testing.assert_allclose(np.asarray(emb.lookup(cache, s2))[0], -1.0)


def test_cache_too_small_raises(tmp_path):
    table = PersistentTable(str(tmp_path / "t"), dim=2, capacity=100)
    emb = CachedEmbedding(table, capacity=2)
    cache, meta = emb.init_cache()
    with pytest.raises(RuntimeError, match="cache too small"):
        emb.prepare(np.arange(5), cache, meta)


def test_multi_table(tmp_path):
    t1 = PersistentTable(str(tmp_path / "a"), dim=2, capacity=10)
    t2 = PersistentTable(str(tmp_path / "b"), dim=3, capacity=10)
    mt = MultiTableEmbedding({
        "user": CachedEmbedding(t1, capacity=4),
        "item": CachedEmbedding(t2, capacity=4),
    })
    caches = mt.init_caches()
    assert set(caches) == {"user", "item"}
    mt.save_snapshot("s")
    mt.load_snapshot("s")


def test_training_loop_integration(tmp_path):
    """A few steps of embedding regression converge (end-to-end smoke)."""
    table = PersistentTable(str(tmp_path / "t"), dim=4, capacity=1000,
                            initializer="zeros")
    emb = CachedEmbedding(table, capacity=16)
    cache, meta = emb.init_cache()
    tgt = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)

    @jax.jit
    def step(cache, slots, tgt):
        def loss_fn(rows):
            return jnp.mean((rows - tgt) ** 2)
        rows = jnp.take(cache, slots, axis=0)
        loss, g = jax.value_and_grad(loss_fn)(rows)
        return loss, g

    losses = []
    for _ in range(30):
        slots, cache = emb.prepare(np.asarray([10, 20]), cache, meta)
        loss, g = step(cache, jnp.asarray(slots), jnp.asarray(tgt))
        cache = emb.apply_grad(cache, slots, g, meta, lr=1.0)
        losses.append(float(loss))
    assert losses[-1] < 0.01 * losses[0] + 1e-8
