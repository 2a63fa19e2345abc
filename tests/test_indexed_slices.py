"""Indexed-slices sparse-gradient path (reference: indexed_slices_reduce_sum
+ IndexedSlices{SGD,Adam} kernels + IndexedSlicesOptimizerRewritePass)."""

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.optim.indexed_slices import (
    IndexedSlices,
    reduce_ids,
    sparse_adam_update,
    sparse_sgd_update,
    sparse_value_and_grad,
)


def test_dense_equivalent():
    g = IndexedSlices(
        indices=jnp.asarray([1, 3, 1]),
        values=jnp.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]),
        n_rows=5,
    )
    want = np.zeros((5, 2), np.float32)
    want[1] = [6.0, 8.0]
    want[3] = [3.0, 4.0]
    np.testing.assert_allclose(np.asarray(g.dense()), want)


def test_reduce_ids_dedups_and_drops():
    g = IndexedSlices(
        indices=jnp.asarray([4, 2, 4, 2, 4]),
        values=jnp.ones((5, 3)),
        n_rows=6,
    )
    r = jax.jit(reduce_ids)(g)
    # same static length, sentinel-filled tail
    assert r.indices.shape == (5,)
    ids = np.asarray(r.indices)
    vals = np.asarray(r.values)
    assert set(ids.tolist()) == {2, 4, 6}  # 6 == n_rows sentinel
    np.testing.assert_allclose(vals[ids == 2], 2.0 * np.ones((1, 3)))
    np.testing.assert_allclose(vals[ids == 4], 3.0 * np.ones((1, 3)))
    np.testing.assert_allclose(vals[ids == 6], 0.0)
    np.testing.assert_allclose(np.asarray(r.dense()), np.asarray(g.dense()))


def test_sparse_sgd_matches_dense():
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.standard_normal((8, 4)).astype(np.float32))
    g = IndexedSlices(
        indices=jnp.asarray([0, 5, 0]),
        values=jnp.asarray(rng.standard_normal((3, 4)).astype(np.float32)),
        n_rows=8,
    )
    got = sparse_sgd_update(p, g, lr=0.1)
    want = p - 0.1 * g.dense()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_sparse_adam_lazy_rows():
    """Touched rows match dense Adam's first step; untouched rows (params
    AND moments) are bit-identical to before — lazy semantics."""
    rng = np.random.default_rng(1)
    n, d = 10, 4
    p = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    m = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32) * 0.01)
    v = jnp.abs(jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))) * 0.01
    ids = jnp.asarray([2, 7, 2])
    vals = jnp.asarray(rng.standard_normal((3, d)).astype(np.float32))
    g = IndexedSlices(indices=ids, values=vals, n_rows=n)
    step = jnp.asarray(1, jnp.int32)

    p2, m2, v2 = jax.jit(sparse_adam_update)(p, m, v, step, g, lr=0.01)

    touched = np.asarray([2, 7])
    untouched = np.asarray([i for i in range(n) if i not in (2, 7)])
    np.testing.assert_array_equal(np.asarray(p2)[untouched], np.asarray(p)[untouched])
    np.testing.assert_array_equal(np.asarray(m2)[untouched], np.asarray(m)[untouched])
    np.testing.assert_array_equal(np.asarray(v2)[untouched], np.asarray(v)[untouched])

    # dense reference on the touched rows
    gd = np.asarray(g.dense())
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.01
    me = b1 * np.asarray(m) + (1 - b1) * gd
    ve = b2 * np.asarray(v) + (1 - b2) * gd * gd
    upd = lr * (me / (1 - b1)) / (np.sqrt(ve / (1 - b2)) + eps)
    np.testing.assert_allclose(
        np.asarray(p2)[touched], (np.asarray(p) - upd)[touched], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(m2)[touched], me[touched], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v2)[touched], ve[touched], rtol=1e-5)


def test_sparse_value_and_grad_never_densifies():
    """End-to-end: embedding loss grad arrives as IndexedSlices and drives
    a sparse update equal to the dense jax.grad result."""
    rng = np.random.default_rng(2)
    n, d = 100, 8
    w = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, n, 16))
    tgt = jnp.asarray(rng.standard_normal((16, d)).astype(np.float32))

    def loss_on_rows(rows, tgt):
        return jnp.mean((rows - tgt) ** 2)

    loss, gs = jax.jit(sparse_value_and_grad(loss_on_rows))(w, ids, tgt)
    assert isinstance(gs, IndexedSlices)

    def dense_loss(w):
        return loss_on_rows(jnp.take(w, ids, axis=0), tgt)

    dl, dg = jax.value_and_grad(dense_loss)(w)
    np.testing.assert_allclose(float(loss), float(dl), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gs.dense()), np.asarray(dg),
                               rtol=1e-5, atol=1e-7)
