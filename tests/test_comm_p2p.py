"""P2P send/recv + PartialSum boxing sweep (VERDICT r1 items 4 and 10).

Reference anchors: Send/Recv functors
(oneflow/core/functional/impl/comm_functor.cpp:331-373) and the eager
boxing algebra treating P->B / P->S as first-class
(oneflow/core/boxing/eager_boxing_interpreter_mgr.cpp:132-165).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from of_spmm import comm
from of_spmm.parallel import to_global


def _shard_map(f, mesh, in_specs=P("x"), out_specs=P("x")):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _ranked(mesh):
    """(8, 4) array whose row i is filled with i (shard i sees its rank)."""
    n = len(mesh.devices.ravel())
    x = np.repeat(np.arange(n, dtype=np.float32)[:, None], 4, axis=1)
    return to_global(x, "S0", mesh)


def test_send_recv_pair(mesh8):
    x = _ranked(mesh8)
    out = _shard_map(lambda a: comm.send_recv(a, 2, 5, "x"), mesh8)(x)
    got = np.asarray(out)
    np.testing.assert_array_equal(got[5], np.full(4, 2.0))
    for i in range(8):
        if i != 5:
            np.testing.assert_array_equal(got[i], np.zeros(4))


def test_send_recv_pairs_disjoint(mesh8):
    x = _ranked(mesh8)
    pairs = [(0, 7), (3, 1), (6, 2)]
    out = _shard_map(lambda a: comm.send_recv_pairs(a, pairs, "x"), mesh8)(x)
    got = np.asarray(out)
    want = {7: 0.0, 1: 3.0, 2: 6.0}
    for i in range(8):
        np.testing.assert_array_equal(
            got[i], np.full(4, want.get(i, 0.0)))


def test_send_recv_differentiable(mesh8):
    """ppermute transposes under AD: grad flows dst -> src."""
    x = _ranked(mesh8)

    def loss(a):
        y = _shard_map(lambda s: comm.send_recv(s, 2, 5, "x"), mesh8)(a)
        return (y[5] ** 2).sum() / 2

    g = jax.grad(loss)(x)
    got = np.asarray(g)
    np.testing.assert_array_equal(got[2], np.full(4, 2.0))
    assert np.all(got[np.arange(8) != 2] == 0)


def test_transfer_eager(mesh8):
    devs = jax.devices()
    x = jnp.arange(4.0)
    y = comm.transfer(x, devs[3])
    assert y.devices() == {devs[3]}
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


# ---------------------------------------------------------------------------
# PartialSum as a first-class source in the boxing sweep
# ---------------------------------------------------------------------------

def _partial_pieces(x, n):
    """Split x into n pieces that SUM to x (a P placement's local shards)."""
    rng = np.random.default_rng(0)
    parts = rng.random((n,) + x.shape).astype(np.float32)
    parts = parts / parts.sum(axis=0) * x
    return parts


def test_p_to_b_psum(mesh8):
    """P -> B == ccl-p-to-b (allreduce)."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4) + 1
    parts = _partial_pieces(x, 8)
    stacked = to_global(parts.reshape(8, -1), "S0", mesh8)

    def body(p_shard):
        return jax.lax.psum(p_shard, "x")

    out = _shard_map(body, mesh8, in_specs=P("x"), out_specs=P())(stacked)
    np.testing.assert_allclose(np.asarray(out)[0].reshape(8, 4), x,
                               rtol=1e-5)


def test_p_to_s0_reduce_scatter(mesh8):
    """P -> S(0) == ccl-p-to-s (reduce_scatter)."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8) + 1
    parts = _partial_pieces(x, 8)  # (8, 8, 8)
    stacked = to_global(parts.reshape(8, -1), "S0", mesh8)

    def body(p_shard):
        local = p_shard.reshape(8, 8)
        return jax.lax.psum_scatter(local, "x", scatter_dimension=0,
                                    tiled=True)

    out = _shard_map(body, mesh8)(stacked)
    np.testing.assert_allclose(np.asarray(out), x, rtol=1e-5)


def test_p_to_s1_reduce_scatter_axis1(mesh8):
    """P -> S(1): reduce_scatter along the second tensor axis."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8) + 1
    parts = _partial_pieces(x, 8)
    stacked = to_global(parts.reshape(8, -1), "S0", mesh8)

    def body(p_shard):
        local = p_shard.reshape(8, 8)
        return jax.lax.psum_scatter(local, "x", scatter_dimension=1,
                                    tiled=True)

    out = _shard_map(body, mesh8, out_specs=P(None, "x"))(stacked)
    np.testing.assert_allclose(np.asarray(out), x, rtol=1e-5)


def test_p_chain_p_to_s_to_b(mesh8):
    """Composite boxing: P -> S(0) -> B round-trips to the full sum
    (the reference's `|` fallback composition of boxing functions)."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8) + 1
    parts = _partial_pieces(x, 8)
    stacked = to_global(parts.reshape(8, -1), "S0", mesh8)

    def body(p_shard):
        local = p_shard.reshape(8, 8)
        s0 = jax.lax.psum_scatter(local, "x", scatter_dimension=0,
                                  tiled=True)
        return jax.lax.all_gather(s0, "x", axis=0, tiled=True)

    out = _shard_map(body, mesh8, out_specs=P())(stacked)
    np.testing.assert_allclose(np.asarray(out), x, rtol=1e-5)
