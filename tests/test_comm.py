"""Collectives + SBP global-view tests on the 8-device CPU mesh.

Mirrors the reference's boxing-combination tests (test/graph/test_comb2d.py
sweeps all SBP pairs through to_global chains) and the eager collective op
tests, on the virtual mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from of_spmm import comm
from of_spmm.parallel import (
    materialize_partial,
    reshard,
    sbp_of,
    sbp_to_spec,
    to_global,
    to_local,
)


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def test_all_reduce(mesh8):
    x = jnp.arange(8.0)
    out = _shard_map(lambda a: comm.all_reduce(a, "x"), mesh8, P("x"), P("x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.full(8, 28.0))


def test_all_gather_tiled(mesh8):
    x = jnp.arange(8.0)
    # every shard receives the full vector; stack them as rows to check
    out = _shard_map(
        lambda a: comm.all_gather(a, "x")[None], mesh8, P("x"), P("x", None)
    )(x)
    np.testing.assert_allclose(np.asarray(out), np.tile(np.arange(8.0), (8, 1)))


def test_reduce_scatter(mesh8):
    # every shard holds [0..7]; reduce_scatter sums -> 8*x, scatters 1 elem each
    x = jnp.tile(jnp.arange(8.0), 8)
    out = _shard_map(lambda a: comm.reduce_scatter(a, "x"), mesh8, P("x"), P("x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.arange(8.0) * 8)


def test_all_to_all_transposes_ownership(mesh8):
    x = jnp.arange(64.0).reshape(8, 8)

    def body(a):  # a: (1, 8) — split cols across shards, receive rows
        return comm.all_to_all(a, "x", split_axis=1, concat_axis=0)

    out = _shard_map(body, mesh8, P("x", None), P("x", None))(x)
    # shard i ends up owning column i: global result is x.T flattened
    np.testing.assert_allclose(
        np.asarray(out), np.arange(64.0).reshape(8, 8).T.reshape(64, 1)
    )


def test_broadcast_and_reduce(mesh8):
    x = jnp.arange(8.0)
    out = _shard_map(lambda a: comm.broadcast(a, root=3, axis_name="x"),
                     mesh8, P("x"), P("x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.full(8, 3.0))
    out = _shard_map(lambda a: comm.reduce(a, root=2, axis_name="x"),
                     mesh8, P("x"), P("x"))(x)
    want = np.zeros(8)
    want[2] = 28.0
    np.testing.assert_allclose(np.asarray(out), want)


def test_ring_shift(mesh8):
    x = jnp.arange(8.0)
    out = _shard_map(lambda a: comm.send_recv_next(a, "x", shift=1),
                     mesh8, P("x"), P("x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.roll(np.arange(8.0), 1))


# ---------------------------------------------------------------------------
# global view / SBP placement
# ---------------------------------------------------------------------------


def test_to_global_split_and_back(mesh8):
    x = np.arange(32.0).reshape(16, 2)
    g = to_global(x, "S0", mesh8)
    assert sbp_of(g, mesh8) == ("S0",)
    shards = to_local(g)
    assert len(shards) == 8 and shards[0].shape == (2, 2)
    np.testing.assert_allclose(np.asarray(g), x)


def test_to_global_replicated(mesh8):
    x = np.arange(6.0)
    g = to_global(x, "B", mesh8)
    assert sbp_of(g, mesh8) == ("B",)
    shards = to_local(g)
    assert all(s.shape == (6,) for s in shards)


@pytest.mark.parametrize("src,dst", [
    ("S0", "B"), ("B", "S0"), ("S0", "S1"), ("S1", "S0"), ("B", "B"), ("S1", "B"),
])
def test_reshard_all_pairs(mesh8, src, dst):
    """The boxing-combination sweep (cf. reference test_comb2d.py)."""
    x = np.arange(8.0 * 16).reshape(8, 16)
    g = to_global(x, src, mesh8)
    r = reshard(g, dst)
    assert sbp_of(r, mesh8) == (dst,)
    np.testing.assert_allclose(np.asarray(r), x)


def test_partial_materialization(mesh8):
    """P -> B via psum inside shard_map (ccl-p-to-b)."""
    x = jnp.arange(8.0)

    def body(a):
        partial = a * 2.0  # pretend each shard holds a partial term
        return materialize_partial(partial, "x")

    out = _shard_map(body, mesh8, P("x"), P("x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.full(8, 56.0))


def test_nd_sbp_2d_mesh():
    """[S0, B] over a 2x4 mesh == DP x TP hybrid placement."""
    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "tp"))
    x = np.arange(4.0 * 8).reshape(4, 8)
    g = to_global(x, ("S0", "S1"), mesh)
    assert sbp_of(g, mesh) == ("S0", "S1")
    np.testing.assert_allclose(np.asarray(g), x)
    spec = sbp_to_spec(("S0", "B"), mesh, 2)
    assert spec == P("dp", None)


def test_sbp_errors(mesh8):
    with pytest.raises(ValueError):
        sbp_to_spec("P", mesh8, 2)
    with pytest.raises(ValueError):
        sbp_to_spec("S5", mesh8, 2)
    with pytest.raises(ValueError):
        sbp_to_spec(("S0", "S1"), mesh8, 2)  # 2 atoms, 1-axis mesh
