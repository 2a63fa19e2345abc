"""SBP-combination sweep (reference: test/graph/test_comb2d.py:33-56 loops
all 1-D/2-D sbp pairs through to_global chains): every (src, dst) SBP pair
must reshard losslessly, and sbp_of must read back the placement."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.parallel import reshard, sbp_of, to_global, to_local

ATOMS_1D = ["S0", "S1", "B"]


@pytest.fixture(scope="module")
def mesh2d():
    devs = np.asarray(jax.devices()).reshape(2, 4)
    return Mesh(devs, ("a", "b"))


def _host(shape=(8, 16)):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def test_comb_1d(mesh8):
    x = _host()
    for src, dst in itertools.product(ATOMS_1D, ATOMS_1D):
        g = to_global(x, src, mesh8)
        assert sbp_of(g, mesh8) == (src,)
        r = reshard(g, dst)
        assert sbp_of(r, mesh8) == (dst,)
        np.testing.assert_array_equal(np.asarray(r), x, err_msg=f"{src}->{dst}")


def test_comb_2d(mesh2d):
    """All 2-D nd-sbp pairs — 9x9 combinations, skipping the illegal
    double-split of one tensor axis over both mesh axes when sizes don't
    divide (8x16 over (2,4): S0,S0 shards axis0 by 8 — legal here)."""
    x = _host()
    pairs = list(itertools.product(ATOMS_1D, ATOMS_1D))
    for src in pairs:
        for dst in pairs:
            g = to_global(x, src, mesh2d)
            assert sbp_of(g, mesh2d) == src
            r = reshard(g, dst)
            assert sbp_of(r, mesh2d) == dst
            np.testing.assert_array_equal(
                np.asarray(r), x, err_msg=f"{src}->{dst}")


def test_comb_chain_1d_to_2d(mesh8, mesh2d):
    """1d<->2d placement transitions (reference test_gbc* files)."""
    x = _host()
    g = to_global(x, "S0", mesh8)
    h = to_global(np.asarray(g), ("S0", "S1"), mesh2d)
    np.testing.assert_array_equal(np.asarray(h), x)
    back = to_global(np.asarray(h), "S1", mesh8)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_to_local_shard_shapes(mesh8):
    x = _host()
    g = to_global(x, "S0", mesh8)
    shards = to_local(g)
    assert len(shards) == 8
    assert all(s.shape == (1, 16) for s in shards)
    np.testing.assert_array_equal(np.concatenate(shards, axis=0), x)


def test_partial_sum_roundtrip(mesh8):
    """P resolves via psum inside shard_map (ccl-p-to-b)."""
    from jax.sharding import PartitionSpec as P

    x = _host()
    pieces = to_global(x, "S0", mesh8)

    def body(x_shard):
        partial = x_shard * 1.0  # pretend each shard holds a partial term
        return jax.lax.psum(partial, "x")

    out = jax.shard_map(
        body, mesh=mesh8, in_specs=P("x"), out_specs=P(),
    )(pieces)
    np.testing.assert_allclose(np.asarray(out)[0], x.sum(axis=0), rtol=1e-6)


def test_partial_to_split_reduce_scatter(mesh8):
    """P -> S0 resolves via psum_scatter inside shard_map (the reference
    boxing algebra's ccl-p-to-s; eager_boxing_interpreter_mgr.cpp makes
    P->S a first-class one-collective lowering, not P->B then slice)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    x = _host((8, 16))

    def body(x_shard):
        partial = x_shard * 1.0
        return jax.lax.psum_scatter(partial, "x", scatter_dimension=0,
                                    tiled=True)

    y = jax.jit(shard_map(
        body, mesh=mesh8, in_specs=P(None, None), out_specs=P("x")))(x)
    # every device contributed one replica of x: P->S0 of (8 copies)
    np.testing.assert_allclose(np.asarray(y), 8.0 * x)


def test_partial_to_split_matches_partial_to_broadcast(mesh8):
    """P->S0 then allgather == P->B (the boxing-combination identity the
    reference checks across its nd-sbp sweep)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    x = _host((8, 16))

    def p_to_b(x_shard):
        return jax.lax.psum(x_shard, "x")

    def p_to_s_to_b(x_shard):
        s = jax.lax.psum_scatter(x_shard, "x", scatter_dimension=0,
                                 tiled=True)
        return jax.lax.all_gather(s, "x", axis=0, tiled=True)

    a = jax.jit(shard_map(p_to_b, mesh=mesh8, in_specs=P(None, None),
                          out_specs=P()))(x)
    b = jax.jit(shard_map(p_to_s_to_b, mesh=mesh8, in_specs=P(None, None),
                          out_specs=P(), check_vma=False))(x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))
