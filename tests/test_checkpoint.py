"""Checkpoint round-trips: npz + sharding restore + orbax sharded."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from of_spmm.utils.checkpoint import (
    load_checkpoint,
    load_sharded,
    save_checkpoint,
    save_sharded,
)


def test_npz_roundtrip_and_structure_check(tmp_path, mesh8):
    sh = NamedSharding(mesh8, P("x"))
    tree = {"w": jax.device_put(jnp.arange(16.0), sh), "b": jnp.ones(3),
            "step": jnp.int32(7)}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, tree)
    like = {"w": jax.device_put(jnp.zeros(16), sh), "b": jnp.zeros(3),
            "step": jnp.int32(0)}
    out = load_checkpoint(p, like)
    np.testing.assert_array_equal(np.asarray(out["w"]), np.arange(16.0))
    assert int(out["step"]) == 7
    assert "x" in str(out["w"].sharding.spec)  # placement restored
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(p, {"different": jnp.zeros(2)})


def test_orbax_sharded_roundtrip(tmp_path, mesh8):
    sh = NamedSharding(mesh8, P("x", None))
    tree = {"emb": jax.device_put(jnp.arange(32.0).reshape(16, 2), sh)}
    p = str(tmp_path / "orb")
    save_sharded(p, tree)
    like = {"emb": jax.device_put(jnp.zeros((16, 2)), sh)}
    out = load_sharded(p, like)
    np.testing.assert_array_equal(np.asarray(out["emb"]),
                                  np.arange(32.0).reshape(16, 2))
    assert "x" in str(out["emb"].sharding.spec)
