"""Distributed-context exception UX: mesh/placement/plan mismatches.

The thinnest area vs the reference's 47 dedicated exception files
(python/oneflow/test/exceptions/, e.g. test_global.py's placement and
sbp mismatch messages): errors raised at the mesh/plan boundary must
name the mismatching quantities, not surface as shape errors deep inside
a collective."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm.sparse.formats import CSR
from of_spmm.utils.errors import (
    CapacityError, ConfigError, OfSpmmError, PlacementError, PlanError,
    ShapeError)


def _mesh(n, axis="x"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _csr(n=64, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    return CSR.from_dense(
        ((rng.random((n, n)) < density)
         * rng.random((n, n))).astype(np.float32))


def test_dist_spmm_wrong_axis_name():
    from of_spmm.parallel.dist_spmm import dist_spmm
    from of_spmm.parallel.partition import partition_rows

    plan = partition_rows(_csr(), 4)
    x = jnp.ones((64, 8), jnp.float32)
    with pytest.raises(KeyError):
        with _mesh(4, axis="data") as mesh:
            dist_spmm(plan, x, mesh, axis="x")


def test_partition_refine_rejects_rectangular():
    from of_spmm.parallel.partition import partition_rows

    rng = np.random.default_rng(1)
    rect = CSR.from_dense((rng.random((32, 64)) < 0.2).astype(np.float32))
    with pytest.raises(ValueError, match="square"):
        partition_rows(rect, 4, refine_slack=0.2)


def test_partition_bad_ladder_message():
    from of_spmm.parallel.partition import partition_rows

    with pytest.raises(ValueError, match="ladder must be"):
        partition_rows(_csr(), 4, ladder="fastest")


def test_make_operator_unknown_layout_lists_choices():
    from of_spmm.ops.autograd import make_operator

    with pytest.raises(ValueError) as e:
        make_operator(_csr(), layout="blocked")
    msg = str(e.value)
    for choice in ("auto", "binned", "tiered"):
        assert choice in msg, msg


def test_make_operator_unknown_reorder_lists_choices():
    from of_spmm.ops.autograd import make_operator

    with pytest.raises(ValueError, match="lp|bfs|identity"):
        make_operator(_csr(), layout="binned", place=False,
                      reorder="metis5")


def test_mesh_shard_mismatch_names_counts():
    from of_spmm.parallel.dist_spmm import dist_spmm
    from of_spmm.parallel.partition import partition_rows

    plan = partition_rows(_csr(), 8)
    x = jnp.ones((64, 8), jnp.float32)
    with pytest.raises(ValueError) as e:
        with _mesh(4) as mesh:
            dist_spmm(plan, x, mesh)
    msg = str(e.value)
    assert "8" in msg and "4" in msg  # both counts named


def test_error_hierarchy_catchable_as_base():
    """Every framework error type derives from OfSpmmError (the Maybe<T>
    error-monad analog, utils/errors.py) AND from the matching builtin."""
    assert issubclass(ShapeError, OfSpmmError)
    assert issubclass(ShapeError, ValueError)
    assert issubclass(PlacementError, ValueError)
    assert issubclass(ConfigError, ValueError)
    assert issubclass(PlanError, RuntimeError)
    assert issubclass(CapacityError, RuntimeError)
