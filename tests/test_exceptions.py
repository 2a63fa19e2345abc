"""Error-message UX tests (reference: python/oneflow/test/exceptions/, 47
files asserting that misuse produces clean, typed, actionable errors)."""

import numpy as np
import pytest

from of_spmm.utils.errors import (
    CapacityError,
    ConfigError,
    OfSpmmError,
    PlacementError,
    ShapeError,
    check,
    error_frame,
)


def test_check_raises_typed():
    with pytest.raises(ShapeError, match="bad dims"):
        check(False, "bad dims", ShapeError)
    check(True, "never", ShapeError)  # no-op


def test_error_frame_stacks_notes():
    with pytest.raises(ValueError) as ei:
        with error_frame("building the plan for graph 'cora'"):
            with error_frame("binning rows"):
                raise ValueError("width must be positive")
    notes = getattr(ei.value, "__notes__", [])
    assert any("binning rows" in n for n in notes)
    assert any("building the plan" in n for n in notes)


def test_typed_hierarchy_catchable_as_base():
    for exc in (ShapeError, PlacementError, ConfigError, CapacityError):
        with pytest.raises(OfSpmmError):
            raise exc("x")


# --- API boundaries produce actionable messages -----------------------------


def test_unknown_graph_lists_available():
    from of_spmm.data.graphs import load_graph

    with pytest.raises((KeyError, ValueError)) as ei:
        load_graph("not-a-graph")
    assert "cora" in str(ei.value)  # suggests what IS available


def test_spgemm_shape_mismatch():
    from of_spmm.ops.reference import spgemm
    from of_spmm.sparse.formats import CSR

    a = CSR.from_dense(np.eye(3, dtype=np.float32))
    b = CSR.from_dense(np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        spgemm(a, b)


def test_bad_sbp_atom():
    import jax
    from jax.sharding import Mesh

    from of_spmm.parallel import to_global

    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    with pytest.raises(ValueError, match="bad SBP atom"):
        to_global(np.ones((4, 4)), "Q7", mesh)


def test_sbp_split_axis_out_of_range():
    import jax
    from jax.sharding import Mesh

    from of_spmm.parallel import to_global

    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    with pytest.raises(ValueError, match="out of range"):
        to_global(np.ones((4, 4)), "S5", mesh)


def test_partial_not_storable():
    import jax
    from jax.sharding import Mesh

    from of_spmm.parallel import to_global

    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    with pytest.raises(ValueError, match="materialize_partial"):
        to_global(np.ones((4, 4)), "P", mesh)


def test_indivisible_split_suggests_padding():
    import jax
    from jax.sharding import Mesh

    from of_spmm.parallel import to_global

    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        to_global(np.ones((9, 4), np.float32), "S0", mesh)


def test_dropout_requires_rng():
    from of_spmm import nn

    m = nn.Dropout(0.5)
    with pytest.raises(ValueError, match="rng"):
        m.apply({}, np.ones((2, 2)), train=True)


def test_unknown_reduction():
    from of_spmm.nn import losses

    with pytest.raises(ValueError, match="unknown reduction"):
        losses.mse_loss(np.ones(3), np.ones(3), reduction="avg")


def test_embedding_cache_capacity_error(tmp_path):
    from of_spmm.embedding import CachedEmbedding, PersistentTable

    t = PersistentTable(str(tmp_path / "t"), dim=2, capacity=100)
    emb = CachedEmbedding(t, capacity=2)
    cache, meta = emb.init_cache()
    with pytest.raises(RuntimeError, match="cache too small"):
        emb.prepare(np.arange(6), cache, meta)


def test_persistent_table_dim_mismatch(tmp_path):
    from of_spmm.embedding import PersistentTable

    PersistentTable(str(tmp_path / "t"), dim=4, capacity=10)
    with pytest.raises(ValueError, match="dim"):
        PersistentTable(str(tmp_path / "t"), dim=8, capacity=10)


def test_spmm_impl_unknown():
    from of_spmm.ops.autograd import make_operator, spmm
    from of_spmm.sparse.formats import CSR

    op = make_operator(CSR.from_dense(np.eye(4, dtype=np.float32)), place=False)
    with pytest.raises(ValueError, match="auto|xla|pallas"):
        spmm(op, np.ones((4, 2), np.float32), impl="cuda")
