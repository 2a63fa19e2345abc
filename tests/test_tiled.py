"""Column-tiered SpMM tests: numerics vs dense, autograd, operator wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.ops import reference as ref
from of_spmm.ops.autograd import make_operator, spmm
from of_spmm.sparse.formats import CSR
from of_spmm.sparse.tiled import TieredEll, bin_rows_tiered

from tests.conftest import ATOL, RTOL


def _rand(n, m, density=0.05, seed=0, zero_rows=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in zero_rows:
        d[r] = 0
    return d


def test_tiered_matches_dense_multi_tier():
    dense = _rand(300, 500, seed=1, zero_rows=(7, 299))
    tiled = bin_rows_tiered(CSR.from_dense(dense), tier_size=128)
    assert len([t for t in tiled.tiers if t.tier >= 0]) == 4
    x = jnp.asarray(np.random.default_rng(2).standard_normal((500, 16)).astype(np.float32))
    y = ref.spmm_tiered_xla(tiled, x)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(y[7]), 0.0)


def test_tiered_single_tier_and_uneven_tail():
    dense = _rand(64, 100, density=0.2, seed=3)  # 100 < tier -> 1 tier, padded x
    tiled = bin_rows_tiered(CSR.from_dense(dense), tier_size=128)
    assert len(tiled.tiers) == 1
    x = jnp.asarray(np.random.default_rng(4).standard_normal((100, 8)).astype(np.float32))
    y = ref.spmm_tiered_xla(tiled, x)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)


def test_tiered_heavy_row_split_across_chunks():
    dense = _rand(60, 200, density=0.05, seed=5)
    dense[10, :] = np.random.default_rng(6).standard_normal(200)  # heavy row
    tiled = bin_rows_tiered(CSR.from_dense(dense), tier_size=64, max_width=16)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((200, 8)).astype(np.float32))
    y = ref.spmm_tiered_xla(tiled, x)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=RTOL, atol=1e-3)


def test_operator_layout_tiered_grad():
    dense = _rand(80, 80, density=0.1, seed=8)
    op = make_operator(CSR.from_dense(dense), layout="tiered", tier_size=32, place=False)
    assert isinstance(op.binned, TieredEll)
    x = jnp.asarray(np.random.default_rng(9).standard_normal((80, 8)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(spmm(op, x)), dense @ np.asarray(x), rtol=RTOL, atol=1e-3
    )
    w = np.random.default_rng(10).standard_normal((80, 8)).astype(np.float32)
    g = jax.grad(lambda xx: jnp.sum(spmm(op, xx) * w))(x)
    np.testing.assert_allclose(np.asarray(g), dense.T @ w, rtol=RTOL, atol=1e-3)


def test_operator_layout_tiered_symmetric_alias():
    dense = _rand(50, 50, density=0.15, seed=11)
    sym = ((dense + dense.T) != 0).astype(np.float32)
    op = make_operator(CSR.from_dense(sym), layout="tiered", tier_size=16, place=False)
    assert op.transpose_aliased
    x = jnp.asarray(np.random.default_rng(12).standard_normal((50, 4)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(spmm(op, x)), sym @ np.asarray(x), rtol=RTOL, atol=1e-3
    )


def test_layout_auto_switches_on_width():
    dense = _rand(40, 40, density=0.2, seed=13)
    op_small = make_operator(CSR.from_dense(dense), place=False)  # auto -> binned
    assert not isinstance(op_small.binned, TieredEll)
    op_forced = make_operator(CSR.from_dense(dense), layout="tiered",
                              tier_size=8, place=False)
    assert isinstance(op_forced.binned, TieredEll)
    with pytest.raises(ValueError, match="layout"):
        make_operator(CSR.from_dense(dense), layout="bogus")


def test_tiered_padding_efficiency_reasonable():
    rng = np.random.default_rng(14)
    dense = (rng.random((256, 256)) < 0.1).astype(np.float32)
    tiled = bin_rows_tiered(CSR.from_dense(dense), tier_size=64)
    assert 0.4 < tiled.padding_efficiency(int(dense.sum())) <= 1.0


def test_tiered_scatter_combine_matches_finish():
    """The memory-lean per-bucket scatter-add combine == finish-gather."""
    import numpy as np
    import jax.numpy as jnp

    from of_spmm.ops.reference import spmm_tiered_xla
    from of_spmm.sparse.formats import CSR
    from of_spmm.sparse.tiled import bin_rows_tiered
    from of_spmm.utils.config import FLAGS

    rng = np.random.default_rng(0)
    n = 300
    dense = (rng.random((n, n)) < 0.05) * rng.random((n, n)).astype(np.float32)
    csr = CSR.from_dense(dense.astype(np.float32))
    tiled = bin_rows_tiered(csr, tier_size=64)
    x = rng.standard_normal((n, 8)).astype(np.float32)

    want = spmm_tiered_xla(tiled, jnp.asarray(x))
    FLAGS.override("OFS_TIERED_SCATTER_BYTES", 1)  # force scatter combine
    try:
        got = spmm_tiered_xla(tiled, jnp.asarray(x))
    finally:
        FLAGS.override("OFS_TIERED_SCATTER_BYTES", None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got), dense @ x, rtol=1e-4, atol=1e-5)


def test_keep_coo_false_spmm_only():
    import numpy as np
    import jax.numpy as jnp
    import pytest

    from of_spmm.ops.autograd import make_operator, spmm, spmv
    from of_spmm.sparse.formats import CSR

    rng = np.random.default_rng(1)
    dense = (rng.random((40, 40)) < 0.1) * rng.random((40, 40)).astype(np.float32)
    csr = CSR.from_dense(dense.astype(np.float32))
    op = make_operator(csr, place=False, keep_coo=False)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm(op, jnp.asarray(x))),
                               dense @ x, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="keep_coo"):
        spmv(op, jnp.asarray(x[:, 0]))
