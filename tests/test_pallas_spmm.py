"""Pallas kernel vs XLA oracle (interpret mode on CPU; compiled on the GPU
by chip_smoke.py and the ``gpu``-marked test below). Tolerance = the
reference's check_equality bar."""

import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.ops import reference as ref
from of_spmm.ops.pallas.spmm import spmm_pallas
from of_spmm.sparse.binned import bin_rows
from of_spmm.sparse.formats import CSR
from conftest import ATOL, RTOL
from test_spmm_grid import DTYPES, SHAPES, WIDTHS, check, graph


def _case(n, m, density, seed=0, heavy_rows=()):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
    for r in heavy_rows:
        dense[r, :] = rng.standard_normal(m)
    return dense


@pytest.mark.parametrize(
    "n,m,d,density",
    [(64, 64, 128, 0.1), (128, 96, 128, 0.05), (96, 128, 256, 0.08)],
)
def test_pallas_matches_oracle(n, m, d, density):
    dense = _case(n, m, density)
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8, 16, 32))
    x = np.random.default_rng(1).standard_normal((m, d)).astype(np.float32)
    got = spmm_pallas(binned, jnp.asarray(x), interpret=True)
    want = np.asarray(ref.spmm(csr.to_coo(), jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=1e-3)


def test_pallas_split_rows():
    dense = _case(64, 64, 0.05, seed=2, heavy_rows=(0, 5))
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8, 16))
    assert binned.has_split_rows
    x = np.random.default_rng(3).standard_normal((64, 128)).astype(np.float32)
    got = spmm_pallas(binned, jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), dense @ x, rtol=RTOL, atol=1e-3
    )


def test_pallas_nonaligned_feature_dim():
    # d=60 exercises the lane-padding path
    dense = _case(32, 48, 0.15, seed=4)
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8, 16))
    x = np.random.default_rng(5).standard_normal((48, 60)).astype(np.float32)
    got = spmm_pallas(binned, jnp.asarray(x), interpret=True)
    assert got.shape == (32, 60)
    np.testing.assert_allclose(np.asarray(got), dense @ x, rtol=RTOL, atol=1e-3)


def test_pallas_bf16_features():
    dense = _case(32, 32, 0.2, seed=6)
    csr = CSR.from_dense(dense)
    binned = bin_rows(csr, ladder=(4, 8))
    x = np.random.default_rng(7).standard_normal((32, 128)).astype(np.float32)
    got = spmm_pallas(binned, jnp.asarray(x, dtype=jnp.bfloat16), interpret=True)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), dense @ x, rtol=0.05, atol=0.1
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pallas_kernel_matches_float64(shape, d, dtype):
    """The Triton-route kernel (interpret mode here) over the same grid as
    the XLA layouts in test_spmm_grid.py."""
    check(graph(shape), "binned", "pallas", d, dtype)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu():
    """The kernel as Triton compiles it (no interpreter) — runs only with
    a GPU (OFS_TEST_ON_GPU=1); chip_smoke.py covers it at full width."""
    dense = graph("powerlaw")
    binned = bin_rows(CSR.from_dense(dense))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((96, 128)),
                    jnp.float32)
    got = spmm_pallas(binned, x, interpret=False)
    want = ref.spmm_binned_xla(binned, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
