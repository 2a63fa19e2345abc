"""SpMM against a float64 reference over a grid of graph shapes, feature
widths and dtypes, for the plain XLA layouts (binned, tiered); the same
grid for the Pallas kernel is in test_pallas_spmm.py. Also the custom-VJP
gradient (A^T @ g through the transpose plan) per layout and impl."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.ops.autograd import make_operator, spmm
from of_spmm.sparse.formats import CSR

SHAPES = ("powerlaw", "uniform", "empty_rows", "split_heavy", "rectangular")
WIDTHS = (1, 7, 100, 128, 256)
DTYPES = ("float32", "bfloat16")
# fp32: summation order only. bf16: X and Y are rounded to 8 mantissa bits
# (accumulation stays fp32), so the bound is bf16's half-ulp and then some.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# two buckets keep each case to one small compile; the short top width
# splits the heavy rows of "split_heavy" (and powerlaw's head) across ELL rows
LADDER = (8, 32)
SPLIT_LADDER = (4, 16)


def graph(shape: str, seed: int = 0) -> np.ndarray:
    """Small dense adjacency with general (signed) edge values."""
    rng = np.random.default_rng(seed)
    if shape == "powerlaw":
        n = m = 96
        deg = np.maximum(1, (40 / (np.arange(n) + 1) ** 0.8).astype(int))
    elif shape == "uniform":
        n = m = 80
        deg = np.full(n, 5)
    elif shape == "empty_rows":
        n = m = 90
        deg = np.where(np.arange(n) % 3 == 0, 0, 6)
    elif shape == "split_heavy":
        n = m = 64
        deg = np.where(np.arange(n) % 16 == 0, 50, 3)
    elif shape == "rectangular":
        n, m = 70, 120
        deg = rng.integers(0, 12, n)
    else:
        raise ValueError(shape)
    dense = np.zeros((n, m), np.float32)
    for i, k in enumerate(deg):
        cols = rng.choice(m, size=min(int(k), m), replace=False)
        dense[i, cols] = rng.standard_normal(cols.shape[0])
    return dense


def check(dense, layout, impl, d, dtype):
    ladder = SPLIT_LADDER if dense.shape[0] == 64 else LADDER
    op = make_operator(CSR.from_dense(dense), layout=layout, ladder=ladder)
    x = np.random.default_rng(d).standard_normal(
        (dense.shape[1], d)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    y = jax.jit(spmm, static_argnames="impl")(op, xj, impl=impl)
    assert y.shape == (dense.shape[0], d) and y.dtype == xj.dtype
    want = dense.astype(np.float64) @ np.asarray(xj, np.float64)
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(y, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_binned_xla_matches_float64(shape, d, dtype):
    check(graph(shape), "binned", "xla", d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiered_xla_matches_float64(shape, d, dtype):
    check(graph(shape), "tiered", "xla", d, dtype)


def test_split_heavy_graph_really_splits():
    """The grid's split_heavy case exercises split rows on both layouts."""
    op = make_operator(CSR.from_dense(graph("split_heavy")),
                       ladder=SPLIT_LADDER)
    assert op.binned.has_split_rows
    assert max(b.width for b in op.binned.buckets) == SPLIT_LADDER[-1]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", ["binned", "tiered"])
@pytest.mark.parametrize("shape", ["powerlaw", "split_heavy", "rectangular"])
def test_custom_vjp_is_transpose_spmm(shape, layout, impl):
    """grad_x sum(spmm(A, x) * w) == A^T @ w, through the plan's transpose
    layout (and through the relabel boundary for square matrices)."""
    dense = graph(shape, seed=3)
    ladder = SPLIT_LADDER if dense.shape[0] == 64 else LADDER
    op = make_operator(CSR.from_dense(dense), layout=layout, ladder=ladder)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((dense.shape[1], 16)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((dense.shape[0], 16)), jnp.float32)
    g = jax.jit(jax.grad(lambda xx: jnp.sum(spmm(op, xx, impl=impl) * w)))(x)
    want = dense.T.astype(np.float64) @ np.asarray(w, np.float64)
    np.testing.assert_allclose(np.asarray(g, np.float64), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
