"""chip_smoke.py's comparison helpers and last line, on Cora on the CPU
(the script itself refuses to run without a GPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs


def test_result_line_is_exact():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(cs.result_line("gpu", "k", 4))["device"]["count"] == 4


def test_compare_accepts_summation_order_noise():
    want = np.linspace(-3.0, 3.0, 101)
    got = want * (1 + 5e-6)
    assert "worst_err/tol" in cs.compare("x", got, want)


@pytest.mark.parametrize("bad", ["scaled", "nan", "shape"])
def test_compare_rejects(bad):
    want = np.linspace(-3.0, 3.0, 101)
    got = {"scaled": want * (1 + 1e-3),
           "nan": np.where(np.arange(101) == 7, np.nan, want),
           "shape": want[:100]}[bad]
    with pytest.raises(AssertionError):
        cs.compare("x", got, want)


def test_compare_atol_is_relative_to_max():
    want = np.array([1000.0, 0.0])
    got = np.array([1000.0, 5e-3])  # 5e-6 of max|ref|: inside
    cs.compare("x", got, want)
    with pytest.raises(AssertionError):
        cs.compare("x", np.array([1000.0, 2e-2]), want)


def test_sample_rows():
    assert np.array_equal(cs.sample_rows(10, k=20), np.arange(10))
    r = cs.sample_rows(1000, k=64, seed=3)
    assert r.shape == (64,) and np.all(np.diff(r) > 0)
    assert np.array_equal(r, cs.sample_rows(1000, k=64, seed=3))


def test_csr64_matches_dense():
    from of_spmm.sparse.formats import CSR

    dense = np.random.default_rng(0).standard_normal((5, 7)).astype(
        np.float32) * (np.random.default_rng(1).random((5, 7)) < 0.4)
    a = cs.csr64(CSR.from_dense(dense))
    assert a.dtype == np.float64
    np.testing.assert_array_equal(a.toarray(), dense.astype(np.float64))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_check_spmm_on_cora(impl):
    adj, cfg, x, y, g, _ = cs._load("cora")
    from of_spmm.ops.autograd import make_operator

    op = make_operator(adj)
    lines = cs.check_spmm("cora", adj, op, x[:, :16], g[:, :16], (impl,),
                          cs.sample_rows(adj.shape[0], k=500))
    assert [ln.split(":")[0] for ln in lines] == [f"cora {impl} fwd",
                                                  f"cora {impl} bwd"]


def test_check_spmm_catches_a_wrong_operator():
    from of_spmm.ops.autograd import make_operator

    adj, cfg, x, y, g, _ = cs._load("cora")
    wrong = make_operator(_scaled(adj, 1.01))
    with pytest.raises(AssertionError, match="out of tolerance"):
        cs.check_spmm("cora", adj, wrong, x[:, :8], g[:, :8], ("xla",),
                      cs.sample_rows(adj.shape[0], k=200))


def _scaled(csr, s):
    from of_spmm.sparse.formats import CSR

    return CSR.from_arrays(np.asarray(csr.indptr), np.asarray(csr.cols),
                           np.asarray(csr.vals) * np.float32(s), csr.shape)


def test_main_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])


def test_tf32_comparison_shape_on_cora():
    """Step 3's comparison on Cora: on the CPU both precisions agree."""
    from of_spmm.models import GCN
    from of_spmm.ops.autograd import make_operator

    adj, cfg, x, y, g, _ = cs._load("cora")
    op = make_operator(adj)
    model = GCN(feature_dims=(cfg.feature_dim, 32, cfg.n_classes))
    params = model.init(jax.random.key(0))
    l0, g0 = jax.value_and_grad(model.loss_fn)(params, op, x, y)
    with jax.default_matmul_precision("highest"):
        lh, gh = jax.value_and_grad(model.loss_fn)(params, op, x, y)
    for a, b in zip(jax.tree_util.tree_leaves(g0), jax.tree_util.tree_leaves(gh)):
        cs.compare("grad", a, b, rtol=cs.TF32_RTOL, atol_frac=cs.TF32_RTOL)
    assert np.isfinite(float(l0)) and abs(float(l0) - float(lh)) < 1e-2
