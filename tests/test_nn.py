"""nn module library tests: layers vs torch semantics, GNN convs vs oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm import nn
from of_spmm.models import normalized_adjacency
from of_spmm.ops import make_operator, spmm
from of_spmm.ops import reference as ref
from of_spmm.sparse.formats import CSR

from tests.conftest import ATOL, RTOL


def _rand_csr(n, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    return CSR.from_dense(dense)


def test_linear_matches_torch():
    torch = pytest.importorskip("torch")
    lin = nn.Linear(8, 5)
    params = lin.init(jax.random.key(0))
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    y = lin.apply(params, jnp.asarray(x))
    tl = torch.nn.Linear(8, 5)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(params["w"]).T))
        tl.bias.copy_(torch.from_numpy(np.asarray(params["b"])))
        ty = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=RTOL, atol=ATOL)


def test_layernorm_matches_torch():
    torch = pytest.importorskip("torch")
    ln = nn.LayerNorm((6,))
    params = ln.init(jax.random.key(0))
    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    y = ln.apply(params, jnp.asarray(x))
    ty = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (6,)
    ).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-4, atol=1e-5)


def test_batchnorm_train_eval():
    torch = pytest.importorskip("torch")
    bn = nn.BatchNorm(5, momentum=0.1)
    params = bn.init(jax.random.key(0))
    state = bn.init_state()
    x = np.random.default_rng(2).standard_normal((16, 5)).astype(np.float32)

    tb = torch.nn.BatchNorm1d(5, momentum=0.1)
    tb.train()
    ty = tb(torch.from_numpy(x)).detach().numpy()
    y, state = bn.apply(params, jnp.asarray(x), state=state, train=True)
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(state["mean"]), tb.running_mean.numpy(), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(state["var"]), tb.running_var.numpy(), rtol=1e-4, atol=1e-5
    )
    # eval mode uses running stats
    tb.eval()
    ty2 = tb(torch.from_numpy(x)).detach().numpy()
    y2 = bn.apply(params, jnp.asarray(x), state=state, train=False)
    np.testing.assert_allclose(np.asarray(y2), ty2, rtol=1e-4, atol=1e-4)


def test_dropout_scaling_and_eval_identity():
    do = nn.Dropout(0.5)
    x = jnp.ones((1000,))
    y = do.apply({}, x, train=True, rng=jax.random.key(0))
    # inverted dropout preserves expectation
    assert abs(float(jnp.mean(y)) - 1.0) < 0.15
    assert float(jnp.max(y)) == pytest.approx(2.0)
    np.testing.assert_array_equal(np.asarray(do.apply({}, x, train=False)), np.asarray(x))


def test_cross_entropy_matches_torch():
    torch = pytest.importorskip("torch")
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 7).astype(np.int64)
    ours = nn.losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    theirs = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels)
    ).numpy()
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL, atol=ATOL)
    # ignore_index path
    labels[0] = -1
    ours = nn.losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), ignore_index=-1
    )
    theirs = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), ignore_index=-1
    ).numpy()
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL, atol=ATOL)


def test_sequential_mlp_runs_and_differentiates():
    model = nn.Sequential(
        nn.Linear(8, 16), nn.relu, nn.Dropout(0.1), nn.Linear(16, 3)
    )
    params = model.init(jax.random.key(0))
    x = jnp.ones((4, 8))

    def loss(p):
        y = model.apply(p, x, train=True, rng=jax.random.key(1))
        return jnp.sum(y ** 2)

    g = jax.grad(loss)(params)
    assert jnp.all(jnp.isfinite(g["layer_0"]["w"]))
    assert g["layer_3"]["w"].shape == (16, 3)


def test_gcnconv_equals_manual():
    csr = _rand_csr(32, seed=4)
    op = make_operator(normalized_adjacency(csr))
    conv = nn.GCNConv(8, 5)
    params = conv.init(jax.random.key(0))
    x = jnp.asarray(np.random.default_rng(5).standard_normal((32, 8)).astype(np.float32))
    y = conv.apply(params, op, x, impl="xla")
    want = spmm(op, x, impl="xla") @ params["w"] + params["b"]
    np.testing.assert_allclose(np.asarray(y), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gatconv_rows_sum_to_one_and_grads():
    csr = _rand_csr(24, density=0.2, seed=6)
    op = make_operator(csr, relabel=False)
    conv = nn.GATConv(6, 4, heads=2)
    params = conv.init(jax.random.key(0))
    x = jnp.asarray(np.random.default_rng(7).standard_normal((24, 6)).astype(np.float32))
    y = conv.apply(params, op, x)
    assert y.shape == (24, 8)

    # attention rows with constant features reduce to plain averaging of hw
    def loss(p, xx):
        return jnp.sum(conv.apply(p, op, xx) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    for leaf in jax.tree_util.tree_leaves((gp, gx)):
        assert np.all(np.isfinite(np.asarray(leaf)))
    assert float(jnp.abs(gp["a_src"]).sum()) > 0  # attention params get grads


def test_ginconv_matches_manual():
    csr = _rand_csr(16, seed=8)
    op = make_operator(csr, relabel=False)
    conv = nn.GINConv(4, 8, 3)
    params = conv.init(jax.random.key(0))
    x = jnp.asarray(np.random.default_rng(9).standard_normal((16, 4)).astype(np.float32))
    y = conv.apply(params, op, x)
    z = (1.0 + params["eps"]) * x + ref.spmm(csr, x)
    z = jax.nn.relu(z @ params["w1"] + params["b1"])
    want = z @ params["w2"] + params["b2"]
    np.testing.assert_allclose(np.asarray(y), np.asarray(want), rtol=RTOL, atol=1e-4)


def test_segment_softmax_normalizes():
    from of_spmm.ops import segment_softmax

    scores = jnp.asarray([1.0, 2.0, 3.0, -1.0, 0.5])
    ids = jnp.asarray([0, 0, 1, 1, 3])
    out = segment_softmax(scores, ids, 4)
    sums = jax.ops.segment_sum(out, ids, num_segments=4)
    np.testing.assert_allclose(np.asarray(sums)[[0, 1, 3]], 1.0, rtol=1e-5)


def test_embedding_padding_idx():
    emb = nn.Embedding(10, 4, padding_idx=0)
    params = emb.init(jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(params["weight"][0]), 0.0)
    out = emb.apply(params, jnp.asarray([[1, 0], [2, 3]]))
    assert out.shape == (2, 2, 4)
    np.testing.assert_array_equal(np.asarray(out[0, 1]), 0.0)
