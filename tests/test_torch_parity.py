"""Dual-object parity tests vs torch — the reference's autotest strategy
(test_utils/automated_test_util/torch_flow_dual_object.py) re-expressed:
every module family runs forward + backward in BOTH frameworks on shared
random inputs; outputs, input-grads, and parameter-grads must agree at
rtol=1e-4 / atol=1e-5 (check_equality defaults)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm import nn
from of_spmm.testing import (
    autotest,
    check_grads_against_torch,
    check_module_against_torch,
)

torch = pytest.importorskip("torch")


def randn(key, *shape):
    return jax.random.normal(key, shape, jnp.float32)


@autotest(n=3)
def test_linear(key, trial):
    b, i, o = 4 + trial, 8 + trial, 16
    m = nn.Linear(i, o)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, b, i)])


@autotest(n=2)
def test_linear_nobias(key, trial):
    m = nn.Linear(8, 3, use_bias=False)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 5, 8)])


@autotest(n=2)
def test_conv2d(key, trial):
    m = nn.Conv2d(3, 8, kernel_size=3, stride=1 + trial, padding=1, dilation=1)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 2, 3, 12, 12)])


def test_conv2d_groups_dilation():
    key = jax.random.key(1)
    m = nn.Conv2d(4, 8, kernel_size=3, padding=2, dilation=2, groups=2)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 2, 4, 10, 10)])


@autotest(n=2)
def test_conv1d(key, trial):
    m = nn.Conv1d(3, 6, kernel_size=3, stride=1, padding=1 + trial)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 2, 3, 16)])


@autotest(n=2)
def test_layernorm(key, trial):
    m = nn.LayerNorm((16,))
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 4, 16)])


def test_batchnorm_eval():
    key = jax.random.key(2)
    m = nn.BatchNorm(8)
    k1, k2 = jax.random.split(key)
    # eval mode: running stats are the init state (mean 0, var 1)
    check_module_against_torch(m, m.init(k1), [randn(k2, 16, 8)], train=False)


def test_embedding():
    key = jax.random.key(3)
    m = nn.Embedding(20, 8)
    idx = jnp.asarray(np.random.default_rng(0).integers(0, 20, (7,)))
    check_module_against_torch(m, m.init(key), [idx], int_inputs=True)


@autotest(n=2)
def test_lstm(key, trial):
    m = nn.LSTM(6, 10)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 5, 3, 6)])


@autotest(n=2)
def test_gru(key, trial):
    m = nn.GRU(6, 10)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 5, 3, 6)])


def test_rnn():
    key = jax.random.key(4)
    m = nn.RNN(6, 10)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 5, 3, 6)])


@autotest(n=2)
def test_multihead_attention(key, trial):
    m = nn.MultiheadAttention(16, 4)
    k1, k2 = jax.random.split(key)
    check_module_against_torch(m, m.init(k1), [randn(k2, 2, 6, 16)])


def test_maxpool2d():
    key = jax.random.key(5)
    m = nn.MaxPool2d(2, stride=2)
    check_module_against_torch(m, {}, [randn(key, 2, 3, 8, 8)])


def test_avgpool2d():
    key = jax.random.key(6)
    m = nn.AvgPool2d(2, stride=2)
    check_module_against_torch(m, {}, [randn(key, 2, 3, 8, 8)])


# --- functional ops vs torch --------------------------------------------------


def test_gather_vs_index_select():
    """gather forward + segment-sum backward vs torch.index_select autograd
    (the reference pairing, gradient_funcs/gather.cpp:62-73)."""
    from of_spmm.ops.autograd import gather

    rng = np.random.default_rng(0)
    params = rng.standard_normal((30, 8)).astype(np.float32)
    idx = rng.integers(0, 30, 50).astype(np.int64)
    check_grads_against_torch(
        lambda p, i: gather(p, i),
        lambda p, i: torch.index_select(p, 0, i),
        [params, idx],
    )


def test_segment_sum_vs_index_add():
    from of_spmm.ops.autograd import segment_sum

    rng = np.random.default_rng(1)
    data = rng.standard_normal((50, 8)).astype(np.float32)
    seg = rng.integers(0, 12, 50).astype(np.int64)

    def torch_segsum(d, s):
        out = torch.zeros(12, 8, dtype=d.dtype)
        return out.index_add(0, s, d)

    check_grads_against_torch(
        lambda d, s: segment_sum(d, s, 12), torch_segsum, [data, seg]
    )


def test_spmm_vs_torch_sparse_mm():
    """The flagship op against torch.sparse autograd."""
    from of_spmm.ops.autograd import make_operator, spmm
    from of_spmm.sparse.formats import CSR

    rng = np.random.default_rng(2)
    n, d = 40, 8
    dense = (rng.random((n, n)) < 0.15).astype(np.float32) * rng.random((n, n)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    op = make_operator(CSR.from_dense(dense), place=False)

    ts = torch.from_numpy(dense).to_sparse_coo()

    check_grads_against_torch(
        lambda xx: spmm(op, xx),
        lambda xx: torch.sparse.mm(ts, xx),
        [x],
    )


def test_cross_entropy_vs_torch():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 12).astype(np.int64)
    check_grads_against_torch(
        lambda lg, lb: nn.losses.cross_entropy(lg, lb),
        lambda lg, lb: torch.nn.functional.cross_entropy(lg, lb),
        [logits, labels],
    )


def test_bce_mse_smoothl1_vs_torch():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((9, 5)).astype(np.float32)
    b = rng.standard_normal((9, 5)).astype(np.float32)
    t = (rng.random((9, 5)) > 0.5).astype(np.float32)
    check_grads_against_torch(
        lambda x, y: nn.losses.mse_loss(x, y),
        lambda x, y: torch.nn.functional.mse_loss(x, y), [a, b])
    check_grads_against_torch(
        lambda x, y: nn.losses.smooth_l1_loss(x, y),
        lambda x, y: torch.nn.functional.smooth_l1_loss(x, y), [a, b])
    check_grads_against_torch(
        lambda x, y: nn.losses.bce_with_logits(x, y),
        lambda x, y: torch.nn.functional.binary_cross_entropy_with_logits(x, y),
        [a, t])


def test_activations_vs_torch():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 11)).astype(np.float32)
    pairs = [
        (nn.relu, torch.nn.functional.relu),
        (nn.silu, torch.nn.functional.silu),
        (nn.sigmoid, torch.sigmoid),
        (nn.tanh, torch.tanh),
        (lambda a: nn.softmax(a, axis=-1),
         lambda a: torch.nn.functional.softmax(a, dim=-1)),
        (lambda a: nn.log_softmax(a, axis=-1),
         lambda a: torch.nn.functional.log_softmax(a, dim=-1)),
        (lambda a: nn.leaky_relu(a, 0.1),
         lambda a: torch.nn.functional.leaky_relu(a, 0.1)),
        (nn.elu, torch.nn.functional.elu),
    ]
    for ours, theirs in pairs:
        check_grads_against_torch(ours, theirs, [x])
    # gelu: torch default is exact erf; jax.nn.gelu default is tanh approx
    check_grads_against_torch(
        lambda a: nn.gelu(a, approximate=False),
        lambda a: torch.nn.functional.gelu(a),
        [x],
    )
