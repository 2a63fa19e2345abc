"""Conv/pool/RNN/attention vs torch oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from of_spmm import nn


def test_conv2d_matches_torch():
    conv = nn.Conv2d(3, 8, 3, stride=2, padding=1, dilation=1)
    params = conv.init(jax.random.key(0))
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(np.float32)
    y = conv.apply(params, jnp.asarray(x))
    tc = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.asarray(params["w"])))
        tc.bias.copy_(torch.from_numpy(np.asarray(params["b"])))
        ty = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-4, atol=1e-4)


def test_conv2d_groups():
    conv = nn.Conv2d(4, 8, 3, groups=2, padding=1)
    params = conv.init(jax.random.key(1))
    x = np.random.default_rng(1).standard_normal((1, 4, 8, 8)).astype(np.float32)
    y = conv.apply(params, jnp.asarray(x))
    tc = torch.nn.Conv2d(4, 8, 3, groups=2, padding=1)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.asarray(params["w"])))
        tc.bias.copy_(torch.from_numpy(np.asarray(params["b"])))
        ty = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-4, atol=1e-4)


def test_conv1d_matches_torch():
    conv = nn.Conv1d(2, 5, 4, stride=2, padding=3)
    params = conv.init(jax.random.key(2))
    x = np.random.default_rng(2).standard_normal((3, 2, 20)).astype(np.float32)
    y = conv.apply(params, jnp.asarray(x))
    tc = torch.nn.Conv1d(2, 5, 4, stride=2, padding=3)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.asarray(params["w"])))
        tc.bias.copy_(torch.from_numpy(np.asarray(params["b"])))
        ty = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-4, atol=1e-4)


def test_pools_match_torch():
    x = np.random.default_rng(3).standard_normal((2, 3, 9, 9)).astype(np.float32)
    mp = nn.MaxPool2d(3, stride=2, padding=1)
    y = mp.apply({}, jnp.asarray(x))
    ty = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2, 1).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-5, atol=1e-5)
    ap = nn.AvgPool2d(2)
    y = ap.apply({}, jnp.asarray(x))
    ty = torch.nn.functional.avg_pool2d(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-5, atol=1e-5)
    gp = nn.AdaptiveAvgPool2d(1)
    y = gp.apply({}, jnp.asarray(x))
    ty = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(np.asarray(y), ty, rtol=1e-5, atol=1e-5)


def _copy_rnn(tmod, params):
    with torch.no_grad():
        tmod.weight_ih_l0.copy_(torch.from_numpy(np.asarray(params["w_ih"])))
        tmod.weight_hh_l0.copy_(torch.from_numpy(np.asarray(params["w_hh"])))
        tmod.bias_ih_l0.copy_(torch.from_numpy(np.asarray(params["b_ih"])))
        tmod.bias_hh_l0.copy_(torch.from_numpy(np.asarray(params["b_hh"])))


def test_lstm_matches_torch():
    m = nn.LSTM(6, 10)
    params = m.init(jax.random.key(4))
    x = np.random.default_rng(4).standard_normal((5, 3, 6)).astype(np.float32)
    ys, (h, c) = m.apply(params, jnp.asarray(x))
    tl = torch.nn.LSTM(6, 10)
    _copy_rnn(tl, params)
    with torch.no_grad():
        tys, (th, tc_) = tl(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(ys), tys.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), th[0].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c), tc_[0].numpy(), rtol=1e-4, atol=1e-5)


def test_gru_matches_torch():
    m = nn.GRU(4, 7)
    params = m.init(jax.random.key(5))
    x = np.random.default_rng(5).standard_normal((6, 2, 4)).astype(np.float32)
    ys, h = m.apply(params, jnp.asarray(x))
    tg = torch.nn.GRU(4, 7)
    _copy_rnn(tg, params)
    with torch.no_grad():
        tys, th = tg(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(ys), tys.numpy(), rtol=1e-4, atol=1e-5)


def test_rnn_matches_torch():
    m = nn.RNN(3, 5)
    params = m.init(jax.random.key(6))
    x = np.random.default_rng(6).standard_normal((4, 2, 3)).astype(np.float32)
    ys, h = m.apply(params, jnp.asarray(x))
    tr = torch.nn.RNN(3, 5)
    _copy_rnn(tr, params)
    with torch.no_grad():
        tys, th = tr(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(ys), tys.numpy(), rtol=1e-4, atol=1e-5)


def test_mha_matches_torch():
    m = nn.MultiheadAttention(8, 2)
    params = m.init(jax.random.key(7))
    x = np.random.default_rng(7).standard_normal((2, 5, 8)).astype(np.float32)
    y = m.apply(params, jnp.asarray(x))
    tm = torch.nn.MultiheadAttention(8, 2, batch_first=True)
    with torch.no_grad():
        tm.in_proj_weight.copy_(torch.from_numpy(np.asarray(params["in_w"])))
        tm.in_proj_bias.copy_(torch.from_numpy(np.asarray(params["in_b"])))
        tm.out_proj.weight.copy_(torch.from_numpy(np.asarray(params["out_w"])))
        tm.out_proj.bias.copy_(torch.from_numpy(np.asarray(params["out_b"])))
        ty, _ = tm(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(y), ty.numpy(), rtol=1e-4, atol=1e-4)


def test_mha_causal():
    m = nn.MultiheadAttention(4, 1, use_bias=False)
    params = m.init(jax.random.key(8))
    x = np.random.default_rng(8).standard_normal((1, 6, 4)).astype(np.float32)
    y = m.apply(params, jnp.asarray(x), is_causal=True)
    # causal: output at t=0 ignores the future -> equals attention over x[:1]
    y0 = m.apply(params, jnp.asarray(x[:, :1]))
    np.testing.assert_allclose(np.asarray(y[:, 0]), np.asarray(y0[:, 0]),
                               rtol=1e-5, atol=1e-6)


def test_groupnorm_matches_torch():
    import torch

    from of_spmm import nn as onn

    x = np.random.default_rng(0).standard_normal((2, 8, 5, 5)).astype(np.float32)
    m = onn.GroupNorm(4, 8)
    params = m.init(jax.random.key(0))
    got = np.asarray(m.apply(params, jnp.asarray(x)))
    tm = torch.nn.GroupNorm(4, 8)
    want = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_instancenorm_matches_torch():
    import torch

    from of_spmm import nn as onn

    x = np.random.default_rng(1).standard_normal((2, 6, 7, 7)).astype(np.float32)
    m = onn.InstanceNorm2d(6)
    got = np.asarray(m.apply({}, jnp.asarray(x)))
    tm = torch.nn.InstanceNorm2d(6)
    want = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (3, 2)])
def test_convtranspose2d_matches_torch(stride, padding):
    import torch

    from of_spmm import nn as onn

    x = np.random.default_rng(2).standard_normal((2, 3, 9, 9)).astype(np.float32)
    m = onn.ConvTranspose2d(3, 5, 4, stride=stride, padding=padding)
    params = m.init(jax.random.key(0))
    got = np.asarray(m.apply(params, jnp.asarray(x)))
    tm = torch.nn.ConvTranspose2d(3, 5, 4, stride=stride, padding=padding)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(params["w"])))
        tm.bias.copy_(torch.tensor(np.asarray(params["b"])))
    want = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
