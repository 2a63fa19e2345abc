"""N-D conv/pool long tail + parametric activations vs torch oracles
(reference surface: nn/modules/conv.py, pooling.py, activation.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from of_spmm import nn
from of_spmm.nn import volumetric as V
from of_spmm.testing.autotest import assert_close


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_conv3d_matches_torch():
    m = nn.Conv3d(3, 5, kernel_size=(2, 3, 3), stride=(1, 2, 1), padding=1,
                  dilation=1)
    p = m.init(jax.random.key(0))
    x = _rand(2, 3, 5, 8, 7)
    tm = torch.nn.Conv3d(3, 5, (2, 3, 3), stride=(1, 2, 1), padding=1)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(p["w"])))
        tm.bias.copy_(torch.tensor(np.asarray(p["b"])))
    want = tm(torch.tensor(x)).detach().numpy()
    got = m.apply(p, jnp.asarray(x))
    assert_close(got, want, what="Conv3d")


def test_conv3d_groups():
    m = nn.Conv3d(4, 6, kernel_size=2, groups=2)
    p = m.init(jax.random.key(1))
    x = _rand(1, 4, 4, 5, 6)
    tm = torch.nn.Conv3d(4, 6, 2, groups=2)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(p["w"])))
        tm.bias.copy_(torch.tensor(np.asarray(p["b"])))
    assert_close(m.apply(p, jnp.asarray(x)),
                 tm(torch.tensor(x)).detach().numpy(), what="Conv3d groups")


@pytest.mark.parametrize("cls,tcls,nd", [
    (nn.ConvTranspose1d, torch.nn.ConvTranspose1d, 1),
    (nn.ConvTranspose3d, torch.nn.ConvTranspose3d, 3),
])
def test_conv_transpose_nd(cls, tcls, nd):
    m = cls(3, 4, kernel_size=3, stride=2, padding=1)
    p = m.init(jax.random.key(2))
    x = _rand(2, 3, *([6] * nd))
    tm = tcls(3, 4, 3, stride=2, padding=1)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(p["w"])))
        tm.bias.copy_(torch.tensor(np.asarray(p["b"])))
    assert_close(m.apply(p, jnp.asarray(x)),
                 tm(torch.tensor(x)).detach().numpy(),
                 what=cls.__name__)


@pytest.mark.parametrize("cls,tfn,nd", [
    (nn.MaxPool1d, F.max_pool1d, 1),
    (nn.MaxPool3d, F.max_pool3d, 3),
    (nn.AvgPool1d, F.avg_pool1d, 1),
    (nn.AvgPool3d, F.avg_pool3d, 3),
])
def test_pool_nd(cls, tfn, nd):
    m = cls(kernel_size=2, stride=2)
    x = _rand(2, 3, *([6] * nd))
    got = m.apply({}, jnp.asarray(x))
    want = tfn(torch.tensor(x), 2, 2).numpy()
    assert_close(got, want, what=cls.__name__)


@pytest.mark.parametrize("cls,tfn,nd,out", [
    (nn.AdaptiveMaxPool1d, F.adaptive_max_pool1d, 1, 3),
    (nn.AdaptiveMaxPool2d, F.adaptive_max_pool2d, 2, (3, 4)),
    (nn.AdaptiveMaxPool3d, F.adaptive_max_pool3d, 3, (2, 3, 2)),
    (nn.AdaptiveAvgPool1d, F.adaptive_avg_pool1d, 1, 5),
    (nn.AdaptiveAvgPool3d, F.adaptive_avg_pool3d, 3, (3, 2, 4)),
])
def test_adaptive_pool_nd_nondivisible(cls, tfn, nd, out):
    """Non-divisible output sizes — the exact torch window rule."""
    x = _rand(2, 3, *([7] * nd))
    got = cls(out).apply({}, jnp.asarray(x))
    want = tfn(torch.tensor(x), out)
    if isinstance(want, tuple):
        want = want[0]
    assert_close(got, want.numpy(), what=cls.__name__)


def test_prelu_matches_torch_and_grads():
    m = nn.PReLU(num_parameters=3)
    p = {"a": jnp.asarray([0.1, 0.25, 0.5])}
    x = _rand(2, 3, 4, 5)
    tm = torch.nn.PReLU(3)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(p["a"])))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    ty.sum().backward()
    got = m.apply(p, jnp.asarray(x))
    assert_close(got, ty.detach().numpy(), what="PReLU fwd")
    ga = jax.grad(lambda pp: m.apply(pp, jnp.asarray(x)).sum())(p)["a"]
    assert_close(ga, tm.weight.grad.numpy(), what="PReLU da")


def test_glu_module():
    x = _rand(2, 6)
    got = nn.GLU(axis=-1).apply({}, jnp.asarray(x))
    want = F.glu(torch.tensor(x), dim=-1).numpy()
    assert_close(got, want, what="GLU")


@pytest.mark.parametrize("fn,tfn,kw", [
    (V.hardshrink, F.hardshrink, {}),
    (V.softshrink, F.softshrink, {}),
    (V.tanhshrink, F.tanhshrink, {}),
    (V.softsign, F.softsign, {}),
    (V.logsigmoid, F.logsigmoid, {}),
    (V.elu, F.elu, {}),
    (V.leaky_relu, F.leaky_relu, {}),
])
def test_activation_fns(fn, tfn, kw):
    x = _rand(3, 17)
    assert_close(fn(jnp.asarray(x), **kw), tfn(torch.tensor(x), **kw).numpy(),
                 what=fn.__name__)


def test_threshold():
    x = _rand(3, 9)
    got = V.threshold(jnp.asarray(x), 0.3, -7.0)
    want = F.threshold(torch.tensor(x), 0.3, -7.0).numpy()
    assert_close(got, want, what="threshold")
