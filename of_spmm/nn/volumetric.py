"""N-D conv/pool long tail + parametric activations.

Covers the reference module surface the 2-D set left out
(python/oneflow/nn/modules/conv.py Conv3d/ConvTranspose{1,3}d,
pooling.py MaxPool{1,3}d/AvgPool{1,3}d/AdaptiveMax*/AdaptiveAvg*,
activation.py PReLU/GLU/Threshold/shrink family). Layouts follow torch
(NCL / NCHW / NCDHW, weights OI*); compute lowers to
lax.conv_general_dilated / reduce_window so XLA picks the kernels.

Adaptive pooling implements the exact torch window rule
(start = floor(i*In/Out), end = ceil((i+1)*In/Out)) with a static
Python loop over output positions — output sizes are small, shapes
static, XLA fuses the slices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import jax
import jax.numpy as jnp

from of_spmm.nn.layers import _kaiming_uniform


def _tup(v, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


_CONV_DN = {1: ("NCH", "OIH", "NCH"),
            2: ("NCHW", "OIHW", "NCHW"),
            3: ("NCDHW", "OIDHW", "NCDHW")}
_CONVT_DN = {1: ("NCH", "IOH", "NCH"),
             2: ("NCHW", "IOHW", "NCHW"),
             3: ("NCDHW", "IODHW", "NCDHW")}


@dataclasses.dataclass(frozen=True)
class _ConvNd:
    in_channels: int
    out_channels: int
    kernel_size: Union[int, Tuple[int, ...]]
    stride: Union[int, Tuple[int, ...]] = 1
    padding: Union[int, Tuple[int, ...]] = 0
    dilation: Union[int, Tuple[int, ...]] = 1
    groups: int = 1
    use_bias: bool = True

    _nd = 3

    def init(self, key) -> dict:
        k = _tup(self.kernel_size, self._nd)
        fan_in = self.in_channels // self.groups * int(jnp.prod(
            jnp.asarray(k)))
        kw_, kb = jax.random.split(key)
        p = {"w": _kaiming_uniform(
            kw_, fan_in,
            (self.out_channels, self.in_channels // self.groups) + k)}
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, fan_in, (self.out_channels,))
        return p

    def apply(self, params, x, *, train=False, rng=None):
        nd = self._nd
        pad = _tup(self.padding, nd)
        y = jax.lax.conv_general_dilated(
            x, params["w"],
            window_strides=_tup(self.stride, nd),
            padding=tuple((p, p) for p in pad),
            rhs_dilation=_tup(self.dilation, nd),
            feature_group_count=self.groups,
            dimension_numbers=_CONV_DN[nd],
        )
        if self.use_bias:
            b = params["b"].reshape((1, -1) + (1,) * nd)
            y = y + b
        return y


@dataclasses.dataclass(frozen=True)
class Conv3d(_ConvNd):
    """3-D convolution, NCDHW / OIDHW (nn/modules/conv.py Conv3d)."""

    _nd = 3


@dataclasses.dataclass(frozen=True)
class _ConvTransposeNd:
    in_channels: int
    out_channels: int
    kernel_size: Union[int, Tuple[int, ...]]
    stride: Union[int, Tuple[int, ...]] = 1
    padding: Union[int, Tuple[int, ...]] = 0
    use_bias: bool = True

    _nd = 3

    def init(self, key) -> dict:
        k = _tup(self.kernel_size, self._nd)
        fan_in = self.in_channels * int(jnp.prod(jnp.asarray(k)))
        kw_, kb = jax.random.split(key)
        p = {"w": _kaiming_uniform(
            kw_, fan_in, (self.in_channels, self.out_channels) + k)}
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, fan_in, (self.out_channels,))
        return p

    def apply(self, params, x, *, train=False, rng=None):
        nd = self._nd
        k = _tup(self.kernel_size, nd)
        s = _tup(self.stride, nd)
        pad = _tup(self.padding, nd)
        spatial = tuple(range(2, 2 + nd))
        # torch semantics: input dilated by stride, VALID conv with the
        # spatially-flipped kernel, then crop `padding` per edge (same
        # construction as ConvTranspose2d in nn/conv.py).
        y = jax.lax.conv_general_dilated(
            x, jnp.flip(params["w"], axis=spatial),
            window_strides=(1,) * nd,
            padding=tuple((k[i] - 1 - pad[i],) * 2 for i in range(nd)),
            lhs_dilation=s,
            dimension_numbers=_CONVT_DN[nd],
        )
        if self.use_bias:
            y = y + params["b"].reshape((1, -1) + (1,) * nd)
        return y


@dataclasses.dataclass(frozen=True)
class ConvTranspose1d(_ConvTransposeNd):
    _nd = 1


@dataclasses.dataclass(frozen=True)
class ConvTranspose3d(_ConvTransposeNd):
    _nd = 3


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _PoolNd:
    kernel_size: Union[int, Tuple[int, ...]]
    stride: Union[int, Tuple[int, ...], None] = None
    padding: Union[int, Tuple[int, ...]] = 0

    _nd = 3
    _max = True

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        nd = self._nd
        k = _tup(self.kernel_size, nd)
        s = _tup(self.stride, nd) if self.stride is not None else k
        pad = _tup(self.padding, nd)
        pads = ((0, 0), (0, 0)) + tuple((p, p) for p in pad)
        if self._max:
            return jax.lax.reduce_window(
                x, -jnp.inf, jax.lax.max,
                window_dimensions=(1, 1) + k,
                window_strides=(1, 1) + s, padding=pads)
        summed = jax.lax.reduce_window(
            x, 0.0, jax.lax.add,
            window_dimensions=(1, 1) + k,
            window_strides=(1, 1) + s, padding=pads)
        return summed / float(jnp.prod(jnp.asarray(k)))


@dataclasses.dataclass(frozen=True)
class MaxPool1d(_PoolNd):
    _nd = 1
    _max = True


@dataclasses.dataclass(frozen=True)
class MaxPool3d(_PoolNd):
    _nd = 3
    _max = True


@dataclasses.dataclass(frozen=True)
class AvgPool1d(_PoolNd):
    _nd = 1
    _max = False


@dataclasses.dataclass(frozen=True)
class AvgPool3d(_PoolNd):
    _nd = 3
    _max = False


def _adaptive_pool(x, out_sizes: Tuple[int, ...], reduce_fn):
    """Exact torch adaptive window rule over the trailing len(out_sizes)
    spatial dims."""
    nd = len(out_sizes)
    for d in range(nd):
        axis = x.ndim - nd + d
        n_in = x.shape[axis]
        n_out = out_sizes[d]
        slices = []
        for i in range(n_out):
            lo = (i * n_in) // n_out
            hi = -(-((i + 1) * n_in) // n_out)
            win = jax.lax.slice_in_dim(x, lo, hi, axis=axis)
            slices.append(reduce_fn(win, axis=axis, keepdims=True))
        x = jnp.concatenate(slices, axis=axis)
    return x


@dataclasses.dataclass(frozen=True)
class _AdaptivePoolNd:
    output_size: Union[int, Tuple[int, ...]] = 1

    _nd = 3
    _max = True

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        out = _tup(self.output_size, self._nd)
        fn = jnp.max if self._max else jnp.mean
        return _adaptive_pool(x, out, fn)


@dataclasses.dataclass(frozen=True)
class AdaptiveMaxPool1d(_AdaptivePoolNd):
    _nd = 1
    _max = True


@dataclasses.dataclass(frozen=True)
class AdaptiveMaxPool2d(_AdaptivePoolNd):
    _nd = 2
    _max = True


@dataclasses.dataclass(frozen=True)
class AdaptiveMaxPool3d(_AdaptivePoolNd):
    _nd = 3
    _max = True


@dataclasses.dataclass(frozen=True)
class AdaptiveAvgPool1d(_AdaptivePoolNd):
    _nd = 1
    _max = False


@dataclasses.dataclass(frozen=True)
class AdaptiveAvgPool3d(_AdaptivePoolNd):
    _nd = 3
    _max = False


# ---------------------------------------------------------------------------
# Parametric / shrink activations (nn/modules/activation.py long tail)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PReLU:
    """Learnable leaky ReLU: y = max(0,x) + a * min(0,x); ``a`` is a
    scalar or per-channel (axis 1) parameter."""

    num_parameters: int = 1
    init_value: float = 0.25

    def init(self, key) -> dict:
        return {"a": jnp.full((self.num_parameters,), self.init_value,
                              jnp.float32)}

    def apply(self, params, x, *, train=False, rng=None):
        a = params["a"]
        if a.shape[0] > 1:
            a = a.reshape((1, -1) + (1,) * (x.ndim - 2))
        return jnp.maximum(x, 0) + a * jnp.minimum(x, 0)


@dataclasses.dataclass(frozen=True)
class GLU:
    axis: int = -1

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        from of_spmm.nn.extras import glu

        return glu(x, axis=self.axis)


def hardshrink(x, lambd: float = 0.5):
    return jnp.where(jnp.abs(x) > lambd, x, 0.0)


def softshrink(x, lambd: float = 0.5):
    return jnp.where(x > lambd, x - lambd,
                     jnp.where(x < -lambd, x + lambd, 0.0))


def tanhshrink(x):
    return x - jnp.tanh(x)


def softsign(x):
    return x / (1.0 + jnp.abs(x))


def logsigmoid(x):
    return jax.nn.log_sigmoid(x)


def threshold(x, threshold_val: float, value: float):
    return jnp.where(x > threshold_val, x, value)


def elu(x, alpha: float = 1.0):
    return jax.nn.elu(x, alpha)


def leaky_relu(x, negative_slope: float = 0.01):
    return jax.nn.leaky_relu(x, negative_slope)
