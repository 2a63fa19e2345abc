"""Convolution + pooling modules (reference: nn/modules/conv.py, pooling.py).

Torch/oneflow layout conventions (NCHW, weight OIHW) so state dicts and
oracle tests line up; compute lowers to lax.conv_general_dilated, which
XLA hands to cuDNN on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.nn.layers import _kaiming_uniform


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@dataclasses.dataclass(frozen=True)
class Conv2d:
    """2-D convolution, NCHW / OIHW, stride/padding/dilation/groups."""

    in_channels: int
    out_channels: int
    kernel_size: Union[int, Tuple[int, int]]
    stride: Union[int, Tuple[int, int]] = 1
    padding: Union[int, Tuple[int, int]] = 0
    dilation: Union[int, Tuple[int, int]] = 1
    groups: int = 1
    use_bias: bool = True

    def init(self, key) -> dict:
        kh, kw = _pair(self.kernel_size)
        fan_in = self.in_channels // self.groups * kh * kw
        kw_, kb = jax.random.split(key)
        p = {
            "w": _kaiming_uniform(
                kw_, fan_in,
                (self.out_channels, self.in_channels // self.groups, kh, kw),
            )
        }
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, fan_in, (self.out_channels,))
        return p

    def apply(self, params, x, *, train=False, rng=None):
        ph, pw = _pair(self.padding)
        y = jax.lax.conv_general_dilated(
            x, params["w"],
            window_strides=_pair(self.stride),
            padding=((ph, ph), (pw, pw)),
            rhs_dilation=_pair(self.dilation),
            feature_group_count=self.groups,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )
        if self.use_bias:
            y = y + params["b"][None, :, None, None]
        return y


@dataclasses.dataclass(frozen=True)
class Conv1d:
    """1-D convolution, NCL / OIL."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    groups: int = 1
    use_bias: bool = True

    def init(self, key) -> dict:
        fan_in = self.in_channels // self.groups * self.kernel_size
        kw_, kb = jax.random.split(key)
        p = {
            "w": _kaiming_uniform(
                kw_, fan_in,
                (self.out_channels, self.in_channels // self.groups,
                 self.kernel_size),
            )
        }
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, fan_in, (self.out_channels,))
        return p

    def apply(self, params, x, *, train=False, rng=None):
        y = jax.lax.conv_general_dilated(
            x, params["w"],
            window_strides=(self.stride,),
            padding=((self.padding, self.padding),),
            rhs_dilation=(self.dilation,),
            feature_group_count=self.groups,
            dimension_numbers=("NCH", "OIH", "NCH"),
        )
        if self.use_bias:
            y = y + params["b"][None, :, None]
        return y


@dataclasses.dataclass(frozen=True)
class MaxPool2d:
    kernel_size: Union[int, Tuple[int, int]]
    stride: Union[int, Tuple[int, int], None] = None
    padding: Union[int, Tuple[int, int]] = 0

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        k = _pair(self.kernel_size)
        s = _pair(self.stride) if self.stride is not None else k
        ph, pw = _pair(self.padding)
        return jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max,
            window_dimensions=(1, 1) + k,
            window_strides=(1, 1) + s,
            padding=((0, 0), (0, 0), (ph, ph), (pw, pw)),
        )


@dataclasses.dataclass(frozen=True)
class AvgPool2d:
    kernel_size: Union[int, Tuple[int, int]]
    stride: Union[int, Tuple[int, int], None] = None
    padding: Union[int, Tuple[int, int]] = 0

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        k = _pair(self.kernel_size)
        s = _pair(self.stride) if self.stride is not None else k
        ph, pw = _pair(self.padding)
        summed = jax.lax.reduce_window(
            x, 0.0, jax.lax.add,
            window_dimensions=(1, 1) + k,
            window_strides=(1, 1) + s,
            padding=((0, 0), (0, 0), (ph, ph), (pw, pw)),
        )
        return summed / (k[0] * k[1])


@dataclasses.dataclass(frozen=True)
class AdaptiveAvgPool2d:
    """Adaptive average pooling for output sizes that divide the input
    (torch semantics match exactly in that case — the common one: the
    ResNet (1,1) head and AlexNet's (6,6))."""

    output_size: Union[int, Tuple[int, int]] = 1

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        oh, ow = _pair(self.output_size)
        if (oh, ow) == (1, 1):
            return jnp.mean(x, axis=(2, 3), keepdims=True)
        h, w = x.shape[2], x.shape[3]
        if (h, w) == (oh, ow):
            return x
        if h % oh or w % ow:
            raise NotImplementedError(
                f"adaptive pooling needs output {oh}x{ow} to divide input "
                f"{h}x{w}")
        kh, kw = h // oh, w // ow
        return AvgPool2d((kh, kw), stride=(kh, kw)).apply({}, x)


@dataclasses.dataclass(frozen=True)
class ConvTranspose2d:
    """2-D transposed convolution, NCHW / IOHW (torch conventions).

    Implemented as the gradient of Conv2d (lax.conv_transpose with the
    torch output-size convention: out = (in-1)*stride - 2*pad + k)."""

    in_channels: int
    out_channels: int
    kernel_size: Union[int, Tuple[int, int]]
    stride: Union[int, Tuple[int, int]] = 1
    padding: Union[int, Tuple[int, int]] = 0
    use_bias: bool = True

    def init(self, key) -> dict:
        kh, kw = _pair(self.kernel_size)
        fan_in = self.in_channels * kh * kw
        kw_, kb = jax.random.split(key)
        p = {
            "w": _kaiming_uniform(
                kw_, fan_in, (self.in_channels, self.out_channels, kh, kw)
            )
        }
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, fan_in, (self.out_channels,))
        return p

    def apply(self, params, x, *, train=False, rng=None):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        # torch semantics: input dilated by stride, VALID conv with the
        # spatially-flipped kernel, then crop `padding` from each edge.
        y = jax.lax.conv_general_dilated(
            x, jnp.flip(params["w"], axis=(2, 3)),
            window_strides=(1, 1),
            padding=((kh - 1 - ph, kh - 1 - ph), (kw - 1 - pw, kw - 1 - pw)),
            lhs_dilation=(sh, sw),
            dimension_numbers=("NCHW", "IOHW", "NCHW"),
        )
        if self.use_bias:
            y = y + params["b"][None, :, None, None]
        return y
