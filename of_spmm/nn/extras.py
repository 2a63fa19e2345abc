"""Additional nn modules: upsampling, padding, shuffle, distance, losses.

Fills out the reference's module surface (python/oneflow/nn/modules/:
upsampling.py, interpolate.py, padding.py, pixelshuffle.py, flatten.py,
distance.py, loss.py, activation.py) with functional
implementations: everything lowers to reshapes/transposes/gathers that XLA
fuses — no dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# interpolate / Upsample (reference: nn/modules/interpolate.py, upsampling.py)
# ---------------------------------------------------------------------------

def interpolate(
    x: jnp.ndarray,
    scale_factor: Optional[Union[float, Tuple[float, float]]] = None,
    size: Optional[Tuple[int, int]] = None,
    mode: str = "nearest",
    align_corners: bool = False,
) -> jnp.ndarray:
    """NCHW spatial resize: 'nearest' or 'bilinear'.

    Matches torch.nn.functional.interpolate semantics for these modes
    (nearest = floor index scaling; bilinear with/without align_corners).
    """
    if x.ndim != 4:
        raise ValueError(f"interpolate expects NCHW, got ndim={x.ndim}")
    n, c, h, w = x.shape
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size/scale_factor is required")
        sf = (scale_factor, scale_factor) if isinstance(
            scale_factor, (int, float)) else tuple(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    oh, ow = size
    if mode == "nearest":
        ih = (jnp.arange(oh) * (h / oh)).astype(jnp.int32)
        iw = (jnp.arange(ow) * (w / ow)).astype(jnp.int32)
        return x[:, :, ih][:, :, :, iw]
    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode!r}")

    def src_coords(out_len, in_len):
        if align_corners and out_len > 1:
            return jnp.arange(out_len) * ((in_len - 1) / (out_len - 1))
        s = in_len / out_len
        return jnp.clip((jnp.arange(out_len) + 0.5) * s - 0.5, 0, in_len - 1)

    ys = src_coords(oh, h)
    xs = src_coords(ow, w)
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(x.dtype)
    wx = (xs - x0).astype(x.dtype)
    top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
    bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


@dataclasses.dataclass(frozen=True)
class Upsample:
    scale_factor: Optional[Union[float, Tuple[float, float]]] = None
    size: Optional[Tuple[int, int]] = None
    mode: str = "nearest"
    align_corners: bool = False

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        return interpolate(x, self.scale_factor, self.size, self.mode,
                           self.align_corners)


# ---------------------------------------------------------------------------
# padding (reference: nn/modules/padding.py — ZeroPad2d etc.)
# ---------------------------------------------------------------------------

def _pad4(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return (padding,) * 4
    p = tuple(padding)
    if len(p) != 4:
        raise ValueError("padding must be int or (left, right, top, bottom)")
    return p


@dataclasses.dataclass(frozen=True)
class ZeroPad2d:
    padding: Union[int, Tuple[int, int, int, int]]

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        l, r, t, b = _pad4(self.padding)
        return jnp.pad(x, ((0, 0), (0, 0), (t, b), (l, r)))


@dataclasses.dataclass(frozen=True)
class ReflectionPad2d:
    padding: Union[int, Tuple[int, int, int, int]]

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        l, r, t, b = _pad4(self.padding)
        return jnp.pad(x, ((0, 0), (0, 0), (t, b), (l, r)), mode="reflect")


@dataclasses.dataclass(frozen=True)
class ReplicationPad2d:
    padding: Union[int, Tuple[int, int, int, int]]

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        l, r, t, b = _pad4(self.padding)
        return jnp.pad(x, ((0, 0), (0, 0), (t, b), (l, r)), mode="edge")


# ---------------------------------------------------------------------------
# pixel shuffle (reference: nn/modules/pixelshuffle.py)
# ---------------------------------------------------------------------------

def pixel_shuffle(x: jnp.ndarray, upscale_factor: int) -> jnp.ndarray:
    n, c, h, w = x.shape
    r = upscale_factor
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by {r}^2")
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.transpose(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x: jnp.ndarray, downscale_factor: int) -> jnp.ndarray:
    n, c, h, w = x.shape
    r = downscale_factor
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {r}")
    x = x.reshape(n, c, h // r, r, w // r, r)
    x = x.transpose(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


@dataclasses.dataclass(frozen=True)
class PixelShuffle:
    upscale_factor: int

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        return pixel_shuffle(x, self.upscale_factor)


@dataclasses.dataclass(frozen=True)
class Flatten:
    start_dim: int = 1
    end_dim: int = -1

    def init(self, key):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        nd = x.ndim
        s = self.start_dim % nd
        e = self.end_dim % nd
        shape = x.shape[:s] + (-1,) + x.shape[e + 1:]
        return x.reshape(shape)


# ---------------------------------------------------------------------------
# distance (reference: nn/modules/distance.py)
# ---------------------------------------------------------------------------

def cosine_similarity(a: jnp.ndarray, b: jnp.ndarray, axis: int = 1,
                      eps: float = 1e-8) -> jnp.ndarray:
    dot = jnp.sum(a * b, axis=axis)
    na = jnp.sqrt(jnp.sum(a * a, axis=axis))
    nb = jnp.sqrt(jnp.sum(b * b, axis=axis))
    # torch semantics: clamp each norm by eps before dividing
    return dot / (jnp.maximum(na, eps) * jnp.maximum(nb, eps))


def pairwise_distance(a: jnp.ndarray, b: jnp.ndarray, p: float = 2.0,
                      eps: float = 1e-6) -> jnp.ndarray:
    d = jnp.abs(a - b + eps)
    return jnp.sum(d ** p, axis=-1) ** (1.0 / p)


# ---------------------------------------------------------------------------
# losses (reference: nn/modules/loss.py)
# ---------------------------------------------------------------------------

def _reduce(x, reduction):
    if reduction == "mean":
        return jnp.mean(x)
    if reduction == "sum":
        return jnp.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"bad reduction {reduction!r}")


def kl_div(logp: jnp.ndarray, target: jnp.ndarray,
           reduction: str = "mean", log_target: bool = False) -> jnp.ndarray:
    """KLDivLoss: input is log-probabilities (torch convention)."""
    if log_target:
        loss = jnp.exp(target) * (target - logp)
    else:
        loss = jnp.where(target > 0, target * (jnp.log(
            jnp.maximum(target, 1e-38)) - logp), 0.0)
    return _reduce(loss, reduction)


def margin_ranking_loss(x1: jnp.ndarray, x2: jnp.ndarray, y: jnp.ndarray,
                        margin: float = 0.0,
                        reduction: str = "mean") -> jnp.ndarray:
    return _reduce(jnp.maximum(0.0, -y * (x1 - x2) + margin), reduction)


def hinge_embedding_loss(x: jnp.ndarray, y: jnp.ndarray, margin: float = 1.0,
                         reduction: str = "mean") -> jnp.ndarray:
    loss = jnp.where(y == 1, x, jnp.maximum(0.0, margin - x))
    return _reduce(loss, reduction)


def triplet_margin_loss(anchor: jnp.ndarray, pos: jnp.ndarray,
                        neg: jnp.ndarray, margin: float = 1.0, p: float = 2.0,
                        eps: float = 1e-6,
                        reduction: str = "mean") -> jnp.ndarray:
    dp = pairwise_distance(anchor, pos, p, eps)
    dn = pairwise_distance(anchor, neg, p, eps)
    return _reduce(jnp.maximum(dp - dn + margin, 0.0), reduction)


# ---------------------------------------------------------------------------
# activations (reference: nn/modules/activation.py)
# ---------------------------------------------------------------------------

def hardsigmoid(x):
    return jnp.clip(x / 6.0 + 0.5, 0.0, 1.0)


def hardswish(x):
    return x * hardsigmoid(x)


def hardtanh(x, min_val=-1.0, max_val=1.0):
    return jnp.clip(x, min_val, max_val)


def mish(x):
    return x * jnp.tanh(jax.nn.softplus(x))


def softplus(x, beta=1.0, threshold=20.0):
    return jnp.where(x * beta > threshold, x,
                     jnp.log1p(jnp.exp(beta * x)) / beta)


def glu(x, axis=-1):
    a, b = jnp.split(x, 2, axis=axis)
    return a * jax.nn.sigmoid(b)


def selu(x):
    return jax.nn.selu(x)


def celu(x, alpha=1.0):
    return jax.nn.celu(x, alpha)
