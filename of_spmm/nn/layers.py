"""Dense layer library — the nn.Module surface re-expressed functionally.

Covers the reference's core module families (python/oneflow/nn/modules/:
linear.py, normalization.py, batchnorm.py, dropout.py, activation.py,
sparse.py) as dataclass-config modules per nn/module.py's protocol. Compute
is plain XLA: Linear is a single jnp.dot (batched shapes
welcome), norms are fused elementwise chains XLA handles well.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.ops.autograd import gather


def _kaiming_uniform(key, fan_in: int, shape, dtype=jnp.float32):
    bound = float(np.sqrt(1.0 / max(fan_in, 1)))
    return jax.random.uniform(key, shape, dtype, -bound, bound)


@dataclasses.dataclass(frozen=True)
class Linear:
    """y = x @ W + b (torch/oneflow Linear semantics, W stored (in, out))."""

    in_features: int
    out_features: int
    use_bias: bool = True
    dtype: jnp.dtype = jnp.float32

    def init(self, key) -> dict:
        kw, kb = jax.random.split(key)
        p = {"w": _kaiming_uniform(kw, self.in_features,
                                   (self.in_features, self.out_features), self.dtype)}
        if self.use_bias:
            p["b"] = _kaiming_uniform(kb, self.in_features,
                                      (self.out_features,), self.dtype)
        return p

    def apply(self, params, x, *, train=False, rng=None):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Inverted dropout; identity in eval mode (reference nn.Dropout)."""

    rate: float = 0.5

    def init(self, key) -> dict:
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        if not train or self.rate <= 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout(train=True) requires rng")
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(rng, keep, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros((), x.dtype))


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    """Normalize over the last ``len(normalized_shape)`` axes + affine."""

    normalized_shape: Tuple[int, ...]
    eps: float = 1e-5
    elementwise_affine: bool = True

    def __post_init__(self):
        if isinstance(self.normalized_shape, int):
            object.__setattr__(self, "normalized_shape", (self.normalized_shape,))

    def init(self, key) -> dict:
        if not self.elementwise_affine:
            return {}
        return {
            "gamma": jnp.ones(self.normalized_shape, jnp.float32),
            "beta": jnp.zeros(self.normalized_shape, jnp.float32),
        }

    def apply(self, params, x, *, train=False, rng=None):
        axes = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        mean = jnp.mean(x, axis=axes, keepdims=True)
        var = jnp.var(x, axis=axes, keepdims=True)
        y = (x - mean) * jax.lax.rsqrt(var + self.eps)
        if self.elementwise_affine:
            y = y * params["gamma"] + params["beta"]
        return y


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """BatchNorm1d/2d over axis -1 features with running stats.

    Stateful: apply(..., state=..., train=True) -> (y, new_state).
    Running stats follow the reference's momentum convention
    (running = (1-m)*running + m*batch).
    """

    num_features: int
    eps: float = 1e-5
    momentum: float = 0.1
    affine: bool = True

    def init(self, key) -> dict:
        if not self.affine:
            return {}
        return {
            "gamma": jnp.ones((self.num_features,), jnp.float32),
            "beta": jnp.zeros((self.num_features,), jnp.float32),
        }

    def init_state(self) -> dict:
        return {
            "mean": jnp.zeros((self.num_features,), jnp.float32),
            "var": jnp.ones((self.num_features,), jnp.float32),
        }

    def apply(self, params, x, *, state=None, train=False, rng=None):
        if state is None:
            state = self.init_state()
        axes = tuple(range(x.ndim - 1))
        if train:
            mean = jnp.mean(x, axis=axes)
            var = jnp.var(x, axis=axes)
            m = self.momentum
            n = max(int(np.prod([x.shape[a] for a in axes])), 1)
            unbiased = var * (n / max(n - 1, 1))
            new_state = {
                "mean": (1 - m) * state["mean"] + m * mean,
                "var": (1 - m) * state["var"] + m * unbiased,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * jax.lax.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["gamma"] + params["beta"]
        if train:
            return y, new_state
        return y


@dataclasses.dataclass(frozen=True)
class Embedding:
    """Gather-backed lookup (reference nn/modules/sparse.py:171-182: forward
    IS gather(weight, indices); backward is the segment-sum pairing)."""

    num_embeddings: int
    embedding_dim: int
    padding_idx: Optional[int] = None

    def init(self, key) -> dict:
        w = jax.random.normal(
            key, (self.num_embeddings, self.embedding_dim), jnp.float32
        )
        if self.padding_idx is not None:
            w = w.at[self.padding_idx].set(0.0)
        return {"weight": w}

    def apply(self, params, indices, *, train=False, rng=None):
        flat = indices.reshape(-1)
        out = gather(params["weight"], flat)
        return out.reshape(*indices.shape, self.embedding_dim)


# Activation aliases (bare callables are accepted by Sequential).
relu = jax.nn.relu
gelu = jax.nn.gelu
silu = jax.nn.silu
sigmoid = jax.nn.sigmoid
tanh = jnp.tanh
softmax = jax.nn.softmax
log_softmax = jax.nn.log_softmax
leaky_relu = jax.nn.leaky_relu
elu = jax.nn.elu


@dataclasses.dataclass(frozen=True)
class GroupNorm:
    """GroupNorm over (N, C, *spatial) inputs (torch conventions;
    reference: python/oneflow/nn/modules/normalization.py GroupNorm)."""

    num_groups: int
    num_channels: int
    eps: float = 1e-5
    affine: bool = True

    def __post_init__(self):
        if self.num_channels % self.num_groups:
            raise ValueError("num_channels must divide num_groups")

    def init(self, key) -> dict:
        if not self.affine:
            return {}
        return {
            "gamma": jnp.ones((self.num_channels,), jnp.float32),
            "beta": jnp.zeros((self.num_channels,), jnp.float32),
        }

    def apply(self, params, x, *, train=False, rng=None):
        n, c = x.shape[0], x.shape[1]
        spatial = x.shape[2:]
        g = self.num_groups
        xg = x.reshape(n, g, c // g, *spatial)
        axes = tuple(range(2, xg.ndim))
        mean = jnp.mean(xg, axis=axes, keepdims=True)
        var = jnp.var(xg, axis=axes, keepdims=True)
        y = ((xg - mean) * jax.lax.rsqrt(var + self.eps)).reshape(x.shape)
        if self.affine:
            shape = (1, c) + (1,) * len(spatial)
            y = y * params["gamma"].reshape(shape) + params["beta"].reshape(shape)
        return y


@dataclasses.dataclass(frozen=True)
class InstanceNorm2d:
    """Per-(sample, channel) spatial normalization over NCHW inputs."""

    num_features: int
    eps: float = 1e-5
    affine: bool = False

    def init(self, key) -> dict:
        if not self.affine:
            return {}
        return {
            "gamma": jnp.ones((self.num_features,), jnp.float32),
            "beta": jnp.zeros((self.num_features,), jnp.float32),
        }

    def apply(self, params, x, *, train=False, rng=None):
        mean = jnp.mean(x, axis=(2, 3), keepdims=True)
        var = jnp.var(x, axis=(2, 3), keepdims=True)
        y = (x - mean) * jax.lax.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["gamma"][None, :, None, None]
            y = y + params["beta"][None, :, None, None]
        return y
