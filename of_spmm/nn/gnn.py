"""GNN convolution layers over the framework's sparse ops.

The layer zoo the reference's gather/segment_sum machinery exists to serve
(its Embedding + segment-sum pairing IS one-layer mean aggregation). Three
aggregation shapes:

- GCNConv / SAGEConv: plan-valued aggregation — ``spmm`` over a
  precomputed SpmmOperator (values fixed at plan time);
- GATConv: runtime-valued aggregation — attention scores computed per
  forward via the sddmm/gather path, normalized with segment_softmax, and
  aggregated with ``spmm_coo`` (values are traced, both vals and features
  differentiable). This is the edge-weight-training path the reference
  differentiates through its gather <-> segment_sum autograd pairing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from of_spmm.nn.layers import _kaiming_uniform
from of_spmm.ops.autograd import (
    SpmmOperator,
    gather,
    segment_softmax,
    spmm,
    spmm_coo,
)


def _glorot(key, shape, dtype=jnp.float32):
    import numpy as np

    fan_in, fan_out = shape[0], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


@dataclasses.dataclass(frozen=True)
class GCNConv:
    """h' = A_hat @ h @ W + b — one GCN layer (aggregate then transform)."""

    in_features: int
    out_features: int
    use_bias: bool = True

    def init(self, key) -> dict:
        p = {"w": _glorot(key, (self.in_features, self.out_features))}
        if self.use_bias:
            p["b"] = jnp.zeros((self.out_features,), jnp.float32)
        return p

    def apply(self, params, op: SpmmOperator, h, *, impl: str = "auto",
              train=False, rng=None):
        y = spmm(op, h, impl=impl) @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class SAGEConv:
    """h' = h @ W_self + mean_agg(h) @ W_neigh + b (GraphSAGE mean)."""

    in_features: int
    out_features: int
    use_bias: bool = True

    def init(self, key) -> dict:
        k1, k2 = jax.random.split(key)
        p = {
            "w_self": _glorot(k1, (self.in_features, self.out_features)),
            "w_neigh": _glorot(k2, (self.in_features, self.out_features)),
        }
        if self.use_bias:
            p["b"] = jnp.zeros((self.out_features,), jnp.float32)
        return p

    def apply(self, params, op: SpmmOperator, h, *, impl: str = "auto",
              train=False, rng=None):
        y = h @ params["w_self"] + spmm(op, h, impl=impl) @ params["w_neigh"]
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class GATConv:
    """Graph attention (GAT, Velickovic et al.) over the COO pattern.

    score[e] = LeakyReLU(a_src . (W h)[src[e]] + a_dst . (W h)[dst[e]])
    alpha    = segment_softmax(score, dst)
    h'[i]    = sum_e alpha[e] (W h)[src[e]]       (+ multi-head concat/mean)

    Attention values are computed inside the traced forward, so gradients
    flow through both the attention weights and the features — the
    runtime-valued counterpart of the plan-valued spmm.
    """

    in_features: int
    out_features: int
    heads: int = 1
    concat_heads: bool = True
    negative_slope: float = 0.2
    use_bias: bool = True

    def init(self, key) -> dict:
        kw, ks, kd, kb = jax.random.split(key, 4)
        H, F = self.heads, self.out_features
        p = {
            "w": _glorot(kw, (self.in_features, H * F)),
            "a_src": _glorot(ks, (H, F)),
            "a_dst": _glorot(kd, (H, F)),
        }
        if self.use_bias:
            out = H * F if self.concat_heads else F
            p["b"] = jnp.zeros((out,), jnp.float32)
        return p

    def apply(self, params, op: SpmmOperator, h, *, impl: str = "auto",
              train=False, rng=None):
        H, F = self.heads, self.out_features
        n = op.shape[0]
        rows, cols = op.coo_rows, op.coo_cols  # dst, src (row = aggregation target)
        hw = (h @ params["w"]).reshape(-1, H, F)  # (n, H, F)
        # per-node attention halves: s[i,h] = a_src[h].hw[i,h]
        s_src = jnp.einsum("nhf,hf->nh", hw, params["a_src"])
        s_dst = jnp.einsum("nhf,hf->nh", hw, params["a_dst"])
        score = gather(s_src, cols) + gather(s_dst, rows)  # (nnz, H)
        score = jax.nn.leaky_relu(score, self.negative_slope)
        alpha = segment_softmax(score, rows, n)  # (nnz, H)
        # aggregate per head with runtime-valued spmm
        outs = []
        for head in range(H):
            outs.append(spmm_coo(rows, cols, alpha[:, head], hw[:, head, :], n))
        y = jnp.stack(outs, axis=1)  # (n, H, F)
        y = y.reshape(n, H * F) if self.concat_heads else jnp.mean(y, axis=1)
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class GINConv:
    """Graph isomorphism network: h' = MLP((1+eps) h + sum_agg(h)).

    The aggregation operator should be the UNNORMALIZED adjacency
    (sum aggregation); eps is learnable.
    """

    in_features: int
    hidden_features: int
    out_features: int

    def init(self, key) -> dict:
        k1, k2 = jax.random.split(key)
        return {
            "eps": jnp.zeros((), jnp.float32),
            "w1": _glorot(k1, (self.in_features, self.hidden_features)),
            "b1": jnp.zeros((self.hidden_features,), jnp.float32),
            "w2": _glorot(k2, (self.hidden_features, self.out_features)),
            "b2": jnp.zeros((self.out_features,), jnp.float32),
        }

    def apply(self, params, op: SpmmOperator, h, *, impl: str = "auto",
              train=False, rng=None):
        z = (1.0 + params["eps"]) * h + spmm(op, h, impl=impl)
        z = jax.nn.relu(z @ params["w1"] + params["b1"])
        return z @ params["w2"] + params["b2"]
