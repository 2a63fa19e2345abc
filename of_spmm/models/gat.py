"""GAT — attention-weighted aggregation model (third model family).

Stacks nn.GATConv layers: per-edge attention computed in the traced
forward via the gather/segment_softmax path, aggregated with the
runtime-valued spmm_coo. Exercises the edge-weight-differentiable path
(the reference differentiates the same composition through its
gather <-> unsorted_segment_sum autograd pairing,
oneflow/core/autograd/gradient_funcs/gather.cpp:62-73).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from of_spmm.nn.gnn import GATConv
from of_spmm.ops.autograd import SpmmOperator


@dataclasses.dataclass(frozen=True)
class GAT:
    """L-layer GAT: hidden layers concat heads + ELU, output layer means."""

    feature_dims: Tuple[int, ...]  # (in, hidden..., out)
    heads: int = 4

    def _convs(self):
        dims = self.feature_dims
        convs = []
        for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(dims) - 2
            in_f = fi if i == 0 else dims[i] * self.heads
            convs.append(
                GATConv(
                    in_features=in_f,
                    out_features=fo,
                    heads=self.heads,
                    concat_heads=not last,
                )
            )
        return convs

    def init(self, key) -> dict:
        convs = self._convs()
        keys = jax.random.split(key, len(convs))
        return {f"layer_{i}": c.init(k) for i, (c, k) in enumerate(zip(convs, keys))}

    def apply(self, params, op: SpmmOperator, x, *, train=False, rng=None):
        convs = self._convs()
        h = x
        for i, conv in enumerate(convs):
            h = conv.apply(params[f"layer_{i}"], op, h)
            if i < len(convs) - 1:
                h = jax.nn.elu(h)
        return h

    def loss_fn(self, params, op, x, labels, mask=None):
        logits = self.apply(params, op, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
        if mask is not None:
            m = mask.astype(nll.dtype)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)
        return jnp.mean(nll)
