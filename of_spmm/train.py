"""Distributed full-batch GCN training step over a row-partitioned graph.

The end-to-end composition: dist_spmm (halo exchange inside shard_map) for
the aggregations, dense matmuls for the transforms, jax.grad through the
whole thing (the reverse halo exchange is derived automatically), and an
SGD/Adam update. Parameters are replicated; the graph, features, and
activations are row-sharded over the mesh axis — the natural data layout
for full-batch GNN training (the reference's analog: module-to_global with
S(0) activations + broadcast weights).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from of_spmm.models.gcn import GCN
from of_spmm.parallel.dist_spmm import dist_spmm
from of_spmm.parallel.partition import RowPartitionPlan, place_plan


def dist_gcn_apply(
    model: GCN,
    params: dict,
    plan: RowPartitionPlan,
    x: jnp.ndarray,
    mesh: Mesh,
    axis: str = "x",
) -> jnp.ndarray:
    """Forward over the partitioned operator (row-sharded activations)."""
    n_layers = len(model.feature_dims) - 1
    h = x
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        h = dist_spmm(plan, h, mesh, axis=axis) @ p["w"] + p["b"]
        if i < n_layers - 1:
            h = model.activation(h)
    return h


def make_dist_train_step(
    model: GCN,
    plan: RowPartitionPlan,
    mesh: Mesh,
    axis: str = "x",
    lr: float = 1e-2,
) -> Callable:
    """jit-compiled (params, x, labels) -> (loss, params) SGD step.

    Shardings: x/labels row-split over ``axis`` (S(0)); params replicated
    (B); gradients arrive replicated because the loss reduction psums over
    the mesh — the same algebra as the reference's DP: B weights, S(0)
    activations, PartialSum grads resolved by allreduce
    (python/oneflow/nn/parallel/ddp.py:39-121 is the eager analog).
    """

    n_padded = plan.n_shards * plan.cols_per_shard
    # the plan is an ARGUMENT of the jitted step, placed on the mesh once:
    # closing over it would bake its arrays into the program as literals
    placed = place_plan(plan, mesh, axis)

    def loss_fn(params, plan, x, labels):
        # dist_gcn_apply slices its output back to the real row count
        logits = dist_gcn_apply(model, params, plan, x, mesh, axis=axis)
        logp = jax.nn.log_softmax(logits, axis=-1)
        lbl = labels[: logits.shape[0]]
        nll = -jnp.take_along_axis(logp, lbl[:, None], axis=-1)[:, 0]
        return jnp.mean(nll)

    x_sharding = NamedSharding(mesh, P(axis, None))
    lbl_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    @functools.partial(jax.jit, out_shardings=(rep, rep))
    def _step(params, plan, x, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, plan, x, labels)
        params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return loss, params

    def step(params, x, labels):
        pad = n_padded - x.shape[0]
        if pad:
            x = jnp.pad(x, ((0, pad), (0, 0)))
            labels = jnp.pad(labels, (0, pad))
        return _step(jax.device_put(params, rep), placed,
                     jax.device_put(x, x_sharding),
                     jax.device_put(labels, lbl_sharding))

    return step
