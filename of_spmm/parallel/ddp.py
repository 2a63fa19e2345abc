"""Data-parallel training API (reference: python/oneflow/nn/parallel/ddp.py).

The reference's DistributedDataParallel broadcasts parameters at wrap time
and registers reversed-order bucketed allreduce hooks on gradients
(ddp.py:39-121). Under XLA, gradient allreduce is not a hook but part of
the compiled program: batch sharded S(0), params replicated, grads psummed
— and XLA overlaps the collectives with backward compute the same way the
reference's bucketing does, without manual buckets. This module provides
the DDP-shaped surface over that:

- ``broadcast_params``: rank-0 values replicated everywhere (the wrap-time
  broadcast).
- ``allreduce_gradients``: tree-psum/pmean for explicit shard_map bodies.
- ``ddp_train_step``: (loss_fn, optimizer) -> jitted data-parallel step
  with batch S(0) in/replicated params out.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from of_spmm.optim.optimizers import Optimizer


def broadcast_params(params: Any, mesh: Mesh) -> Any:
    """Replicate a parameter pytree across the mesh (wrap-time broadcast,
    ddp.py:39-56). With multi-process meshes, jax.device_put with a fully
    replicated sharding performs the actual broadcast from the source."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), params)


def allreduce_gradients(grads: Any, axis: str, mean: bool = True) -> Any:
    """Tree-wide gradient allreduce for explicit shard_map bodies (the
    reference's bucketed local_all_reduce hooks, collapsed into one
    fused-by-XLA collective per leaf)."""
    op = jax.lax.pmean if mean else jax.lax.psum
    return jax.tree_util.tree_map(lambda g: op(g, axis), grads)


def ddp_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    mesh: Mesh,
    axis: str = "x",
    donate: bool = True,
) -> Callable:
    """Build a jitted data-parallel step: (params, opt_state, batch...) ->
    (loss, params, opt_state).

    ``loss_fn(params, *batch) -> scalar`` is written for the GLOBAL batch;
    batch arrays get S(0) shardings over ``axis``, params/state replicated.
    The mean loss over the sharded batch makes gradients arrive as
    partial-sums that GSPMD resolves with one allreduce — semantically the
    reference's DDP allreduce hooks.
    """
    rep = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(axis))

    @functools.partial(
        jax.jit,
        in_shardings=None,  # params/state keep their shardings
        donate_argnums=(0, 1) if donate else (),
    )
    def step(params, opt_state, *batch):
        batch = tuple(
            jax.lax.with_sharding_constraint(b, batch_sh) for b in batch
        )
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.with_sharding_constraint(g, rep), grads
        )
        params, opt_state = optimizer.update(grads, opt_state, params)
        return loss, params, opt_state

    return step
