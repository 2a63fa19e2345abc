"""Tensor (model) parallelism: Megatron-style sharded Linear pairs.

The reference realizes TP as SBP placements on weights — S(1)/S(0) splits
whose matmuls produce Split or PartialSum outputs, with the lazy pass
`InsertNcclLogicalOpPass` turning SBP edges into all-reduce/all-gather
collectives (oneflow/core/job_rewriter/insert_nccl_logical_op_pass.cpp:162-385;
SBP matmul algebra documented at oneflow/core/job/sbp_parallel.proto:4-45).

JAX expression: a `shard_map` region over a mesh `tp` axis with the
canonical column-parallel -> row-parallel pair:

- **ColumnParallelLinear**: W split S(1) (output features). Local matmul
  yields activations S(1); no collective. The reference analog is
  weight sbp=S(1) => out sbp=S(1).
- **RowParallelLinear**: W split S(0) (input features), consuming the
  S(1) activations of the previous layer. Local matmul yields a
  PartialSum output; one `psum` over the tp axis resolves P->B — exactly
  the ccl-p-to-b boxing route (eager_boxing_interpreter_mgr.cpp).

The pair costs ONE all-reduce per MLP block (the Megatron recipe). Both
layers are plain functions of (params, x) so they compose with jax.grad;
the backward collectives (psum <-> identity transposition) are inserted
by JAX's shard_map autodiff, standing in for the reference's
backward-SBP inference.

2-D hybrid DP x TP == nd-sbp [S(0), B] on activations and [B, S(k)] on
weights (sbp_parallel.proto:74-79): build a 2-D mesh and keep the same
functions — `psum` names only the `tp` axis, and GSPMD/ shard_map handle
the dp axis as pure data parallelism.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_tp_mlp(key, d_model: int, d_hidden: int, dtype=jnp.float32):
    """Params for one column->row parallel MLP block (full, unsharded)."""
    k1, k2 = jax.random.split(key)
    s1 = 1.0 / np.sqrt(d_model)
    s2 = 1.0 / np.sqrt(d_hidden)
    return {
        "w_in": jax.random.uniform(k1, (d_model, d_hidden), dtype, -s1, s1),
        "b_in": jnp.zeros((d_hidden,), dtype),
        "w_out": jax.random.uniform(k2, (d_hidden, d_model), dtype, -s2, s2),
        "b_out": jnp.zeros((d_model,), dtype),
    }


def shard_tp_mlp(params, mesh: Mesh, tp_axis: str = "tp"):
    """Place MLP params with their TP shardings: w_in S(1), w_out S(0).

    Biases: b_in S(0) (follows the split hidden dim), b_out replicated
    (added AFTER the psum, once).
    """
    idx = mesh.axis_names.index(tp_axis)
    n = mesh.devices.shape[idx]
    for name, dim in (("w_in", 1), ("b_in", 0), ("w_out", 0)):
        if params[name].shape[dim] % n:
            raise ValueError(
                f"{name} dim {dim} ({params[name].shape[dim]}) not divisible "
                f"by tp={n}; pad d_hidden to a multiple of the tp axis"
            )
    specs = {
        "w_in": P(None, tp_axis),
        "b_in": P(tp_axis),
        "w_out": P(tp_axis, None),
        "b_out": P(),
    }
    return {
        k: jax.device_put(v, NamedSharding(mesh, specs[k]))
        for k, v in params.items()
    }


def column_parallel_linear(w_local, b_local, x, activation=jax.nn.gelu):
    """S(1)-sharded Linear inside a shard_map region: out is S(1), no
    collective (reference: weight S(1) => out S(1))."""
    y = x @ w_local + b_local
    return activation(y) if activation is not None else y


def row_parallel_linear(w_local, x_local, tp_axis: str):
    """S(0)-sharded Linear consuming S(1) activations: local matmul is a
    PartialSum; psum resolves P->B (ccl-p-to-b)."""
    return jax.lax.psum(x_local @ w_local, tp_axis)


def tp_mlp_block(params, x, tp_axis: str = "tp", activation=jax.nn.gelu):
    """Column->row parallel MLP body (call inside shard_map).

    x: replicated along tp (B); returns replicated output. One psum total.
    """
    h = column_parallel_linear(params["w_in"], params["b_in"], x, activation)
    y = row_parallel_linear(params["w_out"], h, tp_axis)
    return y + params["b_out"]


def make_tp_mlp(mesh: Mesh, tp_axis: str = "tp", activation=jax.nn.gelu,
                dp_axis: Optional[str] = None):
    """Jitted global-view MLP: takes sharded params + batch, runs the
    shard_map TP region. With ``dp_axis`` the same function is hybrid
    DP x TP (nd-sbp [S(0), B] activations)."""
    batch_spec = P(dp_axis) if dp_axis else P()
    param_specs = {
        "w_in": P(None, tp_axis),
        "b_in": P(tp_axis),
        "w_out": P(tp_axis, None),
        "b_out": P(),
    }

    @jax.jit
    def fwd(params, x):
        body = functools.partial(tp_mlp_block, tp_axis=tp_axis,
                                 activation=activation)
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(param_specs, batch_spec),
            out_specs=batch_spec,
            check_vma=False,
        )(params, x)

    return fwd
