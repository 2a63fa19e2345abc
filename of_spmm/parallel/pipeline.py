"""Pipeline parallelism: GPipe microbatch schedule over a mesh axis.

The reference builds pipelines from per-block stage scopes
(nn/graph/block_config.py:54), grad-accumulation microbatching
(nn/graph/graph_config.py:219, job_conf.proto:240) and a job pass that
inserts stage-crossing buffer ops (job_rewriter/pipeline_buffer_pass.cpp:
80-113); the 1F1B schedule *emerges* from actor regst backpressure rather
than an explicit scheduler. The JAX re-expression: every stage is
one slice of a `stage` mesh axis inside shard_map; a lax.scan advances the
pipeline one tick at a time, moving activations to the next stage with a
single ppermute per tick. Reverse-mode AD transposes the ppermute chain,
so the backward pipeline schedule (cool-down mirror of the warm-up) is
derived by jax.grad — the same way the reference derives it from dataflow,
not from an explicit schedule.

Constraints (classic GPipe-on-SPMD):
- all stages map activations of one shape to the same shape (put
  embed/head projections inside the first/last stage functions);
- ``stage_params`` is a pytree whose leaves are stacked along a leading
  stage axis (use ``stack_stage_params``), sharded S(0) over the stage
  axis so each device holds only its own stage's weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stack_stage_params(per_stage: Sequence[Any]) -> Any:
    """Stack per-stage param pytrees along a new leading stage axis.

    All stages must share one tree structure and leaf shapes (the shape-
    uniform GPipe constraint applied to parameters).
    """
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_stage)


def _local_stage_slice(stacked: Any) -> Any:
    """Inside shard_map the S(0)-sharded stack has local leading dim 1."""
    return jax.tree_util.tree_map(lambda x: x[0], stacked)


def gpipe_spmd(
    stage_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    n_stages: int,
    n_micro: int,
    axis: str = "stage",
    remat: bool = True,
):
    """Build the SPMD pipeline body: (stacked_params_local, x_micro) -> y.

    Returns a function to be called INSIDE shard_map over ``axis``:
    input x_micro is (n_micro, ...) microbatched activations (replicated
    across the stage axis; only stage 0 reads them), output is the
    (n_micro, ...) last-stage results (valid on the last stage; other
    stages return zeros — combine with a psum or a masked loss).
    """
    if remat:
        stage_fn = jax.checkpoint(stage_fn)

    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]

    def body(stacked_local: Any, x_micro: jnp.ndarray) -> jnp.ndarray:
        params = _local_stage_slice(stacked_local)
        sidx = jax.lax.axis_index(axis)
        is_first = sidx == 0
        is_last = sidx == n_stages - 1
        ticks = n_micro + n_stages - 1

        def tick(carry, t):
            cur = carry
            y = stage_fn(params, cur)
            moved = (
                jax.lax.ppermute(y, axis, fwd_perm)
                if n_stages > 1
                else jnp.zeros_like(y)
            )
            # stage 0's next input is microbatch t+1 (clamped; extras are
            # pipeline-drain junk that is never written to the output)
            nxt_idx = jnp.minimum(t + 1, n_micro - 1)
            nxt_in = jax.lax.dynamic_index_in_dim(x_micro, nxt_idx, 0,
                                                  keepdims=False)
            nxt = jnp.where(is_first, nxt_in, moved)
            return nxt, y

        first_in = x_micro[0]
        init = jnp.where(is_first, first_in, jnp.zeros_like(first_in))
        _, ys = jax.lax.scan(tick, init, jnp.arange(ticks))
        # last stage emitted microbatch m at tick m + n_stages - 1
        out = ys[n_stages - 1:]
        return jnp.where(is_last, out, jnp.zeros_like(out))

    return body


def pipeline_apply(
    stage_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    stacked_params: Any,
    x_micro: jnp.ndarray,
    mesh: Mesh,
    axis: str = "stage",
    n_micro: Optional[int] = None,
    remat: bool = True,
) -> jnp.ndarray:
    """Run the pipeline end-to-end; returns (n_micro, ...) outputs.

    ``stacked_params`` leaves are (n_stages, ...) and get S(0)-sharded over
    ``axis``; activations are replicated (microbatch-major). Differentiable:
    jax.grad produces the transposed (backward) pipeline schedule.
    """
    n_stages = mesh.shape[axis]
    if n_micro is None:
        n_micro = x_micro.shape[0]
    body = gpipe_spmd(stage_fn, n_stages, n_micro, axis=axis, remat=remat)

    def spmd(params, x):
        y = body(params, x)
        # replicate the last stage's result to every stage slice so the
        # caller sees one logical array (cheap: one psum over zeros+result)
        return jax.lax.psum(y, axis)

    pspec = jax.tree_util.tree_map(lambda _: P(axis), stacked_params)
    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(pspec, P()),
        out_specs=P(),
        check_vma=False,
    )(stacked_params, x_micro)


# --------------------------------------------------------------------------
# 1F1B schedule
# --------------------------------------------------------------------------
#
# The reference gets 1F1B steady state from actor regst backpressure: each
# stage owns a fixed number of activation registers, so forwards stall once
# the buffers fill and a backward must retire one first
# (oneflow/core/job_rewriter/pipeline_buffer_pass.cpp:80-113). The SPMD
# re-expression below runs every stage in lockstep: each lax.scan cycle
# has one F slot and one B slot per stage (masked when the schedule says
# idle -- SPMD lockstep burns the bubble as masked compute, the same cost
# shape as an idle actor). With one ppermute hop per slot the dataflow-
# minimal schedule is closed-form:
#   fwd microbatch at stage s, cycle c:  f = c - s
#   bwd microbatch at stage s, cycle c:  b = c - (2S - 2 - s)
# so total cycles = M + 2(S - 1) and the per-stage in-flight count is
# f - b <= 2(S - 1 - s) + 1: bounded by the PIPELINE DEPTH, independent of
# the microbatch count. The activation stash is therefore a static
# (2*n_stages, ...) circular buffer -- the reference's regst-budget
# semantics (buffers sized by stage distance, not by n_micro), versus
# GPipe's O(n_micro) stash. (An async runtime can halve this to S - s by
# throttling warm-up; a lockstep SPMD schedule cannot, because the F and B
# hops of one cycle are synchronous -- the price of deriving 1F1B inside
# one jitted scan.)


def _fwd_mb(c, s, S):
    """Microbatch forwarded by stage s at cycle c (-1 = idle F slot)."""
    f = c - s
    return jnp.where(f >= 0, f, -1)


def _bwd_mb(c, s, S):
    """Microbatch backwarded by stage s at cycle c (-1 = idle B slot)."""
    b = c - (2 * S - 2 - s)
    return jnp.where(b >= 0, b, -1)


def train_step_1f1b(
    stage_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    loss_fn: Callable[[jnp.ndarray, Any], jnp.ndarray],
    n_stages: int,
    n_micro: int,
    axis: str = "stage",
):
    """Build a 1F1B pipelined train step to run INSIDE shard_map.

    Returns ``step(stacked_params_local, x_micro, tgt_micro) ->
    (mean_loss, stacked_param_grads_local)``. ``stage_fn(params, x) -> y``
    is the shape-uniform stage body; ``loss_fn(y, tgt) -> scalar`` is
    applied by the last stage to each microbatch (mean-reduced). Parameter
    gradients come out S(0)-stacked exactly like the parameters, ready for
    a per-stage optimizer update.

    Memory: the activation stash is a static (2*n_stages, ...) circular
    buffer — peak stashed activations per stage <= 2(n_stages - s) - 1,
    bounded by pipeline depth regardless of n_micro (assertable from the
    carry structure; see tests/test_pipeline_1f1b.py).
    """
    S, M = n_stages, n_micro
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i + 1, i) for i in range(S - 1)]

    def step(stacked_local: Any, x_micro: jnp.ndarray,
             tgt_micro: jnp.ndarray):
        params = _local_stage_slice(stacked_local)
        s = jax.lax.axis_index(axis)
        is_first = s == 0
        is_last = s == S - 1
        act_shape = x_micro.shape[1:]
        cycles = M + 2 * (S - 1)

        zero_act = jnp.zeros(act_shape, x_micro.dtype)
        carry0 = dict(
            stash=jnp.zeros((2 * S,) + act_shape, x_micro.dtype),
            in_msg=zero_act,          # activation arriving from stage s-1
            grad_msg=zero_act,        # gradient arriving from stage s+1
            gparams=jax.tree_util.tree_map(jnp.zeros_like, params),
            loss=jnp.zeros((), jnp.float32),
        )

        def cycle(carry, c):
            f = _fwd_mb(c, s, S)
            b = _bwd_mb(c, s, S)
            do_f = jnp.logical_and(f >= 0, f < M)
            do_b = jnp.logical_and(b >= 0, b < M)

            # ---- F slot -------------------------------------------------
            x_own = jax.lax.dynamic_index_in_dim(
                x_micro, jnp.clip(f, 0, M - 1), 0, keepdims=False)
            x_in = jnp.where(is_first, x_own, carry["in_msg"])
            y = stage_fn(params, x_in)
            stash = jnp.where(
                do_f,
                jax.lax.dynamic_update_index_in_dim(
                    carry["stash"], x_in, jnp.clip(f, 0, M - 1) % (2 * S),
                    0),
                carry["stash"],
            )

            # ---- B slot -------------------------------------------------
            x_b = jax.lax.dynamic_index_in_dim(
                stash, jnp.clip(b, 0, M - 1) % (2 * S), 0, keepdims=False)

            def fwd_loss(p, x, tgt):
                out = stage_fn(p, x)
                # last stage folds the loss; others pass activations on
                lval = loss_fn(out, tgt)
                return jnp.where(is_last, lval, 0.0), out

            tgt_b = jax.tree_util.tree_map(
                lambda t: jax.lax.dynamic_index_in_dim(
                    t, jnp.clip(b, 0, M - 1), 0, keepdims=False),
                tgt_micro,
            )
            (lval, y_b), vjp = jax.vjp(
                lambda p, x: fwd_loss(p, x, tgt_b), params, x_b)
            # seed: last stage seeds d(loss)=1/M; others seed the gradient
            # message that arrived from stage s+1
            seed_l = jnp.where(is_last, jnp.float32(1.0 / M), 0.0)
            seed_y = jnp.where(is_last, jnp.zeros_like(y_b),
                               carry["grad_msg"].astype(y_b.dtype))
            dparams, dx = vjp((seed_l, seed_y))
            mask = do_b.astype(jnp.float32)
            gparams = jax.tree_util.tree_map(
                lambda acc, g: acc + mask * g, carry["gparams"], dparams)
            loss = carry["loss"] + mask * jnp.where(is_last, lval, 0.0) / M

            # ---- communication -----------------------------------------
            y_send = jnp.where(do_f, y, jnp.zeros_like(y))
            dx_send = jnp.where(do_b, dx, jnp.zeros_like(dx))
            in_msg = (jax.lax.ppermute(y_send, axis, fwd_perm)
                      if S > 1 else jnp.zeros_like(y))
            grad_msg = (jax.lax.ppermute(dx_send, axis, bwd_perm)
                        if S > 1 else jnp.zeros_like(dx))

            return dict(stash=stash, in_msg=in_msg, grad_msg=grad_msg,
                        gparams=gparams, loss=loss), None

        carry, _ = jax.lax.scan(cycle, carry0, jnp.arange(cycles))
        # every stage holds its own param grads; loss lives on last stage
        loss = jax.lax.psum(carry["loss"], axis)
        gstacked = jax.tree_util.tree_map(
            lambda g: g[None], carry["gparams"])
        return loss, gstacked

    return step


def pipeline_train_step_1f1b(
    stage_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    loss_fn: Callable[[jnp.ndarray, Any], jnp.ndarray],
    stacked_params: Any,
    x_micro: jnp.ndarray,
    tgt_micro: Any,
    mesh: Mesh,
    axis: str = "stage",
):
    """1F1B pipelined (loss, stacked_grads) over ``axis`` of ``mesh``.

    Drop-in training-step counterpart of :func:`pipeline_apply`; grads are
    S(0)-sharded over stages like the parameters.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    step = train_step_1f1b(stage_fn, loss_fn, n_stages, n_micro, axis=axis)
    pspec = jax.tree_util.tree_map(lambda _: P(axis), stacked_params)
    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(pspec, P(), P()),
        out_specs=(P(), pspec),
        check_vma=False,
    )(stacked_params, x_micro, tgt_micro)


@dataclasses.dataclass(frozen=True)
class PipelineModule:
    """Module-flavored wrapper: a Sequential split into shape-uniform stages.

    The analog of assigning nn.Graph blocks to stages with
    ``block.config.set_stage`` (block_config.py:32-114): here each stage is
    an explicit (init, apply) module (e.g. nn.Sequential slices).
    """

    stages: tuple
    axis: str = "stage"
    remat: bool = True

    def init(self, key) -> Any:
        keys = jax.random.split(key, len(self.stages))
        return stack_stage_params(
            [s.init(k) for s, k in zip(self.stages, keys)]
        )

    def _stage_fn(self):
        # all stages must share a pytree structure; dispatch by index is
        # impossible under S(0) stacking, so stages must be homogeneous
        # modules. Heterogeneous pipelines use gpipe_spmd directly with a
        # hand-written stage_fn switching on axis_index.
        s0 = self.stages[0]
        return lambda p, x: s0.apply(p, x)

    def apply(self, stacked_params, x_micro, mesh: Mesh) -> jnp.ndarray:
        return pipeline_apply(
            self._stage_fn(), stacked_params, x_micro, mesh,
            axis=self.axis, remat=self.remat,
        )
