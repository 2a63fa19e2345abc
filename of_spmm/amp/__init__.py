"""AMP — mixed precision policy + loss scaling.

The reference implements AMP as a lazy-graph rewrite inserting fp16 casts
around white-listed ops (oneflow/core/job_rewriter/auto_mixed_precision.cpp)
plus a Python GradScaler (python/oneflow/amp/grad_scaler.py:18,42) with
dynamic loss-scale state. With bf16 the policy is simpler and stronger:
bfloat16 has fp32's exponent range, so the standard recipe is bf16 compute
+ fp32 master params and NO loss scaling; the GradScaler is still provided
(fully traceable) for fp16-style workflows and API parity.

- ``Policy``: dtype triple (param/compute/output) + cast helpers, the
  analog of the AMP white/black lists collapsed to "cast at the boundary".
- ``GradScaler``: dynamic loss scaling with growth/backoff exactly like
  the reference (init_scale, growth_factor, backoff_factor,
  growth_interval); state is a pytree, update is jit-traceable
  (skip-on-nonfinite via lax.cond-free where).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: cast params/inputs to compute dtype at the
    forward boundary, keep master params in param_dtype."""

    param_dtype: Any = jnp.float32
    compute_dtype: Any = jnp.bfloat16
    output_dtype: Any = jnp.float32

    def cast_to_compute(self, tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(self.compute_dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            tree,
        )

    def cast_to_param(self, tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(self.param_dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            tree,
        )

    def cast_output(self, tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(self.output_dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            tree,
        )


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=jnp.float32)


def all_finite(tree) -> jnp.ndarray:
    """Scalar bool: every float leaf is finite (the found_inf check)."""
    leaves = [
        jnp.all(jnp.isfinite(x))
        for x in jax.tree_util.tree_leaves(tree)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
    ]
    if not leaves:
        return jnp.asarray(True)
    return jnp.all(jnp.stack(leaves))


@dataclasses.dataclass(frozen=True)
class GradScaler:
    """Dynamic loss scaler (API parity: python/oneflow/amp/grad_scaler.py).

    usage:
        scaler = GradScaler()
        state = scaler.init()
        loss = ... ; sloss = scaler.scale(loss, state)
        grads = jax.grad(...)  # of sloss
        grads, state, did_step = scaler.unscale_and_update(grads, state)
        # apply grads only where did_step (tree_map with jnp.where)
    """

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    def init(self) -> dict:
        return {
            "scale": jnp.asarray(self.init_scale, jnp.float32),
            "growth_tracker": jnp.zeros((), jnp.int32),
        }

    def scale(self, loss: jnp.ndarray, state: dict) -> jnp.ndarray:
        return loss * state["scale"].astype(loss.dtype)

    def unscale(self, grads, state: dict):
        inv = 1.0 / state["scale"]
        return jax.tree_util.tree_map(lambda g: g * inv.astype(g.dtype), grads)

    def update(self, state: dict, grads_finite: jnp.ndarray) -> dict:
        grown = state["growth_tracker"] + 1
        hit = grown >= self.growth_interval
        new_scale = jnp.where(
            grads_finite,
            jnp.where(hit, state["scale"] * self.growth_factor, state["scale"]),
            state["scale"] * self.backoff_factor,
        )
        new_tracker = jnp.where(
            grads_finite, jnp.where(hit, 0, grown), 0
        ).astype(jnp.int32)
        return {"scale": new_scale, "growth_tracker": new_tracker}

    def unscale_and_update(self, grads, state: dict):
        """(unscaled grads, new state, did_step). When grads are non-finite
        the step must be skipped (the reference skips optimizer.step())."""
        grads = self.unscale(grads, state)
        finite = all_finite(grads)
        return grads, self.update(state, finite), finite


@dataclasses.dataclass(frozen=True)
class StaticGradScaler:
    """Constant loss scale (reference: StaticGradScaler)."""

    scale_value: float = 1.0

    def init(self) -> dict:
        return {"scale": jnp.asarray(self.scale_value, jnp.float32)}

    def scale(self, loss, state):
        return loss * state["scale"].astype(loss.dtype)

    def unscale(self, grads, state):
        inv = 1.0 / state["scale"]
        return jax.tree_util.tree_map(lambda g: g * inv.astype(g.dtype), grads)

    def unscale_and_update(self, grads, state):
        grads = self.unscale(grads, state)
        return grads, state, all_finite(grads)
