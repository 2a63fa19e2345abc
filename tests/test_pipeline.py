"""Pipeline-parallel (GPipe) tests on the 8-device CPU mesh.

Mirrors the reference's pipeline capability (stage scopes + microbatch
grad-acc + buffer pass, SURVEY §2.7 PP): outputs and gradients of the
pipelined model must match the plain sequential execution exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm import nn
from of_spmm.parallel.pipeline import (
    PipelineModule,
    pipeline_apply,
    stack_stage_params,
)

S, B, F = 4, 6, 16  # stages, microbatch size, feature dim
N_MICRO = 8


@pytest.fixture(scope="module")
def mesh4():
    devs = jax.devices()[:4]
    return Mesh(np.asarray(devs), ("stage",))


def _stages(key):
    keys = jax.random.split(key, S)
    mods = [nn.Linear(F, F) for _ in range(S)]
    per_stage = [m.init(k) for m, k in zip(mods, keys)]
    return mods, per_stage


def _stage_fn(p, x):
    return jax.nn.relu(x @ p["w"] + p["b"])


def _sequential(per_stage, x):
    for p in per_stage:
        x = _stage_fn(p, x)
    return x


def test_pipeline_forward_matches_sequential(mesh4):
    key = jax.random.key(0)
    _, per_stage = _stages(key)
    stacked = stack_stage_params(per_stage)
    x = jax.random.normal(jax.random.key(1), (N_MICRO, B, F))

    y = pipeline_apply(_stage_fn, stacked, x, mesh4, axis="stage")
    want = jnp.stack([_sequential(per_stage, x[m]) for m in range(N_MICRO)])
    np.testing.assert_allclose(np.asarray(y), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_pipeline_grads_match_sequential(mesh4):
    """The backward pipeline schedule is jax.grad's transpose of the
    ppermute chain; parameter grads must equal the unpipelined model's."""
    key = jax.random.key(2)
    _, per_stage = _stages(key)
    stacked = stack_stage_params(per_stage)
    x = jax.random.normal(jax.random.key(3), (N_MICRO, B, F))
    tgt = jax.random.normal(jax.random.key(4), (N_MICRO, B, F))

    def loss_pipe(stacked):
        y = pipeline_apply(_stage_fn, stacked, x, mesh4, axis="stage")
        return jnp.mean((y - tgt) ** 2)

    def loss_seq(per_stage):
        y = jnp.stack([_sequential(per_stage, x[m]) for m in range(N_MICRO)])
        return jnp.mean((y - tgt) ** 2)

    g_pipe = jax.jit(jax.grad(loss_pipe))(stacked)
    g_seq = jax.grad(loss_seq)(list(per_stage))

    for s in range(S):
        np.testing.assert_allclose(
            np.asarray(g_pipe["w"][s]), np.asarray(g_seq[s]["w"]),
            rtol=1e-4, atol=1e-6, err_msg=f"dW stage {s}")
        np.testing.assert_allclose(
            np.asarray(g_pipe["b"][s]), np.asarray(g_seq[s]["b"]),
            rtol=1e-4, atol=1e-6, err_msg=f"db stage {s}")


def test_pipeline_module(mesh4):
    key = jax.random.key(5)
    pm = PipelineModule(stages=tuple(nn.Linear(F, F) for _ in range(S)))
    stacked = pm.init(key)
    x = jax.random.normal(jax.random.key(6), (N_MICRO, B, F))
    y = pm.apply(stacked, x, mesh4)
    # reference: unstack and run sequentially (Linear has no relu)
    per_stage = [
        jax.tree_util.tree_map(lambda a: a[s], stacked) for s in range(S)
    ]
    want = x
    for p in per_stage:
        want = jnp.einsum("mbf,fg->mbg", want, p["w"]) + p["b"]
    np.testing.assert_allclose(np.asarray(y), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_pipeline_with_dp_axis():
    """stage x data 2-D mesh: pipeline inside, batch sharded outside."""
    devs = jax.devices()
    mesh = Mesh(np.asarray(devs).reshape(4, 2), ("stage", "data"))
    key = jax.random.key(7)
    _, per_stage = _stages(key)
    stacked = stack_stage_params(per_stage)
    x = jax.random.normal(jax.random.key(8), (N_MICRO, B, F))

    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = jax.device_put(x, NamedSharding(mesh, P(None, "data")))
    y = pipeline_apply(_stage_fn, stacked, xs, mesh, axis="stage")
    want = jnp.stack([_sequential(per_stage, x[m]) for m in range(N_MICRO)])
    np.testing.assert_allclose(np.asarray(y), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
