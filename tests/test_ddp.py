"""DDP-surface tests (reference: test/ddp/ + nn/parallel/ddp.py semantics):
the data-parallel step must produce the same parameters as single-device
training on the concatenated batch."""

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm import nn, optim
from of_spmm.parallel.ddp import (
    allreduce_gradients,
    broadcast_params,
    ddp_train_step,
)


def _model_and_data():
    model = nn.Linear(8, 4)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((32, 8)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((32, 4)).astype(np.float32))

    def loss_fn(params, x, y):
        return jnp.mean((model.apply(params, x) - y) ** 2)

    return model, params, x, y, loss_fn


def test_ddp_step_matches_single_device(mesh8):
    model, params, x, y, loss_fn = _model_and_data()
    opt = optim.sgd(lr=0.1)

    # single-device reference
    ref_p, ref_s = params, opt.init(params)
    for _ in range(3):
        _, g = jax.value_and_grad(loss_fn)(ref_p, x, y)
        ref_p, ref_s = opt.update(g, ref_s, ref_p)

    # ddp over 8 shards
    dp = broadcast_params(params, mesh8)
    ds = opt.init(dp)
    step = ddp_train_step(loss_fn, opt, mesh8, axis="x", donate=False)
    for _ in range(3):
        loss, dp, ds = step(dp, ds, x, y)

    for a, b in zip(jax.tree_util.tree_leaves(dp),
                    jax.tree_util.tree_leaves(ref_p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_allreduce_gradients_in_shard_map(mesh8):
    from jax.sharding import PartitionSpec as P

    grads = {"w": jnp.arange(8.0).reshape(8, 1)}

    def body(g):
        return allreduce_gradients(g, "x", mean=True)

    out = jax.shard_map(
        body, mesh=mesh8, in_specs=({"w": P("x")},), out_specs={"w": P("x")},
    )(grads)
    # every shard becomes the mean over shards
    np.testing.assert_allclose(np.asarray(out["w"]).ravel(),
                               np.full(8, np.arange(8.0).mean()))


def test_broadcast_params_replicates(mesh8):
    params = {"w": jnp.ones((4, 4))}
    rep = broadcast_params(params, mesh8)
    assert rep["w"].sharding.is_fully_replicated
