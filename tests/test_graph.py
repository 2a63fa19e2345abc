"""TrainGraph / amp / grad-accumulation / ZeRO tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from of_spmm import amp, nn, optim
from of_spmm.graph import EvalGraph, GraphConfig, TrainGraph, train_graph


def _mlp_and_data(seed=0, n=32):
    model = nn.Sequential(nn.Linear(4, 16), nn.relu, nn.Linear(16, 2))
    params = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, 4)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 2, n).astype(np.int32))

    def loss_fn(p, xx, yy):
        return nn.losses.cross_entropy(model.apply(p, xx), yy)

    return model, params, x, y, loss_fn


def test_train_graph_basic_converges():
    model, params, x, y, loss_fn = _mlp_and_data()
    init, step = train_graph(loss_fn, optim.adam(1e-2), donate=False)
    state = init(params)
    losses = []
    for _ in range(40):
        params, state, m = step(params, state, x, y)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert bool(m["did_step"])


def test_grad_accumulation_equals_full_batch():
    """K micro-batches of mean-loss grads == full-batch grads (same data)."""
    model, params, x, y, loss_fn = _mlp_and_data(n=32)
    opt = optim.sgd(lr=0.1)  # linear optimizer: equality is exact-ish
    init1, step1 = train_graph(loss_fn, opt, GraphConfig(), donate=False)
    init4, step4 = train_graph(
        loss_fn, opt, GraphConfig(grad_accumulation_steps=4), donate=False
    )
    p1, _, m1 = step1(params, init1(params), x, y)
    p4, _, m4 = step4(params, init4(params), x, y)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p4)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # loss metric: mean over micro-batches == full-batch loss (mean CE)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)


def test_amp_bf16_compute_keeps_fp32_params():
    model, params, x, y, loss_fn = _mlp_and_data()
    init, step = train_graph(
        loss_fn, optim.sgd(1e-2), GraphConfig(amp=True), donate=False
    )
    p2, _, m = step(params, init(params), x, y)
    for leaf in jax.tree_util.tree_leaves(p2):
        assert leaf.dtype == jnp.float32  # master params stay fp32
    assert np.isfinite(float(m["loss"]))


def test_checkpoint_activations_same_grads():
    model, params, x, y, loss_fn = _mlp_and_data()
    init_a, step_a = train_graph(loss_fn, optim.sgd(0.1), GraphConfig(), donate=False)
    init_b, step_b = train_graph(
        loss_fn, optim.sgd(0.1), GraphConfig(checkpoint_activations=True),
        donate=False,
    )
    pa, _, _ = step_a(params, init_a(params), x, y)
    pb, _, _ = step_b(params, init_b(params), x, y)
    for a, b in zip(jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_grad_scaler_dynamics():
    scaler = amp.GradScaler(init_scale=8.0, growth_factor=2.0,
                            backoff_factor=0.5, growth_interval=2)
    state = scaler.init()
    good = {"w": jnp.ones(3)}
    bad = {"w": jnp.asarray([1.0, jnp.inf, 0.0])}
    # finite grads: tracker grows; after growth_interval, scale doubles
    g, state, ok = scaler.unscale_and_update(good, state)
    assert bool(ok) and float(state["scale"]) == 8.0
    g, state, ok = scaler.unscale_and_update(good, state)
    assert float(state["scale"]) == 16.0
    # non-finite: scale backs off, tracker resets
    g, state, ok = scaler.unscale_and_update(bad, state)
    assert not bool(ok) and float(state["scale"]) == 8.0
    np.testing.assert_allclose(np.asarray(g["w"])[0], 1.0 / 16.0)


def test_scaler_in_graph_skips_nonfinite_step():
    model, params, x, y, loss_fn = _mlp_and_data()

    def exploding_loss(p, xx, yy):
        # overflow the GRADIENTS (an additive inf constant would not):
        big = jnp.asarray(1e30, jnp.float32) * jnp.asarray(1e30, jnp.float32)
        return loss_fn(p, xx, yy) * big

    init, step = train_graph(
        exploding_loss, optim.sgd(0.1),
        GraphConfig(loss_scale=amp.GradScaler(init_scale=4.0)), donate=False,
    )
    p2, state, m = step(params, init(params), x, y)
    assert not bool(m["did_step"])
    for a, b in zip(jax.tree_util.tree_leaves(p2), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # skipped
    assert float(state["scaler"]["scale"]) == 2.0  # backed off


def test_zero_shards_optimizer_state(mesh8):
    model = nn.Sequential(nn.Linear(8, 64), nn.relu, nn.Linear(64, 8))
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((16, 8)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 8, 16).astype(np.int32))

    def loss_fn(p, xx, yy):
        return nn.losses.cross_entropy(model.apply(p, xx), yy)

    with mesh8:
        init, step = train_graph(
            loss_fn, optim.adam(1e-3),
            GraphConfig(zero_stage=1, zero_min_size=64),
            mesh=mesh8, dp_axis="x", donate=False,
        )
        state = init(params)
        p2, state, m = step(params, state, x, y)
    assert np.isfinite(float(m["loss"]))
    # big moment leaves sharded over x (first dim 8 or 64 divisible by 8)
    mom = state["opt"]["m"]["layer_0"]["w"]  # (8, 64)
    assert "x" in str(mom.sharding)


def test_eval_graph_amp_output_fp32():
    model, params, x, y, _ = _mlp_and_data()
    g = EvalGraph(lambda p, xx: model.apply(p, xx), GraphConfig(amp=True))
    out = g(params, x)
    assert out.dtype == jnp.float32
    out32 = EvalGraph(lambda p, xx: model.apply(p, xx))(params, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out32), atol=0.1)


def test_train_graph_object_wrapper():
    model, params, x, y, loss_fn = _mlp_and_data()
    g = TrainGraph(loss_fn, optim.adam(1e-2), params)
    m0 = g(x, y)
    for _ in range(20):
        m = g(x, y)
    assert float(m["loss"]) < float(m0["loss"])
    assert g.step_count == 21


def test_train_graph_checkpoint_resume(tmp_path):
    """Save at step k, keep training; reload and retrain -> identical
    params (the reference's resumed train-step semantics)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from of_spmm import nn, optim
    from of_spmm.graph import GraphConfig, TrainGraph

    model = nn.Linear(6, 3)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    xs = [jnp.asarray(rng.standard_normal((8, 6)).astype(np.float32))
          for _ in range(6)]
    ys = [jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
          for _ in range(6)]

    def loss_fn(p, x, y):
        return jnp.mean((model.apply(p, x) - y) ** 2)

    g = TrainGraph(loss_fn, optim.adam(1e-2), params)
    for i in range(3):
        g(xs[i], ys[i])
    ckpt = str(tmp_path / "g.npz")
    g.save(ckpt)
    for i in range(3, 6):
        g(xs[i], ys[i])
    final_a = jax.tree_util.tree_leaves(g.params)

    g2 = TrainGraph(loss_fn, optim.adam(1e-2), params)
    g2.load(ckpt)
    assert g2.step_count == 3
    for i in range(3, 6):
        g2(xs[i], ys[i])
    final_b = jax.tree_util.tree_leaves(g2.params)
    for a, b in zip(final_a, final_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
