"""Optimizer tests: vs optax oracles (adam/adamw/sgd/lamb) + schedules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm import optim


def _params():
    return {
        "w": jnp.asarray(np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)),
        "b": jnp.zeros((3,), jnp.float32),
    }


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32)),
        "b": jnp.asarray(rng.standard_normal((3,)).astype(np.float32)),
    }


def _run_ours(opt, params, grad_seq):
    state = opt.init(params)
    for g in grad_seq:
        params, state = opt.update(g, state, params)
    return params


def _run_optax(tx, params, grad_seq):
    state = tx.init(params)
    for g in grad_seq:
        updates, state = tx.update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return params


@pytest.mark.parametrize("steps", [1, 5])
def test_adam_matches_optax(steps):
    optax = pytest.importorskip("optax")
    params = _params()
    grads = [_grads(i) for i in range(steps)]
    ours = _run_ours(optim.adam(lr=1e-2), params, grads)
    theirs = _run_optax(optax.adam(1e-2), params, grads)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_adamw_matches_optax():
    optax = pytest.importorskip("optax")
    params = _params()
    grads = [_grads(i) for i in range(4)]
    ours = _run_ours(optim.adamw(lr=1e-2, weight_decay=0.05), params, grads)
    theirs = _run_optax(optax.adamw(1e-2, weight_decay=0.05), params, grads)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_sgd_momentum_matches_optax():
    optax = pytest.importorskip("optax")
    params = _params()
    grads = [_grads(i) for i in range(5)]
    ours = _run_ours(optim.sgd(lr=0.1, momentum=0.9), params, grads)
    theirs = _run_optax(optax.sgd(0.1, momentum=0.9), params, grads)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_lamb_trust_ratio_direction():
    # lamb == adam when trust ratio is 1 (zero params disable the ratio)
    params = _params()
    grads = [_grads(7)]
    out = _run_ours(optim.lamb(lr=1e-2), params, grads)
    for a, p in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(params)):
        assert a.shape == p.shape
        assert np.all(np.isfinite(np.asarray(a)))


def test_ftrl_sparsifies_with_l1():
    opt = optim.ftrl(lr=0.5, lambda1=10.0)
    params = {"w": jnp.ones((4,))}
    state = opt.init(params)
    rng = np.random.default_rng(11)
    for i in range(3):
        g = jnp.asarray(rng.standard_normal(4).astype(np.float32)) * 0.01
        params, state = opt.update({"w": g}, state, params)
    # big l1 -> everything clamped to zero
    np.testing.assert_allclose(np.asarray(params["w"]), 0.0, atol=1e-6)


def test_clip_grad_norm():
    grads = {"a": jnp.full((3,), 4.0), "b": jnp.full((4,), 3.0)}
    clipped, total = optim.clip_grad_norm(grads, 1.0)
    got = np.sqrt(sum(float(jnp.sum(g ** 2)) for g in jax.tree_util.tree_leaves(clipped)))
    assert got == pytest.approx(1.0, rel=1e-4)
    assert float(total) == pytest.approx(np.sqrt(48 + 36), rel=1e-5)


def test_schedules_shapes_and_values():
    s = optim.lr_scheduler.cosine_annealing(1.0, t_max=10)
    assert float(s(jnp.asarray(1))) == pytest.approx(1.0)
    assert float(s(jnp.asarray(11))) == pytest.approx(0.0, abs=1e-6)
    st = optim.lr_scheduler.step_lr(1.0, step_size=2, gamma=0.1)
    assert float(st(jnp.asarray(1))) == pytest.approx(1.0)
    assert float(st(jnp.asarray(3))) == pytest.approx(0.1)
    w = optim.lr_scheduler.warmup(optim.lr_scheduler.constant(2.0), 4)
    assert float(w(jnp.asarray(2))) == pytest.approx(1.0)
    assert float(w(jnp.asarray(8))) == pytest.approx(2.0)


def test_training_loop_converges():
    """End-to-end: nn MLP + adam learns XOR-ish separation."""
    from of_spmm import nn

    model = nn.Sequential(nn.Linear(2, 16), nn.tanh, nn.Linear(16, 1))
    params = model.init(jax.random.key(0))
    x = jnp.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], jnp.float32)
    y = jnp.asarray([[0.0], [1.0], [1.0], [0.0]])
    opt = optim.adam(lr=3e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss(p):
            return nn.losses.mse_loss(model.apply(p, x), y)

        l, g = jax.value_and_grad(loss)(params)
        params, state = opt.update(g, state, params)
        return params, state, l

    for _ in range(300):
        params, state, l = step(params, state)
    assert float(l) < 0.03


def test_rmsprop_matches_torch():
    import torch

    params = _params()
    grad_seq = [_grads(i) for i in range(4)]
    got = _run_ours(optim.rmsprop(lr=0.01, alpha=0.95, momentum=0.5,
                                  centered=True), params, grad_seq)

    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    opt = torch.optim.RMSprop(list(tp.values()), lr=0.01, alpha=0.95, momentum=0.5,
                              centered=True, eps=1e-8)
    for g in grad_seq:
        for k, t in tp.items():
            t.grad = torch.tensor(np.asarray(g[k]))
        opt.step()
    for k, t in tp.items():
        v = got[k]
        # centered variance (sq - avg^2) cancels catastrophically; fp32
        # noise amplifies through the sqrt -> looser multi-step tolerance
        np.testing.assert_allclose(np.asarray(v), t.detach().numpy(),
                                   rtol=1e-3, atol=1e-5)


def test_adagrad_matches_torch():
    import torch

    params = _params()
    grad_seq = [_grads(i) for i in range(4)]
    got = _run_ours(optim.adagrad(lr=0.05), params, grad_seq)

    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    opt = torch.optim.Adagrad(list(tp.values()), lr=0.05, eps=1e-10)
    for g in grad_seq:
        for k, t in tp.items():
            t.grad = torch.tensor(np.asarray(g[k]))
        opt.step()
    for k, t in tp.items():
        v = got[k]
        np.testing.assert_allclose(np.asarray(v), t.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_adadelta_matches_torch():
    import torch

    params = _params()
    grad_seq = [_grads(i) for i in range(4)]
    got = _run_ours(optim.adadelta(lr=0.8, rho=0.9), params, grad_seq)

    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    opt = torch.optim.Adadelta(list(tp.values()), lr=0.8, rho=0.9, eps=1e-6)
    for g in grad_seq:
        for k, t in tp.items():
            t.grad = torch.tensor(np.asarray(g[k]))
        opt.step()
    for k, t in tp.items():
        v = got[k]
        np.testing.assert_allclose(np.asarray(v), t.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
