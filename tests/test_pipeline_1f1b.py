"""1F1B pipeline schedule tests (VERDICT r1 item 7).

The reference reaches 1F1B through actor regst backpressure
(oneflow/core/job_rewriter/pipeline_buffer_pass.cpp:80-113); here the
schedule is closed-form inside a lax.scan. Checks:
- loss + parameter grads match the plain sequential computation;
- the closed-form schedule respects 1F1B invariants (in-flight count per
  stage <= n_stages - stage, i.e. the regst budget) so the static
  (n_stages, ...) activation stash never overflows — GPipe's O(n_micro)
  stash reduced to O(n_stages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from of_spmm import nn
from of_spmm.parallel.pipeline import (
    _bwd_mb,
    _fwd_mb,
    pipeline_train_step_1f1b,
    stack_stage_params,
)

S, B, F = 4, 6, 16
N_MICRO = 8


@pytest.fixture(scope="module")
def mesh4():
    devs = jax.devices()[:4]
    return Mesh(np.asarray(devs), ("stage",))


def _stage_fn(p, x):
    return jax.nn.relu(x @ p["w"] + p["b"])


def _loss_fn(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _setup():
    key = jax.random.key(0)
    keys = jax.random.split(key, S)
    per_stage = [nn.Linear(F, F).init(k) for k in keys]
    stacked = stack_stage_params(per_stage)
    x = jax.random.normal(jax.random.key(1), (N_MICRO, B, F))
    tgt = jax.random.normal(jax.random.key(2), (N_MICRO, B, F))
    return per_stage, stacked, x, tgt


def _sequential_loss(per_stage, x, tgt):
    def loss(ps):
        total = 0.0
        for m in range(N_MICRO):
            h = x[m]
            for p in ps:
                h = _stage_fn(p, h)
            total = total + _loss_fn(h, tgt[m])
        return total / N_MICRO

    return jax.value_and_grad(loss)(per_stage)


def test_1f1b_loss_and_grads_match_sequential(mesh4):
    per_stage, stacked, x, tgt = _setup()
    loss, gstacked = pipeline_train_step_1f1b(
        _stage_fn, _loss_fn, stacked, x, tgt, mesh4, axis="stage")
    want_loss, want_grads = _sequential_loss(per_stage, x, tgt)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=1e-5, atol=1e-6)
    want_stacked = stack_stage_params(want_grads)
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(gstacked[k]), np.asarray(want_stacked[k]),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S_,M_", [(2, 3), (4, 8), (4, 4), (8, 16)])
def test_1f1b_schedule_invariants(S_, M_):
    """Every mb forwarded then backwarded exactly once per stage, in order,
    fwd of stage s after fwd of s-1, bwd after fwd of last stage, and
    in-flight(s) <= 2(S-1-s)+1 (pipeline-depth regst budget => static
    stash depth 2*n_stages, independent of n_micro)."""
    cycles = M_ + 2 * (S_ - 1)
    fwd_done = {}
    bwd_done = {}
    for s in range(S_):
        fwd_seen, bwd_seen = [], []
        inflight_max = 0
        for c in range(cycles):
            f = int(_fwd_mb(jnp.int32(c), jnp.int32(s), S_))
            b = int(_bwd_mb(jnp.int32(c), jnp.int32(s), S_))
            if 0 <= f < M_:
                fwd_seen.append((c, f))
            if 0 <= b < M_:
                bwd_seen.append((c, b))
            nf = sum(1 for _, m in fwd_seen)
            nb = sum(1 for _, m in bwd_seen)
            inflight_max = max(inflight_max, nf - nb)
        assert [m for _, m in fwd_seen] == list(range(M_)), (s, fwd_seen)
        assert [m for _, m in bwd_seen] == list(range(M_)), (s, bwd_seen)
        assert inflight_max <= 2 * (S_ - 1 - s) + 1, (s, inflight_max)
        fwd_done[s] = dict((m, c) for c, m in fwd_seen)
        bwd_done[s] = dict((m, c) for c, m in bwd_seen)
    for s in range(1, S_):
        for m in range(M_):
            # stage s forwards m strictly after stage s-1 did
            assert fwd_done[s][m] > fwd_done[s - 1][m]
            # stage s-1 backwards m strictly after stage s did
            assert bwd_done[s - 1][m] > bwd_done[s][m]
    for s in range(S_):
        for m in range(M_):
            assert bwd_done[s][m] >= fwd_done[S_ - 1][m]


def test_1f1b_stash_is_static_n_stages():
    """The activation buffer in the carry is (2*n_stages, ...) — memory is
    O(stages), not O(n_micro) (pipeline_buffer_pass.cpp semantics)."""
    import inspect

    from of_spmm.parallel.pipeline import train_step_1f1b

    src = inspect.getsource(train_step_1f1b)
    assert "stash=jnp.zeros((2 * S,)" in src
