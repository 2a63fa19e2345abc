"""nn extras (upsample/pad/shuffle/distance/losses/activations) vs torch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from of_spmm.nn import extras as X
from of_spmm.testing.autotest import assert_close


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode,align", [("nearest", False),
                                        ("bilinear", False),
                                        ("bilinear", True)])
@pytest.mark.parametrize("scale", [2, 3])
def test_interpolate_matches_torch(mode, align, scale):
    x = _rand(2, 3, 5, 7)
    kw = {"align_corners": align} if mode == "bilinear" else {}
    want = F.interpolate(torch.tensor(x), scale_factor=scale, mode=mode,
                         **kw).numpy()
    got = X.interpolate(jnp.asarray(x), scale_factor=scale, mode=mode,
                        align_corners=align)
    assert_close(got, want, what=f"interpolate {mode} align={align}")


def test_interpolate_size_downscale():
    x = _rand(1, 2, 8, 8)
    want = F.interpolate(torch.tensor(x), size=(5, 3), mode="bilinear",
                         align_corners=False).numpy()
    got = X.interpolate(jnp.asarray(x), size=(5, 3), mode="bilinear")
    assert_close(got, want, what="interpolate size")


@pytest.mark.parametrize("cls,tcls", [
    (X.ZeroPad2d, torch.nn.ZeroPad2d),
    (X.ReflectionPad2d, torch.nn.ReflectionPad2d),
    (X.ReplicationPad2d, torch.nn.ReplicationPad2d),
])
def test_padding_matches_torch(cls, tcls):
    x = _rand(2, 3, 6, 5)
    pad = (1, 2, 3, 1)
    got = cls(pad).apply({}, jnp.asarray(x))
    want = tcls(pad)(torch.tensor(x)).numpy()
    assert_close(got, want, what=cls.__name__)


def test_pixel_shuffle_roundtrip_and_torch():
    x = _rand(2, 8, 3, 4)
    got = X.pixel_shuffle(jnp.asarray(x), 2)
    want = F.pixel_shuffle(torch.tensor(x), 2).numpy()
    assert_close(got, want, what="pixel_shuffle")
    back = X.pixel_unshuffle(got, 2)
    assert_close(back, x, what="pixel_unshuffle roundtrip")


def test_flatten():
    x = _rand(2, 3, 4, 5)
    got = X.Flatten().apply({}, jnp.asarray(x))
    assert got.shape == (2, 60)
    got2 = X.Flatten(1, 2).apply({}, jnp.asarray(x))
    assert got2.shape == (2, 12, 5)


def test_distances_match_torch():
    a, b = _rand(4, 9, seed=1), _rand(4, 9, seed=2)
    assert_close(X.cosine_similarity(jnp.asarray(a), jnp.asarray(b)),
                 F.cosine_similarity(torch.tensor(a), torch.tensor(b)).numpy(),
                 what="cosine_similarity")
    assert_close(X.pairwise_distance(jnp.asarray(a), jnp.asarray(b)),
                 F.pairwise_distance(torch.tensor(a), torch.tensor(b)).numpy(),
                 what="pairwise_distance")


def test_losses_match_torch():
    logits = _rand(6, 5, seed=3)
    target = np.abs(_rand(6, 5, seed=4)) + 0.1
    target /= target.sum(1, keepdims=True)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    assert_close(
        X.kl_div(jnp.asarray(logp), jnp.asarray(target)),
        F.kl_div(torch.tensor(logp), torch.tensor(target)).numpy(),
        what="kl_div")
    x1, x2 = _rand(8, seed=5), _rand(8, seed=6)
    y = np.sign(_rand(8, seed=7)).astype(np.float32)
    assert_close(
        X.margin_ranking_loss(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(y), margin=0.5),
        F.margin_ranking_loss(torch.tensor(x1), torch.tensor(x2),
                              torch.tensor(y), margin=0.5).numpy(),
        what="margin_ranking")
    a, p_, n_ = _rand(4, 6, seed=8), _rand(4, 6, seed=9), _rand(4, 6, seed=10)
    assert_close(
        X.triplet_margin_loss(jnp.asarray(a), jnp.asarray(p_),
                              jnp.asarray(n_)),
        F.triplet_margin_loss(torch.tensor(a), torch.tensor(p_),
                              torch.tensor(n_)).numpy(),
        what="triplet_margin")
    hx = _rand(10, seed=11)
    hy = np.where(_rand(10, seed=12) > 0, 1, -1).astype(np.float32)
    assert_close(
        X.hinge_embedding_loss(jnp.asarray(hx), jnp.asarray(hy)),
        F.hinge_embedding_loss(torch.tensor(hx), torch.tensor(hy)).numpy(),
        what="hinge_embedding")


@pytest.mark.parametrize("ours,theirs", [
    (X.hardsigmoid, F.hardsigmoid),
    (X.hardswish, F.hardswish),
    (X.mish, F.mish),
    (X.softplus, F.softplus),
    (lambda x: X.hardtanh(x, -0.5, 0.7),
     lambda x: F.hardtanh(x, -0.5, 0.7)),
    (X.glu, F.glu),
    (X.selu, F.selu),
    (X.celu, F.celu),
])
def test_activations_match_torch(ours, theirs):
    x = _rand(4, 6, seed=13) * 3
    assert_close(ours(jnp.asarray(x)), theirs(torch.tensor(x)).numpy(),
                 what=getattr(ours, "__name__", "act"))
