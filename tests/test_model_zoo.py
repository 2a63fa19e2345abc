"""ResNet/Transformer model families (reference CI-gate workloads)."""

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.models import ResNet, bert_tiny


def test_resnet_tiny_forward_backward():
    # small ResNet (one block per stage) on 32x32 inputs
    model = ResNet(layers=(1, 1, 1, 1), n_classes=10, width=16)
    params = model.init(jax.random.key(0))
    state = model.init_state()
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))

    logits = model.apply(params, x, state=state, train=False)
    assert logits.shape == (2, 10)

    def loss_fn(params):
        out, _ = model.apply(params, x, state=state, train=True)
        return jnp.mean(out ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert np.isfinite(float(loss))
    gnorm = sum(float(jnp.sum(g ** 2)) for g in jax.tree_util.tree_leaves(grads))
    assert gnorm > 0


def test_resnet_batchnorm_state_updates():
    model = ResNet(layers=(1,), n_classes=4, width=8)
    params = model.init(jax.random.key(1))
    state = model.init_state()
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (4, 3, 16, 16)).astype(np.float32) * 3 + 1)
    _, new_state = model.apply(params, x, state=state, train=True)
    before = np.asarray(state["stem_bn"]["mean"])
    after = np.asarray(new_state["stem_bn"]["mean"])
    assert not np.allclose(before, after)


def test_bert_tiny_forward_backward():
    model = bert_tiny(n_classes=3)
    params = model.init(jax.random.key(2))
    toks = jnp.asarray(np.random.default_rng(2).integers(0, 1000, (2, 16)))

    logits = model.apply(params, toks)
    assert logits.shape == (2, 3)

    def loss_fn(params):
        return jnp.mean(model.apply(params, toks) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert np.isfinite(float(loss))


def test_bert_hidden_states():
    model = bert_tiny()
    params = model.init(jax.random.key(3))
    toks = jnp.zeros((1, 8), jnp.int32)
    h = model.apply(params, toks)
    assert h.shape == (1, 8, 128)


def test_vgg16_alexnet_forward():
    from of_spmm.models import alexnet, vgg16

    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 3, 224, 224)).astype(np.float32))
    for mk in (vgg16, alexnet):
        model = mk(n_classes=10)
        params = model.init(jax.random.key(0))
        logits = model.apply(params, x)
        assert logits.shape == (1, 10)
        assert np.isfinite(np.asarray(logits)).all()
