"""Fused attention route (jax.nn.dot_product_attention) vs the XLA
attention oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from of_spmm.nn.attention import flash_attention, scaled_dot_product_attention


def _qkv(B, H, T, d, seed=0):
    ks = jax.random.split(jax.random.key(seed), 3)
    return [jax.random.normal(k, (B, H, T, d), jnp.float32) for k in ks]


@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("T", [128, 384])
def test_flash_matches_oracle(is_causal, T):
    q, k, v = _qkv(2, 3, T, 64)
    got = flash_attention(q, k, v, is_causal=is_causal)
    want = scaled_dot_product_attention(q, k, v, is_causal=is_causal)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_flash_grads_match_oracle():
    q, k, v = _qkv(1, 2, 128, 64, seed=1)

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v, is_causal=True) ** 2)

    def loss_ref(q, k, v):
        return jnp.sum(scaled_dot_product_attention(
            q, k, v, is_causal=True) ** 2)

    g_f = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    g_r = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(g_f, g_r, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_flash_rejects_ragged_blocks():
    """The fused route has no block constraint: a sequence length that no
    power-of-two block divides runs and matches the oracle."""
    q, k, v = _qkv(1, 1, 100, 64)
    got = flash_attention(q, k, v, is_causal=True)
    want = scaled_dot_product_attention(q, k, v, is_causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_mha_flash_flag_matches_dense():
    from of_spmm.nn.attention import MultiheadAttention

    E, H, B, T = 32, 4, 2, 128
    dense = MultiheadAttention(E, H)
    flash = MultiheadAttention(E, H, flash=True)
    params = dense.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (B, T, E), jnp.float32)
    want = dense.apply(params, x, is_causal=True)
    got = flash.apply(params, x, is_causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
