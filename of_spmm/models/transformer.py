"""Transformer encoder (BERT-style) — the reference's BERT benchmark
workload (ci/test/1node_benchmark_test.sh BERT-base smoke) re-expressed
with this framework's modules. Pre-LN encoder blocks; matmul-friendly shapes
throughout (batch-first (B, T, E))."""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from of_spmm import nn


@dataclasses.dataclass(frozen=True)
class EncoderBlock:
    embed_dim: int
    num_heads: int
    mlp_dim: int
    dropout: float = 0.0

    def _mods(self):
        return {
            "ln1": nn.LayerNorm((self.embed_dim,)),
            "attn": nn.MultiheadAttention(self.embed_dim, self.num_heads),
            "ln2": nn.LayerNorm((self.embed_dim,)),
            "fc1": nn.Linear(self.embed_dim, self.mlp_dim),
            "fc2": nn.Linear(self.mlp_dim, self.embed_dim),
        }

    def init(self, key):
        mods = self._mods()
        keys = jax.random.split(key, len(mods))
        return {k: m.init(kk) for (k, m), kk in zip(mods.items(), keys)}

    def apply(self, params, x, *, mask=None, train=False, rng=None):
        mods = self._mods()
        h = mods["ln1"].apply(params["ln1"], x)
        h = mods["attn"].apply(params["attn"], h, mask=mask)
        if train and self.dropout > 0 and rng is not None:
            h = nn.Dropout(self.dropout).apply({}, h, train=True, rng=rng)
        x = x + h
        h = mods["ln2"].apply(params["ln2"], x)
        h = nn.gelu(mods["fc1"].apply(params["fc1"], h))
        h = mods["fc2"].apply(params["fc2"], h)
        return x + h


@dataclasses.dataclass(frozen=True)
class TransformerEncoder:
    """BERT-base defaults: 12 layers, 768 width, 12 heads."""

    vocab_size: int = 30522
    max_len: int = 512
    embed_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_dim: int = 3072
    n_classes: Optional[int] = None  # None = return hidden states
    dropout: float = 0.0

    def _blocks(self):
        return [
            EncoderBlock(self.embed_dim, self.num_heads, self.mlp_dim,
                         self.dropout)
            for _ in range(self.num_layers)
        ]

    def init(self, key):
        blocks = self._blocks()
        keys = jax.random.split(key, len(blocks) + 4)
        tok = nn.Embedding(self.vocab_size, self.embed_dim)
        pos = nn.Embedding(self.max_len, self.embed_dim)
        p = {
            "tok": tok.init(keys[0]),
            "pos": pos.init(keys[1]),
            "ln_f": nn.LayerNorm((self.embed_dim,)).init(keys[2]),
        }
        if self.n_classes is not None:
            p["head"] = nn.Linear(self.embed_dim, self.n_classes).init(keys[3])
        for i, b in enumerate(blocks):
            p[f"block_{i}"] = b.init(keys[4 + i])
        return p

    def apply(self, params, tokens, *, train=False, rng=None):
        B, T = tokens.shape
        tok = nn.Embedding(self.vocab_size, self.embed_dim)
        pos = nn.Embedding(self.max_len, self.embed_dim)
        h = tok.apply(params["tok"], tokens) + pos.apply(
            params["pos"], jnp.arange(T))[None, :, :]
        from of_spmm.nn.module import split_rng

        rngs = split_rng(rng, self.num_layers)
        for i, b in enumerate(self._blocks()):
            h = b.apply(params[f"block_{i}"], h, train=train, rng=rngs[i])
        h = nn.LayerNorm((self.embed_dim,)).apply(params["ln_f"], h)
        if self.n_classes is not None:
            return nn.Linear(self.embed_dim, self.n_classes).apply(
                params["head"], h[:, 0, :])  # CLS pooling
        return h


def bert_base(n_classes: Optional[int] = None) -> TransformerEncoder:
    return TransformerEncoder(n_classes=n_classes)


def bert_tiny(n_classes: Optional[int] = None) -> TransformerEncoder:
    """4-layer/128-wide config for tests and smoke benches."""
    return TransformerEncoder(
        vocab_size=1000, max_len=128, embed_dim=128, num_heads=4,
        num_layers=4, mlp_dim=512, n_classes=n_classes,
    )
