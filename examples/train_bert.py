"""Masked-language-model pretraining of the BERT-style encoder through the
compiled-graph stack: synthetic token stream -> TokenDataset batches ->
TrainGraph (adamw + warmup-cosine, AMP, grad accumulation).

Mirrors the reference's BERT throughput workload
(ci/test/1node_benchmark_test.sh) on top of of_spmm.

    python examples/train_bert.py --cpu [--steps 20] [--amp]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--amp", action="store_true")
    ap.add_argument("--grad-acc", type=int, default=1)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from of_spmm import nn, optim
    from of_spmm.graph import GraphConfig, TrainGraph
    from of_spmm.optim import lr_scheduler

    from of_spmm.models import TransformerEncoder

    model = TransformerEncoder(
        vocab_size=args.vocab, max_len=args.seq, embed_dim=128, num_heads=4,
        num_layers=4, mlp_dim=512)
    params = model.init(jax.random.key(0))

    rng = np.random.default_rng(0)

    def batch_stream():
        while True:
            tokens = rng.integers(1, args.vocab, (args.batch, args.seq))
            mask = rng.random((args.batch, args.seq)) < 0.15
            inputs = np.where(mask, 0, tokens)  # 0 = [MASK]
            yield (jnp.asarray(inputs.astype(np.int32)),
                   jnp.asarray(tokens.astype(np.int32)),
                   jnp.asarray(mask))

    def loss_fn(params, inputs, targets, mask):
        h = model.apply(params, inputs)  # (B, T, E) hidden states
        # MLM head with tied input embeddings (BERT convention)
        logits = (h @ params["tok"]["weight"].T) / np.sqrt(128)  # (B, T, vocab)
        losses = nn.losses.cross_entropy(
            logits.reshape(-1, args.vocab), targets.reshape(-1),
            reduction="none")
        m = mask.reshape(-1).astype(losses.dtype)
        return (losses * m).sum() / jnp.maximum(m.sum(), 1.0)

    sched = lr_scheduler.warmup(
        lr_scheduler.cosine_annealing(args.lr, t_max=max(args.steps, 2)),
        warmup_steps=max(args.steps // 10, 1))
    g = TrainGraph(
        loss_fn,
        optim.adamw(sched, weight_decay=0.01),
        params,
        config=GraphConfig(amp=args.amp, grad_accumulation_steps=args.grad_acc),
    )

    stream = batch_stream()
    t0 = time.time()
    for step in range(1, args.steps + 1):
        metrics = g(*next(stream))
        if step % max(args.steps // 10, 1) == 0 or step == 1:
            print(f"step {step:4d}  mlm_loss {float(metrics['loss']):.4f}  "
                  f"({(time.time()-t0)/step*1e3:.0f} ms/step avg)")
    tok_s = args.steps * args.batch * args.seq / (time.time() - t0)
    print(f"done: {tok_s:,.0f} tokens/s")


if __name__ == "__main__":
    main()
