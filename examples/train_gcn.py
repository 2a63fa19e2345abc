"""End-to-end GCN training on Cora through the full framework stack:
graph load -> operator plan -> TrainGraph (adam + cosine schedule +
grad clipping) -> accuracy eval. Runs on the default backend (the GPU
where there is one; --cpu forces the CPU).

    python examples/train_gcn.py [--graph cora] [--epochs 100] [--amp]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm import nn, optim
from of_spmm.data import load_graph, random_features
from of_spmm.graph import GraphConfig, TrainGraph
from of_spmm.models import GCN, normalized_adjacency
from of_spmm.ops import make_operator
from of_spmm.utils.config import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="cora")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--amp", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    csr, cfg = load_graph(args.graph, symmetrize=True)
    op = make_operator(normalized_adjacency(csr))
    x, y = random_features(cfg)
    x, y = jnp.asarray(x), jnp.asarray(y)

    model = GCN(feature_dims=(cfg.feature_dim, args.hidden, cfg.n_classes))
    params = model.init(jax.random.key(0))
    print(f"params: {nn.param_count(params):,}")

    schedule = optim.lr_scheduler.warmup(
        optim.lr_scheduler.cosine_annealing(args.lr, t_max=args.epochs), 10
    )
    # the operator is a step ARGUMENT: closing over it would bake the plan
    # arrays into the compiled program as literals
    graph = TrainGraph(
        lambda p, o, xx, yy: model.loss_fn(p, o, xx, yy),
        optim.adam(lr=schedule),
        params,
        config=GraphConfig(amp=args.amp, clip_grad_norm=5.0),
    )

    apply = jax.jit(model.apply)
    t0 = time.time()
    for epoch in range(args.epochs):
        metrics = graph(op, x, y)
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            logits = apply(graph.params, op, x)
            acc = float(jnp.mean((jnp.argmax(logits, -1) == y)))
            print(
                f"epoch {epoch:4d}  loss {float(metrics['loss']):.4f}  "
                f"acc {acc:.3f}  ({time.time()-t0:.1f}s)"
            )
    print("done")


if __name__ == "__main__":
    main()
