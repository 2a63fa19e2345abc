"""Distributed full-batch GCN training over a device mesh (halo-exchange
SpMM inside shard_map, replicated params, row-sharded activations).

Runs anywhere: on a multi-GPU host it uses the real devices; on CPU
it simulates a mesh (--devices N sets jax_num_cpu_devices before first
device use).

    python examples/train_dist.py --devices 8 --graph cora
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="cora")
    ap.add_argument("--devices", type=int, default=0, help="simulate N cpu devices")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    import jax

    if args.devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from of_spmm import distributed as dist
    from of_spmm.data import load_graph, random_features
    from of_spmm.models import GCN, normalized_adjacency
    from of_spmm.parallel import partition_rows
    from of_spmm.parallel.consistency import check_consistent
    from of_spmm.train import make_dist_train_step

    dist.initialize()
    devs = jax.devices()
    n = len(devs)
    print(f"rank {dist.get_rank()}/{dist.get_world_size()}, {n} devices")

    csr, cfg = load_graph(args.graph, symmetrize=True)
    ahat = normalized_adjacency(csr)
    plan = partition_rows(ahat, n)
    check_consistent(plan, "row-partition plan")
    print(f"halo fraction: {plan.halo_fraction:.3f}")

    model = GCN(feature_dims=(cfg.feature_dim, 32, cfg.n_classes))
    params = model.init(jax.random.key(0))
    x, y = random_features(cfg)
    x, y = jnp.asarray(x), jnp.asarray(y)

    mesh = Mesh(np.asarray(devs), ("x",))
    step = make_dist_train_step(model, plan, mesh, lr=1e-2)

    t0 = time.time()
    for i in range(args.steps):
        loss, params = step(params, x, y)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}  ({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
