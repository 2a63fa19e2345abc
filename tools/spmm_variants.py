"""Time every SpMM variant on one graph, on the GPU, forward and backward.

The measurement behind the choices recorded in ops/registry.py (which impl
``auto`` takes) and make_operator (which layout ``auto`` takes):

- ``pallas``: the Triton ELL kernel (ops/pallas/spmm.py) on the binned plan;
- ``xla``: XLA's binned path (ops/reference.py spmm_binned_xla);
- ``tiered``: XLA's column-tiered path (ops/reference.py spmm_tiered_xla);
- ``coo``: ``spmm_coo``, gather then segment-sum — the reference's
  gather + atomic scatter-add design in plain JAX.

Forward is Y = A @ X; "fwd+bwd" is the VJP of sum(Y * W), which runs the
transpose plan. Times are medians of block_until_ready'd calls. With
``--trace`` one forward of each variant is traced and the device time per
kernel name is reported. Prints one JSON line and writes it to
``chiprun_out/spmm_variants_<graph>_d<d>.json``.

    python tools/spmm_variants.py --graph ogbn-products --d 128
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="ogbn-products")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from of_spmm.data.graphs import load_graph
    from of_spmm.models.gcn import normalized_adjacency
    from of_spmm.ops.autograd import make_operator, spmm, spmm_coo
    from of_spmm.utils.config import enable_compile_cache
    from of_spmm.utils.device import device_record, require_gpu
    from of_spmm.utils.roofline import (SpmmTraffic, time_fn,
                                        trace_kernel_times)

    enable_compile_cache()
    require_gpu()
    rec = {"graph": args.graph, "d": args.d, "device": device_record()}
    log(rec["device"])

    t0 = time.time()
    csr, _ = load_graph(args.graph, symmetrize=True)
    adj = normalized_adjacency(csr)
    rec["load_s"] = time.time() - t0
    t0 = time.time()
    op = make_operator(adj, layout="binned")
    jax.block_until_ready(op)
    rec["binned_plan_s"] = time.time() - t0
    t0 = time.time()
    op_t = make_operator(adj, layout="tiered", keep_coo=False)
    jax.block_until_ready(op_t)
    rec["tiered_plan_s"] = time.time() - t0
    n = adj.shape[0]
    rec["nnz"] = int(adj.nnz)
    rec["buckets"] = [list(b.cols.shape) for b in op.binned.buckets]
    traffic = SpmmTraffic(nnz=adj.nnz, n_rows=n, n_cols=n, d=args.d)
    rec["speed_of_light_ms"] = traffic.speed_of_light_s() * 1e3
    log(f"plans ready: {rec}")

    key = jax.random.key(0)
    x = jax.random.normal(key, (n, args.d), jnp.float32)
    w = jax.random.normal(jax.random.key(1), (n, args.d), jnp.float32)

    fwd = {
        "pallas": (op, lambda o, xx: spmm(o, xx, impl="pallas")),
        "xla": (op, lambda o, xx: spmm(o, xx, impl="xla")),
        "tiered": (op_t, lambda o, xx: spmm(o, xx, impl="xla")),
        "coo": (op, lambda o, xx: spmm_coo(o.coo_rows, o.coo_cols,
                                           o.coo_vals, xx, n)),
    }

    y_ref = jax.jit(fwd["xla"][1])(op, x)
    scale = float(jnp.max(jnp.abs(y_ref)))
    rec["fwd_ms"], rec["fwd_bwd_ms"], rec["max_err_vs_xla"] = {}, {}, {}
    for name, (o, f) in fwd.items():
        jf = jax.jit(f)
        y = jf(o, x)
        rec["max_err_vs_xla"][name] = float(jnp.max(jnp.abs(y - y_ref))) / scale
        rec["fwd_ms"][name] = time_fn(jf, o, x, iters=args.iters) * 1e3
        log(f"{name}: fwd {rec['fwd_ms'][name]:.3f} ms "
            f"err {rec['max_err_vs_xla'][name]:.2e}")

        def vjp(oo, xx, ww, f=f):
            y, back = jax.vjp(lambda a: f(oo, a), xx)
            return y, back(ww)[0]

        jb = jax.jit(vjp)
        rec["fwd_bwd_ms"][name] = time_fn(jb, o, x, w, iters=args.iters) * 1e3
        log(f"{name}: fwd+bwd {rec['fwd_bwd_ms'][name]:.3f} ms")

    if args.trace:
        out_dir = os.path.join("chiprun_out", "traces")
        rec["trace_ms"] = {}
        for name in ("pallas", "xla", "tiered", "coo"):
            o, f = fwd[name]
            jf = jax.jit(f)
            jax.block_until_ready(jf(o, x))
            tdir = os.path.join(out_dir, f"{args.graph}_{name}")
            with jax.profiler.trace(tdir):
                jax.block_until_ready(jf(o, x))
            times = trace_kernel_times(tdir)
            top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
            rec["trace_ms"][name] = {k[:80]: v * 1e3 for k, v in top}
            log(f"{name} trace top kernels: {rec['trace_ms'][name]}")

    rec["peak_bytes_in_use"] = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")
    os.makedirs("chiprun_out", exist_ok=True)
    line = json.dumps(rec)
    with open(os.path.join("chiprun_out",
                           f"spmm_variants_{args.graph}_d{args.d}.json"),
              "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
