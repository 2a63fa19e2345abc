"""Benchmark driver — prints ONE JSON line on stdout.

Headline metric (BASELINE.md north star): CSR SpMM roofline fraction on the
ogbn-products-shaped workload (124M nnz, 128-dim fp32 features) on the
GPU; it refuses to run on any other backend. The JSON names the device
(platform, device_kind, count, nvidia-smi name and power limit). Details
(per-impl timings, per-graph sweeps) go to stderr.

Usage:
    python bench.py                  # headline graph (env OFS_BENCH_GRAPH)
    python bench.py --graph cora --sweep
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_graph(name: str, d: int = 128, iters: int = 8, impls=("xla", "pallas"),
                tier_size=None, layout="auto", shuffled=False):
    """Time Y = A @ X per impl with delta timing: k1 vs k2 chained SpMMs
    inside one jitted computation (y <- A_hat y on the normalized adjacency,
    so values stay bounded); the difference cancels the fixed per-call
    launch and host round trip."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from of_spmm.data.graphs import load_graph
    from of_spmm.models.gcn import normalized_adjacency
    from of_spmm.ops.autograd import make_operator, spmm_internal
    from of_spmm.utils.roofline import SpmmTraffic, spmm_report, time_chained

    from of_spmm.data.cache import cached
    from of_spmm.ops.autograd import place_operator

    t0 = time.time()

    def build():
        csr, cfg = load_graph(name, symmetrize=True)
        csr = normalized_adjacency(csr)  # bounded spectrum -> safe to chain
        reorder_s = 0.0
        if shuffled:
            # EARN the locality (VERDICT r3 item 3): destroy the
            # generator's community-contiguous ids with a random
            # permutation, then recover them with the committed
            # multilevel matching pass — the headline is no longer
            # conditional on pre-clustered input.
            import numpy as _np

            from of_spmm.sparse.formats import COO as _COO, CSR as _CSR
            from of_spmm.sparse.reorder import reorder_locality

            n = csr.shape[0]
            perm = _np.random.default_rng(123).permutation(n)
            rows = _np.repeat(
                _np.arange(n),
                _np.diff(_np.asarray(csr.indptr, _np.int64)))
            csr = _CSR.from_coo(_COO.from_arrays(
                perm[rows].astype(_np.int32),
                perm[_np.asarray(csr.cols, _np.int64)].astype(_np.int32),
                _np.asarray(csr.vals), csr.shape))
            t_r = time.time()
            csr, _ofn, _nfo = reorder_locality(csr, "match")
            reorder_s = time.time() - t_r
        t_b = time.time()
        op = make_operator(csr, place=False, tier_size=tier_size,
                           keep_coo=False, layout=layout)
        # COLD build seconds, stored in the cache record so warm runs
        # still report what a from-scratch build cost (VERDICT r3 #7)
        return op, csr.nnz, csr.shape, reorder_s, time.time() - t_b

    ts_key = f"|ts{tier_size}" if tier_size else ""
    ts_key += "|shufmatch-v2" if shuffled else ""
    ly_key = f"|ly-{layout}" if layout != "auto" else ""
    cv = cached(
        "op", f"{name}|sym|gcn-norm|auto-ladder|v5{ts_key}{ly_key}", build)
    op, nnz, shape = cv[:3]
    # scalars come back as 0-d numpy arrays from warm cache loads (the
    # cache numpy-ifies every pytree leaf)
    reorder_s = float(cv[3]) if len(cv) > 3 else 0.0
    cold_build_s = float(cv[4]) if len(cv) > 4 else None
    plan_build_s = time.time() - t0
    log(f"[{name}] plan ready: n={shape[0]:,} nnz={nnz:,} "
        f"({plan_build_s:.1f}s"
        + (f"; cold build {cold_build_s:.1f}s" if cold_build_s else "")
        + (f"; shuffled, match reorder {reorder_s:.1f}s" if shuffled
           else "") + ")")
    t0 = time.time()
    op = place_operator(op)
    eff = op.binned.padding_efficiency(nnz)
    from of_spmm.sparse.tiled import TieredEll

    if isinstance(op.binned, TieredEll):
        layout_s = f"tiered x{len(op.binned.tiers)}"
        widths = sorted({b.width for t in op.binned.tiers for b in t.buckets})
    else:
        layout_s = "binned"
        widths = [b.width for b in op.binned.buckets]
    log(
        f"[{name}] placed: {layout_s} widths={widths}"
        f" pad_eff={eff:.3f} relabeled={op.relabeled}"
        f" sym_alias={op.transpose_aliased} ({time.time()-t0:.1f}s)"
    )

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((shape[1], d)).astype(np.float32))
    x_int = op.to_internal(x)

    traffic = SpmmTraffic(nnz=nnz, n_rows=shape[0], n_cols=shape[1], d=d)
    results = {}
    results["_meta"] = {"plan_build_s": round(plan_build_s, 2),
                        "layout": layout_s, "failures": {}}
    if cold_build_s is not None:
        results["_meta"]["cold_build_s"] = round(cold_build_s, 2)
    if shuffled:
        results["_meta"]["reorder_s"] = round(reorder_s, 2)

    for impl_name in impls:
        try:
            def mk(k, impl=impl_name):
                # op passed as a pytree ARGUMENT: closing over it would bake
                # the plan arrays into the program as giant literals.
                def f(o, xx):
                    def body(i, carry):
                        s, a = carry
                        y = spmm_internal(o, a, impl=impl)
                        return (s + y.ravel()[0] * 1e-30, y)
                    return jax.lax.fori_loop(0, k, body, (0.0, xx))[1]
                return jax.jit(f)

            secs = time_chained(
                mk, op, x_int, k1=1, iters=iters,
                est_iter_s=traffic.speed_of_light_s(),
            )
            rep = spmm_report(secs, traffic)
            results[impl_name] = rep
            log(
                f"[{name}] {impl_name}: {secs*1e3:.3f} ms/spmm  "
                f"{rep['gflops']:.1f} GF/s  {rep['achieved_gb_s']:.1f} GB/s  "
                f"roofline={rep['roofline_fraction']:.3f}  "
                f"(SoL {rep['speed_of_light_ms']:.3f} ms)"
            )
        except Exception as e:  # report every impl; main() exits non-zero
            # when the headline impl is among the failures
            log(f"[{name}] {impl_name} FAILED: {type(e).__name__}: {e}")
            results["_meta"]["failures"][impl_name] = (
                f"{type(e).__name__}: {e}"[:300])
    return results


def bench_spgemm(name: str, iters: int = 3):
    """SpGEMM A@A 2-hop expansion (BASELINE config 4: functional + measured).

    Two numbers: the host Gustavson plan-time op (native SPA when the
    toolchain is present) and the DEVICE numeric phase (symbolic pattern
    fixed host-side once, multiply-accumulate on the device)."""
    import jax
    import numpy as np

    from of_spmm import native
    from of_spmm.data.graphs import load_graph
    from of_spmm.ops.autograd import spgemm_numeric, spgemm_symbolic
    from of_spmm.ops.reference import spgemm

    csr, cfg = load_graph(name, symmetrize=True)
    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols)
    # FLOPs: every (i,k) nonzero of A multiplies against B's row k
    products = int((indptr[cols + 1] - indptr[cols]).sum())
    times = []
    out_nnz = 0
    for _ in range(iters):
        t0 = time.time()
        c = spgemm(csr, csr)
        times.append(time.time() - t0)
        out_nnz = c.nnz
    sec = sorted(times)[len(times) // 2]
    gflops = 2 * products / sec / 1e9
    log(f"[spgemm {name}] host native={native.available()} {sec*1e3:.0f} ms  "
        f"{gflops:.2f} GFLOP/s  in_nnz={csr.nnz:,} out_nnz={out_nnz:,} "
        f"products={products:,}")

    # device numeric phase: bucket-padded gathers + reshape-sum,
    # delta-chained
    import jax.numpy as jnp

    from of_spmm.ops.autograd import (spgemm_numeric_padded,
                                          spgemm_symbolic_padded)
    from of_spmm.utils.roofline import time_chained

    t0 = time.time()
    plan = spgemm_symbolic_padded(csr, csr)
    sym_s = time.time() - t0
    av = jax.device_put(jnp.asarray(np.asarray(csr.vals), jnp.float32))
    buckets = jax.device_put(plan.buckets)

    def mk(k):
        def f(bk, a):
            def body(i, carry):
                s, aa = carry
                v = spgemm_numeric_padded(bk, aa, aa)
                return (s + v[0] * 1e-30, aa + v[0:1] * 1e-30)
            return jax.lax.fori_loop(0, k, body, (0.0, a))[1]
        return jax.jit(f)

    dev_s = time_chained(mk, buckets, av, k1=1, iters=max(iters, 4),
                         est_iter_s=products / 5e9)
    dev_gflops = 2 * products / dev_s / 1e9
    log(f"[spgemm {name}] device numeric {dev_s*1e3:.1f} ms  "
        f"{dev_gflops:.2f} GFLOP/s  (symbolic {sym_s:.1f}s host, "
        f"padded buckets)")

    # product-form numeric (r5): COO-with-dups values in product order —
    # the slot merge moves to the consumer (the framework's sparse
    # engines accept duplicate edges), so the device phase loses the
    # per-product single-element takes (ops/autograd.py
    # ProductSpgemmPlan)
    from of_spmm.ops.autograd import (spgemm_numeric_products,
                                          spgemm_symbolic_products)

    t0 = time.time()
    pplan = spgemm_symbolic_products(csr, csr)
    psym_s = time.time() - t0

    def mkp(k):
        def f(pl, a):
            def body(i, carry):
                s, aa = carry
                v = spgemm_numeric_products(pl, aa, aa)
                return (s + v[0] * 1e-30, aa + v[0:1] * 1e-30)
            return jax.lax.fori_loop(0, k, body, (0.0, a))[1]
        return jax.jit(f)

    prod_s = time_chained(mkp, pplan, av, k1=1, iters=max(iters, 4),
                          est_iter_s=products / 20e9)
    prod_gflops = 2 * products / prod_s / 1e9
    log(f"[spgemm {name}] device product-form {prod_s*1e3:.1f} ms  "
        f"{prod_gflops:.2f} GFLOP/s  (symbolic {psym_s:.1f}s host, "
        f"n_out={pplan.n_out:,} for {products:,} products)")
    return {"seconds": sec, "gflops": gflops, "out_nnz": out_nnz,
            "device_seconds": dev_s, "device_gflops": dev_gflops,
            "device_products_seconds": prod_s,
            "device_products_gflops": prod_gflops}


def bench_spmv(name: str, iters: int = 8):
    """CSR SpMV (BASELINE config 1): parity vs the reference gather/
    segment-sum semantics + measured ms."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from of_spmm.data.graphs import load_graph
    from of_spmm.models.gcn import normalized_adjacency
    from of_spmm.ops.autograd import make_operator, spmv

    csr, cfg = load_graph(name, symmetrize=True)
    csr = normalized_adjacency(csr)
    op = make_operator(csr, place=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(csr.shape[1]).astype(np.float32))
    f = jax.jit(lambda o, v: spmv(o, v))
    y = f(op, x)
    y.block_until_ready()
    # parity vs numpy CSR
    indptr = np.asarray(csr.indptr).astype(np.int64)
    want = np.zeros(csr.shape[0], np.float32)
    xv = np.asarray(x)
    contrib = np.asarray(csr.vals) * xv[np.asarray(csr.cols)]
    np.add.at(want, np.repeat(np.arange(csr.shape[0]), np.diff(indptr)),
              contrib)
    rel = float(np.abs(np.asarray(y) - want).max()
                / (np.abs(want).max() + 1e-12))
    # delta-chained timing (utils/roofline.py time_chained): v <- A_hat v
    # inside one jit, k1 vs k2, so per-call launch cost cancels
    from of_spmm.utils.roofline import time_chained

    def mk(k):
        def g(o, v):
            def body(i, carry):
                s, a = carry
                yy = spmv(o, a)
                return (s + yy[0] * 1e-30, yy)
            return jax.lax.fori_loop(0, k, body, (0.0, v))[1]
        return jax.jit(g)

    sec = time_chained(mk, op, x, k1=1, iters=iters, est_iter_s=1e-4)
    log(f"[spmv {name}] {sec*1e6:.1f} us  parity rel={rel:.2e}")
    return {"us": sec * 1e6, "parity_rel": rel}


def bench_all(args):
    """BASELINE.md measurement matrix in one run (VERDICT r1 item 3):
    Cora/Citeseer SpMV+SpMM parity+ms, Reddit row-binned load-balance
    efficiency, ogbn-arxiv SpGEMM (host + device numeric), plus the
    ogbn-products headline roofline."""
    extras = {}
    for g in ("cora", "citeseer"):
        extras[f"spmv_{g}"] = bench_spmv(g, iters=args.iters)
        r = bench_graph(g, d=args.d, iters=args.iters, impls=("xla",))
        if "xla" in r:
            extras[f"spmm_{g}"] = {
                "ms": r["xla"]["seconds"] * 1e3,
                "roofline": r["xla"]["roofline_fraction"]}

    # Reddit row-binned load balance: efficiency = nnz / padded lane slots
    # (ideal-nnz-time / achieved under the ELL padding model) + measured ms
    import jax.numpy as jnp
    import numpy as np

    from of_spmm.data.graphs import load_graph
    from of_spmm.models.gcn import normalized_adjacency
    from of_spmm.ops.autograd import make_operator, place_operator, spmm_internal
    from of_spmm.utils.roofline import SpmmTraffic, spmm_report, time_chained
    import jax

    rname = args.reddit
    csr, cfg = load_graph(rname, symmetrize=True)
    csr = normalized_adjacency(csr)
    op = make_operator(csr, place=False, layout="binned")
    eff = op.binned.padding_efficiency(csr.nnz)
    op = place_operator(op)
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal((csr.shape[1], args.d))
                    .astype(np.float32))

    def mk(k):
        def f(o, xx):
            def body(i, carry):
                s, a = carry
                y = spmm_internal(o, a, impl="xla")
                return (s + y.ravel()[0] * 1e-30, y)
            return jax.lax.fori_loop(0, k, body, (0.0, xx))[1]
        return jax.jit(f)

    traffic = SpmmTraffic(nnz=csr.nnz, n_rows=csr.shape[0],
                          n_cols=csr.shape[1], d=args.d)
    secs = time_chained(mk, op, x, k1=1, iters=args.iters,
                        est_iter_s=traffic.speed_of_light_s())
    rep = spmm_report(secs, traffic)
    log(f"[{rname}] row-binned: {secs*1e3:.3f} ms  load_balance_eff={eff:.3f}"
        f"  roofline={rep['roofline_fraction']:.3f}")
    extras[f"spmm_rowbinned_{rname}"] = {
        "ms": secs * 1e3, "load_balance_eff": eff,
        "roofline": rep["roofline_fraction"]}

    sp = bench_spgemm("ogbn-arxiv", iters=max(args.iters // 2, 1))
    extras["spgemm_ogbn-arxiv"] = {
        "host_ms": sp["seconds"] * 1e3, "host_gflops": sp["gflops"],
        "device_ms": sp["device_seconds"] * 1e3,
        "device_gflops": sp["device_gflops"],
        "device_products_ms": sp["device_products_seconds"] * 1e3,
        "device_products_gflops": sp["device_products_gflops"]}
    return extras


def main():
    import jax

    from of_spmm.ops.registry import lookup
    from of_spmm.utils.config import enable_compile_cache
    from of_spmm.utils.device import device_record, require_gpu

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default=os.environ.get("OFS_BENCH_GRAPH", "ogbn-products"))
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--impls", default="xla,pallas")
    ap.add_argument("--tier-size", type=int, default=None,
                    help="column tier size override (sparse/tiled.py)")
    ap.add_argument("--layout", default="auto",
                    choices=("auto", "binned", "tiered"),
                    help="plan layout (ops/autograd.py make_operator)")
    ap.add_argument("--op", default="spmm", choices=("spmm", "spgemm"),
                    help="which benchmark to run")
    ap.add_argument("--sweep", action="store_true", help="also run the small graphs")
    ap.add_argument("--all", action="store_true",
                    help="BASELINE.md measurement matrix + headline")
    ap.add_argument("--reddit", default="reddit-small",
                    help="reddit config for the load-balance row "
                         "(reddit = full 114M nnz)")
    ap.add_argument("--shuffled", action="store_true",
                    help="randomly permute node ids, then recover "
                         "locality with the matching reorder pass "
                         "(sparse/reorder.py) — the headline without "
                         "pre-clustered input")
    args = ap.parse_args()
    require_gpu()
    device = device_record()
    log(f"device: {device}")
    impls = tuple(args.impls.split(","))

    extras = bench_all(args) if getattr(args, "all", False) else None

    if args.op == "spgemm":
        g = args.graph if args.graph != "ogbn-products" else "ogbn-arxiv"
        rep = bench_spgemm(g, iters=max(args.iters // 2, 1))
        print(json.dumps({
            "metric": f"spgemm_gflops_{g}",
            # headline = the DEVICE numeric phase (product-form); the host
            # Gustavson symbolic/full op is reported alongside
            "value": round(rep["device_products_gflops"], 3),
            "unit": "GFLOP/s",
            "vs_baseline": round(rep["device_products_gflops"] / 10.0, 4),
            "host_gflops": round(rep["gflops"], 3),
            "device_padded_gflops": round(rep["device_gflops"], 3),
            "device": device,
        }))
        return 0

    if args.sweep:
        for g in ["cora", "citeseer", "ogbn-arxiv", "reddit-small"]:
            bench_graph(g, d=args.d, iters=args.iters, impls=impls,
                        tier_size=args.tier_size, layout=args.layout)

    results = bench_graph(args.graph, d=args.d, iters=args.iters,
                          impls=impls, tier_size=args.tier_size,
                          layout=args.layout, shuffled=args.shuffled)
    meta = results.pop("_meta", {})
    failures = meta.get("failures", {})
    headline_impl = lookup("spmm").resolve_impl("auto")
    best_name, best = max(
        results.items(), key=lambda kv: kv[1]["roofline_fraction"], default=(None, None)
    )
    if best is None or headline_impl in failures:
        print(json.dumps({"metric": "spmm_roofline_fraction", "value": 0.0,
                          "unit": "fraction", "vs_baseline": 0.0,
                          "failures": failures,
                          "plan_build_s": meta.get("plan_build_s"),
                          "device": device}))
        return 1
    log(f"best impl: {best_name}")
    # vs_baseline: ratio against the BASELINE.md target of 60% of the
    # device-memory roofline (>=1.0 means target met).
    out = {
        "metric": f"spmm_roofline_fraction_{args.graph}_d{args.d}"
                  + ("_shuffled" if args.shuffled else ""),
        "value": round(best["roofline_fraction"], 4),
        "unit": "fraction_of_hbm_roofline",
        "vs_baseline": round(best["roofline_fraction"] / 0.60, 4),
        "best_impl": best_name,
        "ms_per_spmm": round(best["seconds"] * 1e3, 3),
        "ms_per_impl": {k: round(v["seconds"] * 1e3, 3)
                        for k, v in results.items()},
        "layout": meta.get("layout"),
        "plan_build_s": meta.get("plan_build_s"),
        "synthetic_graphs": True,  # degree-law-matched stand-ins (no
        # network egress in this environment; see data/graphs.py)
        "device": device,
    }
    if meta.get("cold_build_s") is not None:
        out["cold_build_s"] = meta["cold_build_s"]
    if args.shuffled:
        out["reorder_s"] = meta.get("reorder_s")
    if failures:
        out["failures"] = failures
    if extras is not None:
        out["matrix"] = extras
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
