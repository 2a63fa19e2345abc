"""Smoke test of the main path on the GPU, at ogbn-products width.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the row-partitioned path only

One GPU, in order, each step printing one line:

1. device: JAX's first device must be a GPU (else a non-zero exit); prints
   nvidia-smi's name and power limit and JAX's device_kind.
2. spmm: make_operator -> spmm forward and backward (jax.vjp, which runs
   the transpose plan) on Cora (all rows) and ogbn-products at d=128 (a
   seeded sample of 65,536 rows), for the XLA and the Pallas impl, against
   a float64 scipy CSR reference of A @ X and A^T @ G.
3. gcn: five TrainGraph + Adam steps of GCN(128, 256, 47) on ogbn-products
   with a finite loss at each; the first step's loss and gradients against
   the same model under jax.default_matmul_precision("highest").
4. kernels: each kernel against its plain version at real widths, with
   both times: the Triton SpMM kernel against XLA's binned path and
   spmm_coo (gather + segment-sum) on ogbn-products d=128, and fused
   attention (flash=True, cuDNN) against plain attention at BERT-base
   widths in bf16, both also against an fp32 "highest" reference.

With --four (four GPUs), ogbn-products is row-partitioned four ways, with
the all_to_all halo and with the ragged ppermute halo (refine_slack=0.2);
dist_spmm forward and gradient are compared with the single-card spmm on a
row sample, and make_dist_train_step takes three steps.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. Any failure raises
and exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# fp32 summation order: the kernel, XLA and the reference add the same
# products in different orders. No matrix product is involved, so no TF32.
RTOL = 1e-5
ATOL_FRAC = 1e-5
# GCN's Linear layers run their fp32 matmuls in TF32 on the GPU by default
# (10-bit mantissa, ~1e-3 relative per product), against "highest".
TF32_RTOL = 1e-2
# bf16 attention: 8-bit mantissa, and the fused kernel keeps the softmax in
# fp32 where the plain path rounds probabilities to bf16.
BF16_RTOL = 2e-2
SAMPLE_ROWS = 65536
SEED = 0


def say(*a) -> None:
    print(*a, flush=True)


def compare(name: str, got, want, rtol: float = RTOL,
            atol_frac: float = ATOL_FRAC) -> str:
    """Raise unless |got - want| <= rtol*|want| + atol_frac*max|want|
    everywhere (and got is finite, same shape); returns a summary."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got - want)
    bound = rtol * np.abs(want) + atol_frac * scale
    worst = float((err / np.maximum(bound, 1e-300)).max()) if err.size else 0.0
    summary = (f"{name}: max_abs_err={float(err.max()) if err.size else 0.0:.3e}"
               f" max_ref={scale:.3e} worst_err/tol={worst:.3f}")
    if worst > 1.0:
        raise AssertionError("out of tolerance: " + summary)
    return summary


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of the run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def csr64(csr):
    """float64 scipy CSR of a package CSR (the plain reference)."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.asarray(csr.vals, np.float64), np.asarray(csr.cols),
         np.asarray(csr.indptr)), shape=csr.shape)


def sample_rows(n: int, k: int = SAMPLE_ROWS, seed: int = SEED) -> np.ndarray:
    """All rows when n <= k, else k distinct rows chosen from the seed."""
    if n <= k:
        return np.arange(n)
    return np.sort(np.random.default_rng(seed).choice(n, k, replace=False))


def check_spmm(label: str, adj, op, x, g, impls, rows) -> list:
    """spmm forward and its VJP, per impl, vs float64 A @ x and A^T @ g on
    ``rows``; returns the summary lines."""
    import jax

    from of_spmm.ops.autograd import spmm

    a64 = csr64(adj)
    at64 = a64.T.tocsr()
    x_h = np.asarray(x, np.float64)
    g_h = np.asarray(g, np.float64)
    want_y = a64[rows] @ x_h
    want_dx = at64[rows] @ g_h
    del x_h, g_h

    def fwd_bwd(o, xx, gg, impl):
        y, back = jax.vjp(lambda a: spmm(o, a, impl=impl), xx)
        return y, back(gg)[0]

    step = jax.jit(fwd_bwd, static_argnums=3)
    lines = []
    for impl in impls:
        y, dx = step(op, x, g, impl)
        lines.append(compare(f"{label} {impl} fwd", np.asarray(y[rows]),
                             want_y))
        lines.append(compare(f"{label} {impl} bwd", np.asarray(dx[rows]),
                             want_dx))
    return lines


def _device_step():
    import jax

    from of_spmm.utils.device import gpu_name_power, require_gpu

    require_gpu()
    dev = jax.devices()[0]
    say(f"device: {gpu_name_power()} | jax: {dev.platform} "
        f"{dev.device_kind} x{len(jax.devices())}")


def _load(name: str):
    import jax.numpy as jnp

    from of_spmm.data.graphs import load_graph, random_features
    from of_spmm.models.gcn import normalized_adjacency

    t0 = time.time()
    csr, cfg = load_graph(name, symmetrize=True)
    adj = normalized_adjacency(csr)
    x, y = random_features(cfg, seed=SEED)
    g = np.random.default_rng(SEED + 7).standard_normal(
        x.shape).astype(np.float32)
    return adj, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(g), \
        time.time() - t0


def run_one() -> None:
    import jax
    import jax.numpy as jnp

    from of_spmm import optim
    from of_spmm.graph import GraphConfig, TrainGraph
    from of_spmm.models import GCN
    from of_spmm.nn.attention import MultiheadAttention
    from of_spmm.ops.autograd import make_operator, spmm, spmm_coo
    from of_spmm.ops.registry import lookup
    from of_spmm.utils.roofline import SpmmTraffic, time_fn

    _device_step()
    auto = lookup("spmm").resolve_impl("auto")
    impls = ("xla", "pallas")

    # --- 2. SpMM forward + backward vs float64 -------------------------
    adj, cfg, x, y, g, _ = _load("cora")
    op = make_operator(adj)
    lines = check_spmm("cora", adj, op, x, g, impls, sample_rows(adj.shape[0]))
    adj, cfg, x, y, g, load_s = _load("ogbn-products")
    t0 = time.time()
    op = make_operator(adj)
    jax.block_until_ready(op)
    plan_s = time.time() - t0
    rows = sample_rows(adj.shape[0])
    lines += check_spmm("ogbn-products d128", adj, op, x, g, impls, rows)
    say(f"spmm: auto={auto} | ogbn-products n={adj.shape[0]:,} "
        f"nnz={adj.nnz:,} load {load_s:.1f}s plan {plan_s:.1f}s | "
        + " | ".join(lines))

    # --- 3. GCN training on ogbn-products ------------------------------
    model = GCN(feature_dims=(cfg.feature_dim, 256, cfg.n_classes))
    params = model.init(jax.random.key(SEED))
    l0, g0 = jax.jit(jax.value_and_grad(model.loss_fn))(params, op, x, y)
    with jax.default_matmul_precision("highest"):
        lh, gh = jax.jit(jax.value_and_grad(model.loss_fn))(params, op, x, y)
    cmp = [compare("loss", np.asarray(l0)[None], np.asarray(lh)[None],
                   rtol=TF32_RTOL, atol_frac=0.0)]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g0),
                            jax.tree_util.tree_leaves(gh)):
        cmp.append(compare("grad" + jax.tree_util.keystr(path), a, b,
                           rtol=TF32_RTOL, atol_frac=TF32_RTOL))
    # the operator is a step ARGUMENT: closing over it would bake the plan
    # arrays into the program as literals
    graph = TrainGraph(lambda p, o, xx, yy: model.loss_fn(p, o, xx, yy),
                       optim.adam(lr=1e-2), params,
                       config=GraphConfig(clip_grad_norm=5.0))
    losses, step_s = [], []
    for _ in range(5):
        t0 = time.time()
        loss = float(graph(op, x, y)["loss"])
        step_s.append(time.time() - t0)
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite GCN loss {loss} at step "
                                 f"{len(losses)}")
        losses.append(loss)
    say("gcn: ogbn-products GCN(128, 256, 47) 5 Adam steps losses="
        + ",".join(f"{v:.5f}" for v in losses)
        + " step_s=" + ",".join(f"{v:.3f}" for v in step_s)
        + f" (first includes compile) | vs highest precision, tf32 "
        f"tol {TF32_RTOL}: " + " | ".join(cmp))

    # --- 4. kernels vs their plain versions ----------------------------
    n = adj.shape[0]
    variants = {
        "pallas": lambda o, xx: spmm(o, xx, impl="pallas"),
        "xla": lambda o, xx: spmm(o, xx, impl="xla"),
        "coo": lambda o, xx: spmm_coo(o.coo_rows, o.coo_cols, o.coo_vals,
                                      xx, n),
    }
    y_xla = jax.jit(variants["xla"])(op, x)
    times = []
    for name, f in variants.items():
        jf = jax.jit(f)
        cmp_line = compare(f"{name} vs xla", jf(op, x), y_xla)

        def fb(o, xx, gg, f=f):
            yy, back = jax.vjp(lambda a: f(o, a), xx)
            return yy, back(gg)[0]

        t_f = time_fn(jf, op, x, iters=10)
        t_fb = time_fn(jax.jit(fb), op, x, g, iters=10)
        times.append(f"{name} fwd {t_f * 1e3:.3f} ms fwd+bwd "
                     f"{t_fb * 1e3:.3f} ms ({cmp_line})")
    sol = SpmmTraffic(nnz=adj.nnz, n_rows=n, n_cols=n,
                      d=x.shape[1]).speed_of_light_s()
    E, H, B, T = 768, 12, 8, 512
    plain = MultiheadAttention(E, H)
    fused = MultiheadAttention(E, H, flash=True)
    p_att = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                   plain.init(jax.random.key(1)))
    xa = jax.random.normal(jax.random.key(2), (B, T, E), jnp.bfloat16)
    f_plain = jax.jit(lambda p, a: plain.apply(p, a))
    f_fused = jax.jit(lambda p, a: fused.apply(p, a))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, a: plain.apply(p, a))(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p_att),
            xa.astype(jnp.float32))
    o_fused = f_fused(p_att, xa).astype(jnp.float32)
    o_plain = f_plain(p_att, xa).astype(jnp.float32)
    att_cmp = "; ".join(
        compare(name, got, want, rtol=BF16_RTOL, atol_frac=BF16_RTOL)
        for name, got, want in (("flash vs fp32", o_fused, ref),
                                ("plain vs fp32", o_plain, ref),
                                ("flash vs plain", o_fused, o_plain)))
    t_plain = time_fn(f_plain, p_att, xa, iters=10)
    t_fused = time_fn(f_fused, p_att, xa, iters=10)
    say(f"kernels: spmm ogbn-products d128 (speed of light "
        f"{sol * 1e3:.3f} ms): " + " | ".join(times)
        + f" || attention B={B} T={T} {H}x{E // H} bf16 "
        f"({lookup('dot_product_attention').resolve_impl()}): flash "
        f"{t_fused * 1e3:.3f} ms plain {t_plain * 1e3:.3f} ms ({att_cmp})")


def run_four() -> None:
    import jax

    from of_spmm.models import GCN
    from of_spmm.ops.autograd import make_operator, spmm
    from of_spmm.parallel.dist_spmm import default_mesh, dist_spmm
    from of_spmm.parallel.partition import partition_rows, place_plan
    from of_spmm.train import make_dist_train_step

    _device_step()
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, have {len(jax.devices())}")
    mesh = default_mesh(4)
    adj, cfg, x, y, g, load_s = _load("ogbn-products")
    rows = sample_rows(adj.shape[0])
    op = make_operator(adj)

    def fwd_bwd(o, xx, gg):
        yy, back = jax.vjp(lambda a: spmm(o, a), xx)
        return yy, back(gg)[0]

    y1, dx1 = jax.jit(fwd_bwd)(op, x, g)
    y1, dx1 = np.asarray(y1[rows]), np.asarray(dx1[rows])
    del op

    def dist_fwd_bwd(p, xx, gg):
        yy, back = jax.vjp(lambda a: dist_spmm(p, a, mesh), xx)
        return yy, back(gg)[0]

    lines = []
    plans = {
        "all_to_all": dict(),
        "ragged refine_slack=0.2": dict(ragged=True, refine_slack=0.2),
    }
    first = None
    for name, kw in plans.items():
        t0 = time.time()
        plan = partition_rows(adj, 4, **kw)
        build_s = time.time() - t0
        first = first or plan
        yd, dxd = jax.jit(dist_fwd_bwd)(place_plan(plan, mesh), x, g)
        lines.append(
            f"{name} (plan {build_s:.1f}s, halo_fraction "
            f"{plan.halo_fraction:.3f}): "
            + compare("fwd vs 1-card", np.asarray(yd[rows]), y1) + "; "
            + compare("grad vs 1-card", np.asarray(dxd[rows]), dx1))
    model = GCN(feature_dims=(cfg.feature_dim, 256, cfg.n_classes))
    params = model.init(jax.random.key(SEED))
    step = make_dist_train_step(model, first, mesh)
    losses = []
    for _ in range(3):
        loss, params = step(params, x, y)
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite distributed loss {loss}")
        losses.append(loss)
    say(f"dist: ogbn-products n={adj.shape[0]:,} nnz={adj.nnz:,} over 4 "
        f"GPUs | " + " | ".join(lines) + " | make_dist_train_step losses="
        + ",".join(f"{v:.5f}" for v in losses))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU row-partitioned path")
    args = ap.parse_args(argv)

    import jax

    from of_spmm.utils.config import enable_compile_cache

    enable_compile_cache()
    run_four() if args.four else run_one()
    dev = jax.devices()[0]
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
