"""CI speed gate: run the SpMM bench per graph and assert thresholds.

The reference gates PRs on latency regressions
(ci/test/test_speed_multi_client.sh:29-43: ResNet50 eager/DDP thresholds);
this is the same pattern for the headline SpMM kernels. Thresholds
live in a JSON file so they ratchet with the hardware in use; a gate that
is missing is recorded by its first run on the GPU. Each bench.py runs in
its own process, strictly one after another, so only one process holds
the card at a time.

    python tools/speed_gate.py                 # gates.json next to this file
    python tools/speed_gate.py --gates my.json --update   # (re)record

Exit code 0 = all gates pass; 1 = regression (printed per gate).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_GATES = os.path.join(HERE, "gates.json")
# headroom multiplier: fail only when slower than threshold * slack
SLACK = 1.15


def run_bench(graph: str, layout: str, impls: str) -> float:
    """Returns the best roofline fraction for one bench invocation."""
    out = subprocess.run(
        [sys.executable, "-u", os.path.join(HERE, "..", "bench.py"),
         "--graph", graph, "--layout", layout, "--impls", impls,
         "--iters", "5"],
        capture_output=True, text=True, timeout=1800,
    )
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            rec = json.loads(line)
            return float(rec["value"])
    raise RuntimeError(
        f"bench produced no JSON for {graph}: {out.stderr[-500:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gates", default=DEFAULT_GATES)
    ap.add_argument("--update", action="store_true",
                    help="record current numbers as the new gates")
    args = ap.parse_args()

    # the headline kernel on every graph size, plus the plain XLA path
    configs = [
        ("cora", "auto", "xla"),
        ("cora", "auto", "pallas"),
        ("ogbn-arxiv", "auto", "pallas"),
        ("products-small", "auto", "pallas"),
        ("reddit-small", "auto", "pallas"),
        ("reddit", "auto", "pallas"),
        ("ogbn-products", "auto", "pallas"),
        ("ogbn-products", "auto", "xla"),
    ]
    if os.path.exists(args.gates):
        with open(args.gates) as f:
            gates = json.load(f)
    else:
        gates = {}

    failed = []
    for graph, layout, impls in configs:
        key = f"{graph}|{layout}|{impls}"
        frac = run_bench(graph, layout, impls)
        want = gates.get(key)
        status = "recorded" if args.update or want is None else (
            "ok" if frac * SLACK >= want else "REGRESSION")
        print(f"[gate] {key}: roofline={frac:.4f} "
              f"(gate {want if want is not None else '—'}) {status}",
              flush=True)
        if status == "REGRESSION":
            failed.append(key)
        if args.update or want is None:
            gates[key] = round(frac, 4)

    with open(args.gates, "w") as f:
        json.dump(gates, f, indent=2, sort_keys=True)
    if failed:
        print(f"FAILED gates: {failed}")
        return 1
    print("all gates pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
