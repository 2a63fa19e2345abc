"""Roofline model + timing harness for the sparse kernels.

The analog of the reference's CI speed gates
(ci/test/test_speed_multi_client.sh): SpMM traffic is dominated by the nnz
row-gathers of the dense operand, so speed-of-light is
bytes_moved / device-memory bandwidth.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import jax


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, no sparsity)."""

    hbm_bytes_per_s: float
    fp32_flops: float
    tf32_flops: float
    bf16_flops: float
    source: str


# One entry per ``jax.devices()[0].device_kind``. A device that is not
# listed is an error, never a default.
PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_bytes_per_s=3.35e12, fp32_flops=67e12, tf32_flops=495e12,
        bf16_flops=989e12,
        source="NVIDIA H100 data sheet, SXM5, dense, 700 W"),
}


def device_peaks(kind: Optional[str] = None) -> DevicePeaks:
    """Peaks for ``kind`` (default: the first JAX device's device_kind)."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(PEAKS)}")
    return PEAKS[kind]


@dataclasses.dataclass(frozen=True)
class SpmmTraffic:
    """Minimum device-memory traffic of one Y = A @ X (bytes)."""

    nnz: int
    n_rows: int
    n_cols: int
    d: int
    bytes_val: int = 4
    bytes_idx: int = 4

    @property
    def gather_bytes(self) -> int:
        return self.nnz * self.d * self.bytes_val  # X row reads (dominant)

    @property
    def structure_bytes(self) -> int:
        return self.nnz * (self.bytes_val + self.bytes_idx)  # vals + cols

    @property
    def output_bytes(self) -> int:
        return self.n_rows * self.d * self.bytes_val

    @property
    def total_bytes(self) -> int:
        return self.gather_bytes + self.structure_bytes + self.output_bytes

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.d

    def speed_of_light_s(self, peak_bw: Optional[float] = None) -> float:
        return self.total_bytes / (peak_bw or device_peaks().hbm_bytes_per_s)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall-clock seconds of fn(*args), each call ended by
    block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_chained(
    make_chained: Callable[[int], Callable],
    *args,
    k1: int = 1,
    k2: Optional[int] = None,
    warmup: int = 2,
    iters: int = 8,
    est_iter_s: Optional[float] = None,
    target_marginal_s: float = 0.1,
    max_chain: int = 4096,
) -> float:
    """Per-iteration seconds via delta timing, cancelling fixed dispatch cost.

    ``make_chained(k)`` must return a jitted fn running the op k times
    back-to-back (data-dependent chain). Returns
    (t(k2) - t(k1)) / (k2 - k1) — the marginal cost of one iteration,
    free of the per-call launch and host round trip.

    If ``k2`` is None it is chosen from ``est_iter_s`` (e.g. the
    speed-of-light estimate) so that the marginal work is at least
    ``target_marginal_s``. If the measured delta is still below the
    run-to-run noise, the chain is lengthened and re-measured (up to
    ``max_chain``).
    """
    if k2 is None:
        est = est_iter_s or 1e-3
        k2 = k1 + min(max_chain, max(4, int(target_marginal_s / est)))
    f1 = make_chained(k1)
    t1 = time_fn(f1, *args, warmup=warmup, iters=iters)
    while True:
        f2 = make_chained(k2)
        t2 = time_fn(f2, *args, warmup=warmup, iters=iters)
        delta = t2 - t1
        # Noise guard: the delta must dominate the base measurement's
        # scale; otherwise lengthen the chain (compile time is O(1) in k
        # thanks to fori_loop) and try again.
        if delta > 0.25 * t1 or (k2 - k1) >= max_chain:
            break
        k2 = min(k1 + max_chain, k1 + 4 * (k2 - k1))
    return max(delta, 1e-9) / (k2 - k1)


def spmm_report(
    seconds: float, traffic: SpmmTraffic, peak_bw: Optional[float] = None
) -> Dict[str, float]:
    bw = peak_bw or device_peaks().hbm_bytes_per_s
    return {
        "seconds": seconds,
        "gflops": traffic.flops / seconds / 1e9,
        "nnz_per_s": traffic.nnz / seconds,
        "achieved_gb_s": traffic.total_bytes / seconds / 1e9,
        "roofline_fraction": (traffic.total_bytes / seconds) / bw,
        "speed_of_light_ms": traffic.speed_of_light_s(bw) * 1e3,
        "peak_bw_gb_s": bw / 1e9,
    }


def trace_kernel_times(trace_dir: str, plane_prefix: str = "/device:GPU"
                       ) -> Dict[str, float]:
    """Device seconds per kernel name, summed over a ``jax.profiler`` trace.

    Reads every ``*.xplane.pb`` under ``trace_dir`` and sums the events on
    the device planes' stream lines (the "XLA Ops"/"XLA Modules" lines
    repeat the same time and are skipped)."""
    import glob
    import os

    from jax.profiler import ProfileData

    out: Dict[str, float] = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith(plane_prefix):
                continue
            for line in plane.lines:
                if line.name.startswith("XLA "):
                    continue
                for ev in line.events:
                    out[ev.name] = out.get(ev.name, 0.0) + ev.duration_ns * 1e-9
    return out
