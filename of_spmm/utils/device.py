"""The device a measurement ran on: JAX's view and nvidia-smi's.

Every result a benchmark prints names its device, and a measurement path
that finds no GPU fails instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import jax


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind!r}); this measurement runs only on a GPU")


def gpu_name_power() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def device_record() -> Dict[str, object]:
    """platform, device_kind and count as JAX reports them, plus the
    nvidia-smi name and power limit on a GPU."""
    devs = jax.devices()
    rec: Dict[str, object] = {"platform": devs[0].platform,
                              "kind": devs[0].device_kind,
                              "count": len(devs)}
    if devs[0].platform == "gpu":
        rec["name_power_limit"] = gpu_name_power()
    return rec
