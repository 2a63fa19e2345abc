"""autoprof — side-by-side op/module timing vs torch (reference:
python/oneflow/autoprof/ + test_utils/automated_test_util/profiler.py).

The reference ships a harness that times the same op in torch and oneflow
and prints a comparison table. Same shape here, built on the dual-object
converters (testing/autotest.py): each entry runs our module under jit and
its torch twin eagerly, on identical inputs, and reports wall-clock medians
plus the ratio. CPU-vs-CPU is an apples-to-apples eager-vs-XLA comparison;
on an accelerator the torch column is skipped unless torch has a
matching device.

    from of_spmm.autoprof import profile_module, table
    rows = [profile_module(nn.Linear(512, 512), (x,)) for x in inputs]
    print(table(rows))
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ProfRow:
    name: str
    ours_ms: float
    torch_ms: Optional[float]

    @property
    def speedup(self) -> Optional[float]:
        if self.torch_ms is None or self.ours_ms <= 0:
            return None
        return self.torch_ms / self.ours_ms


def _median_ms(fn: Callable, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def profile_module(
    module,
    inputs: Sequence[np.ndarray],
    key=None,
    iters: int = 20,
    warmup: int = 3,
    with_torch: bool = True,
) -> ProfRow:
    """Median forward latency of one module, ours (jit) vs torch twin."""
    key = key if key is not None else jax.random.key(0)
    params = module.init(key)
    jinputs = [jnp.asarray(x) for x in inputs]

    @jax.jit
    def fwd(params, *xs):
        out = module.apply(params, *xs)
        return out[0] if isinstance(out, tuple) else out

    ours_ms = _median_ms(
        lambda: jax.block_until_ready(fwd(params, *jinputs)), iters, warmup
    )

    torch_ms = None
    if with_torch:
        try:
            import torch

            from of_spmm.testing.autotest import _torch_forward, torch_equivalent

            tm, _ = torch_equivalent(module, params)
            tm = tm.eval()
            tinputs = [torch.from_numpy(np.asarray(x)) for x in inputs]
            with torch.no_grad():
                torch_ms = _median_ms(
                    lambda: _torch_forward(tm, tinputs, module), iters, warmup
                )
        except (ImportError, NotImplementedError):
            pass

    return ProfRow(name=type(module).__name__, ours_ms=ours_ms,
                   torch_ms=torch_ms)


def table(rows: Sequence[ProfRow]) -> str:
    """Render the comparison table (reference autoprof output shape)."""
    w = max([len(r.name) for r in rows], default=4)
    out = [f"{'module':<{w}}  {'ours ms':>9}  {'torch ms':>9}  {'speedup':>8}"]
    for r in rows:
        t = f"{r.torch_ms:9.3f}" if r.torch_ms is not None else "      n/a"
        s = f"{r.speedup:8.2f}" if r.speedup is not None else "     n/a"
        out.append(f"{r.name:<{w}}  {r.ours_ms:9.3f}  {t}  {s}")
    return "\n".join(out)
