"""distributed — multi-host bootstrap (reference: oneflow distributed env).

The reference bootstraps with MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK env
vars (python/oneflow/framework/env_util.py:155-164) set by its launcher
(python/oneflow/distributed/launch.py), then runs a gRPC rendezvous
(oneflow/core/control/ctrl_bootstrap.cpp). The JAX equivalent is
jax.distributed.initialize + the JAX coordination service; this module
adapts the same env contract onto it and exposes the rank/world accessors
the reference API provides (flow.env.get_rank() etc.).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def env_spec() -> dict:
    """Read the reference's env contract (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK); all-or-nothing like env_util.py:155-164."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    present = [k for k in keys if k in os.environ]
    if not present:
        return {}
    if len(present) != len(keys):
        missing = set(keys) - set(present)
        raise RuntimeError(
            f"partial distributed env: {sorted(present)} set but "
            f"{sorted(missing)} missing (all four are required)"
        )
    return {
        "coordinator_address": f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        "num_processes": int(os.environ["WORLD_SIZE"]),
        "process_id": int(os.environ["RANK"]),
    }


_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-process JAX from args or the env contract.

    No-op for single-process (the reference also defaults to a local
    single-process env when the vars are absent).
    """
    global _initialized
    if _initialized:
        return
    spec = env_spec()
    if coordinator_address is not None:
        spec = {
            "coordinator_address": coordinator_address,
            "num_processes": num_processes,
            "process_id": process_id,
        }
    if not spec or spec.get("num_processes", 1) <= 1:
        _initialized = True
        return
    jax.distributed.initialize(**spec)
    _initialized = True


def get_rank() -> int:
    """flow.env.get_rank()"""
    return jax.process_index()


def get_world_size() -> int:
    """flow.env.get_world_size() (process count, not chip count)"""
    return jax.process_count()


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def is_multi_client() -> bool:
    return jax.process_count() > 1


def barrier() -> None:
    """Cross-host sync point (the reference's ctrl barrier). Uses a tiny
    psum across all devices; single-process: no-op."""
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("of_spmm.barrier")
