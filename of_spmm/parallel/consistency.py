"""Cross-host consistency checking — SPMD divergence guard.

The reference rendezvous-verifies placement/SBP metadata across ranks
before global ops (NonRecursiveMetaInfoConsistencyCheckScope,
oneflow/core/framework/op_interpreter/eager_global_op_interpreter.cpp:
115-119, impl core/framework/consistency_check.cpp): if rank 0 and rank 3
disagree about a plan, the job deadlocks in a collective — better to fail
fast with a message. JAX version: hash the plan metadata on every
process and compare via a tiny all-gather on the coordination mesh.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import jax
import numpy as np


def plan_fingerprint(tree: Any) -> str:
    """Stable hash of a plan-like pytree's STRUCTURE + shapes/dtypes (not
    array payloads — those are big; metadata divergence is the failure
    mode that matters)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    meta = {
        "treedef": str(treedef),
        "leaves": [
            [list(np.shape(l)), str(np.asarray(l).dtype if not hasattr(l, "dtype") else l.dtype)]
            for l in leaves
        ],
    }
    return hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()


def check_consistent(tree: Any, name: str = "plan") -> str:
    """Raise if any process disagrees on the fingerprint of ``tree``.

    Single-process: trivially consistent. Multi-process: exchanges the
    16-byte digest through the coordination service (multihost_utils),
    failing with a per-process report instead of a collective deadlock.
    """
    fp = plan_fingerprint(tree)
    if jax.process_count() <= 1:
        return fp
    from jax.experimental import multihost_utils

    digest = np.frombuffer(bytes.fromhex(fp[:32]), dtype=np.uint8)
    all_digests = multihost_utils.process_allgather(digest)
    mine = all_digests[jax.process_index()]
    bad = [
        int(r) for r in range(all_digests.shape[0])
        if not np.array_equal(all_digests[r], mine)
    ]
    if bad:
        raise RuntimeError(
            f"consistency check failed for {name!r}: processes {bad} "
            f"disagree with process {jax.process_index()} "
            f"(local fingerprint {fp[:16]}...). All processes must build "
            f"identical plans — check seeds and input data."
        )
    return fp
