"""Plan-time artifact cache: graphs and operator plans, pickled host-side.

Building a 10^8-nnz operator plan (symmetrize + normalize + bin + halo
planning) is minutes of host work; it is pure function of (graph, options)
and is reused across every benchmark/training run. This cache stores the
numpy-ified pytree on disk, the analog of the reference compiling a Plan
once and broadcasting it (oneflow/core/framework/nn_graph.cpp:308-319) —
except here the plan is device-independent data, so a pickle suffices.

Cache root: $OFS_CACHE_DIR, else ``<checkout>/.ofs_data`` (in .gitignore).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import jax
import numpy as np


def cache_root() -> str:
    from of_spmm.utils.config import checkout_root

    return os.environ.get(
        "OFS_CACHE_DIR", os.path.join(checkout_root(), ".ofs_data"))


def _to_host(tree: Any) -> Any:
    """numpy-ify every array leaf (device-independent, pickle-friendly)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def cache_path(kind: str, key: str) -> str:
    h = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(cache_root(), f"{kind}-{h}.pkl")


def cached(kind: str, key: str, build: Callable[[], Any], refresh: bool = False) -> Any:
    """Return the cached artifact for (kind, key), building it on miss.

    The key string should encode every option that affects the artifact
    (graph name, seed, normalization, ladder, shard count, code version).
    """
    path = cache_path(kind, key)
    if not refresh and os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            pass  # corrupt/stale cache entry: rebuild
    artifact = build()
    os.makedirs(cache_root(), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(artifact), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return artifact
