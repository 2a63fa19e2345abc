"""Typed environment-variable flag system.

Analog of the reference's env flag tiers
(oneflow/core/common/env_var/env_var.h:26-48: DEFINE_ENV_BOOL/INTEGER with
defaults, read lazily at use sites). Flags are declared once with a type and
default, read from the process environment on first access, and can be
overridden programmatically for tests.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off"})


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"cannot parse boolean flag value {s!r}")


@dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str = ""


class FlagRegistry:
    """Process-wide registry of typed env flags with test overrides."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, parser: Callable[[str], Any], doc: str = "") -> None:
        with self._lock:
            if name in self._flags:
                raise ValueError(f"flag {name} already defined")
            self._flags[name] = _Flag(name, default, parser, doc)

    def define_bool(self, name: str, default: bool, doc: str = "") -> None:
        self.define(name, default, _parse_bool, doc)

    def define_int(self, name: str, default: int, doc: str = "") -> None:
        self.define(name, default, int, doc)

    def define_str(self, name: str, default: str, doc: str = "") -> None:
        self.define(name, default, str, doc)

    def get(self, name: str) -> Any:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            flag = self._flags[name]
        raw = os.environ.get(name)
        if raw is None:
            return flag.default
        return flag.parser(raw)

    def override(self, name: str, value: Optional[Any]) -> None:
        """Set (or clear, with None) a programmatic override. For tests."""
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"unknown flag {name}")
            if value is None:
                self._overrides.pop(name, None)
            else:
                self._overrides[name] = value

    def all_flags(self) -> Dict[str, Any]:
        with self._lock:
            names = list(self._flags)
        return {n: self.get(n) for n in names}


FLAGS = FlagRegistry()

# ---------------------------------------------------------------------------
# Framework flags.
# ---------------------------------------------------------------------------
FLAGS.define_bool(
    "OFS_FORCE_PALLAS_INTERPRET",
    False,
    "Run all Pallas kernels in interpreter mode (CPU tests and debugging); "
    "without it a Pallas kernel compiles for the GPU or raises.",
)
FLAGS.define_int(
    "OFS_SPMM_MAX_GATHER_SLOTS",
    2 * 1024 * 1024,
    "Max (rows*width) slots one tiered-spmm bucket may gather at once; "
    "larger buckets chunk via lax.map (bounds the materialized block: "
    "slots * d * 4 bytes of HBM).",
)
FLAGS.define_str(
    "OFS_DEFAULT_IMPL",
    "auto",
    "Default op implementation: auto | xla | pallas.",
)
FLAGS.define_int(
    "OFS_TIERED_SCATTER_BYTES",
    1_500_000_000,
    "Tiered-spmm combine strategy cutoff: plans whose ELL-row results "
    "exceed this many bytes combine by per-bucket sorted scatter-add "
    "(O(out + one bucket) memory) instead of the finish-gather over the "
    "full concat (2x concat bytes, faster for small plans).",
)


def checkout_root() -> str:
    """The directory that holds the ``of_spmm`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Where JAX keeps its persistent compile cache for this program:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path, so the cache hits across runs; listed in .gitignore)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(checkout_root(), ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and no
    other directory is configured here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
