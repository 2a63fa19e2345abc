"""Typed errors + error frames — the Maybe<T>/JUST UX, Python-native.

The reference threads a ``Maybe<T>`` error monad through every layer and
stacks human-readable frames onto failures (oneflow/core/common/maybe.h:41,
just.h:110, CHECK_OR_RETURN); a whole test family asserts the resulting
messages (python/oneflow/test/exceptions/, 47 files). Python already has
exceptions and PEP-678 notes, so the JAX expression is small:

- a typed exception hierarchy (``ShapeError``, ``PlacementError``, ...)
  so callers can catch by failure class;
- ``check(cond, ...)`` — the CHECK_OR_RETURN analog;
- ``error_frame(msg)`` — a context manager that annotates any exception
  passing through with "while <msg>" notes, producing the reference's
  stacked-frame narrative without a monad.
"""

from __future__ import annotations

import contextlib
from typing import NoReturn, Optional, Type


class OfSpmmError(Exception):
    """Base class for all framework errors."""


class ShapeError(OfSpmmError, ValueError):
    """Operand shapes/dims are inconsistent (op-level InferLogical analog)."""


class PlacementError(OfSpmmError, ValueError):
    """SBP/mesh/sharding misuse (boxing/placement-check analog)."""


class ConfigError(OfSpmmError, ValueError):
    """Bad configuration value (graph_config/env-var validation analog)."""


class PlanError(OfSpmmError, RuntimeError):
    """Plan construction failed (graph compiler analog)."""


class CapacityError(OfSpmmError, RuntimeError):
    """A fixed-capacity store overflowed (embedding cache/table)."""


def check(
    cond: bool,
    msg: str,
    exc: Type[Exception] = OfSpmmError,
) -> None:
    """CHECK_OR_RETURN: raise ``exc(msg)`` when the condition fails."""
    if not cond:
        raise exc(msg)


def check_shape(cond: bool, msg: str) -> None:
    check(cond, msg, ShapeError)


def check_placement(cond: bool, msg: str) -> None:
    check(cond, msg, PlacementError)


@contextlib.contextmanager
def error_frame(msg: str):
    """Annotate exceptions with a stacked 'while <msg>' frame (the JUST()
    call-site narrative). Notes accumulate innermost-first."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 — annotate and re-raise
        if hasattr(e, "add_note"):
            e.add_note(f"  while {msg}")
        raise
