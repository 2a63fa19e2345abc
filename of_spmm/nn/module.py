"""Minimal module system: dataclass configs + pure init/apply functions.

The JAX re-expression of the reference's nn.Module surface
(python/oneflow/nn/modules/, 63 module files): a module is an immutable
dataclass describing the layer; parameters and mutable state (e.g.
BatchNorm running stats) are separate pytrees that flow through jit, grad,
and shard_map unchanged. There is no parameter registration machinery —
the pytree IS the registry.

Protocol (duck-typed, see also models/gcn.py):
    init(key) -> params                       # parameter pytree
    init_state() -> state | None              # mutable buffers (optional)
    apply(params, x, *, state=None, train=False, rng=None)
        -> y                                   (stateless modules)
        -> (y, new_state)                      (stateful modules, train=True)

``Sequential`` threads params/state/rng through a list of modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def param_count(params: Any) -> int:
    """Total number of scalar parameters in a pytree."""
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))


def param_bytes(params: Any) -> int:
    return sum(
        int(x.size) * jnp.dtype(x.dtype).itemsize
        for x in jax.tree_util.tree_leaves(params)
    )


def is_stateful(module: Any) -> bool:
    """True if the module declares mutable state (init_state not None)."""
    fn = getattr(module, "init_state", None)
    return fn is not None and fn() is not None


def split_rng(rng: Optional[jax.Array], n: int):
    """Split an optional rng into n optional keys."""
    if rng is None:
        return [None] * n
    return list(jax.random.split(rng, n))


@dataclasses.dataclass(frozen=True)
class Sequential:
    """Compose modules; params/state keyed "layer_<i>" (matching models/)."""

    layers: Tuple[Any, ...]

    def __init__(self, *layers: Any):
        object.__setattr__(
            self, "layers", layers[0] if len(layers) == 1 and isinstance(layers[0], (tuple, list)) else layers
        )

    def init(self, key) -> dict:
        keys = jax.random.split(key, max(len(self.layers), 1))
        out = {}
        for i, layer in enumerate(self.layers):
            init = getattr(layer, "init", None)
            out[f"layer_{i}"] = init(keys[i]) if init is not None else {}
        return out

    def init_state(self) -> Optional[dict]:
        states = {}
        any_state = False
        for i, layer in enumerate(self.layers):
            fn = getattr(layer, "init_state", None)
            s = fn() if fn is not None else None
            states[f"layer_{i}"] = s
            any_state = any_state or s is not None
        return states if any_state else None

    def apply(self, params, x, *, state=None, train: bool = False,
              rng: Optional[jax.Array] = None):
        rngs = split_rng(rng, len(self.layers))
        new_state = dict(state) if state is not None else None
        for i, layer in enumerate(self.layers):
            p = params.get(f"layer_{i}", {})
            s = state.get(f"layer_{i}") if state is not None else None
            if s is not None:
                x, s2 = layer.apply(p, x, state=s, train=train, rng=rngs[i])
                new_state[f"layer_{i}"] = s2
            elif callable(layer) and not hasattr(layer, "apply"):
                x = layer(x)  # bare activation function
            else:
                x = layer.apply(p, x, train=train, rng=rngs[i])
        if new_state is not None:
            return x, new_state
        return x
