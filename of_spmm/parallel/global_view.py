"""Global view: SBP-style placement of arrays/pytrees on a device mesh.

The JAX re-expression of the reference's global-tensor system:

- SBP atoms (oneflow/core/job/sbp_parallel.proto:47-79): ``S(k)`` (split
  on tensor axis k), ``B`` (broadcast/replicated), ``P`` (partial-sum).
- ``to_global(x, sbp, mesh)`` == tensor.to_global(placement, sbp)
  (python/oneflow/utils/global_view/to_global.py): places a host/local
  array on the mesh with the NamedSharding equivalent of the SBP.
- ``to_local`` == tensor.to_local: the calling process's addressable
  shard(s).
- ``reshard(x, sbp)`` == GlobalToGlobal boxing
  (oneflow/core/boxing/eager_boxing_interpreter_mgr.cpp:132-179): S/B
  transitions lower to device_put with a new sharding — GSPMD inserts the
  same collectives the reference's boxing algebra picks by hand
  (S->B all-gather, S(i)->S(j) all-to-all, B->S local slice).
- ``P`` exists transiently inside shard_map bodies (a value whose shards
  must be summed); ``materialize_partial`` resolves it with a psum —
  the ccl-p-to-b route. A first-class lazily-reduced P tensor type would
  fight XLA's model, so P is a protocol, not a storage class.

nd-SBP: pass a tuple of atoms, one per mesh axis, e.g.
``("S0", "B")`` over a 2-D mesh == the reference's [S(0), B] hybrid
DP x TP placement (nd_sbp at sbp_parallel.proto:74-79).
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SbpAtom = str  # "S0", "S1", ..., "B", "P"
Sbp = Union[SbpAtom, Sequence[SbpAtom]]

_S_RE = re.compile(r"^S(\d+)$")


def _atoms(sbp: Sbp) -> Tuple[SbpAtom, ...]:
    if isinstance(sbp, str):
        return (sbp,)
    return tuple(sbp)


def _check_atom(a: SbpAtom) -> None:
    if a in ("B", "P"):
        return
    if _S_RE.match(a):
        return
    raise ValueError(f"bad SBP atom {a!r} (want 'S<k>', 'B' or 'P')")


def sbp_to_spec(sbp: Sbp, mesh: Mesh, ndim: int) -> P:
    """Map an (nd-)SBP signature onto a PartitionSpec over mesh axes.

    atoms[i] governs mesh axis i (mesh.axis_names[i]): S(k) shards tensor
    axis k over that mesh axis; B replicates. P has no storage equivalent
    (see module docstring) and is rejected here.
    """
    atoms = _atoms(sbp)
    if len(atoms) != len(mesh.axis_names):
        raise ValueError(
            f"sbp {atoms} has {len(atoms)} atoms but mesh has axes "
            f"{mesh.axis_names}"
        )
    spec: list = [None] * ndim
    for axis_name, a in zip(mesh.axis_names, atoms):
        _check_atom(a)
        if a == "B":
            continue
        if a == "P":
            raise ValueError(
                "P (partial-sum) is not a storable placement; resolve it "
                "with materialize_partial inside shard_map"
            )
        k = int(_S_RE.match(a).group(1))
        if k >= ndim:
            raise ValueError(f"S{k} out of range for ndim={ndim}")
        if spec[k] is None:
            spec[k] = axis_name
        elif isinstance(spec[k], tuple):
            spec[k] = spec[k] + (axis_name,)
        else:
            spec[k] = (spec[k], axis_name)
    return P(*spec)


def pad_to_multiple(x: jnp.ndarray, axis: int, multiple: int, value=0):
    """Zero-pad ``axis`` up to the next multiple — XLA shardings require
    dimensions divisible by the mesh axis (the reference's SBP instead
    carries uneven slice views; explicit padding keeps shapes static)."""
    size = x.shape[axis]
    pad = -size % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    if isinstance(x, np.ndarray):
        return np.pad(x, widths, constant_values=value)
    return jnp.pad(x, widths, constant_values=value)


def to_global(x, sbp: Sbp, mesh: Mesh):
    """Place an array (or pytree of arrays, matching sbp as a prefix) onto
    the mesh with the NamedSharding of the SBP signature.

    Split dimensions must be divisible by the owning mesh axis size
    (use pad_to_multiple first for ragged sizes).
    """

    def place_one(a):
        a_ = jnp.asarray(a) if not isinstance(a, (jnp.ndarray, np.ndarray)) else a
        sharding = NamedSharding(mesh, sbp_to_spec(sbp, mesh, np.ndim(a_)))
        try:
            return jax.device_put(a_, sharding)
        except ValueError as e:
            raise ValueError(
                f"to_global({_atoms(sbp)}) on shape {np.shape(a_)}: split "
                f"dims must be divisible by the mesh axis size — pad first "
                f"with parallel.pad_to_multiple. ({e})"
            ) from None

    return jax.tree_util.tree_map(place_one, x)


def to_local(x):
    """Addressable shard(s) of a global array: list of (index, array) per
    local device — single-process == all shards (the reference's
    to_local returns this process's slice)."""

    def local_one(a):
        shards = getattr(a, "addressable_shards", None)
        if shards is None:
            return np.asarray(a)
        return [np.asarray(s.data) for s in shards]

    return jax.tree_util.tree_map(local_one, x)


def reshard(x, sbp: Sbp, mesh: Optional[Mesh] = None):
    """GlobalToGlobal: move an already-placed array to a new SBP placement.

    S/B transitions only (P is transient; see module docstring). GSPMD
    emits the minimal collective: S->B all-gather, S(i)->S(j) all-to-all,
    B->S a local slice — the same decisions as the reference's boxing
    expression tree.
    """

    def reshard_one(a):
        m = mesh
        if m is None:
            sh = getattr(a, "sharding", None)
            if not isinstance(sh, NamedSharding):
                raise ValueError(
                    "reshard needs a mesh (array has no NamedSharding)"
                )
            m = sh.mesh
        return jax.device_put(a, NamedSharding(m, sbp_to_spec(sbp, m, a.ndim)))

    return jax.tree_util.tree_map(reshard_one, x)


def materialize_partial(x: jnp.ndarray, axis_name: str = "x") -> jnp.ndarray:
    """Resolve a partial-sum value inside shard_map: P -> B (psum), the
    ccl-p-to-b boxing route."""
    return jax.lax.psum(x, axis_name)


def sbp_of(x, mesh: Mesh) -> Tuple[SbpAtom, ...]:
    """Inverse mapping: read the SBP signature of a placed array."""
    sh = getattr(x, "sharding", None)
    if not isinstance(sh, NamedSharding):
        raise ValueError("array is not placed with a NamedSharding")
    spec = sh.spec
    atoms = []
    for axis_name in mesh.axis_names:
        atom = "B"
        for k, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if axis_name in [n for n in names if n is not None]:
                atom = f"S{k}"
                break
        atoms.append(atom)
    return tuple(atoms)
