"""comm — collective communication API (reference: python/oneflow/comm).

Two layers, mirroring the reference's split between the device-generic
collective API (oneflow/user/kernels/collective_communication/include/
collective_communication.h:44-62) and the torch-style eager wrappers
(python/oneflow/comm/comm_ops.py:21-290):

- inside ``shard_map``: thin named wrappers over XLA collectives (NCCL on
  the GPU: psum / all_gather / psum_scatter / all_to_all / ppermute). These are
  the JAX replacements for the reference's NCCL calls — XLA
  schedules them deterministically, no comm-manager/stream plumbing.
- outside shard_map: ``to_global`` / ``to_local`` placement utilities in
  parallel/global_view.py move arrays between host/replicated and
  SBP-style placements (GSPMD inserts any needed transfers).

Collective parity with the reference's eager boxing algebra
(oneflow/core/boxing/eager_boxing_interpreter_mgr.cpp:132-165):
all_reduce == ccl-p-to-b, all_gather == ccl-s-to-b,
reduce_scatter == ccl-p-to-s, all_to_all == ccl-s-to-s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp


def all_reduce(x: jnp.ndarray, axis_name: str = "x") -> jnp.ndarray:
    """Sum-reduce across the mesh axis (ccl AllReduce; P -> B)."""
    return jax.lax.psum(x, axis_name)


def all_reduce_mean(x: jnp.ndarray, axis_name: str = "x") -> jnp.ndarray:
    return jax.lax.pmean(x, axis_name)


def all_gather(
    x: jnp.ndarray, axis_name: str = "x", axis: int = 0, tiled: bool = True
) -> jnp.ndarray:
    """Concatenate shards along ``axis`` (ccl AllGather; S -> B)."""
    return jax.lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def reduce_scatter(
    x: jnp.ndarray, axis_name: str = "x", axis: int = 0
) -> jnp.ndarray:
    """Sum then scatter along ``axis`` (ccl ReduceScatter; P -> S)."""
    return jax.lax.psum_scatter(x, axis_name, scatter_dimension=axis, tiled=True)


def all_to_all(
    x: jnp.ndarray,
    axis_name: str = "x",
    split_axis: int = 0,
    concat_axis: int = 0,
    tiled: bool = True,
) -> jnp.ndarray:
    """Transpose shard <-> axis ownership (ccl S2S; S(i) -> S(j))."""
    return jax.lax.all_to_all(
        x, axis_name, split_axis=split_axis, concat_axis=concat_axis, tiled=tiled
    )


def broadcast(x: jnp.ndarray, root: int = 0, axis_name: str = "x") -> jnp.ndarray:
    """Every shard receives root's value (ccl Broadcast).

    Implemented as a masked psum — root contributes its value, everyone
    else zeros; cheaper specializations are XLA's concern.
    """
    me = jax.lax.axis_index(axis_name)
    contrib = jnp.where(me == root, x, jnp.zeros_like(x))
    return jax.lax.psum(contrib, axis_name)


def reduce(x: jnp.ndarray, root: int = 0, axis_name: str = "x") -> jnp.ndarray:
    """Sum on every shard, masked to root (others get zeros) — the
    device-generic ccl Reduce shape (only root's result is meaningful)."""
    total = jax.lax.psum(x, axis_name)
    me = jax.lax.axis_index(axis_name)
    return jnp.where(me == root, total, jnp.zeros_like(total))


def permute(
    x: jnp.ndarray, perm: Sequence[tuple], axis_name: str = "x"
) -> jnp.ndarray:
    """Point-to-point shuffle by (src, dst) pairs (ccl Send/Recv pairs;
    shards not named as a dst receive zeros) — jax.lax.ppermute."""
    return jax.lax.ppermute(x, axis_name, perm=list(perm))


def send_recv_next(x: jnp.ndarray, axis_name: str = "x", shift: int = 1):
    """Ring shift by ``shift`` (each shard sends to rank+shift mod N) —
    the building block of ring/pipeline schedules."""
    n = jax.lax.axis_size(axis_name)  # static inside shard_map
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name, perm=perm)


def send_recv(x: jnp.ndarray, src: int, dst: int, axis_name: str = "x"):
    """Arbitrary-pair point-to-point transfer inside shard_map.

    The SPMD form of the reference's Send/Recv functor pair
    (oneflow/core/functional/impl/comm_functor.cpp:331-373): ``src``'s
    shard value arrives on ``dst``; every other shard receives zeros (the
    reference's recv allocates fresh memory — zeros are the SPMD
    placeholder). Needed for non-ring pipeline topologies and
    cross-placement boxing. Static (plan-time) src/dst, like the
    reference's rank arguments.
    """
    return jax.lax.ppermute(x, axis_name, perm=[(src, dst)])


def send_recv_pairs(x: jnp.ndarray, pairs: Sequence[tuple],
                    axis_name: str = "x"):
    """Batch of disjoint (src, dst) point-to-point transfers — the
    device-generic ccl Send/Recv list (collective_communication.h:44-62);
    shards not named as a dst receive zeros."""
    return jax.lax.ppermute(x, axis_name, perm=list(pairs))


def transfer(x, dst_device):
    """Eager cross-device tensor transfer OUTSIDE shard_map — the analog
    of the reference's eager Send/Recv between placements (data moved by
    the runtime, not by a collective): jax.device_put handles host/NVLink
    routing."""
    return jax.device_put(x, dst_device)


__all__ = [
    "all_reduce",
    "all_reduce_mean",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "broadcast",
    "reduce",
    "permute",
    "send_recv_next",
    "send_recv",
    "send_recv_pairs",
    "transfer",
]
