"""Distributed SpMM: halo exchange + local row-binned compute in shard_map.

The execution of a RowPartitionPlan. Per shard, inside one shard_map body:

1. gather the X rows this shard must export (static send_idx plan),
2. one padded ``jax.lax.all_to_all`` over the mesh axis moves every halo
   row in a single collective (the static equivalent of the reference's
   ncclSend/ncclRecv count+data rounds,
   oneflow/user/kernels/data_shuffle_kernel.cu:100-130),
3. local SpMM over [x_local ; halo] with plan-remapped column indices.

Collective parity with the reference's eager boxing algebra
(oneflow/core/boxing/eager_boxing_interpreter_mgr.cpp:132-165):
psum == ccl-p-to-b, all_gather == ccl-s-to-b, reduce_scatter == ccl-p-to-s,
all_to_all == ccl-s-to-s — all expressed as XLA collectives, which XLA
hands to NCCL on the GPU.

The "xla" impl is plain JAX and therefore end-to-end differentiable: the
cotangent of the all_to_all is the reverse all_to_all, and the cotangent of
the send-gather is a scatter-add — jax derives the whole reverse halo
exchange automatically (the hand-written analog in the reference is the
gather<->segment_sum SBP pairing).

The "pallas" impl is differentiable through a custom_vjp around the LOCAL
SpMM: the backward runs the same Pallas kernel on the plan's transposed
local matrices (plan.transpose_buckets, dXcat = A_local^T @ dY), while jax
transposes the surrounding take/all_to_all/concatenate — so the flagship
kernel runs in both the distributed forward AND backward (the distributed
face of gradient_funcs/gather.cpp:62-73).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from of_spmm.ops import reference as ref
from of_spmm.ops.pallas.spmm import spmm_pallas
from of_spmm.parallel.partition import RowPartitionPlan, StackedBucket
from of_spmm.sparse.binned import BinnedEll, EllBucket
from of_spmm.utils.config import FLAGS


def default_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _local_binned(plan: RowPartitionPlan, buckets) -> BinnedEll:
    """Wrap this shard's (squeezed) bucket arrays as a BinnedEll."""
    ell = tuple(
        EllBucket(row_ids=b_r, cols=b_c, vals=b_v)
        for (b_r, b_c, b_v) in buckets
    )
    return BinnedEll(
        buckets=ell,
        shape=(plan.rows_per_shard,
               plan.cols_per_shard + plan.halo_rows_total + plan.n_hubs),
        has_split_rows=True,  # conservative: always combine via scatter-add
    )


def pad_x_for_plan(plan: RowPartitionPlan, x: jnp.ndarray) -> jnp.ndarray:
    """Lay global X rows out as the padded (S*cols_per_shard, d) shard grid.

    Uniform plans just zero-pad the tail; refined-cut plans gather through
    the plan's x_pack_idx (pad rows point at row 0 — never referenced)."""
    if plan.x_pack_idx is not None:
        return jnp.take(x, plan.x_pack_idx, axis=0)
    want = plan.n_shards * plan.cols_per_shard
    pad = want - x.shape[0]
    return jnp.pad(x, ((0, pad), (0, 0))) if pad else x


def _unpack_y(plan: RowPartitionPlan, out: jnp.ndarray) -> jnp.ndarray:
    """Map the padded (S*rps, d) shard-grid output to global row order."""
    if plan.y_unpack_idx is not None:
        return jnp.take(out, plan.y_unpack_idx, axis=0)
    return out[: plan.shape[0]]


def _exchange_halo_ragged(plan: RowPartitionPlan, x_local, offset_bufs,
                          axis: str, d: int):
    """Per-ring-offset ppermute halo (plan.ragged): offset k's buffer is
    padded only to that offset's worst pair, so sum(H_k) << (S-1)*H on
    locality-ordered graphs. Segment k of the returned halo holds the
    rows owned by (p - k) mod S, matching the plan's remap bases."""
    S = plan.n_shards
    parts = []
    for k in range(1, S):
        hk = plan.offset_widths[k - 1]
        sk = offset_bufs[k - 1].reshape(hk)
        buf = jnp.take(x_local, sk, axis=0)          # (H_k, d)
        perm = [(i, (i + k) % S) for i in range(S)]
        parts.append(jax.lax.ppermute(buf, axis, perm))
    return jnp.concatenate(parts, axis=0)            # (sum H_k, d)


def _mk_binned(sq, shape) -> BinnedEll:
    ell = tuple(EllBucket(row_ids=r, cols=c, vals=v) for (r, c, v) in sq)
    return BinnedEll(buckets=ell, shape=shape, has_split_rows=True)


def _make_pallas_local(plan: RowPartitionPlan, split: bool):
    """Differentiable Pallas local SpMM: custom_vjp whose backward runs the
    same kernel on the transposed local plan (plan.transpose_buckets).

    Bucket arrays are ARGUMENTS (not closures — custom_vjp forbids traced
    closures); their cotangents are structural zeros, matching the
    reference's requires_grad=False on indices
    (user/ops/gather_op.cpp:44-50)."""
    SH = plan.halo_rows_total
    n_xcat = plan.cols_per_shard + SH + plan.n_hubs
    fwd_shape = (plan.rows_per_shard, n_xcat)
    t_shape = (n_xcat, plan.rows_per_shard)
    cps = plan.cols_per_shard

    if split:
        @jax.custom_vjp
        def f(int_sq, bnd_sq, t_sq, x_local, halo):
            y = spmm_pallas(_mk_binned(int_sq, fwd_shape), x_local)
            xcat = jnp.concatenate([x_local, halo], axis=0)
            return y + spmm_pallas(_mk_binned(bnd_sq, fwd_shape), xcat)

        def f_fwd(int_sq, bnd_sq, t_sq, x_local, halo):
            return f(int_sq, bnd_sq, t_sq, x_local, halo), \
                (int_sq, bnd_sq, t_sq)

        def f_bwd(res, dy):
            int_sq, bnd_sq, t_sq = res
            dxcat = spmm_pallas(_mk_binned(t_sq, t_shape), dy)
            zeros = jax.tree_util.tree_map(jnp.zeros_like,
                                           (int_sq, bnd_sq, t_sq))
            return (*zeros, dxcat[:cps], dxcat[cps:])

        f.defvjp(f_fwd, f_bwd)
        return f

    @jax.custom_vjp
    def g(fwd_sq, t_sq, xcat):
        return spmm_pallas(_mk_binned(fwd_sq, fwd_shape), xcat)

    def g_fwd(fwd_sq, t_sq, xcat):
        return g(fwd_sq, t_sq, xcat), (fwd_sq, t_sq)

    def g_bwd(res, dy):
        fwd_sq, t_sq = res
        dxcat = spmm_pallas(_mk_binned(t_sq, t_shape), dy)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, (fwd_sq, t_sq))
        return (*zeros, dxcat)

    g.defvjp(g_fwd, g_bwd)
    return g


def _gather_hubs(plan, hub_idx_local, x_local, axis):
    """One small all_gather of the replicated hub rows, reordered to
    hub-rank order (the plan's remapped tail of the local index space)."""
    own = jnp.take(x_local, hub_idx_local.reshape(-1), axis=0)
    slab = jax.lax.all_gather(own, axis, axis=0, tiled=True)  # (S*Kmax, d)
    return jnp.take(slab, plan.hub_perm, axis=0)              # (K, d)


def dist_spmm(
    plan: RowPartitionPlan,
    x: jnp.ndarray,
    mesh: Mesh,
    axis: str = "x",
    impl: str = "auto",
) -> jnp.ndarray:
    """Y = A @ X with A row-partitioned per ``plan`` over ``mesh[axis]``.

    ``x`` is the global (m, d) feature matrix (replicated or sharded; it is
    resharded to row-split). Returns the global (n, d) result row-split
    across the mesh. ``impl`` is resolved like ``spmm``'s (ops/registry.py).
    Both impls are differentiable ("pallas" via the transpose-plan
    custom_vjp when the plan was built with_transpose).
    """
    from of_spmm.ops.registry import lookup

    impl = lookup("spmm").resolve_impl(impl)
    S = plan.n_shards
    if mesh.shape[axis] != S:
        raise ValueError(
            f"plan built for {S} shards but mesh axis {axis!r} has "
            f"{mesh.shape[axis]} devices"
        )
    H = plan.halo_size
    d = x.shape[1]
    xp = pad_x_for_plan(plan, x)

    def _arrays(buckets):
        return tuple((b.row_ids, b.cols, b.vals) for b in buckets)

    def _squeeze(buckets):
        return tuple(
            (r.reshape(r.shape[1:]), c.reshape(c.shape[1:]), v.reshape(v.shape[1:]))
            for (r, c, v) in buckets
        )

    def _spmm(buckets, xcat):
        binned = _local_binned(plan, _squeeze(buckets))
        if impl == "pallas":
            return spmm_pallas(binned, xcat)
        return ref.spmm_binned_xla(binned, xcat)

    diff_pallas = impl == "pallas" and plan.transpose_buckets is not None
    t_arrays = (
        _arrays(plan.transpose_buckets) if diff_pallas else ()
    )

    if plan.split and plan.n_hubs:
        raise ValueError(
            "split plan with replicated hubs is not supported (the split "
            "body does not gather the hub slab)")

    if plan.split:
        interior_arrays = _arrays(plan.interior_buckets)
        boundary_arrays = _arrays(plan.boundary_buckets)
        f_split = _make_pallas_local(plan, split=True) if diff_pallas else None

        def body(send_idx, off_sends, interior, boundary, t_arr, x_local):
            # issue the collective(s) FIRST; interior compute has no data
            # dependency on them, so XLA overlaps (async collectives)
            if plan.ragged:
                halo = _exchange_halo_ragged(plan, x_local, off_sends,
                                             axis, d)
            else:
                send = jnp.take(x_local, send_idx.reshape(-1), axis=0) \
                    .reshape(S, H, d)
                halo = jax.lax.all_to_all(
                    send, axis, split_axis=0, concat_axis=0, tiled=False
                ).reshape(S * H, d)
            if diff_pallas:
                return f_split(_squeeze(interior), _squeeze(boundary),
                               _squeeze(t_arr), x_local, halo)
            y = _spmm(interior, x_local)  # overlaps with the exchange
            xcat = jnp.concatenate([x_local, halo], axis=0)
            return y + _spmm(boundary, xcat)

        off_sends = plan.offset_send or ()
        shard = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(
                P(axis),
                jax.tree_util.tree_map(lambda _: P(axis), off_sends),
                jax.tree_util.tree_map(lambda _: P(axis), interior_arrays),
                jax.tree_util.tree_map(lambda _: P(axis), boundary_arrays),
                jax.tree_util.tree_map(lambda _: P(axis), t_arrays),
                P(axis),
            ),
            out_specs=P(axis),
            check_vma=False,
        )
        out = shard(plan.send_idx, off_sends, interior_arrays,
                    boundary_arrays, t_arrays, xp)
        return _unpack_y(plan, out)

    bucket_arrays = _arrays(plan.buckets)
    f_plain = _make_pallas_local(plan, split=False) if diff_pallas else None
    hub_idx = (plan.hub_local_idx if plan.n_hubs
               else jnp.zeros((S, 1), jnp.int32))

    def body(send_idx, off_sends, buckets, t_arr, hub_idx_local, x_local):
        # 1) + 2) export and exchange halo rows: one padded all_to_all, or
        # per-offset ppermutes when the plan is ragged
        if plan.ragged:
            halo = _exchange_halo_ragged(plan, x_local, off_sends, axis, d)
        else:
            send_idx = send_idx.reshape(S, H)  # (1, S, H) -> (S, H)
            send = jnp.take(x_local, send_idx.reshape(-1),
                            axis=0).reshape(S, H, d)
            halo = jax.lax.all_to_all(
                send, axis, split_axis=0, concat_axis=0, tiled=False
            ).reshape(S * H, d)
        # 3) local SpMM over [own rows ; halo ; hub broadcast]
        parts = [x_local, halo]
        if plan.n_hubs:
            parts.append(_gather_hubs(plan, hub_idx_local, x_local, axis))
        xcat = jnp.concatenate(parts, axis=0)
        if diff_pallas:
            return f_plain(_squeeze(buckets), _squeeze(t_arr), xcat)
        return _spmm(buckets, xcat)

    off_sends = plan.offset_send or ()
    shard = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis),
                  jax.tree_util.tree_map(lambda _: P(axis), off_sends),
                  jax.tree_util.tree_map(lambda _: P(axis), bucket_arrays),
                  jax.tree_util.tree_map(lambda _: P(axis), t_arrays),
                  P(axis),
                  P(axis)),
        out_specs=P(axis),
        check_vma=False,  # pallas_call inside the body predates vma typing
    )
    out = shard(plan.send_idx, off_sends, bucket_arrays, t_arrays,
                hub_idx, xp)
    return _unpack_y(plan, out)


def dist_spmm_allgather(
    plan: RowPartitionPlan,
    x: jnp.ndarray,
    mesh: Mesh,
    axis: str = "x",
    impl: str = "auto",
) -> jnp.ndarray:
    """Comms-volume baseline: replace the halo all_to_all with a full
    all_gather of X (the ccl-s-to-b route of the reference boxing algebra),
    then reconstruct the halo buffer locally so the same remapped plan
    arrays are reused. Strictly more communication than ``dist_spmm`` —
    used to measure what the halo plan saves.
    """
    from of_spmm.ops.registry import lookup

    impl = lookup("spmm").resolve_impl(impl)
    S = plan.n_shards
    H = plan.halo_size
    d = x.shape[1]
    cps = plan.cols_per_shard
    xp = pad_x_for_plan(plan, x)
    bucket_arrays = tuple((b.row_ids, b.cols, b.vals) for b in plan.buckets)

    off_sends = plan.offset_send or ()

    def body(send_idx_all, off_all, buckets, x_local):
        xfull = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)  # (S*cps, d)
        me = jax.lax.axis_index(axis)
        if plan.ragged:
            # rebuild the ragged halo layout locally: segment k holds the
            # rows owned by q = (me - k) mod S, listed in off_all[k-1][q]
            parts = []
            for k in range(1, S):
                q = (me - k) % S
                idx = jnp.take(off_all[k - 1], q, axis=0)  # (H_k,)
                parts.append(jnp.take(xfull, q * cps + idx, axis=0))
            halo = jnp.concatenate(parts, axis=0)
        else:
            send_idx_all = send_idx_all.reshape(S, S, H)
            # halo row j from owner q lives at q*cps + send_idx_all[q, me, j]
            owner_base = (jnp.arange(S, dtype=jnp.int32) * cps)[:, None]
            recv_idx = owner_base + send_idx_all[:, me, :]  # (S, H)
            halo = jnp.take(xfull, recv_idx.reshape(-1), axis=0)  # (S*H, d)
        xcat = jnp.concatenate([x_local, halo], axis=0)
        squeezed = tuple(
            (r.reshape(r.shape[1:]), c.reshape(c.shape[1:]), v.reshape(v.shape[1:]))
            for (r, c, v) in buckets
        )
        binned = _local_binned(plan, squeezed)
        if impl == "pallas":
            return spmm_pallas(binned, xcat)
        return ref.spmm_binned_xla(binned, xcat)

    shard = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(),
                  jax.tree_util.tree_map(lambda _: P(), off_sends),
                  jax.tree_util.tree_map(lambda _: P(axis), bucket_arrays),
                  P(axis)),
        out_specs=P(axis),
        check_vma=False,  # pallas_call inside the body predates vma typing
    )
    out = shard(plan.send_idx, off_sends, bucket_arrays, xp)
    return _unpack_y(plan, out)
