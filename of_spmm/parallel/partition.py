"""1-D row partition of a sparse matrix with a precomputed halo-exchange plan.

Re-expression of the reference's distributed sparse aggregation:

- the per-rank row ranges the reference derives from SBP slice views
  (oneflow/core/job/nd_sbp_util.cpp:98-106,
  oneflow/user/kernels/unsorted_segment_sum_kernel.cpp:59-75) become an
  explicit plan built host-side at partition time;
- the ragged id-shuffle exchange the reference runs with per-rank
  ncclSend/ncclRecv count+data rounds
  (oneflow/user/kernels/data_shuffle_kernel.cu:41-130) becomes a *static*
  padded all-to-all: per-pair halo index lists are computed once, padded to
  a uniform width H, and executed as one ``jax.lax.all_to_all`` inside
  ``shard_map`` — static shapes, so XLA compiles one program and can
  overlap the collective with local compute.

Plan construction: shard p owns A rows [p*rps, (p+1)*rps) and X rows
[p*cps, (p+1)*cps). The columns A_p references outside p's own X range are
halo rows; need[p][q] lists them per owner q. Column indices of A_p are
remapped at plan time into the concatenated local index space
[own X (cps) | halo buffer (S*H)], so the kernel runs unmodified on
[x_local ; halo] with no runtime index translation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.sparse.binned import DEFAULT_LADDER, SUBLANES, BinnedEll, EllBucket, bin_rows
from of_spmm.sparse.formats import CSR


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class StackedBucket:
    """An EllBucket stacked across shards (leading dim = n_shards)."""

    row_ids: jnp.ndarray  # (S, R)
    cols: jnp.ndarray  # (S, R, K) — remapped into [0, cps + S*H)
    vals: jnp.ndarray  # (S, R, K)

    def tree_flatten(self):
        return (self.row_ids, self.cols, self.vals), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def width(self) -> int:
        return int(self.cols.shape[2])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RowPartitionPlan:
    """Static halo-exchange plan for Y = A @ X row-partitioned over S shards.

    Built with ``split_boundary=True``, the per-shard ELL rows are divided
    into INTERIOR rows (every nonzero hits shard-local X) and BOUNDARY rows
    (at least one halo reference): ``buckets`` is then empty and
    ``interior_buckets``/``boundary_buckets`` carry the work. dist_spmm
    computes interior rows while the halo all_to_all is in flight (XLA
    schedules the collective asynchronously when no data dependency forces
    serialization), and interior gathers index the smaller local-only
    table — the overlap the reference gets from its actor dataflow."""

    buckets: Tuple[StackedBucket, ...]
    send_idx: jnp.ndarray  # (S, S, H) int32: p sends own-local X rows
    #                         send_idx[p, q] to shard q (padding -> row 0)
    shape: Tuple[int, int]  # global logical A shape
    n_shards: int
    rows_per_shard: int  # output rows per shard (padded)
    cols_per_shard: int  # X rows per shard (padded)
    halo_size: int  # H
    interior_buckets: Optional[Tuple[StackedBucket, ...]] = None
    boundary_buckets: Optional[Tuple[StackedBucket, ...]] = None
    # hub replication (degree-aware halo bound): the K highest in-degree
    # columns are excluded from the pairwise halo need-lists and instead
    # broadcast once per call (one small all_gather) — on power-law graphs
    # a single hub-heavy pair otherwise inflates every shard's padded H
    # toward an all_gather. hub_local_idx[p, k] = p-local X row of the
    # k-th hub slot owned by p (padded with 0); hub_perm maps the gathered
    # (S, Kmax) slab to hub-rank order.
    hub_local_idx: Optional[jnp.ndarray] = None   # (S, Kmax) int32
    hub_perm: Optional[jnp.ndarray] = None        # (K,) int32 into S*Kmax
    # transposed local matrices (cps + S*H + K, rps), binned+stacked: the
    # backward of the local SpMM (dXcat = A_local^T @ dY) for the Pallas
    # impl's custom_vjp — the distributed face of the reference's
    # gather<->segment-sum autograd pairing (gradient_funcs/gather.cpp).
    transpose_buckets: Optional[Tuple[StackedBucket, ...]] = None
    # RAGGED halo (ragged=True): instead of one all_to_all padded to the
    # worst (p, q) pair, the exchange runs one ppermute per ring OFFSET
    # k = 1..S-1, each padded only to that offset's worst pair. On
    # locality-ordered graphs adjacent offsets carry boundary slivers and
    # far offsets only the global tail, so sum(H_k) << (S-1)*H — the
    # static-shape analog of the reference's count-exchange-then-
    # data-exchange (data_shuffle_kernel.cu:100-130).
    offset_send: Optional[Tuple[jnp.ndarray, ...]] = None  # k-1 -> (S, H_k)
    offset_widths: Optional[Tuple[int, ...]] = None        # (S-1,) H_k
    # refined cuts (refine_slack > 0): shard boundaries move off the
    # uniform grid (toward community edges, METIS-style 1-D min-cut);
    # x_pack_idx gathers global X rows into the padded (S*cps,) layout
    # and y_unpack_idx maps padded outputs back to global row order.
    x_pack_idx: Optional[jnp.ndarray] = None   # (S*cps,) int32
    y_unpack_idx: Optional[jnp.ndarray] = None  # (n,) int32
    def tree_flatten(self):
        children = (self.buckets, self.send_idx, self.interior_buckets,
                    self.boundary_buckets, self.hub_local_idx,
                    self.hub_perm, self.transpose_buckets,
                    self.offset_send, self.x_pack_idx, self.y_unpack_idx)
        aux = (self.shape, self.n_shards, self.rows_per_shard,
               self.cols_per_shard, self.halo_size, self.offset_widths)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (buckets, send_idx, interior, boundary, hub_idx, hub_perm,
         transpose, offset_send, x_pack, y_unpack) = children
        shape, s, rps, cps, h, offw = aux
        return cls(buckets=tuple(buckets), send_idx=send_idx, shape=shape,
                   n_shards=s, rows_per_shard=rps, cols_per_shard=cps,
                   halo_size=h,
                   interior_buckets=None if interior is None else tuple(interior),
                   boundary_buckets=None if boundary is None else tuple(boundary),
                   hub_local_idx=hub_idx, hub_perm=hub_perm,
                   transpose_buckets=None if transpose is None else tuple(transpose),
                   offset_send=None if offset_send is None else tuple(offset_send),
                   offset_widths=offw,
                   x_pack_idx=x_pack, y_unpack_idx=y_unpack)

    @property
    def split(self) -> bool:
        return self.interior_buckets is not None

    @property
    def ragged(self) -> bool:
        return self.offset_send is not None

    @property
    def halo_rows_total(self) -> int:
        """Halo buffer rows per shard (ragged-aware)."""
        if self.offset_widths is not None:
            return int(sum(self.offset_widths))
        return self.n_shards * self.halo_size

    @property
    def n_hubs(self) -> int:
        return 0 if self.hub_perm is None else int(self.hub_perm.shape[0])

    @property
    def halo_fraction(self) -> float:
        """Exchanged rows / owned rows — comms pressure indicator."""
        return self.halo_rows_total / max(1, self.cols_per_shard)

    def comm_stats(self, d: int = 128, bytes_per: int = 4) -> dict:
        """Per-shard exchanged bytes: padded halo + hub broadcast vs the
        all_gather baseline (BASELINE.md halo-vs-allgather accounting)."""
        S = self.n_shards
        halo = self.halo_rows_total * d * bytes_per
        kmax = 0 if self.hub_local_idx is None else int(
            self.hub_local_idx.shape[1])
        hub = S * kmax * d * bytes_per
        allg = S * self.cols_per_shard * d * bytes_per
        return {"halo_bytes": halo, "hub_bytes": hub,
                "all_gather_bytes": allg,
                "saving": 1.0 - (halo + hub) / max(allg, 1)}


def place_plan(plan: RowPartitionPlan, mesh, axis: str = "x"
               ) -> RowPartitionPlan:
    """Put a plan on ``mesh`` once: leaves stacked per shard (leading dim
    n_shards) split over ``axis``, every other leaf replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    split = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(a):
        per_shard = a.ndim > 0 and a.shape[0] == plan.n_shards
        return jax.device_put(a, split if per_shard else rep)

    return jax.tree_util.tree_map(put, plan)


def _refine_bounds(n: int, S: int, rows, cols, slack: float) -> np.ndarray:
    """Shard boundaries moved off the uniform grid toward min-cut points.

    1-D METIS-style refinement: an edge (r, c) "crosses" cut x when
    min(r,c) < x <= max(r,c); one +-1 sweep gives the crossing count at
    every position, and each boundary picks the minimum within
    +-slack*rps of its uniform position. On cluster-contiguous orderings
    (sparse/reorder.py) the minima sit at cluster edges, so communities
    stop straddling shards — the dominant halo term."""
    rps = _cdiv(n, S)
    lo_rc = np.minimum(rows, cols)
    hi_rc = np.maximum(rows, cols)
    ev = np.zeros(n + 1, np.int64)
    np.add.at(ev, lo_rc + 1, 1)
    np.add.at(ev, hi_rc + 1, -1)
    crossing = np.cumsum(ev)  # crossing[x] = edges straddling cut x
    w = max(int(slack * rps), 1)
    bounds = np.zeros(S + 1, np.int64)
    bounds[S] = n
    for p in range(1, S):
        u = p * rps
        lo = max(u - w, bounds[p - 1] + 1)
        hi = min(u + w, n - (S - p))
        c = int(lo + np.argmin(crossing[lo:hi + 1]))
        c -= c % SUBLANES
        bounds[p] = max(c, bounds[p - 1] + 1)
    return bounds


def partition_rows(
    csr: CSR,
    n_shards: int,
    ladder="auto",
    split_boundary: bool = False,
    with_transpose: bool = True,
    replicate_hubs=0,
    ragged: bool = False,
    refine_slack: float = 0.0,
) -> RowPartitionPlan:
    """Build the plan (host-side, once per graph x shard count).

    With ladder="auto" one global width ladder is chosen from the full
    graph's degree histogram so every shard bins with the same widths
    (SPMD requires identical bucket shapes across shards).

    ``replicate_hubs=K``: the K highest in-degree columns are broadcast
    once per call instead of riding the pairwise halo — bounds the padded
    H on power-law graphs (the reference's id-shuffle dedups hot keys in
    its GPU hash table for the same reason, data_shuffle_kernel.cu:41-130).
    ``replicate_hubs="auto"`` picks K from {0, 256, 1024, 4096} by
    minimizing modeled exchange bytes — hubs are only replicated when the
    byte saving is real (VERDICT r2 item 5).

    ``ragged=True``: per-ring-offset ppermute halo instead of one
    all_to_all padded to the worst pair; ``refine_slack>0``: min-cut
    boundary refinement (square matrices only). See RowPartitionPlan.
    """
    from of_spmm.sparse.binned import optimal_ladder

    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        ladder = optimal_ladder(csr)
    n, m = csr.shape
    S = n_shards
    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)

    # --- shard boundaries -------------------------------------------------
    if refine_slack > 0:
        if n != m:
            raise ValueError("refine_slack needs a square adjacency "
                             "(rows and cols share the cut points)")
        rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        bounds = _refine_bounds(n, S, rows_all, cols, refine_slack)
        del rows_all
    else:
        bounds = np.minimum(np.arange(S + 1, dtype=np.int64) * _cdiv(n, S),
                            n)
    uniform = refine_slack <= 0
    sizes = np.diff(bounds)
    rps = int(sizes.max())
    rps += -rps % SUBLANES
    if uniform:
        rps = _cdiv(n, S)
        cps = _cdiv(m, S)
        col_bounds = np.minimum(
            np.arange(S + 1, dtype=np.int64) * cps, m)
    else:
        cps = rps  # square: cols share the refined bounds
        col_bounds = bounds

    def owner_of(c):
        if uniform:
            return c // cps
        return np.searchsorted(col_bounds, c, side="right") - 1

    # --- hub selection ----------------------------------------------------
    indeg = np.bincount(cols, minlength=m)
    auto_hubs = replicate_hubs == "auto"
    hub_candidates = (0, 256, 1024, 4096, 16384, 65536) if auto_hubs \
        else (min(int(replicate_hubs), m),)

    # per-shard unique referenced cols (computed once; hub filtering masks)
    shard_uniq = []
    shard_slices = []
    for p in range(S):
        r0, r1 = int(bounds[p]), int(bounds[p + 1])
        lo, hi = indptr[r0], indptr[r1]
        shard_slices.append((r0, r1, lo, hi))
        shard_uniq.append(np.unique(cols[lo:hi]))

    hub_order = np.argsort(-indeg, kind="stable")

    def modeled_bytes(K):
        """Exchanged rows (incl. hub slab) for hub count K — with the SAME
        alignment/padding the final plan applies, so "auto" never picks a
        K that loses after rounding."""
        if K:
            hub_set = np.zeros(m, bool)
            hub_set[hub_order[:K]] = True
        worst = np.zeros(S, np.int64)  # per-offset max (ragged model)
        for p in range(S):
            u = shard_uniq[p]
            if K:
                u = u[~hub_set[u]]
            ow = owner_of(u)
            cnt = np.bincount(ow, minlength=S)
            for q in range(S):
                if q == p:
                    continue
                k = (p - q) % S
                worst[k] = max(worst[k], cnt[q])
        if ragged:
            hk = np.maximum(worst[1:], 1)
            hk += (-hk) % SUBLANES
            halo_rows = int(hk.sum())
        else:
            h = max(int(worst.max()), 1)
            h += -h % SUBLANES
            halo_rows = S * h
        kmax = 0
        if K:
            kmax = max(int(np.bincount(owner_of(hub_order[:K]),
                                       minlength=S).max()), 1)
        return halo_rows + S * kmax

    if split_boundary:
        # the split dist_spmm body gathers [x_local | halo] only — it
        # never appends the broadcast hub slab, so replicated-hub columns
        # would read clipped rows
        if not auto_hubs and hub_candidates[0]:
            raise ValueError(
                "split_boundary=True is incompatible with "
                "replicate_hubs>0 (the split compute body does not gather "
                "the hub slab); use replicate_hubs=0 or "
                "split_boundary=False")
        if auto_hubs:
            hub_candidates = (0,)  # split bodies never pick hubs
    if len(hub_candidates) > 1:
        K = min(hub_candidates, key=modeled_bytes)
    else:
        K = hub_candidates[0]
    K = min(K, m)

    hub_rank = np.full(m, -1, dtype=np.int64)
    hub_ids = np.zeros(0, np.int64)
    hub_local_idx = None
    hub_perm = None
    if K:
        hub_ids = hub_order[:K]
        hub_rank[hub_ids] = np.arange(K, dtype=np.int64)
        owner_h = owner_of(hub_ids)
        kmax = max(int(np.bincount(owner_h, minlength=S).max()), 1)
        hub_local_idx = np.zeros((S, kmax), np.int32)
        hub_perm = np.zeros(K, np.int32)
        slot_of = np.zeros(S, np.int64)
        for r, c in enumerate(hub_ids):
            p = int(owner_h[r])
            k = int(slot_of[p])
            hub_local_idx[p, k] = c - col_bounds[p]
            hub_perm[r] = p * kmax + k
            slot_of[p] += 1

    # --- per-shard halo needs -------------------------------------------
    # need[p][q]: sorted unique global cols owned by q (!=p) referenced by A_p
    need = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for p in range(S):
        uniq = shard_uniq[p]
        if K:
            uniq = uniq[hub_rank[uniq] < 0]  # hubs ride the broadcast
        owner = owner_of(uniq)
        for q in range(S):
            if q == p:
                continue
            need[p][q] = uniq[owner == q]

    H = max((need[p][q].shape[0] for p in range(S) for q in range(S)), default=0)
    H = max(H, 1)
    H += -H % SUBLANES  # align halo buffer rows

    # --- ragged per-offset widths + halo segment bases -------------------
    offset_widths = None
    offset_send = None
    if ragged:
        offset_widths = []
        for k in range(1, S):
            hk = max((need[p][(p - k) % S].shape[0] for p in range(S)),
                     default=0)
            hk = max(hk, 1)
            hk += -hk % SUBLANES
            offset_widths.append(hk)
        offset_widths = tuple(offset_widths)
        halo_base = np.zeros(S, np.int64)  # base row of owner-q's segment
        # per (p, q): q's rows land at base of offset k = (p - q) % S
        off_pref = np.zeros(S, np.int64)
        np.cumsum(np.asarray(offset_widths[:-1]), out=off_pref[2:])
        # off_pref[k] = sum of widths for offsets < k (k >= 1)
        # send plan per offset: p sends need[(p+k)%S][p] to (p+k)%S
        offset_send = []
        for k in range(1, S):
            hk = offset_widths[k - 1]
            sk = np.zeros((S, hk), np.int32)
            for p in range(S):
                dest = (p + k) % S
                idx = need[dest][p] - col_bounds[p]
                sk[p, : idx.shape[0]] = idx
            offset_send.append(sk)
        halo_total = int(sum(offset_widths))
    else:
        halo_total = S * H

    # --- send plan: p sends need[q][p] (as p-local indices) to q ---------
    send_idx = np.zeros((S, S, H), dtype=np.int32)
    for p in range(S):
        for q in range(S):
            if q == p:
                continue
            idx = need[q][p] - col_bounds[p]  # p-local X row indices
            send_idx[p, q, : idx.shape[0]] = idx

    def halo_pos(p, q):
        """Base of owner-q's halo rows in p's xcat halo section."""
        if ragged:
            k = (p - q) % S
            return int(off_pref[k])
        return q * H

    # --- pack/unpack maps for refined (non-uniform) boundaries -----------
    x_pack_idx = None
    y_unpack_idx = None
    if not uniform:
        x_pack_idx = np.zeros(S * cps, np.int32)
        y_unpack_idx = np.zeros(n, np.int32)
        for p in range(S):
            r0, r1 = int(bounds[p]), int(bounds[p + 1])
            x_pack_idx[p * cps: p * cps + (r1 - r0)] = np.arange(r0, r1)
            y_unpack_idx[r0:r1] = p * rps + np.arange(r1 - r0)

    # --- per-shard local CSR with remapped cols, then bin ----------------
    per_shard_binned = []
    per_shard_t_binned = []
    for p in range(S):
        r0, r1, lo, hi = shard_slices[p]
        c = cols[lo:hi]
        v = vals[lo:hi]
        local_indptr = (indptr[r0 : r1 + 1] - lo).astype(np.int64)
        # remap: own cols -> c - col_bounds[p] ; halo col from owner q at
        # position j in need[p][q] -> cps + halo_pos(p, q) + j
        owner = owner_of(c)
        remapped = np.empty_like(c)
        is_hub = hub_rank[c] >= 0 if K else np.zeros(c.shape[0], bool)
        own = np.logical_and(owner == p, ~is_hub)
        remapped[own] = c[own] - col_bounds[p]
        if K:
            remapped[is_hub] = cps + halo_total + hub_rank[c[is_hub]]
        for q in range(S):
            if q == p:
                continue
            sel = np.logical_and(owner == q, ~is_hub)
            if not sel.any():
                continue
            pos = np.searchsorted(need[p][q], c[sel])
            remapped[sel] = cps + halo_pos(p, q) + pos
        # pad local rows to rps
        pad_rows = rps - (r1 - r0)
        if pad_rows:
            local_indptr = np.concatenate(
                [local_indptr, np.full(pad_rows, local_indptr[-1], np.int64)]
            )
        if with_transpose:
            # A_local^T (cps + S*H, rps): the local backward operator
            local_rows = np.repeat(
                np.arange(rps, dtype=np.int64), np.diff(local_indptr))
            order = np.argsort(remapped, kind="stable")
            t_cols = remapped[order]
            t_counts = np.bincount(t_cols, minlength=cps + halo_total + K)
            t_indptr = np.zeros(cps + halo_total + K + 1, np.int64)
            np.cumsum(t_counts, out=t_indptr[1:])
            t_csr = CSR.from_arrays(
                t_indptr.astype(np.int64),
                local_rows[order].astype(np.int32),
                v[order],
                (cps + halo_total + K, rps),
            )
            per_shard_t_binned.append(bin_rows(t_csr, ladder=ladder))
        if split_boundary:
            # a row is BOUNDARY iff any of its nnz references HALO;
            # interior rows gather only own X (split plans have no hubs)
            is_halo = ((remapped >= cps)
                       & (remapped < cps + halo_total)).astype(np.int64)
            cum = np.zeros(remapped.shape[0] + 1, np.int64)
            np.cumsum(is_halo, out=cum[1:])
            row_halo = (cum[local_indptr[1:]] - cum[local_indptr[:-1]]) > 0

            def masked_csr(keep_rows: np.ndarray) -> CSR:
                keep_nnz = np.repeat(keep_rows, np.diff(local_indptr))
                counts = np.diff(local_indptr) * keep_rows
                ip = np.zeros(local_indptr.shape[0], np.int64)
                np.cumsum(counts, out=ip[1:])
                return CSR.from_arrays(
                    ip.astype(np.int32),
                    remapped[keep_nnz].astype(np.int32),
                    v[keep_nnz],
                    (rps, cps + halo_total + K),
                )

            per_shard_binned.append(
                (bin_rows(masked_csr(~row_halo), ladder=ladder),
                 bin_rows(masked_csr(row_halo), ladder=ladder))
            )
        else:
            local_csr = CSR.from_arrays(
                local_indptr.astype(np.int32),
                remapped.astype(np.int32),
                v,
                (rps, cps + halo_total + K),
            )
            per_shard_binned.append(bin_rows(local_csr, ladder=ladder))

    t_buckets = (
        _stack_binned(per_shard_t_binned, ladder) if with_transpose else None
    )
    common = dict(
        send_idx=jnp.asarray(send_idx),
        shape=csr.shape,
        n_shards=S,
        rows_per_shard=rps,
        cols_per_shard=cps,
        halo_size=H,
        hub_local_idx=None if not K else jnp.asarray(hub_local_idx),
        hub_perm=None if not K else jnp.asarray(hub_perm),
        transpose_buckets=t_buckets,
        offset_send=(None if offset_send is None
                     else tuple(jnp.asarray(a) for a in offset_send)),
        offset_widths=offset_widths,
        x_pack_idx=None if x_pack_idx is None else jnp.asarray(x_pack_idx),
        y_unpack_idx=(None if y_unpack_idx is None
                      else jnp.asarray(y_unpack_idx)),
    )
    if split_boundary:
        interior = _stack_binned([a for a, _ in per_shard_binned], ladder)
        boundary = _stack_binned([b for _, b in per_shard_binned], ladder)
        return RowPartitionPlan(
            buckets=(),
            interior_buckets=interior,
            boundary_buckets=boundary,
            **common,
        )
    return RowPartitionPlan(
        buckets=_stack_binned(per_shard_binned, ladder),
        **common,
    )


def _stack_binned(
    per_shard: Sequence[BinnedEll], ladder: Sequence[int]
) -> Tuple[StackedBucket, ...]:
    """Stack per-shard BinnedElls into uniform (S, R, K) arrays.

    SPMD requires identical shapes on every shard, so each width bucket is
    padded to the max row count over shards (padding rows: row_id 0,
    vals 0 — harmless under scatter-add).
    """
    S = len(per_shard)
    widths = sorted(
        {b.width for sh in per_shard for b in sh.buckets}
    )
    out = []
    for w in widths:
        per = []
        for sh in per_shard:
            found = None
            for b in sh.buckets:
                if b.width == w:
                    found = b
            per.append(found)
        rmax = max((b.n_ell_rows if b is not None else 0) for b in per)
        rmax += -rmax % SUBLANES
        if rmax == 0:
            continue
        rids = np.zeros((S, rmax), np.int32)
        cols = np.zeros((S, rmax, w), np.int32)
        vals = np.zeros((S, rmax, w), np.float32)
        for s, b in enumerate(per):
            if b is None:
                continue
            r = b.n_ell_rows
            b_rids = np.asarray(b.row_ids)
            rids[s, :r] = b_rids
            # keep row_ids ascending through the cross-shard padding too
            if r:
                rids[s, r:] = b_rids[-1]
            cols[s, :r] = np.asarray(b.cols)
            vals[s, :r] = np.asarray(b.vals)
        out.append(
            StackedBucket(
                row_ids=jnp.asarray(rids),
                cols=jnp.asarray(cols),
                vals=jnp.asarray(vals),
            )
        )
    return tuple(out)
