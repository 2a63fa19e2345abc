"""Row-binned padded-ELL format — the load-balanced kernel-facing layout.

The reference sidesteps load balance with per-edge CUDA atomics
(oneflow/user/kernels/unsorted_segment_sum_kernel_util.cu:52-71). Here load
balance is achieved structurally at plan time, so the kernel needs no
atomics:

- rows are binned by nnz into buckets with widths from a fixed power-of-two
  ladder, each row padded (with val=0 entries, mirroring the reference's
  bounds-check-to-zero read) up to the bucket width;
- rows wider than the max ladder width are *split* into several ELL rows
  whose partial results are scatter-added — this bounds the per-tile work
  and makes power-law degree skew (Reddit/ogbn) tractable;
- each bucket's row count is padded to a multiple of 8 with zero-value
  dummy rows;
- the ladder is fixed, so jit recompilation is bounded to a small set of
  (width, padded-rows) shapes (SURVEY.md §7 hard part 5).

All binning runs host-side in numpy at plan time and RETURNS numpy arrays —
no device transfers happen here. make_operator / partition_rows place the
finished plan on device once with jax.device_put.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.sparse.formats import CSR

# Power-of-two bucket-width ladder. Width-0 rows are dropped entirely
# (they contribute nothing; output rows default to zero).
DEFAULT_LADDER: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)
SUBLANES = 8  # bucket row counts are padded to a multiple of this.


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One padded-ELL bucket: R rows of exactly K (padded) nonzeros."""

    row_ids: jnp.ndarray  # (R,) int32 — output row each ELL row adds into
    cols: jnp.ndarray  # (R, K) int32 — padded with 0 (val 0 masks it)
    vals: jnp.ndarray  # (R, K) float — padding entries are exactly 0

    def tree_flatten(self):
        return (self.row_ids, self.cols, self.vals), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        row_ids, cols, vals = children
        return cls(row_ids=row_ids, cols=cols, vals=vals)

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def n_ell_rows(self) -> int:
        return int(self.cols.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Finish:
    """Plan-time permutation that turns bucket-ordered partial results into
    output rows with ONE gather instead of per-bucket scatters.

    ``pos[r]`` is the index (into the concatenation of all buckets' ELL
    rows) of the first ELL row writing output row r, or an out-of-range
    sentinel for empty rows (the framework gather semantics turn it into
    zeros). ``extra_*`` lists the remaining ELL rows of split rows — a
    scatter-add over only those few rows finishes the job.
    """

    pos: jnp.ndarray  # (n_rows,) int32; sentinel = total ELL rows
    extra_rids: jnp.ndarray  # (E,) int32, ascending
    extra_idx: jnp.ndarray  # (E,) int32

    def tree_flatten(self):
        return (self.pos, self.extra_rids, self.extra_idx), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BucketExtras:
    """Per-bucket split-row leftovers for the relabeled (slice-concat) finish.

    rids[b] are output rows (ascending) receiving contrib rows idx[b] of
    bucket b beyond each row's first chunk.
    """

    rids: Tuple[jnp.ndarray, ...]
    idx: Tuple[jnp.ndarray, ...]

    def tree_flatten(self):
        return (self.rids, self.idx), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        rids, idx = children
        return cls(rids=tuple(rids), idx=tuple(idx))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BinnedEll:
    """A CSR matrix re-laid-out as a tuple of padded-ELL buckets.

    ``slice_counts`` (static), when set, marks the *relabeled* layout: the
    first slice_counts[b] ELL rows of bucket b write output rows
    contiguously in bucket-concat order (see bin_rows_relabeled), so the
    finish is slicing + concatenation instead of a gather.
    """

    buckets: Tuple[EllBucket, ...]
    shape: Tuple[int, int]  # static logical (n_rows, n_cols)
    has_split_rows: bool  # static: True if any row was split across ELL rows
    finish: Optional[Finish] = None
    slice_counts: Optional[Tuple[int, ...]] = None

    def tree_flatten(self):
        return (self.buckets, self.finish), (
            self.shape, self.has_split_rows, self.slice_counts)

    @classmethod
    def tree_unflatten(cls, aux, children):
        buckets, finish = children
        shape, has_split_rows, slice_counts = aux
        return cls(buckets=tuple(buckets), shape=shape,
                   has_split_rows=has_split_rows, finish=finish,
                   slice_counts=slice_counts)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_padded(self) -> int:
        return sum(b.n_ell_rows * b.width for b in self.buckets)

    def padding_efficiency(self, true_nnz: int) -> float:
        """Fraction of padded slots holding real nonzeros (1.0 = no waste)."""
        p = self.nnz_padded
        return float(true_nnz) / p if p else 1.0


def _pick_width(deg: int, ladder: Sequence[int]) -> int:
    for w in ladder:
        if deg <= w:
            return w
    return ladder[-1]


def optimal_ladder(
    csr: CSR,
    max_buckets: int = 10,
    max_width: int = 256,
) -> Tuple[int, ...]:
    """Choose bucket widths minimizing padded-slot count for this graph.

    Classic breakpoint DP over the (clipped) degree histogram: pick up to
    ``max_buckets`` widths w1<...<wB=max_width minimizing
    sum_rows smallest-width >= deg(row) (rows wider than max_width are
    pre-split into chunks <= max_width, so the histogram is clipped).
    O(max_width^2 * max_buckets) — negligible at plan time.
    """
    degs = np.diff(np.asarray(csr.indptr))
    degs = degs[degs > 0]
    if degs.size == 0:
        return (max_width,)
    # split heavy rows exactly as bin_rows will: full chunks of max_width
    # (histogram entry max_width) plus one remainder chunk.
    n_full = (degs // max_width).sum()
    rem = degs % max_width
    rem = rem[rem > 0]
    hist = np.bincount(rem, minlength=max_width + 1).astype(np.int64)
    hist[max_width] += n_full
    return ladder_from_hist(hist, max_buckets=max_buckets, max_width=max_width)


def ladder_from_hist(
    hist: np.ndarray, max_buckets: int = 10, max_width: int = 256
) -> Tuple[int, ...]:
    """Breakpoint DP over a chunk-length histogram (see optimal_ladder)."""
    W = max_width
    # cnt[w] rows with chunk length exactly w (1..W)
    # cost(a, b) = padded slots if widths (a, b] all map to width b
    csum = np.zeros(W + 1, dtype=np.int64)
    wsum = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(hist, out=csum)  # csum[w] = #chunks with len <= w
    np.cumsum(hist * np.arange(W + 1), out=wsum)

    def cost(a: int, b: int) -> int:
        # chunks with len in (a, b] padded to b
        return b * (csum[b] - csum[a]) - (wsum[b] - wsum[a])

    B = max_buckets
    INF = 1 << 62
    # dp[j][w]: min pad using j buckets covering lengths (0, w]
    dp = np.full((B + 1, W + 1), INF, dtype=np.int64)
    choice = np.zeros((B + 1, W + 1), dtype=np.int32)
    dp[0, 0] = 0
    lens = np.nonzero(hist[1:])[0] + 1  # candidate breakpoints: present lens
    cands = sorted(set(lens.tolist()) | {W})
    for j in range(1, B + 1):
        for w in cands:
            best, arg = INF, 0
            for a in [0] + [c for c in cands if c < w]:
                if dp[j - 1, a] >= INF:
                    continue
                v = dp[j - 1, a] + cost(a, w)
                if v < best:
                    best, arg = v, a
            dp[j, w], choice[j, w] = best, arg
    # best bucket count <= B ending at W
    j_best = min(range(1, B + 1), key=lambda j: dp[j, W])
    widths = []
    w, j = W, j_best
    while w > 0 and j > 0:
        widths.append(w)
        w = int(choice[j, w])
        j -= 1
    return tuple(sorted(widths))


def bin_rows(
    csr: CSR,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 10,
    max_width: int = 256,
) -> BinnedEll:
    """Bin CSR rows by degree into padded-ELL buckets (host-side, plan time).

    ``ladder="auto"`` runs the breakpoint DP (optimal_ladder) to pick the
    width set minimizing padded slots for this graph's degree histogram.
    Rows with degree > max(ladder) are split into ceil(deg / max_width)
    ELL rows sharing the same output row id; their partial sums are
    combined by scatter-add in the compute path.

    Bucket row_ids are ascending (padding rows repeat the last row id with
    zero values), so consumers may scatter with indices_are_sorted=True.
    """
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        ladder = optimal_ladder(csr, max_buckets=max_buckets, max_width=max_width)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    if not ladder:
        raise ValueError("ladder must be non-empty")
    max_w = ladder[-1]

    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols)
    vals = np.asarray(csr.vals)
    degs = np.diff(indptr)
    n_rows = csr.shape[0]

    # 1) Chunkify every row into pieces of length <= max_w (fully vectorized).
    n_chunks_per_row = -(-degs // max_w)  # ceil; 0 for empty rows
    has_split = bool((n_chunks_per_row > 1).any())
    chunk_row = np.repeat(np.arange(n_rows, dtype=np.int64), n_chunks_per_row)
    total_chunks = chunk_row.shape[0]
    if total_chunks == 0:
        return BinnedEll(buckets=(), shape=csr.shape, has_split_rows=False)
    # index of each chunk within its row: arange reset at row boundaries
    row_first_chunk = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=row_first_chunk[1:])
    chunk_in_row = np.arange(total_chunks, dtype=np.int64) - np.repeat(
        row_first_chunk[:-1], n_chunks_per_row
    )
    chunk_start = indptr[chunk_row] + chunk_in_row * max_w
    chunk_len = np.minimum(max_w, degs[chunk_row] - chunk_in_row * max_w)

    # 2) Assign each chunk to the smallest ladder width that fits it.
    ladder_arr = np.asarray(ladder, dtype=np.int64)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")

    buckets = []
    real_rids = []  # per bucket: real (non-padding) row ids
    real_counts = []
    for wi, w in enumerate(ladder):
        sel = np.nonzero(width_idx == wi)[0]
        n = sel.shape[0]
        if n == 0:
            continue
        starts = chunk_start[sel]
        lens = chunk_len[sel]
        rids = chunk_row[sel]
        n_pad = -n % sublanes
        total = n + n_pad
        b_rows = np.zeros(total, dtype=np.int32)
        b_rows[:n] = rids
        # padding rows repeat the last (max) row id with zero vals: keeps
        # row_ids ascending so scatters may assume sorted indices.
        b_rows[n:] = rids[-1]
        b_cols = np.zeros((total, w), dtype=np.int32)
        b_vals = np.zeros((total, w), dtype=vals.dtype)
        # Flat scatter: chunk c occupies dest (c, 0:lens[c]) from
        # src starts[c] : starts[c]+lens[c].
        total_len = int(lens.sum())
        dst_row = np.repeat(np.arange(n, dtype=np.int64), lens)
        cum = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=cum[1:])
        intra = np.arange(total_len, dtype=np.int64) - np.repeat(cum[:-1], lens)
        src = np.repeat(starts, lens) + intra
        b_cols[dst_row, intra] = cols[src]
        b_vals[dst_row, intra] = vals[src]
        # dummy padding rows keep row_id 0 with all-zero vals: harmless
        # under scatter-add accumulation.
        buckets.append(
            EllBucket(row_ids=b_rows, cols=b_cols, vals=b_vals)
        )
        real_rids.append(rids.astype(np.int64))
        real_counts.append(total)

    finish = _build_finish(real_rids, real_counts, n_rows)
    return BinnedEll(buckets=tuple(buckets), shape=csr.shape,
                     has_split_rows=has_split, finish=finish)


def _build_finish(real_rids, bucket_totals, n_rows: int) -> Finish:
    """pos/extras for the permutation finish (see Finish docstring)."""
    sentinel_parts = []
    offsets = []
    off = 0
    for rids, total in zip(real_rids, bucket_totals):
        offsets.append(off)
        off += total
    total_rows = off
    if real_rids:
        all_rids = np.concatenate(real_rids)
        all_idx = np.concatenate(
            [o + np.arange(r.shape[0], dtype=np.int64)
             for o, r in zip(offsets, real_rids)]
        )
    else:
        all_rids = np.zeros(0, np.int64)
        all_idx = np.zeros(0, np.int64)
    order = np.argsort(all_rids, kind="stable")
    s_rids = all_rids[order]
    s_idx = all_idx[order]
    first = np.ones(s_rids.shape[0], dtype=bool)
    first[1:] = s_rids[1:] != s_rids[:-1]
    pos = np.full(n_rows, total_rows, dtype=np.int32)  # sentinel -> zeros
    pos[s_rids[first]] = s_idx[first]
    extra = ~first
    return Finish(
        pos=pos,
        extra_rids=s_rids[extra].astype(np.int32),
        extra_idx=s_idx[extra].astype(np.int32),
    )


def bin_rows_relabeled(
    csr: CSR,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 10,
    max_width: int = 256,
):
    """Bin a SQUARE matrix with plan-time node relabeling for a slice finish.

    Rows are renumbered so that output row order == bucket-concat order of
    each row's first chunk (empty rows last). Column indices are remapped
    through the same permutation, so the operator acts on the *relabeled*
    graph: inputs and outputs live in the internal (relabeled) space.

    Why: the generic finish permutation forces XLA to materialize the
    concatenated partial results, which breaks the take+einsum fusion.
    With relabeling, the finish is static slicing + concatenation straight
    into the output buffer; only split-row leftovers need a (tiny)
    scatter.

    Returns (binned, old_from_new, new_from_old): int32 permutations with
    x_internal = x[old_from_new] and y = y_internal[new_from_old].
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"relabeling requires a square matrix, got {csr.shape}")
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        ladder = optimal_ladder(csr, max_buckets=max_buckets, max_width=max_width)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    max_w = ladder[-1]
    ladder_arr = np.asarray(ladder, dtype=np.int64)

    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)
    degs = np.diff(indptr)

    # --- derive the permutation from each row's FIRST chunk width --------
    first_w = np.minimum(degs, max_w)  # 0 for empty rows
    first_bucket = np.searchsorted(ladder_arr, first_w, side="left")
    # sort key: (bucket of first chunk, old id); empty rows get bucket +inf
    key = np.where(degs > 0, first_bucket, len(ladder))
    old_from_new = np.argsort(key, kind="stable").astype(np.int64)
    new_from_old = np.empty(n, dtype=np.int64)
    new_from_old[old_from_new] = np.arange(n, dtype=np.int64)

    # --- chunkify in NEW row order (ascending new id == bucket order) ----
    o_degs = degs[old_from_new]
    n_chunks_per_row = -(-o_degs // max_w)
    has_split = bool((n_chunks_per_row > 1).any())
    chunk_row = np.repeat(np.arange(n, dtype=np.int64), n_chunks_per_row)  # new ids
    total_chunks = chunk_row.shape[0]
    row_first_chunk = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=row_first_chunk[1:])
    chunk_in_row = np.arange(total_chunks, dtype=np.int64) - np.repeat(
        row_first_chunk[:-1], n_chunks_per_row
    )
    old_rows = old_from_new[chunk_row]
    chunk_start = indptr[old_rows] + chunk_in_row * max_w
    chunk_len = np.minimum(max_w, degs[old_rows] - chunk_in_row * max_w)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")
    is_first = chunk_in_row == 0

    buckets = []
    extras_rids = []
    extras_idx = []
    slice_counts = []
    next_first_expected = 0
    for wi, w in enumerate(ladder):
        sel_first = np.nonzero((width_idx == wi) & is_first)[0]
        sel_extra = np.nonzero((width_idx == wi) & ~is_first)[0]
        nf, ne = sel_first.shape[0], sel_extra.shape[0]
        if nf + ne == 0:
            continue
        # firsts' new row ids must be one contiguous ascending run
        rids_first = chunk_row[sel_first]
        if nf:
            assert rids_first[0] == next_first_expected and (
                np.diff(rids_first) == 1
            ).all(), "relabeled firsts not contiguous (internal invariant)"
            next_first_expected = int(rids_first[-1]) + 1
        order = np.concatenate([sel_first, sel_extra])
        starts = chunk_start[order]
        lens = chunk_len[order]
        rids = chunk_row[order]
        total = nf + ne
        n_pad = -total % sublanes
        padded = total + n_pad
        b_rows = np.zeros(padded, dtype=np.int32)
        b_rows[:total] = rids
        if total:
            b_rows[total:] = rids[total - 1]
        b_cols = np.zeros((padded, w), dtype=np.int32)
        b_vals = np.zeros((padded, w), dtype=vals.dtype)
        total_len = int(lens.sum())
        dst_row = np.repeat(np.arange(total, dtype=np.int64), lens)
        cum = np.zeros(total + 1, dtype=np.int64)
        np.cumsum(lens, out=cum[1:])
        intra = np.arange(total_len, dtype=np.int64) - np.repeat(cum[:-1], lens)
        src = np.repeat(starts, lens) + intra
        b_cols[dst_row, intra] = new_from_old[cols[src]]  # relabel columns
        b_vals[dst_row, intra] = vals[src]
        buckets.append(
            EllBucket(row_ids=b_rows, cols=b_cols, vals=b_vals)
        )
        slice_counts.append(nf)
        e_order = np.argsort(chunk_row[sel_extra], kind="stable")
        extras_rids.append(chunk_row[sel_extra][e_order].astype(np.int32))
        extras_idx.append((nf + e_order).astype(np.int32))

    finish = BucketExtras(rids=tuple(extras_rids), idx=tuple(extras_idx))
    binned = BinnedEll(
        buckets=tuple(buckets),
        shape=csr.shape,
        has_split_rows=has_split,
        finish=finish,
        slice_counts=tuple(slice_counts),
    )
    return binned, old_from_new.astype(np.int32), new_from_old.astype(np.int32)
