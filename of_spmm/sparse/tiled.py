"""Column-tiered binned-ELL — the column-sliced SpMM layout.

Splits the COLUMN space into tiers of ``tier_size`` rows of X; each tier's
nonzeros gather from a slice of X small enough to stay in cache. It
was built for a device whose gather slowed down on multi-megarow tables;
on the H100 the plain binned layout is the default (``make_operator``
layout="auto") and this one stays, in plain XLA, behind layout="tiered".

Layout (built host-side at plan time, like sparse/binned.py):

- a row's nonzeros are CSR-sorted by column, so its nnz inside one tier
  form a contiguous run; runs are chunked to <= max ladder width and each
  chunk becomes an ELL row in bucket (tier, width);
- chunk-length histogram over ALL tiers drives one global width ladder
  (ladder_from_hist DP);
- the finish is the generic plan-time permutation (Finish): one pos-gather
  assembles output rows from the concatenated per-(tier,bucket) partials,
  a sorted scatter-add folds in rows split across tiers/chunks.

Column locality matters: community/cluster-contiguous node ids keep each
row's nnz in few tiers (few split rows). Real co-purchase/social graphs
ordered by any clustering pass have this property; data/graphs.py's
generator reproduces it.

Cited reference behavior: this is still gather + segment-sum semantics
(oneflow/user/ops/gather_op.cpp, unsorted_segment_sum_op.cpp).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.sparse.binned import (
    SUBLANES,
    EllBucket,
    Finish,
    _build_finish,
    ladder_from_hist,
)
from of_spmm.sparse.formats import CSR

# Default column-tier height (rows of X per tier); make_operator's
# ``tier_size`` overrides it.
DEFAULT_TIER_SIZE = 131072


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TierBlock:
    """All width-buckets of one column tier; cols are tier-local."""

    tier: int  # static: column range [tier*tier_size, ...)
    buckets: Tuple[EllBucket, ...]

    def tree_flatten(self):
        return (self.buckets,), (self.tier,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (buckets,) = children
        return cls(tier=aux[0], buckets=tuple(buckets))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TieredEll:
    """Column-tiered ELL plan for Y = A @ X."""

    tiers: Tuple[TierBlock, ...]
    finish: Finish
    shape: Tuple[int, int]  # logical (n_rows, n_cols)
    tier_size: int  # static

    def tree_flatten(self):
        return (self.tiers, self.finish), (self.shape, self.tier_size)

    @classmethod
    def tree_unflatten(cls, aux, children):
        tiers, finish = children
        shape, tier_size = aux
        return cls(tiers=tuple(tiers), finish=finish, shape=shape,
                   tier_size=tier_size)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_padded(self) -> int:
        return sum(
            b.n_ell_rows * b.width for t in self.tiers for b in t.buckets
        )

    def padding_efficiency(self, true_nnz: int) -> float:
        p = self.nnz_padded
        return float(true_nnz) / p if p else 1.0


def bin_rows_tiered(
    csr: CSR,
    tier_size: int = DEFAULT_TIER_SIZE,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 8,
    max_width: int = 256,
    min_run: int = 4,
) -> TieredEll:
    """Build the tiered plan (host-side numpy; see module docstring).

    ``min_run``: runs shorter than this (a row's stray nonzeros in a
    foreign tier — the anti-locality tail every real graph has) are
    diverted to per-row COLD chunks that gather from the full table under
    sentinel tier -1. Without coalescing, stray single-nnz runs explode
    the ELL row count (46M ELL rows on a 123M-nnz graph = 24GB of
    partials), and each fragment also costs a finish scatter.
    """
    if not isinstance(ladder, str):
        # an explicit ladder caps the chunk length, as bin_rows does
        max_width = int(max(ladder))
    n, m = csr.shape
    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)
    nnz = cols.shape[0]
    n_tiers = max(-(-m // tier_size), 1)

    # --- split every row into (row, tier) runs ---------------------------
    # CSR column order => runs are contiguous slices. Boundary positions:
    # where the tier of consecutive nnz changes, or a row starts.
    tier_of = cols // tier_size
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    if nnz:
        new_run = np.ones(nnz, dtype=bool)
        new_run[1:] = (tier_of[1:] != tier_of[:-1]) | (row_of[1:] != row_of[:-1])
        run_start = np.nonzero(new_run)[0]
        run_end = np.concatenate([run_start[1:], [nnz]])
        run_len = run_end - run_start
        run_row = row_of[run_start]
        run_tier = tier_of[run_start]
    else:
        run_start = run_len = run_row = run_tier = np.zeros(0, np.int64)

    # --- divert short runs to per-row cold chunks (tier -1) --------------
    if min_run > 1 and n_tiers > 1 and run_start.shape[0]:
        cold_run = run_len < min_run
        if cold_run.any():
            # mark cold nnz, regroup them per row (CSR order preserved)
            cold_nnz = np.zeros(nnz, dtype=bool)
            c_starts = run_start[cold_run]
            c_lens = run_len[cold_run]
            pos = np.repeat(c_starts, c_lens) + (
                np.arange(int(c_lens.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(np.concatenate([[0], c_lens[:-1]])), c_lens)
            )
            cold_nnz[pos] = True
            # hot runs keep their (start, len, row, tier)
            run_start = run_start[~cold_run]
            run_len = run_len[~cold_run]
            run_row = run_row[~cold_run]
            run_tier = run_tier[~cold_run]
            # cold runs: one run per row over the cold subset, expressed in
            # a compacted nnz space (gather indices stay original cols)
            cold_idx = np.nonzero(cold_nnz)[0]
            cold_rows = row_of[cold_idx]
            boundary = np.ones(cold_idx.shape[0], dtype=bool)
            boundary[1:] = cold_rows[1:] != cold_rows[:-1]
            c_run_start_c = np.nonzero(boundary)[0]  # in cold-compacted space
            c_run_end_c = np.concatenate([c_run_start_c[1:], [cold_idx.shape[0]]])
            c_run_len = c_run_end_c - c_run_start_c
            c_run_row = cold_rows[c_run_start_c]
        else:
            cold_idx = np.zeros(0, np.int64)
            c_run_start_c = c_run_len = c_run_row = np.zeros(0, np.int64)
    else:
        cold_idx = np.zeros(0, np.int64)
        c_run_start_c = c_run_len = c_run_row = np.zeros(0, np.int64)

    # --- chunk runs to <= max_width (same as bin_rows row splitting) -----
    def chunkify(starts, lens, rows, tiers):
        n_chunks = -(-lens // max_width)
        chunk_run = np.repeat(np.arange(starts.shape[0], dtype=np.int64), n_chunks)
        total = chunk_run.shape[0]
        first = np.zeros(starts.shape[0] + 1, dtype=np.int64)
        np.cumsum(n_chunks, out=first[1:])
        in_run = np.arange(total, dtype=np.int64) - np.repeat(first[:-1], n_chunks)
        c_start = starts[chunk_run] + in_run * max_width
        c_len = np.minimum(max_width, lens[chunk_run] - in_run * max_width)
        return c_start, c_len, rows[chunk_run], tiers[chunk_run]

    chunk_start, chunk_len, chunk_row, chunk_tier = chunkify(
        run_start, run_len, run_row, run_tier
    )
    if c_run_row.shape[0]:
        cc_start, cc_len, cc_row, cc_tier = chunkify(
            c_run_start_c, c_run_len, c_run_row,
            np.full(c_run_row.shape[0], -1, dtype=np.int64),
        )
        chunk_start = np.concatenate([chunk_start, cc_start])
        chunk_len = np.concatenate([chunk_len, cc_len])
        chunk_row = np.concatenate([chunk_row, cc_row])
        chunk_tier = np.concatenate([chunk_tier, cc_tier])

    # --- one global ladder from the chunk-length histogram ---------------
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        hist = np.bincount(
            np.minimum(chunk_len, max_width), minlength=max_width + 1
        ).astype(np.int64)
        hist[0] = 0
        ladder = ladder_from_hist(hist, max_buckets=max_buckets, max_width=max_width)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    ladder_arr = np.asarray(ladder, dtype=np.int64)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")

    # --- build per-(tier, width) ELL buckets ------------------------------
    # tier -1 (cold) first: its gather table is the full X (original cols,
    # positions routed through cold_idx back to original nnz slots).
    # One lexsort groups chunks by (tier, width); each bucket is then a
    # contiguous slice — the naive per-bucket boolean mask re-scans the
    # full chunk list n_tiers*n_widths times (measured 20+ min on 123M nnz
    # at 75 tiers; this path is seconds).
    order = np.lexsort((width_idx, chunk_tier))
    s_tier = chunk_tier[order]
    s_width = width_idx[order]
    group_key = (s_tier + 1) * (len(ladder) + 1) + s_width
    g_bounds = np.nonzero(
        np.concatenate([[True], group_key[1:] != group_key[:-1]])
    )[0]
    g_ends = np.concatenate([g_bounds[1:], [order.shape[0]]])

    tier_blocks = []
    real_rids = []  # per emitted bucket (concat order): real row ids
    bucket_totals = []
    groups_by_tier: dict = {}
    for lo, hi in zip(g_bounds, g_ends):
        groups_by_tier.setdefault(int(s_tier[lo]), []).append(
            (int(s_width[lo]), order[lo:hi])
        )
    for t in [-1] + list(range(n_tiers)):
        if t not in groups_by_tier:
            continue
        buckets = []
        for wi, sel in groups_by_tier[t]:
            w = ladder[wi]
            nsel = sel.shape[0]
            if nsel == 0:
                continue
            starts = chunk_start[sel]
            lens = chunk_len[sel]
            rids = chunk_row[sel]
            n_pad = -nsel % sublanes
            total = nsel + n_pad
            b_rows = np.zeros(total, dtype=np.int32)
            b_rows[:nsel] = rids
            if nsel:
                b_rows[nsel:] = rids[-1]
            b_cols = np.zeros((total, w), dtype=np.int32)
            b_vals = np.zeros((total, w), dtype=vals.dtype)
            total_len = int(lens.sum())
            dst_row = np.repeat(np.arange(nsel, dtype=np.int64), lens)
            cum = np.zeros(nsel + 1, dtype=np.int64)
            np.cumsum(lens, out=cum[1:])
            intra = np.arange(total_len, dtype=np.int64) - np.repeat(cum[:-1], lens)
            src = np.repeat(starts, lens) + intra
            if t < 0:
                src = cold_idx[src]  # compacted cold space -> original nnz
                b_cols[dst_row, intra] = cols[src]  # full-table indices
            else:
                b_cols[dst_row, intra] = cols[src] - t * tier_size  # tier-local
            b_vals[dst_row, intra] = vals[src]
            buckets.append(EllBucket(row_ids=b_rows, cols=b_cols, vals=b_vals))
            real_rids.append(rids)
            bucket_totals.append(total)
        tier_blocks.append(TierBlock(tier=t, buckets=tuple(buckets)))

    finish = _build_finish(real_rids, bucket_totals, n)
    return TieredEll(
        tiers=tuple(tier_blocks),
        finish=finish,
        shape=csr.shape,
        tier_size=tier_size,
    )
