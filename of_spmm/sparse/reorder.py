"""Locality reordering: cluster-recovering row/column relabeling.

An SpMM's gathers hit cache when the columns each block of output rows
references concentrate in contiguous id bands. Real co-purchase/social
graphs have that structure (communities), but only if node ids are laid
out cluster-contiguously — raw dataset ids usually aren't. This pass
recovers the layout: heavy-edge matching, label propagation or a
degree-seeded BFS (Cuthill–McKee) permutation places each vertex next to
its neighbors, so clusters land in contiguous id ranges. Relabeling reuses
the operator's old_from_new/new_from_old machinery (ops/autograd.py
SpmmOperator), so the public API stays in node space.

The reference has no clustering pass; its per-edge-atomic CUDA scatter
(oneflow/user/kernels/unsorted_segment_sum_kernel_util.cu:52-151) is
insensitive to ordering. Whether the reorder pays on the H100, where
locality buys L2 hits, is not measured yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from of_spmm.sparse.formats import CSR


def bfs_order(csr: CSR, seed_by: str = "min_degree") -> np.ndarray:
    """Cuthill–McKee-style BFS permutation.

    Returns ``old_from_new``: position k holds the OLD id placed at new
    id k. Vectorized frontier expansion (numpy per level, O(E) total);
    each connected component is seeded by its minimum-degree vertex —
    low-degree periphery first keeps each BFS shell (and therefore each
    id band) tight.
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # seeds in degree order (argsort once; skip visited as we go)
    if seed_by == "min_degree":
        seed_seq = np.argsort(deg, kind="stable")
    else:
        seed_seq = np.arange(n)
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[seed_seq[seed_ptr]]:
            seed_ptr += 1
        if seed_ptr >= n:
            # numerical safety: append any stragglers
            rest = np.nonzero(~visited)[0]
            order[pos:pos + rest.shape[0]] = rest
            visited[rest] = True
            pos += rest.shape[0]
            break
        frontier = np.asarray([seed_seq[seed_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.shape[0]:
            # place this shell in degree order (Cuthill–McKee rule)
            shell = frontier[np.argsort(deg[frontier], kind="stable")]
            order[pos:pos + shell.shape[0]] = shell
            pos += shell.shape[0]
            # expand: all neighbors of the shell, vectorized
            starts = indptr[shell]
            lens = deg[shell]
            total = int(lens.sum())
            if total == 0:
                break
            base = np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens)[:-1]]), lens)
            nbr = cols[base + np.arange(total)]
            nbr = nbr[~visited[nbr]]
            if nbr.shape[0] == 0:
                break
            frontier = np.unique(nbr)
            visited[frontier] = True
    return order


def label_prop_order(csr: CSR, iters: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Community-recovering permutation via label propagation.

    Each round every vertex adopts the most common label among its
    neighbors (ties broken toward the smaller label); labels converge to
    communities in a few rounds on modular graphs. The permutation sorts
    by (final label, vertex id), making every recovered community a
    contiguous id range — exactly what the ranges engine's windows want.
    BFS (bfs_order) keeps shells tight but hops across communities
    through stray inter-cluster edges; label propagation recovers the
    blocks themselves. Vectorized: one lexsort + segment-argmax per
    round, O(E log E).
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    labels = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        lab = labels[cols]
        order = np.lexsort((lab, rows))
        r_s, l_s = rows[order], lab[order]
        # count runs of equal (row, label)
        new_run = np.empty(r_s.shape[0], dtype=bool)
        if r_s.shape[0] == 0:
            break
        new_run[0] = True
        new_run[1:] = (r_s[1:] != r_s[:-1]) | (l_s[1:] != l_s[:-1])
        run_id = np.cumsum(new_run) - 1
        run_len = np.bincount(run_id)
        run_row = r_s[new_run]
        run_lab = l_s[new_run]
        # per row: label of the longest run (lexsort put smaller labels
        # first, so the first maximal run breaks ties toward them)
        improve = np.zeros(n, dtype=np.int64)
        np.maximum.at(improve, run_row, run_len)
        is_best = run_len == improve[run_row]
        idx = np.nonzero(is_best)[0]
        rr = run_row[idx]
        keep = np.concatenate([[True], rr[1:] != rr[:-1]])
        sel = idx[keep]
        new_labels = labels.copy()
        new_labels[run_row[sel]] = run_lab[sel]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return np.lexsort((np.arange(n), labels)).astype(np.int64)


def matching_order(csr: CSR, coarse_n: int = 2048,
                   max_levels: int = 48) -> np.ndarray:
    """Multilevel heavy-edge-matching permutation (METIS-style
    coarsening without refinement).

    Each level mutually matches every vertex with its heaviest unmatched
    neighbor (on degree-normalized weights, intra-community edges are
    the heavy ones) and contracts the pairs; parallel edges sum, so
    communities coalesce into supernodes within a few levels. The final
    ordering expands the coarsest level's BFS order back down the
    contraction tree — every community (at every scale) lands in a
    contiguous id range.

    Label propagation (label_prop_order) recovers planted blocks on
    small graphs but collapses to mega-labels at ogbn scale (measured:
    65 labels / 0.20 band coverage on shuffled products-small, vs 0.62
    for this pass — PROFILE_r04.md); matching has no label dynamics to
    oscillate. O(E log E) per level with geometrically shrinking E.

    r5 refinement study (negative results, committed so they are not
    re-tried): spectrally re-sequencing 128/256/512-row chunks of the
    final order moves shuffled products-small band coverage by <0.001
    (0.5949 -> 0.5950); coarse_n {512: 0.589, 2048: 0.595, 8192: 0.563,
    32768: 0.448} peaks at the default; a second matching pass on the
    relabeled graph LOSES coverage (0.577). The remaining gap to the
    planted 0.797 lives in the level-0 matching quality (hub-capped
    Jaccard mis-merges), not in supernode sequencing.

    The native path (csrc/planner.cpp hem_order) and this numpy
    fallback differ algorithmically: native uses Jaccard
    common-neighbor level-0 weights (256-degree hub cap) with GREEDY
    periphery-first matching; the fallback matches mutually on raw
    contracted weights. Orderings and recovered locality therefore
    differ by toolchain — tests pin only the permutation contract.
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    from of_spmm import native

    nat = native.hem_order(indptr, np.asarray(csr.cols),
                           np.asarray(csr.vals, np.float32), coarse_n,
                           max_levels)
    if nat is not None:
        return nat
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    # drop self loops (never matchable)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    children = []  # per level: (first_child, second_child|-1) arrays
    cur_n = n
    for _ in range(max_levels):
        if cur_n <= coarse_n or rows.shape[0] == 0:
            break
        # heaviest neighbor per vertex (ties -> smaller neighbor id);
        # rows are sorted after contraction, so segment reductions run
        # via reduceat (ufunc.at is ~100 ns/element — measured 100+ s at
        # 12M nnz)
        counts = np.bincount(rows, minlength=cur_n)
        ip = np.zeros(cur_n + 1, np.int64)
        np.cumsum(counts, out=ip[1:])
        nz = counts > 0
        starts = ip[:-1][nz]
        best_w = np.zeros(cur_n)
        best_w[nz] = np.maximum.reduceat(vals, starts)
        is_best = vals >= best_w[rows] - 1e-300
        h = np.full(cur_n, cur_n, dtype=np.int64)
        h[nz] = np.minimum.reduceat(np.where(is_best, cols, cur_n),
                                    starts)
        # mutual matches only
        hh = np.where(h < cur_n, h, 0)
        mutual = (h < cur_n) & (h[hh] == np.arange(cur_n)) \
            & (np.arange(cur_n) != h)
        mate = np.where(mutual, h, np.arange(cur_n))
        # parent = min(u, mate); compress ids
        parent = np.minimum(np.arange(cur_n), mate)
        uniq, new_of = np.unique(parent, return_inverse=True)
        nxt_n = uniq.shape[0]
        if nxt_n >= cur_n:  # no progress
            break
        # children table for expansion
        c1 = uniq
        c2 = np.where(mate[uniq] != uniq, mate[uniq], -1)
        children.append((c1, c2))
        # contract edges
        pr = new_of[parent[rows]]
        pc = new_of[parent[cols]]
        ek = pr * nxt_n + pc
        keep = pr != pc
        ek = ek[keep]
        vv = vals[keep]
        uk, inv = np.unique(ek, return_inverse=True)
        vals = np.bincount(inv, weights=vv)
        rows = uk // nxt_n
        cols = uk - rows * nxt_n
        cur_n = nxt_n

    # coarse ordering: BFS over the coarse graph keeps sibling
    # communities adjacent
    if rows.shape[0]:
        order = np.argsort(rows * cur_n + cols, kind="stable")
        counts = np.bincount(rows, minlength=cur_n)
        cp = np.zeros(cur_n + 1, np.int64)
        np.cumsum(counts, out=cp[1:])
        coarse = CSR.from_arrays(
            cp, cols[order].astype(np.int32),
            vals[order].astype(np.float32), (cur_n, cur_n))
        cur_order = bfs_order(coarse)
    else:
        cur_order = np.arange(cur_n, dtype=np.int64)

    # expand back down the contraction tree
    for c1, c2 in reversed(children):
        o1 = c1[cur_order]
        o2 = c2[cur_order]
        both = np.empty((cur_order.shape[0], 2), np.int64)
        both[:, 0] = o1
        both[:, 1] = o2
        flat = both.ravel()
        cur_order = flat[flat >= 0]
    return cur_order.astype(np.int64)


def reorder_locality(csr: CSR, method: str = "lp"
                     ) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """(relabeled P·A·Pᵀ, old_from_new, new_from_old).

    Square matrices only (rows and columns are the same vertex set); the
    permutation applies to both so the relabeled adjacency keeps the
    gather×segment-sum semantics under to_internal/from_internal.
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(
            f"reorder_locality needs a square adjacency, got {csr.shape}")
    if method in ("match", "hem", True):
        old_from_new = matching_order(csr)
    elif method in ("lp", "bfs+lp"):
        old_from_new = label_prop_order(csr)
    elif method == "bfs":
        old_from_new = bfs_order(csr)
    elif method == "identity":
        old_from_new = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown reorder method {method!r} "
                         "(want match|lp|bfs|identity)")
    new_from_old = np.empty(n, dtype=np.int64)
    new_from_old[old_from_new] = np.arange(n, dtype=np.int64)

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    from of_spmm.sparse.formats import COO

    relabeled = CSR.from_coo(COO.from_arrays(
        new_from_old[rows].astype(np.int32),
        new_from_old[cols].astype(np.int32),
        vals, csr.shape))
    return relabeled, old_from_new, new_from_old


def locality_stats(csr: CSR, R: int = 128, window: int = 12288) -> dict:
    """Plan-free locality diagnostics: how much of each R-row tile's
    column mass the densest ``window``-row band would capture.

    Used to measure reordering gains without a plan build."""
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    n_tiles = max(-(-n // R), 1)
    covered = 0
    total = 0
    w = min(window, m)
    for t in range(n_tiles):
        lo, hi = indptr[t * R], indptr[min((t + 1) * R, n)]
        c = np.sort(cols[lo:hi])
        u, cnt = np.unique(c, return_counts=True)
        _, mass = _best_window(u, cnt, m, w)
        covered += mass
        total += c.shape[0]
    return {"tiles": n_tiles, "window": w,
            "band_coverage": covered / max(total, 1)}


def _best_window(cols: np.ndarray, counts: np.ndarray, m: int,
                 w: int) -> Tuple[int, int]:
    """(lo, mass) of the densest w-row window over weighted sorted cols.

    Sparse two-pointer over the sorted distinct cols — O(k) per tile;
    the window start snaps to a multiple of 128 and stays in [0, m)."""
    if cols.shape[0] == 0:
        return 0, 0
    pref = np.zeros(cols.shape[0] + 1, np.int64)
    np.cumsum(counts, out=pref[1:])
    hi = np.searchsorted(cols, cols + w, side="left")
    mass = pref[hi] - pref[np.arange(cols.shape[0])]
    lo = int(cols[int(np.argmax(mass))])
    lo = min(max(lo // 128 * 128, 0), max((m - w) // 128 * 128, 0))
    a = np.searchsorted(cols, lo, side="left")
    b = np.searchsorted(cols, lo + w, side="left")
    return lo, int(pref[b] - pref[a])
