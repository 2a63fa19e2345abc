"""Pure-XLA reference implementations — the numeric oracles.

These define the framework's semantics exactly as the reference defines
them with its gather / unsorted_segment_sum pair:

- ``gather``: out[i, ...] = params[indices[i], ...], out-of-range reads
  yield zeros (oneflow/user/kernels/gather_kernel_util.cu:28-56 bounds check).
- ``segment_sum``: out[seg_ids[i], ...] += data[i, ...] with a fixed
  ``num_segments`` (oneflow/user/ops/unsorted_segment_sum_op.cpp:21-131);
  out-of-range segment ids are dropped.
- ``spmv`` / ``spmm`` over COO are exactly segment_sum(vals * gather(x)),
  the same composition the reference's GNN aggregation uses.
- low-precision inputs accumulate in float32, mirroring the reference's
  fp16/bf16 -> fp32 tmp-buffer accumulation
  (oneflow/user/kernels/unsorted_segment_sum_kernel.cpp:144-217).

Every optimized kernel is tested against these at the reference's own
tolerance (rtol=1e-4, atol=1e-5).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm.sparse.binned import BinnedEll
from of_spmm.utils.config import FLAGS
from of_spmm.sparse.formats import COO, CSR

_LOW_PRECISION = (jnp.bfloat16, jnp.float16)


def _acc_dtype(dtype) -> jnp.dtype:
    """Accumulation dtype: fp32 for low-precision inputs."""
    return jnp.float32 if jnp.dtype(dtype) in _LOW_PRECISION else jnp.dtype(dtype)


# ---------------------------------------------------------------------------
# gather / segment_sum — the primitive pair.
# ---------------------------------------------------------------------------


def gather(params: jnp.ndarray, indices: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Row gather with out-of-range -> 0 semantics.

    Matches the reference gather op (oneflow/user/ops/gather_op.cpp:21-90):
    an index outside [0, params.shape[axis]) — including negative indices —
    contributes zeros rather than clamping or wrapping. The distributed
    row-split path relies on this (each shard gathers only rows it owns,
    zeros elsewhere, outputs combine by partial-sum; gather SBP at
    oneflow/user/ops/gather_op.cpp:51-82).
    """
    n = params.shape[axis]
    valid = (indices >= 0) & (indices < n)
    safe = jnp.where(valid, indices, 0)
    out = jnp.take(params, safe, axis=axis)
    # broadcast the validity mask over the non-indexed dims
    mask_shape = [1] * out.ndim
    for i, s in enumerate(indices.shape):
        mask_shape[axis + i] = s
    return jnp.where(valid.reshape(mask_shape), out, jnp.zeros((), out.dtype))


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
) -> jnp.ndarray:
    """Unsorted segment sum: out[seg_ids[i], ...] += data[i, ...].

    Matches oneflow/user/ops/unsorted_segment_sum_op.cpp:21-131 semantics
    (out-of-range ids dropped). Accumulates in fp32 for bf16/fp16 data.
    """
    acc = _acc_dtype(data.dtype)
    out = jax.ops.segment_sum(
        data.astype(acc), segment_ids, num_segments=num_segments
    )
    return out.astype(data.dtype)


def segment_sum_like(
    data: jnp.ndarray, segment_ids: jnp.ndarray, like: jnp.ndarray
) -> jnp.ndarray:
    """unsorted_segment_sum_like: shape taken from ``like`` — used as
    gather's backward (oneflow/core/autograd/gradient_funcs/gather.cpp:62-73).
    """
    return segment_sum(data, segment_ids, like.shape[0]).astype(like.dtype)


# ---------------------------------------------------------------------------
# SpMV / SpMM / SDDMM over COO and BinnedEll.
# ---------------------------------------------------------------------------

Sparse = Union[COO, CSR, BinnedEll]


def _coerce_coo(a: Sparse) -> COO:
    if isinstance(a, COO):
        return a
    if isinstance(a, CSR):
        return a.to_coo()  # host-side; fine for oracle use
    raise TypeError(f"expected COO/CSR, got {type(a)}")


def spmv(a: Sparse, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x for a sparse A and dense vector x."""
    coo = _coerce_coo(a)
    acc = _acc_dtype(jnp.result_type(coo.vals.dtype, x.dtype))
    contrib = coo.vals.astype(acc) * gather(x.astype(acc), coo.cols)
    y = jax.ops.segment_sum(contrib, coo.rows, num_segments=coo.shape[0])
    return y.astype(x.dtype)


def spmm(a: Sparse, x: jnp.ndarray) -> jnp.ndarray:
    """Y = A @ X for sparse A (n x m) and dense X (m x d).

    This is exactly the reference's GNN aggregation: per-edge gather of the
    source feature row, scale by edge value, segment-sum into the
    destination row.
    """
    if isinstance(a, BinnedEll):
        return spmm_binned_xla(a, x)
    coo = _coerce_coo(a)
    acc = _acc_dtype(jnp.result_type(coo.vals.dtype, x.dtype))
    gathered = gather(x.astype(acc), coo.cols)  # (nnz, d)
    contrib = coo.vals.astype(acc)[:, None] * gathered
    y = jax.ops.segment_sum(contrib, coo.rows, num_segments=coo.shape[0])
    return y.astype(x.dtype)


def sddmm(
    lhs: jnp.ndarray,
    rhs: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
) -> jnp.ndarray:
    """Sampled dense-dense matmul: out[e] = lhs[rows[e]] . rhs[cols[e]].

    The pattern-restricted product (L @ R^T)[rows, cols]; the vals-gradient
    of spmm uses it (dA.vals[e] = g[rows[e]] . X[cols[e]]).
    """
    acc = _acc_dtype(jnp.result_type(lhs.dtype, rhs.dtype))
    le = gather(lhs.astype(acc), rows)  # (nnz, d)
    re = gather(rhs.astype(acc), cols)  # (nnz, d)
    return jnp.sum(le * re, axis=-1).astype(lhs.dtype)


def spmm_binned_xla(
    binned: BinnedEll,
    x: jnp.ndarray,
    row_chunk: Optional[int] = None,
) -> jnp.ndarray:
    """XLA path over the binned-ELL layout: take + einsum + scatter-add.

    Per bucket: gather (R, K, d) feature rows, contract the K (padded-nnz)
    axis against vals, scatter-add ELL-row results into output rows. With
    ``row_chunk`` set, ELL rows are processed in chunks via lax.map to bound
    the materialized gather (R*K*d) memory.
    """
    d = x.shape[1]
    if not binned.buckets:
        return jnp.zeros((binned.n_rows, d), x.dtype)
    acc = _acc_dtype(jnp.result_type(x.dtype, *(b.vals.dtype for b in binned.buckets)))
    xa = x.astype(acc)

    contribs = []
    for b in binned.buckets:
        def one_chunk(args):
            cols, vals = args
            g = jnp.take(xa, cols, axis=0)  # (r, K, d)
            return jnp.einsum(
                "rk,rkd->rd", vals.astype(acc), g,
                preferred_element_type=acc,
            )

        if row_chunk is None or b.n_ell_rows <= row_chunk:
            contrib = one_chunk((b.cols, b.vals))
        else:
            r = b.n_ell_rows
            # pad ELL rows to a multiple of row_chunk, then lax.map chunks.
            pad = -r % row_chunk
            cols = jnp.pad(b.cols, ((0, pad), (0, 0)))
            vals = jnp.pad(b.vals, ((0, pad), (0, 0)))
            nchunks = (r + pad) // row_chunk
            cols = cols.reshape(nchunks, row_chunk, b.width)
            vals = vals.reshape(nchunks, row_chunk, b.width)
            contrib = jax.lax.map(one_chunk, (cols, vals)).reshape(r + pad, d)[:r]
        contribs.append(contrib)

    out = combine_contribs(binned, contribs, acc)
    return out.astype(x.dtype)


def combine_contribs(binned: BinnedEll, contribs, acc) -> jnp.ndarray:
    """Turn per-bucket ELL-row partial results into output rows.

    With a Finish plan: concatenate and apply the plan-time permutation —
    one gather (empty rows hit the sentinel and become zeros via the
    framework's gather semantics) plus a tiny scatter-add for split-row
    extras. Without: per-bucket sorted scatter-add (used inside shard_map
    where the finish arrays are not stacked).
    """
    from of_spmm.sparse.binned import BucketExtras, Finish

    if not contribs:
        return jnp.zeros((binned.n_rows, 0), dtype=acc)
    d = contribs[0].shape[1]
    fin = binned.finish
    if binned.slice_counts is not None:
        # relabeled layout: output rows ARE the bucket-concat order — the
        # finish is slicing into the output buffer, which XLA fuses with the
        # take+einsum producers (a gather/scatter consumer would break that
        # fusion; see bin_rows_relabeled docstring).
        parts = [c[:nf] for c, nf in zip(contribs, binned.slice_counts)]
        n_first = sum(binned.slice_counts)
        if n_first < binned.n_rows:  # empty rows sorted to the tail
            parts.append(jnp.zeros((binned.n_rows - n_first, d), dtype=acc))
        out = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        assert isinstance(fin, BucketExtras)
        for contrib, rids, idx in zip(contribs, fin.rids, fin.idx):
            if rids.shape[0]:
                out = out.at[rids].add(
                    jnp.take(contrib, idx, axis=0), indices_are_sorted=True
                )
        return out
    if fin is not None and isinstance(fin, Finish):
        cat = contribs[0] if len(contribs) == 1 else jnp.concatenate(contribs, axis=0)
        out = gather(cat, fin.pos)
        if fin.extra_rids.shape[0]:
            out = out.at[fin.extra_rids].add(
                jnp.take(cat, fin.extra_idx, axis=0), indices_are_sorted=True
            )
        return out
    out = jnp.zeros((binned.n_rows, d), dtype=acc)
    for b, contrib in zip(binned.buckets, contribs):
        # bin_rows guarantees ascending row_ids (padding repeats the max id)
        out = out.at[b.row_ids].add(contrib, indices_are_sorted=True)
    return out


def spmm_tiered_xla(tiled, x: jnp.ndarray) -> jnp.ndarray:
    """Column-tiered SpMM (see sparse/tiled.py): per tier, slice X to the
    tier's rows, gather + weighted-reduce each width bucket, then assemble
    rows with the plan-time Finish permutation. Cold (tier -1) buckets
    gather from the full X.

    The per-bucket reduce is an explicit multiply + sum, which XLA fuses
    into one loop fusion with the gather's consumers.
    """
    d = x.shape[1]
    if not tiled.tiers:
        return jnp.zeros((tiled.n_rows, d), x.dtype)
    acc = _acc_dtype(
        jnp.result_type(x.dtype, *(b.vals.dtype for t in tiled.tiers for b in t.buckets))
    )
    ts = tiled.tier_size
    n_pad = tiled.n_cols if tiled.n_cols % ts == 0 else (tiled.n_cols // ts + 1) * ts
    xa = x.astype(acc)
    if n_pad != x.shape[0]:
        xa = jnp.pad(xa, ((0, n_pad - x.shape[0]), (0, 0)))

    # Cap the transient gather materialization: XLA's take of (r, K) rows
    # materializes an (r*K, d) block; a hub bucket at 10^8-nnz scale would
    # exceed device memory (one 178k x 256 bucket at d=128 is 23 GB).
    # Buckets beyond the slot budget process in lax.map chunks.
    max_slots = int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS"))

    def bucket_contrib(xt, b):
        R, K = b.cols.shape
        v = b.vals.astype(acc)

        def one(cols_c, vals_c):
            if K <= 32:
                # K-accumulation: per-k take + multiply + add keeps every
                # intermediate (r, d)-shaped (the take's elementwise
                # consumers fuse; the (r, K, d) transient never
                # round-trips device memory).
                r_rows = cols_c.shape[0]

                def body(k, acc_):
                    ck = jax.lax.dynamic_index_in_dim(cols_c, k, 1, False)
                    vk = jax.lax.dynamic_index_in_dim(vals_c, k, 1, False)
                    return acc_ + vk[:, None] * jnp.take(xt, ck, axis=0)

                return jax.lax.fori_loop(
                    0, K, body, jnp.zeros((r_rows, xt.shape[1]), acc))
            g = jnp.take(xt, cols_c, axis=0)
            return (vals_c[:, :, None] * g).sum(axis=1)

        if R * K <= max_slots:
            return one(b.cols, v)
        rows_per = max(max_slots // K, 8)
        pad = -R % rows_per
        cols_p = jnp.pad(b.cols, ((0, pad), (0, 0)))
        vals_p = jnp.pad(v, ((0, pad), (0, 0)))
        nchunk = (R + pad) // rows_per
        out = jax.lax.map(
            lambda args: one(*args),
            (cols_p.reshape(nchunk, rows_per, K),
             vals_p.reshape(nchunk, rows_per, K)),
        )
        return out.reshape(R + pad, -1)[:R]

    contribs = []
    for t in tiled.tiers:
        if t.tier < 0:
            xt = xa  # cold chunks: full-table gather (coalesced stray nnz)
        else:
            xt = jax.lax.slice_in_dim(xa, t.tier * ts, (t.tier + 1) * ts, axis=0)
        for b in t.buckets:
            contribs.append((b, bucket_contrib(xt, b)))

    total_ell_rows = sum(c.shape[0] for _, c in contribs)
    cat_bytes = total_ell_rows * d * jnp.dtype(acc).itemsize
    if cat_bytes > int(FLAGS.get("OFS_TIERED_SCATTER_BYTES")):
        # Large plans: one jnp.concatenate would hold every contribution
        # AND the result live at once (2x cat bytes). Assemble instead with
        # static-offset dynamic_update_slice into one preallocated buffer:
        # XLA updates in place, and each contribution's buffer dies right
        # after its insertion. (A per-bucket scatter-add combine copies the
        # whole output once per bucket.)
        cat = jnp.zeros((total_ell_rows, d), acc)
        off = 0
        for _, c in contribs:
            cat = jax.lax.dynamic_update_slice(cat, c, (off, 0))
            off += c.shape[0]
    else:
        cat = (contribs[0][1] if len(contribs) == 1
               else jnp.concatenate([c for _, c in contribs], axis=0))
    fin = tiled.finish
    out = gather(cat, fin.pos)
    if fin.extra_rids.shape[0]:
        out = out.at[fin.extra_rids].add(
            gather(cat, fin.extra_idx), indices_are_sorted=True
        )
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# SpGEMM — host-side expand/sort/reduce (plan-time op).
# ---------------------------------------------------------------------------


def spgemm(a: CSR, b: CSR) -> CSR:
    """C = A @ B for CSR operands — host-side numpy (plan-time).

    Output nnz is unknown until computed, so this runs outside jit
    (SURVEY.md §7 hard part 4: static-shape JAX needs two-phase or
    upper-bound allocation; GNN usage — 2-hop expansion A @ A — is graph
    preprocessing, naturally a plan-time operation). Algorithm:
    expand every (i,k,v_a) against B's row k, lexsort the (i,j) products,
    reduce duplicate coordinates by summation.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    from of_spmm import native

    nat = native.spgemm(
        np.asarray(a.indptr), np.asarray(a.cols), np.asarray(a.vals),
        np.asarray(b.indptr), np.asarray(b.cols), np.asarray(b.vals),
        a.shape[0], b.shape[1],
    )
    if nat is not None:
        indptr, cols, vals = nat
        return CSR.from_arrays(
            indptr.astype(np.int32), cols, vals, (a.shape[0], b.shape[1])
        )
    a_indptr = np.asarray(a.indptr).astype(np.int64)
    a_cols = np.asarray(a.cols)
    a_vals = np.asarray(a.vals)
    b_indptr = np.asarray(b.indptr).astype(np.int64)
    b_cols = np.asarray(b.cols)
    b_vals = np.asarray(b.vals)

    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a_indptr))
    # expansion size per A-nonzero = nnz of B row a_cols[e]
    exp_counts = (b_indptr[a_cols + 1] - b_indptr[a_cols]).astype(np.int64)
    total = int(exp_counts.sum())
    if total == 0:
        return CSR.from_arrays(
            np.zeros(a.shape[0] + 1, np.int32), np.zeros(0, np.int32),
            np.zeros(0, a_vals.dtype), (a.shape[0], b.shape[1]),
        )
    e_ids = np.repeat(np.arange(a_cols.shape[0], dtype=np.int64), exp_counts)
    cum = np.zeros(a_cols.shape[0] + 1, dtype=np.int64)
    np.cumsum(exp_counts, out=cum[1:])
    intra = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], exp_counts)
    b_pos = b_indptr[a_cols[e_ids]] + intra

    out_rows = a_rows[e_ids]
    out_cols = b_cols[b_pos].astype(np.int64)
    out_vals = a_vals[e_ids] * b_vals[b_pos]

    # reduce duplicates: lexsort by (row, col), segment boundaries where
    # either changes.
    order = np.lexsort((out_cols, out_rows))
    out_rows, out_cols, out_vals = out_rows[order], out_cols[order], out_vals[order]
    key = out_rows * b.shape[1] + out_cols
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = key[1:] != key[:-1]
    group = np.cumsum(boundary) - 1
    n_out = int(group[-1]) + 1
    red_vals = np.zeros(n_out, dtype=out_vals.dtype)
    np.add.at(red_vals, group, out_vals)
    red_rows = out_rows[boundary]
    red_cols = out_cols[boundary]

    counts = np.bincount(red_rows, minlength=a.shape[0])
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR.from_arrays(
        indptr.astype(np.int32), red_cols.astype(np.int32), red_vals,
        (a.shape[0], b.shape[1]),
    )
