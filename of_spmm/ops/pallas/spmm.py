"""Pallas kernel (Triton route): row-binned ELL SpMM for the GPU.

Computes Y = A @ X for A in the BinnedEll layout (of_spmm/sparse/
binned.py) and dense X (n_cols, d). One program owns a block of ``BR``
ELL rows of one bucket and ``BD`` feature columns. It walks the bucket
width K one nonzero per step: it loads the BR column indices and values,
gathers the referenced rows' BD-wide slices of X straight from device
memory (X stays one whole array there), scales them and sums in fp32
registers. The (rows, K, d) gathered block never reaches device
memory — the round trip that the reference's gather +
unsorted_segment_sum pair pays (gather_kernel_util.cu:28-120,
unsorted_segment_sum_kernel_util.cu:52-151).

Rows wider than the ladder's top width were split into several ELL rows at
plan time; their partial rows are combined outside the kernel by the
plan's finish (ops/reference.py combine_contribs), so no atomics are
needed. Accumulation is fp32 for any input dtype, mirroring the
reference's fp16 -> fp32 tmp-buffer accumulation
(unsorted_segment_sum_kernel.cpp:144-217).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from of_spmm.sparse.binned import BinnedEll, EllBucket

# Block shape: BR ELL rows x BD features per program. A sweep of 15
# shapes on the H100 at ogbn-products d=128 put 8 x 64 on one warp first
# (12.2 ms; 64 x 64 on 4 warps: 17.1 ms); pipeline stages 1-4 made no
# difference (PERF.md, PR 1 findings).
BLOCK_ROWS = 8
BLOCK_D = 64
NUM_WARPS = 1
NUM_STAGES = 2


def _bucket_kernel(cols_ref, vals_ref, x_ref, out_ref, *, R, K, d, BR, BD):
    """One program: out[rows, dcols] = sum_k vals[rows, k] * X[cols[rows, k],
    dcols] for a (BR, BD) block, fp32 accumulation."""
    rows = pl.program_id(0) * BR + jnp.arange(BR)
    dcols = pl.program_id(1) * BD + jnp.arange(BD)
    rmask = rows < R
    dmask = dcols < d
    # rows past R read X row 0 with value 0 (harmless); columns past d
    # are masked so they issue no memory traffic
    xmask = (jnp.broadcast_to(dmask[None, :], (BR, BD)) if d % BD
             else None)

    def body(k, acc):
        c = plgpu.load(cols_ref.at[rows, k], mask=rmask, other=0)
        v = plgpu.load(vals_ref.at[rows, k], mask=rmask, other=0)
        xr = plgpu.load(x_ref.at[c[:, None], dcols[None, :]], mask=xmask,
                        other=None if xmask is None else 0)
        return acc + v.astype(jnp.float32)[:, None] * xr.astype(jnp.float32)

    acc = jax.lax.fori_loop(0, K, body, jnp.zeros((BR, BD), jnp.float32))
    plgpu.store(out_ref.at[rows[:, None], dcols[None, :]], acc,
                mask=rmask[:, None] & dmask[None, :])


@functools.partial(jax.jit, static_argnames=("interpret",))
def bucket_contrib(bucket: EllBucket, x: jnp.ndarray, *,
                   interpret: bool) -> jnp.ndarray:
    """fp32 partial rows (R, d) of one bucket: row r is
    sum_k vals[r, k] * x[cols[r, k]]."""
    R, K = bucket.cols.shape
    d = x.shape[1]
    BD = min(BLOCK_D, max(16, 1 << (d - 1).bit_length()))
    kernel = functools.partial(_bucket_kernel, R=R, K=K, d=d,
                               BR=BLOCK_ROWS, BD=BD)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(R, BLOCK_ROWS), pl.cdiv(d, BD)),
        out_shape=jax.ShapeDtypeStruct((R, d), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="spmm_ell_bucket",
    )(bucket.cols, bucket.vals, x)


def spmm_pallas(
    binned: BinnedEll,
    x: jnp.ndarray,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Y = A @ X with the row-binned Triton kernel.

    Matches the XLA oracle (ops/reference.py spmm_binned_xla) to fp32
    summation order. Output dtype follows X. ``interpret=None`` asks the
    registry: compiled on a GPU, interpreted only under
    OFS_FORCE_PALLAS_INTERPRET, an error anywhere else.
    """
    from of_spmm.ops.reference import combine_contribs
    from of_spmm.ops.registry import pallas_interpret

    if interpret is None:
        interpret = pallas_interpret()
    if not binned.buckets:
        return jnp.zeros((binned.n_rows, x.shape[1]), x.dtype)
    contribs = [bucket_contrib(b, x, interpret=interpret)
                for b in binned.buckets]
    return combine_contribs(binned, contribs, jnp.float32).astype(x.dtype)
