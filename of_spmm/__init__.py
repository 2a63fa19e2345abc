"""of_spmm — a JAX sparse linear-algebra framework for the GPU.

A from-scratch JAX/XLA/Pallas re-expression of the capabilities of the
reference OneFlow fork ``yuang-chen/of-spmm`` (see SURVEY.md): CSR/COO sparse
formats and the SpMV/SpMM/SDDMM/SpGEMM operations that back GNN sparse
aggregation (neighbor-feature gather + segment-sum reduction), with

- a row-binned load-balanced SpMM (rows binned by nnz into padded ELL
  buckets) with a Pallas kernel for the GPU (Triton route),
- a small op registry carrying per-op {reference impl, pallas impl, sharding
  rule} — the analog of the reference's OpRegistry/OpKernelRegistry + GetSbp
  (reference: oneflow/core/framework/user_op_registry.h:62-147),
- gather <-> segment_sum autograd pairing via jax.custom_vjp (reference:
  oneflow/core/autograd/gradient_funcs/gather.cpp:62-73),
- 1-D row partition over a jax.sharding.Mesh with a precomputed halo-exchange
  plan executed inside shard_map (reference precedent: SBP slice views
  oneflow/core/job/nd_sbp_util.cpp:98-106 + NCCL boxing).

Public API (stable):
    from of_spmm import COO, CSR, BinnedEll
    from of_spmm.ops import spmv, spmm, sddmm, spgemm, gather, segment_sum
    from of_spmm.parallel import RowPartition, dist_spmm
    from of_spmm.models import GCN, GraphSAGE, Embedding
"""

from of_spmm.sparse.formats import COO, CSR
from of_spmm.sparse.binned import BinnedEll, EllBucket, bin_rows
from of_spmm import ops
from of_spmm import sparse
from of_spmm import utils

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "BinnedEll",
    "EllBucket",
    "bin_rows",
    "ops",
    "sparse",
    "utils",
    "__version__",
]
