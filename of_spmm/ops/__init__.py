"""Op layer: reference oracles, Pallas kernels, autograd pairing, registry."""

from of_spmm.ops import reference
from of_spmm.ops.autograd import (
    SpmmOperator,
    gather,
    make_operator,
    sddmm,
    segment_softmax,
    segment_sum,
    spmm,
    spmm_coo,
    spmm_internal,
    spmv,
)
from of_spmm.ops.pallas.spmm import spmm_pallas
from of_spmm.ops.reference import spgemm
from of_spmm.ops.registry import OpDef, ShardingRule, all_ops, lookup, register_op

__all__ = [
    "reference",
    "SpmmOperator",
    "make_operator",
    "gather",
    "segment_sum",
    "spmm",
    "spmm_coo",
    "spmm_internal",
    "spmv",
    "sddmm",
    "segment_softmax",
    "spgemm",
    "spmm_pallas",
    "OpDef",
    "ShardingRule",
    "all_ops",
    "lookup",
    "register_op",
]
