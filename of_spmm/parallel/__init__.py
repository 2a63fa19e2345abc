from of_spmm.parallel.partition import (RowPartitionPlan, StackedBucket,
                                       partition_rows, place_plan)
from of_spmm.parallel.dist_spmm import default_mesh, dist_spmm, dist_spmm_allgather
from of_spmm.parallel.global_view import (
    materialize_partial,
    pad_to_multiple,
    reshard,
    sbp_of,
    sbp_to_spec,
    to_global,
    to_local,
)

__all__ = [
    "RowPartitionPlan",
    "StackedBucket",
    "partition_rows",
    "place_plan",
    "default_mesh",
    "dist_spmm",
    "dist_spmm_allgather",
    "to_global",
    "pad_to_multiple",
    "to_local",
    "reshard",
    "sbp_of",
    "sbp_to_spec",
    "materialize_partial",
]
from of_spmm.parallel.tp import (
    column_parallel_linear,
    init_tp_mlp,
    make_tp_mlp,
    row_parallel_linear,
    shard_tp_mlp,
    tp_mlp_block,
)
from of_spmm.parallel.sp import (
    SequenceParallelAttention,
    head_to_sequence,
    sequence_to_head,
    ulysses_attention,
)
from of_spmm.parallel.ring import RingAttention, ring_attention
from of_spmm.parallel.ep import MoELayer, expert_capacity, top_k_dispatch
from of_spmm.parallel.pipeline import (
    PipelineModule,
    gpipe_spmd,
    pipeline_apply,
    stack_stage_params,
)
