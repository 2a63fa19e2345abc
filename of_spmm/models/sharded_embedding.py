"""Sharded embedding — the one-embedding / id-shuffle path, in JAX.

The reference's large-scale embedding (python/oneflow/one_embedding.py +
oneflow/core/embedding/) shards the table across ranks and looks up with
the id-shuffle kernels: dedup ids in a GPU hash table, partition per
destination rank, exchange variable-length buffers with ncclSend/ncclRecv
(oneflow/user/kernels/data_shuffle_kernel.cu:41-130).

JAX re-expression: the table is row-split S(0) over the mesh axis;
inside one shard_map body the lookup is

1. all_gather of the batch's ids (each shard learns all requested ids),
2. local gather with out-of-range -> 0 semantics (each shard contributes
   exactly the rows it owns, zeros elsewhere — the gather SBP route
   "in split(0) -> out PartialSum", oneflow/user/ops/gather_op.cpp:51-82),
3. psum_scatter to resolve the partial sum AND return each shard its own
   batch chunk (ccl-p-to-s) — half the volume of a full psum.

Everything is static-shape (no hash tables, no ragged buffers) and the
whole lookup is differentiable: gather's custom_vjp is segment_sum, and
shard_map transposes psum_scatter/all_gather into each other, so the
backward pass IS the reference's reverse id-shuffle (gradients routed back
to owning shards and scatter-added into table rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from of_spmm.ops.autograd import gather


@dataclasses.dataclass(frozen=True)
class ShardedEmbedding:
    """Row-sharded embedding table over one mesh axis.

    num_embeddings is padded up to a multiple of the mesh axis size; ids
    >= num_embeddings (or negative) return zero rows, matching the
    framework gather semantics.
    """

    num_embeddings: int
    embedding_dim: int
    axis: str = "x"

    def padded_rows(self, n_shards: int) -> int:
        return -(-self.num_embeddings // n_shards) * n_shards

    def init(self, key, mesh: Mesh) -> dict:
        """Table created directly with its S(0) sharding (never
        materialized replicated — the whole point of sharding the table)."""
        n_shards = mesh.shape[self.axis]
        v = self.padded_rows(n_shards)
        sharding = NamedSharding(mesh, P(self.axis, None))
        w = jax.jit(
            lambda k: jax.random.normal(k, (v, self.embedding_dim), jnp.float32)
            * (self.embedding_dim ** -0.5),
            out_shardings=sharding,
        )(key)
        return {"weight": w}

    def apply(self, params: dict, ids: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
        """Lookup: ids (B,) int32 (B divisible by the axis size) ->
        (B, D). ids enter row-split; output rows come back row-split."""
        if ids.ndim != 1:
            raise ValueError(f"ids must be rank-1, got shape {ids.shape}")
        n_shards = mesh.shape[self.axis]
        if ids.shape[0] % n_shards:
            raise ValueError(
                f"batch {ids.shape[0]} not divisible by mesh axis "
                f"{self.axis}={n_shards} (pad ids first)"
            )
        v = self.padded_rows(n_shards)
        rows_per_shard = v // n_shards
        axis = self.axis

        def body(w_local, ids_local):
            me = jax.lax.axis_index(axis)
            ids_all = jax.lax.all_gather(ids_local, axis, tiled=True)  # (B,)
            local = ids_all - me * rows_per_shard
            # out-of-range -> zero rows: shards contribute only owned rows
            contrib = gather(w_local, local)  # (B, D) partial
            return jax.lax.psum_scatter(
                contrib, axis, scatter_dimension=0, tiled=True
            )  # (B/S, D) — my batch chunk, fully summed

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=P(axis, None),
        )(params["weight"], ids)
