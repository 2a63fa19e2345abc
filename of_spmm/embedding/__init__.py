"""embedding — large-scale embedding with tiered storage (one_embedding).

Reference surface: python/oneflow/one_embedding.py:166-770 (MultiTable
embedding with device-cache/host/SSD tiers) over C++ stores in
oneflow/core/embedding/ (lru_cache.cu, full_cache.cu, persistent_table.cpp,
cached_key_value_store.cu). JAX re-expression in this package:

- ``PersistentTable``: host-side file-backed KV table (ids -> rows) with
  snapshot save/load — the SSD tier.
- ``CachedEmbedding``: HBM-resident row cache in front of a
  PersistentTable with host-managed LRU admission; lookups dedup ids,
  fetch misses from the host tier, and run one device gather; sparse
  gradient updates land in the cache and write back on eviction/flush.
- ``MultiTableEmbedding``: the multi-table API wrapper.
"""

from of_spmm.embedding.one_embedding import (
    CachedEmbedding,
    MultiTableEmbedding,
    PersistentTable,
)

__all__ = ["PersistentTable", "CachedEmbedding", "MultiTableEmbedding"]
