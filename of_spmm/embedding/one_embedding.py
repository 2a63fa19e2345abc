"""Tiered embedding storage: persistent host table + HBM row cache.

The reference keeps huge embedding tables out of device memory with a
tiered KV store — GPU LRU/full cache (core/embedding/lru_cache.cu,
full_cache.cu) over a host/SSD persistent table
(core/embedding/persistent_table.cpp) glued by cached_key_value_store.cu,
with snapshots (one_embedding.py:243-277). The device keeps no hash table, so
the split is: *host* owns the id->slot map and LRU
policy (plain Python/numpy — plan-time logic, off the hot math path);
*device* owns one dense (capacity, dim) cache array indexed with
plan-computed slots, so the jitted step is pure gather/scatter on static
shapes.

Training loop contract (functional, jit-friendly):

    emb = CachedEmbedding(table, capacity=65536)
    slots, cache = emb.prepare(ids, cache)      # host: dedup, miss fill
    rows = emb.lookup(cache, slots)             # device, differentiable
    ...
    cache = emb.apply_grad(cache, slots, g_rows, lr)  # sparse row update
    emb.flush(cache)                            # write dirty rows back
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class PersistentTable:
    """Host-side persistent KV table: int64 ids -> float32 rows.

    File-backed (np.memmap) fixed-capacity store with an in-memory
    id->index dict (rebuilt from the id column on open). The analog of the
    reference's persistent_table.cpp (SSD tier), sized for host RAM/disk.

    Rows for never-seen ids are initialized by ``initializer`` on first
    touch (the reference initializes lazily in the cache the same way).
    """

    def __init__(
        self,
        path: str,
        dim: int,
        capacity: int = 1 << 20,
        initializer: str = "normal",
        init_scale: float = 0.05,
        seed: int = 0,
    ):
        self.path = path
        self.dim = dim
        self.capacity = capacity
        self.initializer = initializer
        self.init_scale = init_scale
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        self._meta_file = os.path.join(path, "meta.json")
        self._ids_file = os.path.join(path, "ids.npy")
        self._vals_file = os.path.join(path, "values.dat")
        if os.path.exists(self._meta_file):
            self._open()
        else:
            self._create()

    def _create(self):
        with open(self._meta_file, "w") as f:
            json.dump({"dim": self.dim, "capacity": self.capacity,
                       "n": 0}, f)
        self._ids = np.full(self.capacity, -1, np.int64)
        self._vals = np.memmap(self._vals_file, np.float32, "w+",
                               shape=(self.capacity, self.dim))
        self._index: Dict[int, int] = {}
        self._n = 0

    def _open(self):
        with open(self._meta_file) as f:
            meta = json.load(f)
        if meta["dim"] != self.dim:
            raise ValueError(
                f"table at {self.path} has dim {meta['dim']}, want {self.dim}")
        self.capacity = meta["capacity"]
        self._ids = np.load(self._ids_file) if os.path.exists(self._ids_file) \
            else np.full(self.capacity, -1, np.int64)
        self._vals = np.memmap(self._vals_file, np.float32, "r+",
                               shape=(self.capacity, self.dim))
        live = np.nonzero(self._ids >= 0)[0]
        self._index = {int(self._ids[i]): int(i) for i in live}
        self._n = len(live)

    def _init_rows(self, k: int) -> np.ndarray:
        if self.initializer == "zeros":
            return np.zeros((k, self.dim), np.float32)
        return (self._rng.standard_normal((k, self.dim)) *
                self.init_scale).astype(np.float32)

    def get(self, ids: np.ndarray) -> np.ndarray:
        """Fetch rows (first touch initializes)."""
        ids = np.asarray(ids, np.int64)
        out = np.empty((len(ids), self.dim), np.float32)
        with self._lock:
            for x in ids:
                if int(x) in self._index:
                    continue  # also dedups repeats within this batch
                if self._n >= self.capacity:
                    raise RuntimeError(
                        f"PersistentTable at {self.path} full "
                        f"({self.capacity} rows)")
                slot = self._n
                self._n += 1
                self._index[int(x)] = slot
                self._ids[slot] = x
                self._vals[slot] = self._init_rows(1)[0]
            for i, x in enumerate(ids):
                out[i] = self._vals[self._index[int(x)]]
        return out

    def put(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        with self._lock:
            for i, x in enumerate(ids):
                slot = self._index.get(int(x))
                if slot is None:
                    if self._n >= self.capacity:
                        raise RuntimeError("table full")
                    slot = self._n
                    self._n += 1
                    self._index[int(x)] = slot
                    self._ids[slot] = x
                self._vals[slot] = rows[i]

    @property
    def n_rows(self) -> int:
        return self._n

    def save_snapshot(self, name: str = "snapshot") -> str:
        """Durable snapshot (reference: Embedding.save_snapshot)."""
        with self._lock:
            self._vals.flush()
            np.save(self._ids_file, self._ids)
            snap_dir = os.path.join(self.path, name)
            os.makedirs(snap_dir, exist_ok=True)
            np.save(os.path.join(snap_dir, "ids.npy"), self._ids)
            live = self._ids >= 0
            np.save(os.path.join(snap_dir, "values.npy"),
                    np.asarray(self._vals)[: self.capacity][live])
            np.save(os.path.join(snap_dir, "live.npy"), np.nonzero(live)[0])
        return snap_dir

    def load_snapshot(self, name: str = "snapshot") -> None:
        snap_dir = os.path.join(self.path, name)
        ids = np.load(os.path.join(snap_dir, "ids.npy"))
        vals = np.load(os.path.join(snap_dir, "values.npy"))
        slots = np.load(os.path.join(snap_dir, "live.npy"))
        with self._lock:
            self._ids[:] = -1
            self._index.clear()
            for row, slot in zip(vals, slots):
                self._vals[slot] = row
            self._ids[slots] = ids[slots]
            self._index = {int(self._ids[s]): int(s) for s in slots}
            self._n = len(slots)


@dataclasses.dataclass
class _CacheMeta:
    """Host-side cache bookkeeping (slot -> id, LRU clock, dirty bits)."""

    slot_ids: np.ndarray  # (capacity,) int64, -1 = empty
    last_used: np.ndarray  # (capacity,) int64 LRU stamps
    dirty: np.ndarray  # (capacity,) bool — updated on device since fetch
    clock: int = 0
    index: Dict[int, int] = dataclasses.field(default_factory=dict)


class CachedEmbedding:
    """HBM row cache over a PersistentTable (cached_key_value_store analog).

    The device-visible state is ONE dense jnp array (capacity, dim); the
    host decides which table rows live in which cache slots. ``prepare``
    is the per-step host phase (dedup, miss fetch, LRU evict+writeback);
    everything after it is static-shape device compute.
    """

    def __init__(self, table: PersistentTable, capacity: int = 65536):
        self.table = table
        self.capacity = capacity
        self.dim = table.dim

    def init_cache(self) -> Tuple[jnp.ndarray, _CacheMeta]:
        cache = jnp.zeros((self.capacity, self.dim), jnp.float32)
        meta = _CacheMeta(
            slot_ids=np.full(self.capacity, -1, np.int64),
            last_used=np.zeros(self.capacity, np.int64),
            dirty=np.zeros(self.capacity, bool),
        )
        return cache, meta

    def prepare(
        self, ids: np.ndarray, cache: jnp.ndarray, meta: _CacheMeta
    ) -> Tuple[np.ndarray, jnp.ndarray]:
        """Host phase: ensure every id is cached; return per-id slots.

        Evicts least-recently-used slots when full, writing dirty rows
        back to the persistent table first (the reference's cached KV
        store eviction protocol).
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        uniq = np.unique(ids)
        meta.clock += 1
        missing = [x for x in uniq if int(x) not in meta.index]
        if missing:
            # pick victim slots: empty first, then LRU among non-requested
            empty = np.nonzero(meta.slot_ids < 0)[0]
            need = len(missing)
            victims = list(empty[:need])
            if len(victims) < need:
                requested = set(int(x) for x in uniq)
                order = np.argsort(meta.last_used)
                for s in order:
                    if len(victims) >= need:
                        break
                    sid = int(meta.slot_ids[s])
                    if sid >= 0 and sid not in requested:
                        victims.append(int(s))
                if len(victims) < need:
                    raise RuntimeError(
                        f"cache too small: need {need} slots, "
                        f"capacity {self.capacity}")
            victims = np.asarray(victims[:need], np.int64)
            # write back dirty victims
            dirty_v = victims[meta.dirty[victims]]
            if len(dirty_v):
                rows = np.asarray(jax.device_get(cache[jnp.asarray(dirty_v)]))
                self.table.put(meta.slot_ids[dirty_v], rows)
                meta.dirty[dirty_v] = False
            # drop victims from the index
            for s in victims:
                sid = int(meta.slot_ids[s])
                if sid >= 0:
                    del meta.index[sid]
            # fetch misses from the table, install into the cache
            fresh = self.table.get(np.asarray(missing, np.int64))
            cache = cache.at[jnp.asarray(victims)].set(jnp.asarray(fresh))
            for x, s in zip(missing, victims):
                meta.index[int(x)] = int(s)
                meta.slot_ids[s] = x
        slots = np.asarray([meta.index[int(x)] for x in ids], np.int32)
        used = np.asarray([meta.index[int(x)] for x in uniq], np.int64)
        meta.last_used[used] = meta.clock
        return slots, cache

    @staticmethod
    def lookup(cache: jnp.ndarray, slots: np.ndarray) -> jnp.ndarray:
        """Device gather (differentiable; use sparse grads for updates)."""
        return jnp.take(cache, jnp.asarray(slots), axis=0)

    def apply_grad(
        self, cache: jnp.ndarray, slots: np.ndarray, g_rows: jnp.ndarray,
        meta: _CacheMeta, lr: float = 0.1,
    ) -> jnp.ndarray:
        """Sparse SGD on cached rows; marks touched slots dirty."""
        s = jnp.asarray(slots)
        cache = cache.at[s].add(-lr * g_rows)
        meta.dirty[np.unique(np.asarray(slots))] = True
        return cache

    def flush(self, cache: jnp.ndarray, meta: _CacheMeta) -> None:
        """Write all dirty cached rows back to the persistent table."""
        dirty = np.nonzero(meta.dirty)[0]
        if len(dirty) == 0:
            return
        rows = np.asarray(jax.device_get(cache[jnp.asarray(dirty)]))
        self.table.put(meta.slot_ids[dirty], rows)
        meta.dirty[dirty] = False


class MultiTableEmbedding:
    """Named tables sharing one API (reference MultiTableEmbedding)."""

    def __init__(self, tables: Dict[str, CachedEmbedding]):
        self.tables = tables

    def init_caches(self):
        return {k: v.init_cache() for k, v in self.tables.items()}

    def save_snapshot(self, name: str = "snapshot"):
        for emb in self.tables.values():
            emb.table.save_snapshot(name)

    def load_snapshot(self, name: str = "snapshot"):
        for emb in self.tables.values():
            emb.table.load_snapshot(name)
