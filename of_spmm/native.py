"""ctypes bindings for the native plan-builder (csrc/planner.cpp).

Compiled on first use with g++ -O3 -fopenmp into a cache directory keyed
by the source hash; every entry point has a numpy fallback so the library
works without a toolchain. This is the framework's native runtime layer —
the role the reference fills with its C++ graph/plan compiler — scoped to
where native code actually pays: 10^8-element host-side sorts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "planner.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> str:
    from of_spmm.utils.config import checkout_root

    return os.environ.get(
        "OFS_NATIVE_CACHE", os.path.join(checkout_root(), ".ofs_native"))


def _build() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    h = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"planner-{h}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_cache_dir(), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}.so"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception:
        try:  # retry without -march/-fopenmp (portability)
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except Exception:
            return None
    os.replace(tmp, out)
    return out


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64, i32p, f32p, i64p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        )
        lib.coo_to_csr.argtypes = [i64, i64, i32p, i32p, ctypes.c_void_p,
                                   i64p, i32p, f32p]
        lib.coo_to_csr.restype = ctypes.c_int
        lib.symmetrize_dedup.argtypes = [i64, i64, i32p, i32p,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         np.ctypeslib.ndpointer(np.int64)]
        lib.symmetrize_dedup.restype = ctypes.c_int
        lib.csr_transpose.argtypes = [i64, i64, i64, i64p, i32p,
                                      ctypes.c_void_p, i64p, i32p, f32p]
        lib.csr_transpose.restype = ctypes.c_int
        lib.spgemm_count.argtypes = [i64, i64, i64p, i32p, i64p, i32p, i64p]
        lib.spgemm_count.restype = ctypes.c_int
        lib.spgemm_fill.argtypes = [i64, i64, i64p, i32p, f32p, i64p, i32p,
                                    f32p, i64p, i32p, f32p]
        lib.spgemm_fill.restype = ctypes.c_int
        lib.expansion_pass1.argtypes = [i64, i64, i64p, i32p, f32p, i64,
                                        i32p, i32p, f32p, i32p, i64p]
        lib.expansion_pass1.restype = ctypes.c_int
        lib.hem_order.argtypes = [i64, i64p, i32p, ctypes.c_void_p, i64,
                                  i64, i64p]
        lib.hem_order.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _lib() is not None


def coo_to_csr(
    rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
    n_rows: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr int64, cols int32 sorted per row, vals f32). Parallel native
    counting-sort; numpy lexsort fallback."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nnz = rows.shape[0]
    lib = _lib()
    if lib is not None:
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        out_cols = np.empty(nnz, dtype=np.int32)
        out_vals = np.empty(nnz, dtype=np.float32)
        vp = (
            np.ascontiguousarray(vals, dtype=np.float32).ctypes.data
            if vals is not None else None
        )
        rc = lib.coo_to_csr(n_rows, nnz, rows, cols, vp, indptr,
                            out_cols, out_vals)
        if rc == 0:
            return indptr, out_cols, out_vals
    # fallback: numpy lexsort
    v = (np.ones(nnz, np.float32) if vals is None
         else np.asarray(vals, np.float32))
    order = np.lexsort((cols, rows))
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[order], v[order]


def symmetrize_dedup(
    src: np.ndarray, dst: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """unique(E ∪ E^T) sorted by (src, dst)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    lib = _lib()
    if lib is not None:
        cnt = np.zeros(1, dtype=np.int64)
        if lib.symmetrize_dedup(n, src.shape[0], src, dst, None, None, cnt) == 0:
            out_s = np.empty(int(cnt[0]), dtype=np.int32)
            out_d = np.empty(int(cnt[0]), dtype=np.int32)
            rc = lib.symmetrize_dedup(
                n, src.shape[0], src, dst,
                out_s.ctypes.data, out_d.ctypes.data, cnt,
            )
            if rc == 0:
                return out_s, out_d
    s2 = np.concatenate([src, dst]).astype(np.int64)
    d2 = np.concatenate([dst, src]).astype(np.int64)
    key = np.unique(s2 * n + d2)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def csr_transpose(
    indptr: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
    shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR of A^T from CSR of A (native counting pass; numpy fallback)."""
    n_rows, n_cols = shape
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nnz = cols.shape[0]
    lib = _lib()
    if lib is not None:
        out_indptr = np.zeros(n_cols + 1, dtype=np.int64)
        out_cols = np.empty(nnz, dtype=np.int32)
        out_vals = np.empty(nnz, dtype=np.float32)
        vp = (
            np.ascontiguousarray(vals, dtype=np.float32).ctypes.data
            if vals is not None else None
        )
        rc = lib.csr_transpose(n_rows, n_cols, nnz, indptr, cols, vp,
                               out_indptr, out_cols, out_vals)
        if rc == 0:
            return out_indptr, out_cols, out_vals
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(indptr))
    v = (np.ones(nnz, np.float32) if vals is None
         else np.asarray(vals, np.float32))
    return coo_to_csr(cols, rows, v, n_cols)


def spgemm(
    a_indptr: np.ndarray, a_cols: np.ndarray, a_vals: np.ndarray,
    b_indptr: np.ndarray, b_cols: np.ndarray, b_vals: np.ndarray,
    n_rows: int, n_cols_b: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C = A @ B via the native two-phase Gustavson SPA kernel.

    Returns (indptr int64, cols int32 sorted per row, vals f32), or None if
    the native library is unavailable (callers fall back to the numpy
    expand/sort/reduce in ops/reference.py).
    """
    lib = _lib()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    a_vals = np.ascontiguousarray(a_vals, np.float32)
    b_indptr = np.ascontiguousarray(b_indptr, np.int64)
    b_cols = np.ascontiguousarray(b_cols, np.int32)
    b_vals = np.ascontiguousarray(b_vals, np.float32)
    counts = np.zeros(n_rows, dtype=np.int64)
    if lib.spgemm_count(n_rows, n_cols_b, a_indptr, a_cols,
                        b_indptr, b_cols, counts) != 0:
        return None
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float32)
    if lib.spgemm_fill(n_rows, n_cols_b, a_indptr, a_cols, a_vals,
                       b_indptr, b_cols, b_vals, indptr,
                       out_cols, out_vals) != 0:
        return None
    return indptr, out_cols, out_vals


def expansion_pass1(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    R: int):
    """Per-tile column-sorted lanes + unique columns (expansion plan pass 1;
    see sparse/expansion.py). Returns (lane_inv, lane_row, lane_val,
    uniq_cols, uniq_ptr) with lanes tile-concatenated in sorted order, or
    None when the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    n = indptr.shape[0] - 1
    nnz = cols.shape[0]
    n_tiles = max(-(-n // R), 1)
    lane_inv = np.empty(nnz, dtype=np.int32)
    lane_row = np.empty(nnz, dtype=np.int32)
    lane_val = np.empty(nnz, dtype=np.float32)
    uniq_cols = np.empty(max(nnz, 1), dtype=np.int32)
    uniq_ptr = np.zeros(n_tiles + 1, dtype=np.int64)
    rc = lib.expansion_pass1(n, nnz, indptr, cols, vals, R, lane_inv,
                             lane_row, lane_val, uniq_cols, uniq_ptr)
    if rc != 0:
        return None
    return lane_inv, lane_row, lane_val, uniq_cols, uniq_ptr


def hem_order(indptr: np.ndarray, cols: np.ndarray,
              vals: Optional[np.ndarray], coarse_n: int,
              max_levels: int = 48) -> Optional[np.ndarray]:
    """Multilevel heavy-edge-matching permutation (sparse/reorder.py
    matching_order, native path). Returns old_from_new (n,) int64 or
    None when the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n = indptr.shape[0] - 1
    out = np.empty(n, dtype=np.int64)
    vp = (None if vals is None
          else np.ascontiguousarray(vals, dtype=np.float32)
          .ctypes.data_as(ctypes.c_void_p))
    rc = lib.hem_order(n, indptr, cols, vp, int(coarse_n),
                       int(max_levels), out)
    if rc != 0:
        return None
    return out
