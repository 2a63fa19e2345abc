"""Record-file format: length-prefixed binary records with CRC checks.

Analog of the reference's OFRecord/OneRec C++ readers
(oneflow/user/data/ofrecord_dataset.h, onerec_dataset.h): a sequential
record container for example-level data that streams without loading the
file, supports shard-aware round-robin reading for data parallelism
(distributed_training_dataset.h), and verifies integrity per record.

Layout per record (little-endian):
    uint64 length | uint32 crc32(payload) | payload bytes

Payloads are opaque bytes; `encode_example`/`decode_example` provide the
reference's feature-dict convention (int64/float32/bytes lists keyed by
name) on top, via a compact self-describing binary header — protobuf's
job in the reference, without the dependency.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from of_spmm.data.dataset import Dataset

_LEN = struct.Struct("<Q")
_CRC = struct.Struct("<I")
_FEAT_KINDS = {0: np.int64, 1: np.float32, 2: bytes}
_KIND_OF = {np.dtype(np.int64): 0, np.dtype(np.float32): 1}


class RecordWriter:
    """Append records to a file: `with RecordWriter(p) as w: w.write(b)`."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        self._f.write(_LEN.pack(len(payload)))
        self._f.write(_CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)

    def write_example(self, features: Dict[str, Any]) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, *, verify: bool = True) -> Iterator[bytes]:
    """Stream records from a file; raises on CRC mismatch or truncation."""
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN.size)
            if not head:
                return
            if len(head) < _LEN.size:
                raise IOError(f"truncated record header in {path}")
            (n,) = _LEN.unpack(head)
            (crc,) = _CRC.unpack(f.read(_CRC.size))
            payload = f.read(n)
            if len(payload) < n:
                raise IOError(f"truncated record body in {path}")
            if verify and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise IOError(f"record CRC mismatch in {path}")
            yield payload


def encode_example(features: Dict[str, Any]) -> bytes:
    """Feature dict -> bytes. Values: int/float arrays/lists or bytes."""
    out = io.BytesIO()
    out.write(struct.pack("<I", len(features)))
    for name, value in sorted(features.items()):
        nb = name.encode()
        out.write(struct.pack("<H", len(nb)))
        out.write(nb)
        if isinstance(value, (bytes, bytearray)):
            out.write(struct.pack("<BQ", 2, len(value)))
            out.write(value)
            continue
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)
        elif np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        else:
            raise TypeError(f"unsupported feature dtype {arr.dtype} ({name})")
        kind = _KIND_OF[arr.dtype]
        flat = np.ascontiguousarray(arr).tobytes()
        out.write(struct.pack("<BQB", kind, len(flat), arr.ndim))
        for d in arr.shape:
            out.write(struct.pack("<Q", d))
        out.write(flat)
    return out.getvalue()


def decode_example(payload: bytes) -> Dict[str, Any]:
    f = io.BytesIO(payload)
    (n,) = struct.unpack("<I", f.read(4))
    out: Dict[str, Any] = {}
    for _ in range(n):
        (ln,) = struct.unpack("<H", f.read(2))
        name = f.read(ln).decode()
        kind, nbytes = struct.unpack("<BQ", f.read(9))
        if kind == 2:
            out[name] = f.read(nbytes)
            continue
        (ndim,) = struct.unpack("<B", f.read(1))
        shape = tuple(
            struct.unpack("<Q", f.read(8))[0] for _ in range(ndim))
        out[name] = np.frombuffer(
            f.read(nbytes), dtype=_FEAT_KINDS[kind]).reshape(shape)
    return out


class RecordDataset(Dataset):
    """Dataset over one or more record files with optional sharding.

    ``rank``/``world`` select every world-th record round-robin (the
    reference's shard-aware distributed dataset). Records are indexed once
    at construction (offsets scan) so access is O(1) per item.
    """

    def __init__(self, paths: Sequence[str] | str, *, rank: int = 0,
                 world: int = 1, decode: bool = True):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._index: List[tuple] = []  # (path, offset, length)
        for p in paths:
            size = os.path.getsize(p)
            with open(p, "rb") as f:
                off = 0
                while off < size:
                    f.seek(off)
                    (n,) = _LEN.unpack(f.read(_LEN.size))
                    self._index.append(
                        (p, off + _LEN.size + _CRC.size, n))
                    off += _LEN.size + _CRC.size + n
        self._index = self._index[rank::world]
        self._decode = decode

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i):
        path, off, n = self._index[i]
        with open(path, "rb") as f:
            f.seek(off)
            payload = f.read(n)
        return decode_example(payload) if self._decode else payload
