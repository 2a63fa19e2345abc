"""Record file format: round trip, CRC, sharded reading, DataLoader."""

import numpy as np
import pytest

from of_spmm.data import (
    DataLoader, RecordDataset, RecordWriter, decode_example, encode_example,
    read_records,
)


def _write(path, n=10):
    with RecordWriter(str(path)) as w:
        for i in range(n):
            w.write_example({
                "x": np.arange(4, dtype=np.float32) + i,
                "label": np.int64(i),
                "name": f"ex{i}".encode(),
            })


def test_roundtrip(tmp_path):
    p = tmp_path / "data.rec"
    _write(p, 5)
    items = [decode_example(r) for r in read_records(str(p))]
    assert len(items) == 5
    np.testing.assert_array_equal(items[3]["x"],
                                  np.arange(4, dtype=np.float32) + 3)
    assert items[3]["label"] == 3
    assert items[3]["name"] == b"ex3"


def test_crc_detects_corruption(tmp_path):
    p = tmp_path / "data.rec"
    _write(p, 3)
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF  # flip a bit in the last record's payload
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        list(read_records(str(p)))


def test_sharded_dataset_partitions(tmp_path):
    p = tmp_path / "data.rec"
    _write(p, 10)
    shards = [RecordDataset(str(p), rank=r, world=3) for r in range(3)]
    labels = sorted(int(ds[i]["label"]) for ds in shards
                    for i in range(len(ds)))
    assert labels == list(range(10))
    assert abs(len(shards[0]) - len(shards[2])) <= 1


def test_dataloader_over_records(tmp_path):
    p = tmp_path / "data.rec"
    _write(p, 8)
    ds = RecordDataset(str(p))

    def collate(items):
        return (np.stack([it["x"] for it in items]),
                np.asarray([it["label"] for it in items]))

    dl = DataLoader(ds, batch_size=4, num_workers=0, collate_fn=collate)
    xb, yb = next(iter(dl))
    assert xb.shape == (4, 4)
    assert yb.shape == (4,)
