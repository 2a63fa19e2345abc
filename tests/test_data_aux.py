"""Datasets/DataLoader, distributed env accessors, profiler, consistency."""

import os

import jax
import numpy as np
import pytest

from of_spmm.data.dataset import (
    DataLoader,
    ShardedDataset,
    TensorDataset,
    TokenDataset,
    shard_dataset,
)


def test_tensor_dataset_and_loader_batching():
    x = np.arange(20).reshape(10, 2).astype(np.float32)
    y = np.arange(10).astype(np.int32)
    ds = TensorDataset(x, y)
    assert len(ds) == 10
    dl = DataLoader(ds, batch_size=4, prefetch=0)
    batches = list(dl)
    assert len(batches) == 3  # 4+4+2
    bx, by = batches[0]
    assert bx.shape == (4, 2) and by.shape == (4,)
    np.testing.assert_array_equal(batches[2][1], [8, 9])
    dl = DataLoader(ds, batch_size=4, drop_last=True, prefetch=0)
    assert len(list(dl)) == 2


def test_loader_shuffle_deterministic_and_epoch_varies():
    ds = TensorDataset(np.arange(32))
    dl = DataLoader(ds, batch_size=32, shuffle=True, seed=7, prefetch=0)
    a = list(dl)[0][0]
    b = list(dl)[0][0]
    np.testing.assert_array_equal(a, b)  # same epoch -> same order
    dl.set_epoch(1)
    c = list(dl)[0][0]
    assert not np.array_equal(a, c)  # different epoch -> reshuffled
    np.testing.assert_array_equal(np.sort(c), np.arange(32))


def test_loader_prefetch_matches_sync():
    ds = TensorDataset(np.arange(50), np.arange(50) * 2)
    sync = [b for b in DataLoader(ds, batch_size=8, prefetch=0)]
    pre = [b for b in DataLoader(ds, batch_size=8, prefetch=3)]
    for (a1, a2), (b1, b2) in zip(sync, pre):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)


def test_token_dataset_windows(tmp_path):
    tokens = np.arange(100, dtype=np.int32)
    p = str(tmp_path / "tokens.npy")
    np.save(p, tokens)
    ds = TokenDataset(p, seq_len=10)
    inp, lbl = ds[0]
    np.testing.assert_array_equal(inp, np.arange(10))
    np.testing.assert_array_equal(lbl, np.arange(1, 11))
    inp, lbl = ds[1]
    np.testing.assert_array_equal(inp, np.arange(10, 20))
    assert len(ds) == 9  # (100 - 11) // 10 + 1
    with pytest.raises(IndexError):
        ds[9]


def test_token_dataset_raw_binary(tmp_path):
    tokens = np.arange(64, dtype=np.int32)
    p = str(tmp_path / "tokens.bin")
    tokens.tofile(p)
    ds = TokenDataset(p, seq_len=8, stride=4)
    inp, lbl = ds[1]
    np.testing.assert_array_equal(inp, np.arange(4, 12))


def test_sharded_dataset_covers_all_disjoint():
    base = TensorDataset(np.arange(23))
    seen = []
    for r in range(4):
        sh = shard_dataset(base, r, 4)
        seen += [int(sh[i][0]) for i in range(len(sh))]
    assert sorted(seen) == list(range(23))
    with pytest.raises(ValueError):
        ShardedDataset(base, 4, 4)


def test_distributed_env_accessors():
    from of_spmm import distributed as dist

    assert dist.get_rank() == 0
    assert dist.get_world_size() == 1
    assert not dist.is_multi_client()
    dist.barrier()  # no-op single process
    dist.initialize()  # no-op without env vars


def test_distributed_partial_env_rejected(monkeypatch):
    from of_spmm import distributed as dist

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        dist.env_spec()


def test_profiler_ranges_and_table():
    from of_spmm.utils import profiler

    with profiler.profile() as prof:
        with profiler.record("outer"):
            with profiler.record("inner"):
                sum(range(1000))
        with profiler.record("outer"):
            pass
    names = [e.name for e in prof.events]
    assert names.count("outer") == 2 and names.count("inner") == 1
    table = prof.key_averages()
    assert "outer" in table and "avg ms" in table


def test_consistency_fingerprint():
    from of_spmm.parallel.consistency import check_consistent, plan_fingerprint

    t1 = {"a": np.zeros((3, 2)), "b": [np.ones(4, np.int32)]}
    t2 = {"a": np.zeros((3, 2)), "b": [np.ones(4, np.int32)]}
    t3 = {"a": np.zeros((3, 3)), "b": [np.ones(4, np.int32)]}
    assert plan_fingerprint(t1) == plan_fingerprint(t2)
    assert plan_fingerprint(t1) != plan_fingerprint(t3)
    fp = check_consistent(t1)  # single-process: returns fingerprint
    assert isinstance(fp, str) and len(fp) == 64


def test_dataloader_num_workers_matches_single_process():
    """Multiprocess workers produce the same batches in the same order."""
    import numpy as np
    from of_spmm.data.dataset import DataLoader, TensorDataset

    x = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    y = np.arange(103, dtype=np.int64)
    ds = TensorDataset(x, y)
    kw = dict(batch_size=8, shuffle=True, seed=7, drop_last=False)
    ref = list(DataLoader(ds, num_workers=0, **kw))
    got = list(DataLoader(ds, num_workers=3, **kw))
    assert len(ref) == len(got) == 13
    for (rx, ry), (gx, gy) in zip(ref, got):
        np.testing.assert_array_equal(rx, gx)
        np.testing.assert_array_equal(ry, gy)


def test_dataloader_worker_error_propagates():
    import numpy as np
    import pytest
    from of_spmm.data.dataset import DataLoader, Dataset

    class Bad(Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("boom")
            return np.zeros(2, np.float32)

    with pytest.raises(RuntimeError, match="worker failed"):
        list(DataLoader(Bad(), batch_size=2, num_workers=2))


def test_launcher_spawns_ranks(tmp_path):
    """launch sets the env contract per rank and propagates failures."""
    import subprocess, sys, os
    script = tmp_path / "child.py"
    # each rank writes its OWN file: children share the stdout pipe and
    # concurrent line writes can tear mid-line (observed '01 1 3' under
    # host contention), which is a test artifact, not a launcher bug
    script.write_text(
        "import os, sys\n"
        "open(os.path.join(os.path.dirname(__file__),"
        " 'rank%s.out' % os.environ['RANK']), 'w').write(\n"
        "    ' '.join([os.environ['RANK'], os.environ['LOCAL_RANK'],"
        " os.environ['WORLD_SIZE']]))\n"
        "sys.exit(0)\n"
    )
    # JAX_PLATFORMS=cpu: children must not open the accelerator (one
    # process per card); one retry absorbs transient spawn failures.
    child_env = {**os.environ, "PYTHONPATH": os.getcwd(),
                 "JAX_PLATFORMS": "cpu"}
    for attempt in range(2):
        out = subprocess.run(
            [sys.executable, "-m", "of_spmm.distributed.launch",
             "--nproc_per_node", "3", str(script)],
            capture_output=True, text=True, timeout=120, env=child_env,
        )
        if out.returncode == 0:
            break
    assert out.returncode == 0, out.stderr
    lines = sorted((tmp_path / f"rank{r}.out").read_text()
                   for r in range(3))
    assert lines == ["0 0 3", "1 1 3", "2 2 3"]

    bad = tmp_path / "bad.py"
    bad.write_text("import os, sys; sys.exit(3 if os.environ['RANK']=='1' else 0)\n")
    out = subprocess.run(
        [sys.executable, "-m", "of_spmm.distributed.launch",
         "--nproc_per_node", "2", str(bad)],
        capture_output=True, text=True, timeout=120, env=child_env,
    )
    assert out.returncode == 3
