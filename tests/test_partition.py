"""Halo-plan construction invariants (host-side, no mesh needed)."""

import numpy as np
import pytest

from of_spmm.parallel.partition import partition_rows
from of_spmm.sparse.formats import CSR


def _random_dense(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(np.float32)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_plan_shapes(n_shards):
    dense = _random_dense(64, 64, 0.1)
    plan = partition_rows(CSR.from_dense(dense), n_shards)
    S, H = plan.n_shards, plan.halo_size
    assert plan.send_idx.shape == (S, S, H)
    assert plan.rows_per_shard * S >= 64
    for b in plan.buckets:
        assert b.row_ids.shape[0] == S
        assert b.cols.shape[:2] == b.row_ids.shape
        assert b.vals.shape == b.cols.shape


def test_plan_reconstructs_matrix():
    """Decode the plan back into the dense matrix: every remapped col index
    must resolve (through the halo mapping) to the original global col."""
    n = 48
    dense = _random_dense(n, n, 0.12, seed=3)
    S = 4
    plan = partition_rows(CSR.from_dense(dense), S)
    cps, rps, H = plan.cols_per_shard, plan.rows_per_shard, plan.halo_size
    send = np.asarray(plan.send_idx)

    recon = np.zeros((S * rps, S * cps), np.float32)
    for b in plan.buckets:
        rids = np.asarray(b.row_ids)
        cols = np.asarray(b.cols)
        vals = np.asarray(b.vals)
        for p in range(S):
            for i in range(rids.shape[1]):
                for k in range(cols.shape[2]):
                    v = vals[p, i, k]
                    if v == 0:
                        continue
                    c = cols[p, i, k]
                    if c < cps:
                        gc = p * cps + c
                    else:
                        q, j = divmod(c - cps, H)
                        gc = q * cps + send[q, p, j]
                    recon[p * rps + rids[p, i], gc] += v
    np.testing.assert_allclose(recon[:n, :n], dense, rtol=1e-6, atol=1e-6)


def test_send_idx_local_range():
    dense = _random_dense(64, 64, 0.2, seed=4)
    plan = partition_rows(CSR.from_dense(dense), 4)
    send = np.asarray(plan.send_idx)
    assert send.min() >= 0
    assert send.max() < plan.cols_per_shard


def test_halo_fraction_reported():
    dense = _random_dense(64, 64, 0.05, seed=5)
    plan = partition_rows(CSR.from_dense(dense), 4)
    assert 0.0 <= plan.halo_fraction
