"""Second batch of error-message UX tests (reference:
python/oneflow/test/exceptions/ — 47 files asserting misuse produces
clean, typed, actionable messages). Each test drives a real API boundary
the same way a user would hit it."""

import numpy as np
import pytest


# --- sparse formats ---------------------------------------------------------


def test_encode_example_rejects_unsupported_type():
    from of_spmm.data.records import encode_example

    with pytest.raises(TypeError):
        encode_example({"x": object()})


def test_coo_out_of_range_rows():
    from of_spmm.sparse.formats import COO

    coo = COO(rows=np.asarray([0, 5]), cols=np.asarray([0, 1]),
              vals=np.ones(2, np.float32), shape=(2, 2))
    with pytest.raises(ValueError, match="out of range"):
        coo.validate()


def test_csr_indptr_must_start_at_zero():
    from of_spmm.sparse.formats import CSR

    with pytest.raises(ValueError, match="start at 0"):
        CSR(indptr=np.asarray([1, 1, 1, 1]), cols=np.asarray([0]),
            vals=np.ones(1, np.float32), shape=(3, 3)).validate()


def test_csr_indptr_decreasing():
    from of_spmm.sparse.formats import CSR

    with pytest.raises(ValueError, match="non-decreasing"):
        CSR(indptr=np.asarray([0, 2, 1, 2]), cols=np.asarray([0, 1]),
            vals=np.ones(2, np.float32), shape=(3, 3)).validate()


def test_from_dense_requires_2d():
    from of_spmm.sparse.formats import COO

    with pytest.raises(ValueError, match="2-D"):
        COO.from_dense(np.ones((2, 2, 2), np.float32))


# --- ops / registry ---------------------------------------------------------


def test_registry_unknown_op_lists_known():
    from of_spmm.ops.registry import lookup

    with pytest.raises(KeyError) as ei:
        lookup("not-an-op")
    assert "spmm" in str(ei.value)  # names what IS registered


def test_registry_double_register():
    from of_spmm.ops import registry

    with pytest.raises(ValueError, match="already registered"):
        registry.register_op("spmm", oracle=lambda: None, impls={})


def test_spmm_expects_sparse_type():
    from of_spmm.ops.reference import spmm

    with pytest.raises(TypeError, match="COO/CSR"):
        spmm(np.eye(3), np.ones((3, 2)))


def test_relabel_needs_square():
    from of_spmm.ops.autograd import make_operator
    from of_spmm.sparse.formats import CSR

    a = CSR.from_dense(np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="square"):
        make_operator(a, place=False, relabel=True)


# --- nn ---------------------------------------------------------------------


def test_attention_head_divisibility():
    from of_spmm.nn import MultiheadAttention

    with pytest.raises(ValueError, match="embed_dim"):
        MultiheadAttention(embed_dim=10, num_heads=3)


def test_groupnorm_divisibility():
    import jax

    from of_spmm import nn

    with pytest.raises(ValueError, match="divide"):
        nn.GroupNorm(num_groups=3, num_channels=8)


def test_interpolate_requires_size_or_scale():
    import jax.numpy as jnp

    from of_spmm.nn.extras import interpolate

    with pytest.raises(ValueError, match="size/scale_factor"):
        interpolate(jnp.ones((1, 1, 4, 4)))


def test_interpolate_unsupported_mode():
    import jax.numpy as jnp

    from of_spmm.nn.extras import interpolate

    with pytest.raises(ValueError, match="unsupported mode"):
        interpolate(jnp.ones((1, 1, 4, 4)), scale_factor=2, mode="bicubic")


def test_pixel_shuffle_divisibility():
    import jax.numpy as jnp

    from of_spmm.nn.extras import pixel_shuffle

    with pytest.raises(ValueError, match="divisible"):
        pixel_shuffle(jnp.ones((1, 3, 4, 4)), 2)


def test_flash_attention_mask_restriction():
    import jax

    from of_spmm.nn import MultiheadAttention

    m = MultiheadAttention(embed_dim=16, num_heads=2, flash=True)
    p = m.init(jax.random.key(0))
    x = np.ones((2, 8, 16), np.float32)
    mask = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="is_causal"):
        m.apply(p, x, mask=mask)


# --- plan builders ----------------------------------------------------------


def test_binned_bad_ladder():
    from of_spmm.sparse.binned import bin_rows
    from of_spmm.sparse.formats import CSR

    a = CSR.from_dense(np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="ladder"):
        bin_rows(a, ladder="fibonacci")


# --- distribution -----------------------------------------------------------


def test_dist_spmm_shard_count_mismatch():
    import jax
    from jax.sharding import Mesh

    from of_spmm.models.gcn import normalized_adjacency
    from of_spmm.parallel import dist_spmm, partition_rows
    from of_spmm.sparse.formats import CSR

    rng = np.random.default_rng(0)
    a = CSR.from_dense((rng.random((32, 32)) < 0.2).astype(np.float32))
    plan = partition_rows(normalized_adjacency(a), 4)
    mesh = Mesh(np.asarray(jax.devices())[:8], ("x",))
    x = np.ones((32, 8), np.float32)
    with pytest.raises(ValueError, match="4"):
        dist_spmm(plan, x, mesh)


def test_tp_requires_divisible_width():
    import jax
    from jax.sharding import Mesh

    from of_spmm.parallel.tp import init_tp_mlp, shard_tp_mlp

    mesh = Mesh(np.asarray(jax.devices()), ("tp",))
    params = init_tp_mlp(jax.random.key(0), 4, 10)
    with pytest.raises(ValueError):
        shard_tp_mlp(params, mesh)


def test_auto_sharding_unknown_rules():
    from of_spmm.ops.registry import OpDef
    from of_spmm.parallel.auto_sharding import choose_signature

    op = OpDef(name="mystery", oracle=None, impls={}, sharding_rules=())
    with pytest.raises(ValueError, match="sharding rules"):
        choose_signature(op, ("B",), (1.0,), 8)


# --- data / records ---------------------------------------------------------


def test_record_reader_rejects_corrupt_crc(tmp_path):
    from of_spmm.data.records import RecordWriter, read_records

    path = tmp_path / "r.rec"
    with RecordWriter(str(path)) as w:
        w.write(b"hello world")
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF  # flip a payload byte
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError, match="CRC"):
        list(read_records(str(path)))


def test_dataset_batch_nonpositive():
    from of_spmm.data.dataset import DataLoader, TensorDataset

    ds = TensorDataset(np.arange(10))
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(ds, batch_size=0)


def test_tensor_dataset_leading_dim_mismatch():
    from of_spmm.data.dataset import TensorDataset

    with pytest.raises(ValueError, match="leading dim"):
        TensorDataset(np.arange(4), np.arange(5))
