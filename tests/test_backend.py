"""The one backend decision (ops/registry.py), the device peak table, the
device record and the compile-cache location."""

import os

import jax
import pytest

from of_spmm.ops import registry
from of_spmm.utils.config import FLAGS


@pytest.fixture
def platform(monkeypatch):
    """Pretend the default backend is ``platform``."""
    def set_(name):
        monkeypatch.setattr(registry, "platform", lambda: name)
    return set_


@pytest.fixture
def no_interpret_flag():
    FLAGS.override("OFS_FORCE_PALLAS_INTERPRET", False)
    yield
    FLAGS.override("OFS_FORCE_PALLAS_INTERPRET", True)


@pytest.mark.parametrize("plat", ["gpu", "cpu"])
def test_spmm_auto_follows_platform(platform, plat):
    platform(plat)
    want = registry.SPMM_AUTO[plat]
    assert registry.lookup("spmm").resolve_impl("auto") == want
    assert registry.lookup("spmm").impl("auto") is \
        registry.lookup("spmm").impls[want]


def test_cpu_auto_is_xla(platform):
    platform("cpu")
    assert registry.lookup("spmm").resolve_impl() == "xla"


@pytest.mark.parametrize("plat", ["gpu", "cpu", "rocm"])
def test_ops_without_auto_entry_take_xla(platform, plat):
    platform(plat)
    assert registry.lookup("gather").resolve_impl("auto") == "xla"


def test_explicit_impl_wins_over_auto(platform):
    platform("gpu")
    assert registry.lookup("spmm").resolve_impl("xla") == "xla"
    assert registry.lookup("spmm").resolve_impl("pallas") == "pallas"


def test_default_impl_flag_overrides_auto(platform):
    platform("gpu")
    FLAGS.override("OFS_DEFAULT_IMPL", "xla")
    try:
        assert registry.lookup("spmm").resolve_impl("auto") == "xla"
    finally:
        FLAGS.override("OFS_DEFAULT_IMPL", None)


def test_pallas_compiles_on_gpu(platform, no_interpret_flag):
    platform("gpu")
    assert registry.pallas_interpret() is False


@pytest.mark.parametrize("plat", ["cpu", "rocm", "metal"])
def test_pallas_refuses_other_backends(platform, no_interpret_flag, plat):
    platform(plat)
    with pytest.raises(RuntimeError, match="OFS_FORCE_PALLAS_INTERPRET"):
        registry.pallas_interpret()


def test_interpret_flag_interprets_anywhere(platform):
    platform("cpu")
    assert registry.pallas_interpret() is True


def test_spmm_pallas_without_flag_raises_on_cpu(no_interpret_flag):
    import jax.numpy as jnp
    import numpy as np

    from of_spmm.ops.autograd import make_operator, spmm
    from of_spmm.sparse.formats import CSR

    op = make_operator(CSR.from_dense(np.eye(8, dtype=np.float32)))
    with pytest.raises(RuntimeError, match="compile only for a GPU"):
        spmm(op, jnp.ones((8, 4), jnp.float32), impl="pallas")


def test_unknown_impl_name_lists_choices():
    with pytest.raises(KeyError, match="xla"):
        registry.lookup("spmm").impl("cusparse")


# --- peak table -------------------------------------------------------------


def test_h100_peaks():
    from of_spmm.utils.roofline import device_peaks

    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p.hbm_bytes_per_s == 3.35e12
    assert (p.fp32_flops, p.tf32_flops, p.bf16_flops) == (67e12, 495e12,
                                                          989e12)
    assert "H100" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    from of_spmm.utils.roofline import device_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)


def test_roofline_on_cpu_refuses_to_guess():
    from of_spmm.utils.roofline import SpmmTraffic

    t = SpmmTraffic(nnz=10, n_rows=4, n_cols=4, d=8)
    with pytest.raises(KeyError):
        t.speed_of_light_s()


def test_products_speed_of_light_on_h100():
    """ogbn-products d=128 moves ~65.7 GB: 19.6 ms at 3.35 TB/s."""
    from of_spmm.utils.roofline import SpmmTraffic, device_peaks, spmm_report

    t = SpmmTraffic(nnz=124_017_627, n_rows=2_449_029, n_cols=2_449_029,
                    d=128)
    bw = device_peaks("NVIDIA H100 80GB HBM3").hbm_bytes_per_s
    assert abs(t.speed_of_light_s(bw) - 0.0196) < 0.0002
    rep = spmm_report(0.0392, t, peak_bw=bw)
    assert abs(rep["roofline_fraction"] - 0.5) < 0.01


# --- device record ----------------------------------------------------------


def test_require_gpu_raises_on_cpu():
    from of_spmm.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_device_record_on_cpu():
    from of_spmm.utils.device import device_record

    rec = device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


# --- compile cache ----------------------------------------------------------


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path,
                                    restore_cache_config):
    from of_spmm.utils.config import compile_cache_dir, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is configured
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    from of_spmm.utils.config import (checkout_root, compile_cache_dir,
                                      enable_compile_cache)

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(checkout_root(), ".jax_cache")
    assert compile_cache_dir() == want
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isfile(os.path.join(checkout_root(), "of_spmm",
                                       "__init__.py"))


def test_caches_live_in_the_checkout(monkeypatch):
    from of_spmm import native
    from of_spmm.data.cache import cache_root
    from of_spmm.utils.config import checkout_root

    monkeypatch.delenv("OFS_CACHE_DIR", raising=False)
    monkeypatch.delenv("OFS_NATIVE_CACHE", raising=False)
    assert cache_root() == os.path.join(checkout_root(), ".ofs_data")
    assert native._cache_dir() == os.path.join(checkout_root(),
                                               ".ofs_native")


def test_gitignore_lists_the_caches():
    from of_spmm.utils.config import checkout_root

    with open(os.path.join(checkout_root(), ".gitignore")) as f:
        ignored = set(f.read().split())
    assert {".jax_cache/", ".ofs_data/", ".ofs_native/",
            "chiprun_out/"} <= ignored


# --- trace reduction --------------------------------------------------------


def test_trace_kernel_times_reads_device_planes(tmp_path):
    import jax.numpy as jnp

    from of_spmm.utils.roofline import trace_kernel_times

    f = jax.jit(lambda a: (a @ a).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    # no GPU plane in a CPU trace; the host plane has events
    assert trace_kernel_times(str(tmp_path)) == {}
    host = trace_kernel_times(str(tmp_path), plane_prefix="/host:CPU")
    assert host and all(v >= 0 for v in host.values())


@pytest.mark.parametrize("plat,want", [("gpu", "cudnn"), ("cpu", "xla")])
def test_attention_route_follows_platform(platform, plat, want):
    """jax.nn.dot_product_attention's own default is XLA; the registry
    asks for cuDNN by name on the GPU."""
    platform(plat)
    assert registry.lookup("dot_product_attention").resolve_impl() == want
