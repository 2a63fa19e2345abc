"""Test harness: 8 virtual CPU devices, Pallas in interpreter mode.

Mirrors the reference's strategy of running distributed tests without
dedicated clusters (multi-process simulation,
ci/test/generic_test_multi_client.sh): here the mesh is 8 virtual CPU
devices in one process, and Pallas kernels run interpreted. GPU execution
is exercised by chip_smoke.py and bench.py; tests marked ``gpu`` run only
with OFS_TEST_ON_GPU=1 on a machine with a card
(``OFS_TEST_ON_GPU=1 python -m pytest -m gpu tests/``).
"""

import os

import jax
import pytest

ON_GPU = bool(os.environ.get("OFS_TEST_ON_GPU"))
if not ON_GPU:
    # Must run before any device access: CPU with 8 virtual devices for
    # the test mesh. OFS_TEST_DEVICE_NUM mirrors the reference's
    # ONEFLOW_TEST_DEVICE_NUM (framework/unittest.py:188-221): the same
    # test files run at different simulated device counts (>= 8; mesh
    # tests slice jax.devices()[:n]).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update(
        "jax_num_cpu_devices",
        max(8, int(os.environ.get("OFS_TEST_DEVICE_NUM", "8"))))

from of_spmm.utils.config import FLAGS  # noqa: E402

if not ON_GPU:
    FLAGS.override("OFS_FORCE_PALLAS_INTERPRET", True)

# Reference numeric parity bar (torch_flow_dual_object.py:1044 defaults).
RTOL = 1e-4
ATOL = 1e-5


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test; skipped unless OFS_RUN_SLOW=1. "
        "Budget (measured r4, 2-core CI host): default tier ~20 min, "
        "+slow tier ~35 min total; run the slow tier at least once per "
        "round (it holds the deepest distributed oracles).")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (a compiled kernel has no CPU form); skips "
        "unless OFS_TEST_ON_GPU=1 and JAX's first device is a GPU.")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("OFS_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; set OFS_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless a GPU is the default device
    (decided here, at run time, never at collection)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if not ON_GPU or jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with OFS_TEST_ON_GPU=1 on a card")


@pytest.fixture(scope="session")
def mesh8():
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual cpu devices, got {len(devs)}"
    return Mesh(np.asarray(devs), ("x",))
