import os

import pytest

# Tests run on a virtual 8-device CPU mesh, so the multi-device sharding
# logic is exercised without accelerators. Setting METAMDBG_TPU_TESTS_ON_DEVICE
# keeps JAX's own platform choice instead, for `pytest -m gpu` on a GPU host.
if not os.environ.get("METAMDBG_TPU_TESTS_ON_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

# Tests exercise the device dispatch paths: every calibrated gate routes
# its batches to the device unless a test says otherwise.
os.environ.setdefault("METAMDBG_TPU_REQUIRE_DEVICE", "1")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a CUDA GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (METAMDBG_TPU_TESTS_ON_DEVICE=1 "
                    "JAX_PLATFORMS=cuda pytest -m gpu)")
