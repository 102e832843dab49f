"""Test configuration: run every test on a virtual 8-device CPU mesh.

SURVEY §4: multi-device without a cluster —
``--xla_force_host_platform_device_count=8`` exercises the real
pjit/sharding/collective paths on fake CPU devices. Must be set before jax
initializes a backend, hence at conftest import time.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# This image pre-imports parts of jax at interpreter startup (the env vars
# above would be read too late), so force the platform through the config too.
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def runtime(tmp_path):
    from rocket_tpu.runtime.context import Runtime

    return Runtime(seed=0, project_dir=str(tmp_path))


@pytest.fixture
def runtime8(tmp_path):
    """Runtime over all 8 virtual devices on a data axis."""
    from rocket_tpu.runtime.context import Runtime

    return Runtime(
        mesh_shape={"data": 8}, seed=0, project_dir=str(tmp_path)
    )


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run @pytest.mark.slow tests (the full CI tier; the "
        "default fast tier finishes in a few minutes)",
    )


def pytest_configure(config):
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {len(jax.devices())}: "
        f"{jax.devices()}"
    )
    config.addinivalue_line(
        "markers",
        "slow: long-running test (multi-process spawns, big compiles); "
        "skipped unless --runslow",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
