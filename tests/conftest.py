"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-host logic is tested without a cluster via
``xla_force_host_platform_device_count`` (SURVEY.md §4 item 4). The CPU is
forced through jax.config before any backend is initialized.

Tests marked ``gpu`` need a card: they take the ``gpu`` fixture, which
skips them unless the run was started with SONDETPU_TEST_GPU=1 (which
leaves JAX on its default platform) and JAX found a GPU. On a card:
``SONDETPU_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import os

import pytest

ON_GPU = bool(os.environ.get("SONDETPU_TEST_GPU"))
if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    if not ON_GPU:
        pytest.skip("needs a GPU: run with SONDETPU_TEST_GPU=1 on a card")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX found {dev.platform!r}")
    return dev
