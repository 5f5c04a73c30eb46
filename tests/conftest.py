"""Test configuration: run JAX on CPU with 8 virtual devices so multi-card
sharding tests work without accelerator hardware (SURVEY.md §4).

jax.config is updated directly as well as through the environment, in
case jax was imported before this file (works as long as no backend has
been initialized yet).

Tests that only the card can run carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them unless JAX's platform is "gpu".  On the
card run them with ``TAXOR_TEST_PLATFORM=gpu python -m pytest tests -m
gpu``; that variable keeps this file from forcing the CPU.
"""

import os

import pytest

ON_GPU = os.environ.get("TAXOR_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided per test, never at
    import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "TAXOR_TEST_PLATFORM=gpu python -m pytest tests -m gpu")
