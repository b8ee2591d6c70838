"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic
is exercised without GPUs.  DARWIN_TPU_TEST_PLATFORM=gpu keeps JAX's
default platform, so the `gpu`-marked tests run on a machine with a
card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("DARWIN_TPU_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA
