"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Unit and integration tests run everywhere (CI included) on the CPU
backend with 8 virtual devices, so multi-device sharding is testable
without hardware — the same trick the reference uses to test SYCL "GPU"
code on CPU runners (reference
``.github/workflows/test_gpgpu_install.yml:31-41``).

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX sees no GPU. On a machine with one,
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them: the CPU
stays the default backend and the card is added beside it.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_platforms = (
    "cpu,cuda" if "cuda" in os.environ.get("JAX_PLATFORMS", "") else "cpu"
)
os.environ["JAX_PLATFORMS"] = _platforms

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on the card)")
