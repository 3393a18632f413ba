"""Test harness: by default, an 8-device virtual CPU mesh.

The test pyramid (SURVEY §4) runs on the CPU so it is fast and
deterministic; the sharding tests use the 8 virtual devices to stand in for
several cards. XLA_FLAGS must be set before the CPU client is created.

Tests marked `chip` need a GPU. They skip on the CPU (decided in the `gpu`
fixture, never at import) and run on the card with

    TRITD_TESTS_ON_CHIP=1 python -m pytest tests/ -q -m chip

which leaves JAX's platform choice alone.
"""

import os

ON_CHIP = os.environ.get("TRITD_TESTS_ON_CHIP") == "1"

if not ON_CHIP:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    if not ON_CHIP:
        assert jax.default_backend() == "cpu"
        assert jax.device_count() == 8


@pytest.fixture
def gpu():
    """The first GPU; skips the test where there is none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs a GPU: run on the card with"
            " TRITD_TESTS_ON_CHIP=1 python -m pytest tests/ -m chip"
        )
    return device
