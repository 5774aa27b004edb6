"""Test harness configuration.

Tests run on the CPU, on a virtual 8-device mesh (the standard JAX pattern
for validating sharding/collectives without several accelerators), with x64
enabled so that oracle comparisons against scipy are tight. The framework
itself is dtype-polymorphic; GPU runs use f32.

Tests that need the card carry the `gpu` marker and skip elsewhere (the
decision is made in a fixture). On a GPU machine run them with
`python -m pytest tests -m gpu`: with exactly that marker expression the
platform is left to JAX instead of being pinned to the CPU.
"""

import os

import jax


def pytest_configure(config):
    if config.option.markexpr == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
