"""Test configuration: the CPU backend with an 8-device virtual mesh.

Multi-device sharding logic runs without accelerators via XLA's
host-platform device-count flag (the "fake backend" strategy, SURVEY.md
section 4).  The platform is also pinned through jax.config, in case jax
was imported before this file.  The persistent compilation cache is off:
it serves the GPU, and CPU workers would otherwise load each other's
ahead-of-time CPU executables.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
