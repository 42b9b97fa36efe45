"""Test configuration: run JAX on the CPU backend with 8 virtual devices.

The sharded/multi-device code paths run on a virtual 8-device CPU mesh
(SURVEY.md §4.4). The engine's device programs use exact integer
arithmetic, so CPU-run results are the same bits a GPU produces.

TAT_GPU_TESTS=1 selects the GPU lane instead: the backend is left alone
and only tests marked `gpu` should be selected, in one process for the
card:

    TAT_GPU_TESTS=1 python -m pytest tests -m gpu -q -p no:xdist
"""

import os

GPU_LANE = os.environ.get("TAT_GPU_TESTS") == "1"

if not GPU_LANE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8

