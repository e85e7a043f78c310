"""Test configuration: force an 8-device virtual CPU platform.

The multi-device sharding tests run on a virtual CPU mesh (the
analogue of the reference's serial/mpi twin backends, SURVEY §4.1);
physics tests run on the same platform in float64 where needed.
Tests marked ``gpu`` need an NVIDIA card and run their work in a child
process that is free to open it (the `gpu_card` fixture decides, at
run time, whether there is one).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: the model-step graphs take minutes to
# compile on the CPU backend; cache them across test runs.
from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA card is visible; returns its name."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    names = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not names:
        pytest.skip("no NVIDIA GPU visible to nvidia-smi")
    return names[0]


@pytest.fixture(scope="session")
def gx3_grid():
    import jax.numpy as jnp
    from cice4_tpu.config import gx3_config
    from cice4_tpu.grid import make_grid

    return make_grid(gx3_config(), dtype=jnp.float64)


@pytest.fixture(scope="session")
def gx3_cfg():
    from cice4_tpu.config import gx3_config

    return gx3_config()
