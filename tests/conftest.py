"""Test config: an 8-device virtual CPU platform so sharding tests run on
any host. JAX_PLATFORMS defaults to cpu; tests marked `gpu` need a CUDA
device and run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tpufdtd.utils.envcfg import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import tpufdtd as tf  # noqa: E402


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a CUDA GPU. Decided
    here, at run time, never at import or collection."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run with -m gpu on the card)")


@pytest.fixture
def small_grid():
    return tf.Grid3D(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)


def make_correctness_ic(grid):
    """The reference's correctness IC: u_cur = sin(i*0.001)*10+100 over the
    flat padded volume, u_prev = 0 (main.cpp:525-532 — the third ring level
    read as u_{-1} on the first step is freshly-zeroed memory)."""
    volp = int(np.prod(grid.padded_shape))
    idx = np.arange(volp, dtype=np.float32).reshape(grid.padded_shape)
    u_cur = np.sin(idx * np.float32(0.001)) * np.float32(10.0) + np.float32(100.0)
    u_prev = np.zeros_like(u_cur)
    m = np.full(grid.padded_shape, 1.5, dtype=np.float32)
    return u_prev, u_cur, m


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2) / (np.sum(b**2) + 1e-30)))
