"""Engine choice, the jnp engine against the f64 ring oracle at every order,
device peaks, compile-cache placement and run_timed."""

import os
import subprocess
import sys

import numpy as np
import pytest

import tpufdtd as tf
from tpufdtd.stepper import (JnpEngine, PlaneSweepEngine, make_engine,
                             plane_sweep_measured_faster, resolve_backend)
from tpufdtd.utils import peaks
from conftest import make_correctness_ic, rel_l2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("with_sources", [False, True], ids=["nosrc", "src"])
@pytest.mark.parametrize("order", [2, 4, 6, 8, 10, 12])
def test_jnp_engine_matches_f64_ring(order, with_sources):
    """All three ring levels vs the f64 oracle on an odd, anisotropic grid
    with a heterogeneous medium; sources sit between lattice nodes."""
    g = tf.Grid3D(11, 9, 14, hx=0.5, hy=0.7, hz=0.4, order=order)
    rng = np.random.default_rng(order)
    up = rng.standard_normal(g.padded_shape).astype(np.float32)
    uc = rng.standard_normal(g.padded_shape).astype(np.float32)
    m = (1.0 + rng.random(g.padded_shape)).astype(np.float32)
    src = coords = None
    if with_sources:
        src = tf.ricker_table(10, 2, 5e-4) * np.float32(1e3)
        coords = np.array([[1.3, 2.05, 3.7], [4.1, 0.35, 2.2]], np.float32)
    ring = tf.simulate_ring(up, uc, m, g, tf.SimConfig(dt=5e-4, nsteps=10),
                            src, coords)
    truth = tf.oracle_run_ring(up, uc, m, g, 5e-4, 10, src, coords,
                               dtype=np.float64)
    for got, ref in zip(ring, truth):
        assert rel_l2(got, ref) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "plane_sweep"])
def test_engine_ring_rims_cycle_exactly(backend, small_grid):
    """Mixed-rim IC (the reference correctness setup): each ring level keeps
    the rim it started with, bit for bit, as the oracle's levels do."""
    up0, uc0, m = make_correctness_ic(small_grid)
    ring_t = tf.oracle_run_ring(up0, uc0, m, small_grid, 0.001, 7)
    sim = tf.Simulator(small_grid, tf.SimConfig(nsteps=7, backend=backend), m,
                       interpret=True)
    ring = sim.extract_state(sim.run(sim.prepare_state(up0, uc0)))
    rim = np.ones(small_grid.padded_shape, bool)
    rim[small_grid.interior_slices()] = False
    for mine, truth in zip(ring, ring_t):
        np.testing.assert_array_equal(mine[rim], truth[rim])


@pytest.mark.parametrize("backend", ["jnp", "plane_sweep"])
def test_engine_source_injection_into_rim_persists(backend):
    """A source corner one cell outside the interior lands in the rim
    (cuda.cu:155-156); the step never writes the rim, so the deposit stays."""
    g = tf.Grid3D(8, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    coords = np.array([[3.0, 3.0, -0.5]], np.float32)  # z floor = -1 (rim)
    m = np.full(g.padded_shape, 1.0, np.float32)
    src = np.ones((6, 1), np.float32)
    u0 = np.zeros(g.padded_shape, np.float32)
    ring_t = tf.oracle_run_ring(u0, u0, m, g, 0.001, 6, src=src,
                                src_coords=coords)
    sim = tf.Simulator(g, tf.SimConfig(nsteps=6, backend=backend), m, coords,
                       interpret=True)
    ring = sim.extract_state(sim.run(sim.prepare_state(u0, u0), src))
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-4
    assert np.abs(ring[1][3 + g.halo, 3 + g.halo, g.halo - 1]) > 0


def test_auto_backend_is_jnp_on_cpu():
    cfg = tf.SimConfig()
    assert cfg.backend == "auto"
    assert resolve_backend(cfg, tf.Grid3D(512, 512, 512)) == "jnp"
    g = tf.Grid3D(8, 8, 8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    eng = make_engine(g, cfg, m)
    assert type(eng) is JnpEngine
    assert tf.Simulator(g, cfg, m).backend == "jnp"


@pytest.mark.parametrize("shape,order,dtype,faster", [
    ((512, 512, 512), 4, "float32", True),
    ((256, 256, 256), 4, "float32", True),
    ((64, 512, 512), 4, "float32", True),
    ((128, 128, 128), 4, "float32", False),
    ((512, 512, 512), 2, "float32", False),
    ((1024, 1024, 40), 4, "float32", False),
    ((512, 512, 100), 6, "float32", False),
    ((64, 64, 64), 12, "float32", True),
    ((1024, 1024, 40), 8, "float32", True),
    ((32, 32, 32), 12, "float32", False),
    ((512, 512, 512), 4, "bfloat16", False),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plane_sweep_measured_faster(shape, order, dtype, faster):
    """auto's GPU rule: the kernel only where it beat jnp on the H100 (the
    cases are measured points: PERF.md), and never for bf16 storage."""
    g = tf.Grid3D(*shape, order=order)
    assert plane_sweep_measured_faster(g, dtype) is faster


def test_plane_sweep_requested_on_cpu_raises():
    g = tf.Grid3D(8, 8, 8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    with pytest.raises(ValueError, match="CUDA GPU"):
        tf.Simulator(g, tf.SimConfig(backend="plane_sweep"), m)
    # interpret=True is the tests' explicit way to run it here
    sim = tf.Simulator(g, tf.SimConfig(backend="plane_sweep"), m,
                       interpret=True)
    assert isinstance(sim.engine, PlaneSweepEngine)
    assert sim.engine.interpret and sim.backend == "plane_sweep"


def test_plane_sweep_needs_float32_storage():
    cfg = tf.SimConfig(backend="plane_sweep", storage_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        resolve_backend(cfg, tf.Grid3D(8, 8, 8), interpret=True)


@pytest.mark.parametrize("name", ["pallas", "pallas_v2", "cuda"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend(tf.SimConfig(backend=name), tf.Grid3D(8, 8, 8))


def test_h100_peaks_row():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert (p.hbm_gbps, p.fp32_gflops, p.hbm_gb) == (3350.0, 67000.0, 80.0)


@pytest.mark.parametrize(
    "kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks.peaks_for(kind)


def test_detect_peaks_raises_on_cpu():
    with pytest.raises(ValueError):
        peaks.detect_peaks()


def _cache_dir(env):
    code = ("from tpufdtd.utils.envcfg import enable_compile_cache; import jax;"
            " d = enable_compile_cache();"
            " print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return out.stdout.split()


def test_compile_cache_follows_env_var(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir(env) == [str(tmp_path), str(tmp_path)]


def test_compile_cache_default_is_in_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    assert _cache_dir(env) == [want, want]


def test_run_timed_with_sources_times_and_advances():
    """run_timed returns a positive time and the same state run() gives."""
    g = tf.Grid3D(12, 12, 12)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = tf.default_source_coords(1, 12, 12, 12)
    src = tf.ricker_table(9, 1, 0.001)
    sim = tf.Simulator(g, tf.SimConfig(nsteps=9, warmup_steps=4), m, coords)
    state, secs = sim.run_timed(sim.zero_state(), src)
    assert secs > 0.0
    ref = sim.run(sim.zero_state(), src, 9)
    for a, b in zip(sim.extract_state(state), sim.extract_state(ref)):
        np.testing.assert_array_equal(a, b)
    assert np.abs(sim.extract_state(state)[1]).max() > 0
