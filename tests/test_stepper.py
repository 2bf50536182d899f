"""Differential tests: jnp backend vs the oracle (the reference's
CUDA-vs-OpenACC comparison, main.cpp:511-652, rebuilt as pytest)."""

import numpy as np
import pytest

import tpufdtd as tf
from conftest import make_correctness_ic, rel_l2


def test_jnp_matches_truth_50_steps(small_grid):
    """Correctness-phase analogue: 50 steps, no sources, sin IC; gate
    relative L2 < 1e-4 vs the f64 truth (the criterion the reference
    documents, README.md:33; its published numbers are L2 2.18e-5-8.36e-5,
    STABILITY_FIX_LOG.md:133-140)."""
    up0, uc0, m = make_correctness_ic(small_grid)
    _, uc_t = tf.oracle_run(up0, uc0, m, small_grid, 0.001, 50, dtype=np.float64)
    up, uc = tf.simulate(
        up0, uc0, m, small_grid, tf.SimConfig(dt=0.001, nsteps=50, backend="jnp")
    )
    assert rel_l2(uc, uc_t) < 1e-4
    assert np.all(np.isfinite(uc))


def test_odd_size_grid():
    """Odd extents exercise partial tiles (DEBUG.md odd-size recipe)."""
    g = tf.Grid3D(17, 13, 11, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_correctness_ic(g)
    _, uc_t = tf.oracle_run(up0, uc0, m, g, 0.001, 20, dtype=np.float64)
    _, uc = tf.simulate(up0, uc0, m, g, tf.SimConfig(dt=0.001, nsteps=20, backend="jnp"))
    assert rel_l2(uc, uc_t) < 1e-4


def test_sources_match_oracle(small_grid):
    g = small_grid
    nsteps = 20
    src = tf.ricker_table(nsteps, 3, 0.001)
    coords = tf.default_source_coords(3, g.nx, g.ny, g.nz, h=1.0)
    shape = g.padded_shape
    u0 = np.zeros(shape, np.float32)
    m = np.full(shape, 1.5, np.float32)
    _, uc_t = tf.oracle_run(
        u0, u0, m, g, 0.001, nsteps, src=src, src_coords=coords, dtype=np.float64
    )
    _, uc = tf.simulate(
        u0,
        u0,
        m,
        g,
        tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp"),
        src=src,
        src_coords=coords,
    )
    assert rel_l2(uc, uc_t) < 1e-4
    assert np.abs(uc).max() > 0.0  # sources actually injected


def test_determinism(small_grid):
    """Bitwise-identical repeated runs — the regression guard for the
    reference's race-condition bug class (STABILITY_FIX_LOG.md:119-128)."""
    up0, uc0, m = make_correctness_ic(small_grid)
    cfg = tf.SimConfig(dt=0.001, nsteps=20, backend="jnp")
    _, uc1 = tf.simulate(up0, uc0, m, small_grid, cfg)
    _, uc2 = tf.simulate(up0, uc0, m, small_grid, cfg)
    np.testing.assert_array_equal(np.asarray(uc1), np.asarray(uc2))


def test_bf16_storage_mixed_precision(small_grid):
    """bf16 storage / f32 compute. Quantization feeds back through the
    carried state each step (the reference's FP16 mode avoided that only by
    keeping full FP32 shadow copies of all three levels,
    cuda_optimized.cu:301-302, which cancels the bandwidth win). On this
    harsh growing-DC IC, bf16 eps 2^-8 accumulates to a few percent — gate
    loosely and check stability, not f32-level accuracy."""
    up0, uc0, m = make_correctness_ic(small_grid)
    _, uc_t = tf.oracle_run(up0, uc0, m, small_grid, 0.001, 20, dtype=np.float64)
    _, uc = tf.simulate(
        up0,
        uc0,
        m,
        small_grid,
        tf.SimConfig(dt=0.001, nsteps=20, backend="jnp", storage_dtype="bfloat16"),
    )
    assert rel_l2(np.asarray(uc, np.float32), uc_t) < 1e-1
    assert np.all(np.isfinite(np.asarray(uc, np.float32)))


def test_nonuniform_medium_and_anisotropic_h():
    g = tf.Grid3D(12, 12, 12, hx=0.5, hy=1.0, hz=2.0)
    up0, uc0, _ = make_correctness_ic(g)
    rng = np.random.default_rng(0)
    m = (1.0 + rng.random(g.padded_shape)).astype(np.float32)
    _, uc_t = tf.oracle_run(up0, uc0, m, g, 0.0005, 20, dtype=np.float64)
    _, uc = tf.simulate(up0, uc0, m, g, tf.SimConfig(dt=0.0005, nsteps=20, backend="jnp"))
    assert rel_l2(uc, uc_t) < 1e-4


def test_run_timed_returns_final_state(small_grid):
    up0, uc0, m = make_correctness_ic(small_grid)
    cfg = tf.SimConfig(dt=0.001, nsteps=10, warmup_steps=5, backend="jnp")
    sim = tf.Simulator(small_grid, cfg, m)
    state = sim.prepare_state(up0, uc0)
    (up, uc, ut), secs = sim.run_timed(state)
    _, uc_ref = tf.oracle_run(up0, uc0, m, small_grid, 0.001, 10, dtype=np.float64)
    assert secs > 0.0
    assert rel_l2(uc, uc_ref) < 1e-4


def test_ring_state_matches_oracle_all_three_levels(small_grid):
    """Full 3-level ring parity — the reference compares all 3*volp values
    (main.cpp:577)."""
    up0, uc0, m = make_correctness_ic(small_grid)
    ring_t = tf.oracle_run_ring(up0, uc0, m, small_grid, 0.001, 21, dtype=np.float64)
    ring = tf.simulate_ring(
        up0, uc0, m, small_grid, tf.SimConfig(dt=0.001, nsteps=21, backend="jnp")
    )
    for a, b in zip(ring, ring_t):
        assert rel_l2(a, b) < 1e-4
