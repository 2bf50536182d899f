"""Fast-subset coverage of the sharded engine, whose full module
(test_sharded.py) is marked `slow`: 2- and 4-device virtual-mesh runs
against the f64 ring oracle, one with a source straddling a shard cut."""

import numpy as np
import pytest

import tpufdtd as tf
from conftest import make_correctness_ic, rel_l2


def test_sharded_smoke():
    """Minimal 2-device sharded run (jnp backend, 1-D mesh) vs the f64 ring
    oracle."""
    from tpufdtd.parallel import make_mesh, simulate_sharded

    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_correctness_ic(g)
    cfg = tf.SimConfig(dt=0.001, nsteps=8, backend="jnp")
    ring = simulate_sharded(up0, uc0, m, g, cfg, make_mesh(2))
    ring_t = tf.oracle_run_ring(up0, uc0, m, g, 0.001, 8, dtype=np.float64)
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-6


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_jnp_matches_oracle_with_boundary_source(ndev):
    """Zero ICs plus a source half a cell before the cut between shards 0
    and 1: its trilinear corners land in two owners, and the ppermute
    exchange must carry the wave across."""
    from tpufdtd.parallel import make_mesh, simulate_sharded

    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    u0 = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(8, 1, 0.001)
    coords = np.array([[g.nx / ndev - 0.5, 4.2, 3.7]], np.float32)
    cfg = tf.SimConfig(dt=0.001, nsteps=8, backend="jnp")
    ring = simulate_sharded(u0, u0, m, g, cfg, make_mesh(ndev), src=src,
                            src_coords=coords)
    ring_t = tf.oracle_run_ring(u0, u0, m, g, 0.001, 8, src=src,
                                src_coords=coords, dtype=np.float64)
    assert np.abs(ring[1]).max() > 0
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-6


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_equals_single_device_with_boundary_source(ndev):
    """With h = 0.1 a source at a shard cut has f32 coordinates that a
    per-shard shift would round differently; the sharded run takes the
    global source weights, so it equals the single-device run bit for bit."""
    from tpufdtd.parallel import make_mesh, simulate_sharded

    g = tf.Grid3D(16, 8, 8)
    u0 = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(8, 1, 0.001) * np.float32(1e3)
    coords = np.array([[(g.nx / ndev - 0.3) * g.hx, 0.37, 0.41]], np.float32)
    cfg = tf.SimConfig(dt=0.001, nsteps=8, backend="jnp")
    ring = simulate_sharded(u0, u0, m, g, cfg, make_mesh(ndev), src=src,
                            src_coords=coords)
    ref = tf.simulate_ring(u0, u0, m, g, cfg, src, coords)
    assert np.abs(ref[1]).max() > 0
    for mine, single in zip(ring, ref):
        np.testing.assert_array_equal(mine, single)
