"""Sharded (multi-device) stepper vs the single-device oracle on an
8-device virtual CPU mesh (SURVEY.md §5: ppermute halo exchange over a 1-D
mesh)."""

import numpy as np
import pytest

import jax

# multi-device compiles per test dominate; test_smoke.py keeps fast sharded
# runs in `-m "not slow"`
pytestmark = pytest.mark.slow

import tpufdtd as tf
from tpufdtd.parallel import (
    ShardedSimulator,
    global_from_shards,
    make_mesh,
    shards_from_global,
    simulate_sharded,
)
from conftest import make_correctness_ic, rel_l2


def test_virtual_mesh_available():
    assert jax.device_count() >= 8


def test_shards_roundtrip():
    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    rng = np.random.default_rng(0)
    a = rng.random(g.padded_shape).astype(np.float32)
    stacked = shards_from_global(g, 4, a)
    assert np.array_equal(global_from_shards(g, 4, stacked), a)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_matches_oracle(ndev):
    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_correctness_ic(g)
    mesh = make_mesh(ndev)
    cfg = tf.SimConfig(dt=0.001, nsteps=12, backend="jnp")
    ring = simulate_sharded(up0, uc0, m, g, cfg, mesh)
    ring_t = tf.oracle_run_ring(up0, uc0, m, g, 0.001, 12, dtype=np.float64)
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-4


def test_sharded_with_sources_matches_oracle():
    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    shape = g.padded_shape
    u0 = np.zeros(shape, np.float32)
    m = np.full(shape, 1.5, np.float32)
    nsteps = 12
    src = tf.ricker_table(nsteps, 3, 0.001)
    coords = tf.default_source_coords(3, g.nx, g.ny, g.nz, h=1.0)
    mesh = make_mesh(4)
    cfg = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp")
    ring = simulate_sharded(u0, u0, m, g, cfg, mesh, src=src, src_coords=coords)
    ring_t = tf.oracle_run_ring(
        u0, u0, m, g, 0.001, nsteps, src=src, src_coords=coords, dtype=np.float64
    )
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-4
    assert np.abs(ring[1]).max() > 0


def test_sharded_source_on_shard_boundary():
    """Source straddling a shard cut: corners split across owners."""
    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    shape = g.padded_shape
    u0 = np.zeros(shape, np.float32)
    m = np.full(shape, 1.5, np.float32)
    nsteps = 8
    src = np.ones((nsteps, 1), np.float32)
    # with 4 shards of 4 planes each, x=3.5 straddles the cut between
    # shards 0 and 1
    coords = np.array([[3.5, 4.0, 4.0]], np.float32)
    mesh = make_mesh(4)
    cfg = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp")
    ring = simulate_sharded(u0, u0, m, g, cfg, mesh, src=src, src_coords=coords)
    ring_t = tf.oracle_run_ring(
        u0, u0, m, g, 0.001, nsteps, src=src, src_coords=coords, dtype=np.float64
    )
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-4


def test_sharded_frozen_global_rim():
    g = tf.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    _, uc0, m = make_correctness_ic(g)
    mesh = make_mesh(4)
    cfg = tf.SimConfig(dt=0.001, nsteps=6, backend="jnp")
    ring = simulate_sharded(uc0, uc0, m, g, cfg, mesh)
    h = g.halo
    # after 6 steps (two ring rotations) u_N sits in the u_cur buffer
    uc = ring[1]
    assert np.array_equal(uc[:h], uc0[:h])
    assert np.array_equal(uc[-h:], uc0[-h:])


def test_sharded_long_axis_1024():
    """A long sharded x axis (1024 planes over 8 devices) with thin y/z so
    it runs on the CPU mesh."""
    g = tf.Grid3D(1024, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    shape = g.padded_shape
    u0 = np.zeros(shape, np.float32)
    m = np.full(shape, 1.5, np.float32)
    src = tf.ricker_table(4, 1, 0.001)
    coords = tf.default_source_coords(1, g.nx, g.ny, g.nz, h=1.0)
    mesh = make_mesh(8)
    cfg = tf.SimConfig(dt=0.001, nsteps=4, backend="jnp")
    ring = simulate_sharded(u0, u0, m, g, cfg, mesh, src=src, src_coords=coords)
    ring_t = tf.oracle_run_ring(u0, u0, m, g, 0.001, 4, src=src,
                                src_coords=coords, dtype=np.float64)
    for mine, truth in zip(ring, ring_t):
        assert rel_l2(mine, truth) < 1e-4


def _zero_rim_ic(g, seed=3):
    rng = np.random.default_rng(seed)
    h = g.halo
    out = []
    for _ in range(2):
        a = rng.standard_normal(g.padded_shape).astype(np.float32)
        a[:h] = a[-h:] = 0
        a[:, :h] = a[:, -h:] = 0
        a[..., :h] = a[..., -h:] = 0
        out.append(a)
    return out


def test_sharded_bf16_per_step_fallback():
    """bf16 storage on the per-step sharded program: bf16 state and f32
    compute, bit-equal to the single-device jnp bf16 engine."""
    import jax.numpy as jnp

    g = tf.Grid3D(8, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_correctness_ic(g)
    cfg = tf.SimConfig(dt=0.001, nsteps=6, backend="jnp",
                       storage_dtype="bfloat16")
    sim = ShardedSimulator(g, cfg, m, make_mesh(4))
    st, ms, pk = sim.prepare(up0.copy(), uc0.copy(), m)
    assert st[0].dtype == jnp.bfloat16
    st = sim.run(st, ms, pk, None, 6)
    ring = sim.extract_state(st)
    cfg_j = tf.SimConfig(dt=0.001, nsteps=6, backend="jnp",
                         storage_dtype="bfloat16")
    ring_j = tf.simulate_ring(up0.copy(), uc0.copy(), m, g, cfg_j)
    for mine, jref in zip(ring, ring_j):
        assert np.array_equal(mine, np.asarray(jref, np.float32))


def test_sharded_checkpoint_resume_equals_unbroken(tmp_path):
    """Sharded checkpoint/resume (SURVEY §5): gather -> npz -> reshard. A
    run checkpointed mid-stream and resumed on a fresh ShardedSimulator is
    bit-equal to the unbroken run (no sources: the per-step f32 math does
    not depend on where the run was cut), and a sourced resume with
    absolute-step indexing stays within fp-association distance of the
    unbroken run."""
    from tpufdtd.checkpoint import run_sharded_with_checkpoints, resume_sharded

    g = tf.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _zero_rim_ic(g)
    m = np.full(g.padded_shape, 1.5, np.float32)
    cfg = tf.SimConfig(dt=0.001, nsteps=9, backend="jnp")
    mesh = make_mesh(4)

    # unbroken 9-step run
    sim = ShardedSimulator(g, cfg, m, mesh)
    st, ms, pk = sim.prepare(up.copy(), uc.copy(), m)
    st = sim.run(st, ms, pk, None, 9)
    P0, C0, _ = sim.extract_state(st)

    # checkpointed at step 5, resumed on a FRESH simulator over the mesh
    path_fmt = str(tmp_path / "ck_{step:06d}.npz")
    sim_a = ShardedSimulator(g, cfg, m, mesh)
    run_sharded_with_checkpoints(
        sim_a, up.copy(), uc.copy(), m, 9,
        checkpoint_every=5, path_fmt=path_fmt,
    )
    P1, C1 = resume_sharded(
        path_fmt.format(step=5), cfg, m, mesh, nsteps_total=9
    )
    assert np.array_equal(C1, C0)
    assert np.array_equal(P1, P0)

    # sourced variant: absolute-step source indexing across the break
    src = tf.ricker_table(9, 1, cfg.dt)
    coords = np.array([[16.0, 8.0, 8.0]], np.float32)
    sim_s = ShardedSimulator(g, cfg, m, mesh, src_coords=coords)
    st, ms, pk = sim_s.prepare(up.copy(), uc.copy(), m)
    st = sim_s.run(st, ms, pk, src, 9)
    _, Cs0, _ = sim_s.extract_state(st)

    sim_b = ShardedSimulator(g, cfg, m, mesh, src_coords=coords)
    run_sharded_with_checkpoints(
        sim_b, up.copy(), uc.copy(), m, 9, src=src,
        checkpoint_every=5, path_fmt=path_fmt,
    )
    _, Cs1 = resume_sharded(
        path_fmt.format(step=5), cfg, m, mesh, nsteps_total=9,
        src=src, src_coords=coords,
    )
    assert rel_l2(Cs1, Cs0) < 1e-6, rel_l2(Cs1, Cs0)
