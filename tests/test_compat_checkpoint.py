"""Reference-ABI compat entry point + checkpoint/resume."""

import numpy as np

import tpufdtd as tf
from tpufdtd.compat import Profiler, kernel_tpu
from tpufdtd.checkpoint import Checkpoint, load, save, run_with_checkpoints
from conftest import make_correctness_ic, rel_l2


def test_kernel_tpu_matches_oracle_ring(small_grid):
    """Full ABI-shaped call: 3-level ring array updated in place with the
    reference's entry/exit slot mapping (cuda.cu:233-235)."""
    g = small_grid
    up0, uc0, m = make_correctness_ic(g)
    nsteps = 11
    u = np.stack([uc0, uc0, up0])  # levels 0,1 = IC, level 2 = zeros
    timers = Profiler()
    rc = kernel_tpu(
        m, None, None, u,
        g.nx - 1, 0, g.ny - 1, 0, g.nz - 1, 0,
        0.001, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
        -1, 0, nsteps - 1, 0,
        timers=timers, backend="jnp",
    )
    assert rc == 0
    ring_t = tf.oracle_run_ring(up0, uc0, m, g, 0.001, nsteps, dtype=np.float64)
    # oracle returns (u_{N-1}, u_N, u_{N-2}); map to ring slots
    tM = nsteps - 1
    assert rel_l2(u[(tM + 1) % 3], ring_t[1]) < 1e-4
    assert rel_l2(u[tM % 3], ring_t[0]) < 1e-4
    assert rel_l2(u[(tM + 2) % 3], ring_t[2]) < 1e-4
    assert timers.section0 >= 0.0


def test_kernel_tpu_with_sources(small_grid):
    g = small_grid
    shape = g.padded_shape
    m = np.full(shape, 1.5, np.float32)
    u = np.zeros((3,) + shape, np.float32)
    nsteps = 10
    src = tf.ricker_table(nsteps, 2, 0.001)
    coords = tf.default_source_coords(2, g.nx, g.ny, g.nz, h=1.0)
    kernel_tpu(
        m, src, coords, u,
        g.nx - 1, 0, g.ny - 1, 0, g.nz - 1, 0,
        0.001, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
        1, 0, nsteps - 1, 0, backend="jnp",
    )
    z = np.zeros(shape, np.float32)
    ring_t = tf.oracle_run_ring(z, z, m, g, 0.001, nsteps, src=src,
                                src_coords=coords, dtype=np.float64)
    assert rel_l2(u[(nsteps) % 3], ring_t[1]) < 1e-4
    assert np.abs(u).max() > 0


def test_checkpoint_roundtrip(tmp_path, small_grid):
    up0, uc0, m = make_correctness_ic(small_grid)
    ck = Checkpoint(7, up0, uc0, up0, small_grid, 1e-3)
    p = str(tmp_path / "c.npz")
    save(p, ck)
    got = load(p)
    assert got.step == 7 and got.grid == small_grid and got.dt == 1e-3
    np.testing.assert_array_equal(got.u_cur, uc0)
    np.testing.assert_array_equal(got.u_target, up0)


def test_checkpointed_run_equals_unbroken(tmp_path, small_grid):
    """Split run (checkpoint every 4 of 12 steps) == single run, with
    sources indexed by absolute step."""
    g = small_grid
    shape = g.padded_shape
    m = np.full(shape, 1.5, np.float32)
    u0 = np.zeros(shape, np.float32)
    nsteps = 12
    src = tf.ricker_table(nsteps, 1, 0.001)
    coords = tf.default_source_coords(1, g.nx, g.ny, g.nz, h=1.0)
    cfg = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp")

    sim = tf.Simulator(g, cfg, m, coords)
    P1, C1 = run_with_checkpoints(
        sim, u0, u0, nsteps, src=src, checkpoint_every=4,
        path_fmt=str(tmp_path / "ck_{step:06d}.npz"),
    )
    sim2 = tf.Simulator(g, cfg, m, coords)
    st = sim2.prepare_state(u0, u0)
    st = sim2.run(st, src, nsteps)
    ref = sim2.extract_state(st)
    np.testing.assert_array_equal(C1, ref[1])
    np.testing.assert_array_equal(P1, ref[0])
    assert (tmp_path / "ck_000004.npz").exists()
    assert (tmp_path / "ck_000008.npz").exists()


def test_resume_from_checkpoint(tmp_path, small_grid):
    from tpufdtd.checkpoint import resume

    g = small_grid
    up0, uc0, m = make_correctness_ic(g)
    cfg = tf.SimConfig(dt=0.001, nsteps=6, backend="jnp")
    sim = tf.Simulator(g, cfg, m)
    st = sim.prepare_state(up0, uc0)
    st = sim.run(st, None, 6)
    lv = sim.extract_state(st)
    ck = Checkpoint(6, lv[0], lv[1], lv[2], g, 0.001)
    p = str(tmp_path / "mid.npz")
    save(p, ck)
    P, C = resume(p, cfg, m, nsteps_total=12)
    ring_t = tf.oracle_run_ring(up0, uc0, m, g, 0.001, 12)
    assert rel_l2(C, ring_t[1].astype(np.float64)) < 1e-4
    assert rel_l2(P, ring_t[0].astype(np.float64)) < 1e-4
