"""The Hopper plane-sweep kernel (ops/stencil_gpu): interpret-mode cases
against stencil_jnp on the CPU, its launch choice, and compiled cases that
run only on a CUDA GPU (`gpu` marker)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpufdtd as tf
from tpufdtd.ops import stencil_gpu, stencil_jnp
from conftest import make_correctness_ic, rel_l2


def _fields(g, seed=0):
    rng = np.random.default_rng(seed)
    u0, u1, tgt = (jnp.asarray(rng.standard_normal(g.padded_shape), jnp.float32)
                   for _ in range(3))
    m = jnp.asarray(1.0 + rng.random(g.padded_shape), jnp.float32)
    return u0, u1, m, tgt


def _rims_equal(a, b, h):
    a, b = np.asarray(a), np.asarray(b)
    return all(
        np.array_equal(a[s], b[s])
        for s in (np.s_[:h], np.s_[-h:], np.s_[:, :h], np.s_[:, -h:],
                  np.s_[..., :h], np.s_[..., -h:])
    )


@pytest.mark.parametrize("shape", [(32, 32, 32), (17, 24, 40)],
                         ids=["32cube", "17x24x40"])
@pytest.mark.parametrize("order", [2, 4, 8, 12])
def test_interpret_step_matches_jnp(order, shape):
    """One step with anisotropic h and a heterogeneous medium; 17x24x40
    leaves partial (masked) y and z tiles."""
    g = tf.Grid3D(*shape, hx=0.5, hy=1.0, hz=2.0, order=order)
    u0, u1, m, tgt = _fields(g, order)
    got = stencil_gpu.leapfrog_step(u0, u1, m, tgt, grid=g, dt=1e-3,
                                    interpret=True)
    ref = stencil_jnp.leapfrog_step(u0, u1, m, tgt, grid=g, dt=1e-3)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(got) - ref).max() <= 1e-6 * scale
    assert _rims_equal(got, ref, g.halo)


def test_interpret_leaves_target_rims_untouched():
    """Only the interior of the target is written: its rim survives even
    where it differs from u_cur's (the per-ring-level frozen rim)."""
    g = tf.Grid3D(12, 10, 20)
    u0, u1, m, _ = _fields(g, 1)
    tgt = jnp.full(g.padded_shape, 7.0, jnp.float32)
    got = np.asarray(stencil_gpu.leapfrog_step(u0, u1, m, tgt, grid=g,
                                               dt=1e-3, interpret=True))
    inner = np.ones(g.padded_shape, bool)
    inner[g.interior_slices()] = False
    assert np.all(got[inner] == 7.0)
    assert not np.any(got[g.interior_slices()] == 7.0)


def test_interpret_forced_launch_covers_chunks_and_edges():
    """A launch with 3-plane x chunks (the last one short) and tiles that
    overhang y and z gives the same step as the chosen launch."""
    g = tf.Grid3D(10, 9, 11, order=4)
    u0, u1, m, tgt = _fields(g, 2)
    lc = stencil_gpu.Launch(ty=4, tz=8, xc=3)
    a = stencil_gpu.leapfrog_step(u0, u1, m, tgt, grid=g, dt=1e-3,
                                  interpret=True, launch=lc)
    b = stencil_gpu.leapfrog_step(u0, u1, m, tgt, grid=g, dt=1e-3,
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_choose_launch():
    """Power-of-two tiles that cover small planes; x chunks of at most 64
    planes that still give >= MIN_PROGRAMS programs; 16-row tiles from
    256-row planes up."""
    for n in (16, 17, 32, 128, 256, 512, 1024):
        g = tf.Grid3D(n, n, n)
        lc = stencil_gpu.choose_launch(g)
        assert lc.ty & (lc.ty - 1) == 0 and lc.tz & (lc.tz - 1) == 0
        assert lc.ty == (16 if n >= 256 else min(8, 1 << (n - 1).bit_length()))
        assert 1 <= lc.xc <= 64
        tiles = -(-n // lc.ty) * -(-n // lc.tz)
        programs = tiles * -(-n // lc.xc)
        assert programs >= min(stencil_gpu.MIN_PROGRAMS, tiles * n)
    assert stencil_gpu.choose_launch(tf.Grid3D(512, 512, 512)) == (16, 64, 64)


def test_interpret_engine_ring_matches_jnp_engine():
    """The whole Simulator ring (exact 3-level rotation, sources) on the
    kernel equals the jnp engine's within fp-contraction distance."""
    g = tf.Grid3D(16, 12, 20, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    src = tf.ricker_table(6, 2, 0.001) * np.float32(1e3)
    coords = np.array([[3.3, 4.1, 9.7], [11.5, 6.0, 2.2]], np.float32)
    cfg = tf.SimConfig(nsteps=6, backend="plane_sweep")
    sim = tf.Simulator(g, cfg, m, coords, interpret=True)
    got = sim.extract_state(sim.run(sim.prepare_state(up, uc), src))
    ref = tf.simulate_ring(up, uc, m, g, tf.SimConfig(nsteps=6, backend="jnp"),
                           src, coords)
    for a, b in zip(got, ref):
        assert rel_l2(a, b) < 1e-6


@pytest.mark.gpu
def test_compiled_step_matches_jnp(gpu):
    g = tf.Grid3D(48, 40, 72, hx=0.5, hy=1.0, hz=2.0, order=8)
    u0, u1, m, tgt = _fields(g, 3)
    got = jax.jit(stencil_gpu.make_step(g, 1e-3))(u0, u1, m, tgt)
    ref = stencil_jnp.leapfrog_step(u0, u1, m, tgt, grid=g, dt=1e-3)
    assert rel_l2(got, ref) < 1e-6
    assert _rims_equal(got, ref, g.halo)


@pytest.mark.gpu
def test_auto_engine_on_gpu_is_plane_sweep(gpu):
    """On a GPU auto follows the measured rule: the kernel for order 4 from
    256^3 cells (a 64 x 512 x 512 grid, thin in x, counts too), jnp below
    and at order 2; the run it picks matches the f64 oracle."""
    from tpufdtd.oracle import truth_run_ring
    from tpufdtd.stepper import resolve_backend

    cfg = tf.SimConfig(nsteps=20)
    assert resolve_backend(cfg, tf.Grid3D(128, 128, 128)) == "jnp"
    assert resolve_backend(cfg, tf.Grid3D(256, 256, 256)) == "plane_sweep"
    assert resolve_backend(cfg, tf.Grid3D(512, 512, 512, order=2)) == "jnp"
    g = tf.Grid3D(64, 512, 512)
    up, uc, m = make_correctness_ic(g)
    sim = tf.Simulator(g, cfg, m)
    assert sim.backend == "plane_sweep"
    got = sim.extract_state(sim.run(sim.prepare_state(up, uc)))
    truth = truth_run_ring(up, uc, m, g, 1e-3, 20)
    for a, b in zip(got, truth):
        assert rel_l2(a, b) < 1e-4
