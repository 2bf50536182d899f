"""Harness layer: correctness phase, perf phase, CSV schema (SURVEY.md §2.1)."""

import os

import numpy as np
import pytest

import tpufdtd as tf
from tpufdtd.harness.correctness import run_correctness
from tpufdtd.harness.perf import memory_budget_bytes, run_benchmark, state_bytes
from tpufdtd.utils.csvio import HEADER
from tpufdtd.utils import metrics


def test_correctness_phase_small():
    reports = run_correctness(sizes=[16], nsteps=10, backends=("jnp", "auto"),
                              verbose=False)
    assert len(reports) == 2
    for r in reports:
        assert r.passed, (r.method, r.rel_l2)
        assert r.rel_l2 < 1e-4
        assert r.nan_count == 0 and r.inf_count == 0


def test_perf_phase_writes_csv(tmp_path):
    csv = str(tmp_path / "benchmark.csv")
    results = run_benchmark(
        method="jnp", grids=[16], timesteps=10, nsrc=1, reps=2,
        csv_path=csv, verbose=False,
    )
    assert len(results) == 1
    assert results[0]["gflops"] > 0
    lines = open(csv).read().strip().split("\n")
    assert lines[0] == HEADER
    assert len(lines) == 2
    row = lines[1].split(",")
    assert len(row) == len(HEADER.split(","))
    assert row[0] == "jnp"
    assert int(row[18]) == 16  # NX
    assert int(row[23]) == 4  # StencilOrder
    # no published peaks on the CPU: efficiencies are empty, not numbers
    assert row[15] == "" and row[16] == ""
    assert results[0]["platform"] == "cpu"
    assert results[0]["memory_eff_pct"] is None


@pytest.mark.parametrize("storage_dtype,bytes_pt",
                         [("float32", 16.0), ("bfloat16", 10.0)])
def test_perf_rates_use_streaming_bytes_of_timed_steps(tmp_path, storage_dtype,
                                                       bytes_pt):
    """Every engine is charged the bytes one step moves (u_cur, u_prev and
    target in the storage dtype, m in f32), over the timed steps only."""
    csv = str(tmp_path / "b.csv")
    r = run_benchmark(method="jnp", grids=[16], timesteps=10, nsrc=1, reps=1,
                      csv_path=csv, verbose=False,
                      storage_dtype=storage_dtype)[0]
    assert metrics.bytes_streaming(2 if storage_dtype == "bfloat16" else 4) \
        == bytes_pt
    assert r["gbps"] / r["gflops"] == pytest.approx(bytes_pt / 36)
    # 10 steps, the first 5 untimed
    assert r["gcells_per_s"] == pytest.approx(16**3 * 5 / r["device_time_s"] / 1e9)
    row = open(csv).read().strip().split("\n")[1].split(",")
    assert float(row[17]) == pytest.approx(36 / bytes_pt)  # AI


def test_perf_zero_sources_zero_field(tmp_path):
    results = run_benchmark(
        method="jnp", grids=[16], timesteps=5, nsrc=0, reps=1,
        csv_path=None, verbose=False,
    )
    assert results[0]["nan"] is False


def test_grid_skip_over_memory():
    # 4096^3 needs ~1.6 TB: over any device's (and this host's) budget
    assert state_bytes(tf.Grid3D(4096, 4096, 4096)) > memory_budget_bytes()
    results = run_benchmark(
        method="jnp", grids=[4096], timesteps=5, nsrc=0, reps=1,
        csv_path=None, verbose=False,
    )
    assert results == []


def test_state_bytes_reaches_ladder_on_16gib():
    """The skip guard lets the whole ladder to 1024^3 through (f32 and bf16
    storage) on an 80 GB H100: the default --hbm-frac 0.6 of the three
    quarters of the card a JAX process reserves. 4096^3 stays over the
    card (main.cpp:337-341 is the reference's analogue)."""
    from tpufdtd.config import Grid3D

    budget80 = 0.6 * 0.75 * 80e9
    for n in (512, 768, 1024):
        for dtype in ("float32", "bfloat16"):
            assert state_bytes(Grid3D(n, n, n), dtype) <= budget80, (n, dtype)
    assert state_bytes(Grid3D(4096, 4096, 4096)) > 80e9


def test_models_match_reference_constants():
    # 36 flops/pt at order 4; AI = 36/64 naive (main.cpp:129-152)
    assert metrics.flops_per_point(4) == 36
    assert metrics.arithmetic_intensity(4, metrics.BYTES_NAIVE) == 36 / 64
    assert metrics.gflops_model(128, 128, 128, 50, 1.0) == pytest.approx(
        128**3 * 50 * 36 / 1e9
    )


def test_cli_smoke(tmp_path, capsys):
    from tpufdtd.harness.cli import main

    csv = str(tmp_path / "b.csv")
    rc = main(["--sizes", "16", "--grids", "16", "--steps", "5", "--reps", "1",
               "--backends", "jnp", "--csv", csv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Step 1: Correctness" in out
    assert "Step 2: Performance" in out
    assert "benchmark.csv" in out or "Results" in out
    assert os.path.exists(csv)


def test_speed_test_smoke(capsys):
    from tpufdtd.harness.speedtest import run_speed_test

    out = run_speed_test(sizes=(12,), timesteps=6, backends=("jnp", "jnp"))
    assert len(out) == 1
    gs, ta, tb, sp = out[0]
    assert gs == 12 and ta > 0 and tb > 0 and sp > 0


def test_state_spec_matches_prepare_state():
    """state_spec / zero_state produce the exact prepare_state pytree
    (structure, shapes, dtypes): the device-built zero ICs the perf driver
    times must run the same compiled programs as host ICs."""
    import jax

    for dtype, gs in (("float32", 16), ("bfloat16", 12)):
        g = tf.Grid3D(gs, gs, gs)
        cfg = tf.SimConfig(dt=0.001, nsteps=4, storage_dtype=dtype)
        m = np.full(g.padded_shape, 1.5, np.float32)
        sim = tf.Simulator(g, cfg, m, tf.default_source_coords(1, gs, gs, gs))
        u = np.zeros(g.padded_shape, np.float32)
        ref = sim.prepare_state(u, u)
        spec = sim.state_spec()
        z = sim.zero_state()
        assert (
            jax.tree_util.tree_structure(ref)
            == jax.tree_util.tree_structure(spec)
            == jax.tree_util.tree_structure(z)
        )
        for a, s, r in zip(
            jax.tree_util.tree_leaves(ref),
            jax.tree_util.tree_leaves(spec),
            jax.tree_util.tree_leaves(z),
        ):
            assert a.shape == s.shape == r.shape
            assert a.dtype == s.dtype == r.dtype
        assert sim.state_field_stats(z) == (0.0, False)
        # one sourced step makes the field nonzero, and the stats see it
        st = sim.run(z, tf.ricker_table(4, 1, 0.001) * 1e3, 4)
        mx, nan = sim.state_field_stats(st)
        assert mx > 0 and nan is False
