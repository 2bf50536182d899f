"""Bring-up check of the FDTD main path on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: phases 1-5 below
    python chip_smoke.py --four   # four GPUs: the sharded 512^3 run only

Phases (one process, nothing caught; any failure exits non-zero):
  1. device: JAX must see a GPU; prints device kind, count, and the card's
     name and power limit from nvidia-smi (a child process off JAX).
  2. correctness on the card vs the f64 oracle (XLA on the host CPU):
     the reference ladder 32^3-256^3 x 50 steps for both engines, orders 8
     and 12 at 128^3, bf16 storage at 128^3, a heterogeneous medium with
     sources at 128^3.
  3. 512^3 x 50 steps, order 4, f32, one Ricker source (the reference's
     headline run, ~2.3 GB of state) through Simulator.run and simulate;
     prints the compiled program's memory analysis and peak_bytes_in_use.
  4. the plane-sweep kernel vs XLA's fusion of the jnp step, both in the
     same Simulator ring: 512^3 x 50 agreement, then ms/step at order 4
     on 128^3-1024^3 and at orders 2, 8 and 12 on 512^3, each beside the
     engine backend="auto" picks there (scripts/kernel_vs_xla.py times
     more shapes).
  5. the benchmark CLI in-process: correctness at small grids, perf grid
     64, 128, 512.
The last stdout line is {"ok": true, "device": {...}} and nothing else.
"""

import argparse
import json
import sys
import time

import numpy as np

# bf16 storage re-rounds the carried state to an 8-bit mantissa every step;
# at 128^3 x 50 with sources the error settles near 4e-2 (CPU run of the
# same case), so the gate is 1e-1, not the f32 1e-4.
BF16_TOL = 1e-1
# kernel vs jnp: identical arithmetic order, only FMA contraction may
# differ, and leapfrog amplifies it over 50 steps
KERNEL_TOL = 1e-6
F32_TOL = 1e-4


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2) / (np.sum(b**2) + 1e-30)))


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: rel-L2 {err:.3e} (gate {tol:g})", flush=True)
    if not err < tol:
        raise AssertionError(f"{name}: rel-L2 {err:.3e} >= {tol:g}")


def finite_nonzero(name: str, arr) -> None:
    a = np.asarray(arr, np.float32)
    bad = int((~np.isfinite(a)).sum())
    nz = int((a != 0).sum())
    print(f"  {name}: non-finite {bad}, nonzero cells {nz},"
          f" max |u| {float(np.abs(a).max()):.6g}", flush=True)
    if bad or not nz:
        raise AssertionError(f"{name}: {bad} non-finite, {nz} nonzero")


def phase_correctness(tf):
    from tpufdtd.harness.correctness import make_ic, run_correctness
    from tpufdtd.oracle import truth_run_ring

    print("\n== phase 2: correctness vs the f64 oracle ==", flush=True)
    reports = run_correctness([32, 64, 128, 256], 50, ("jnp", "plane_sweep"))
    if not all(r.passed for r in reports):
        raise AssertionError("correctness ladder failed")

    for order in (8, 12):
        g = tf.Grid3D(128, 128, 128, hx=1.0, hy=1.0, hz=1.0, order=order)
        up, uc, m = make_ic(g)
        truth = truth_run_ring(up, uc, m, g, 0.001, 50)
        for backend in ("jnp", "plane_sweep"):
            ring = tf.simulate_ring(up, uc, m, g,
                                    tf.SimConfig(nsteps=50, backend=backend))
            check(f"order {order} 128^3 {backend}",
                  max(rel_l2(a, b) for a, b in zip(ring, truth)), F32_TOL)

    g = tf.Grid3D(128, 128, 128)
    z = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(50, 2, 0.001)
    coords = tf.default_source_coords(2, g.nx, g.ny, g.nz)
    truth = truth_run_ring(z, z, m, g, 0.001, 50, src, coords)
    ring = tf.simulate_ring(z, z, m, g, tf.SimConfig(storage_dtype="bfloat16"),
                            src, coords)
    finite_nonzero("bf16 storage 128^3 u_N", ring[1])
    check("bf16 storage 128^3, 2 sources",
          max(rel_l2(np.asarray(a, np.float32), b) for a, b in zip(ring, truth)),
          BF16_TOL)

    g = tf.Grid3D(128, 128, 128, hx=0.1, hy=0.12, hz=0.08)
    rng = np.random.default_rng(0)
    m = (1.0 + rng.random(g.padded_shape)).astype(np.float32)
    extent = np.array([(g.nx - 1) * g.hx, (g.ny - 1) * g.hy, (g.nz - 1) * g.hz])
    coords = (np.array([[0.262, 0.507, 0.493], [0.716, 0.276, 0.652]])
              * extent).astype(np.float32)
    src = tf.ricker_table(50, 2, 0.0005)
    truth = truth_run_ring(z, z, m, g, 0.0005, 50, src, coords)
    for backend in ("jnp", "plane_sweep"):
        ring = tf.simulate_ring(
            z, z, m, g, tf.SimConfig(dt=0.0005, backend=backend), src, coords)
        finite_nonzero(f"heterogeneous 128^3 {backend}", ring[1])
        check(f"heterogeneous medium 128^3, 2 sources, {backend}",
              max(rel_l2(a, b) for a, b in zip(ring, truth)), F32_TOL)


def phase_headline(tf, jax):
    print("\n== phase 3: 512^3 x 50, order 4, f32, 1 source ==", flush=True)
    n = 512
    g = tf.Grid3D(n, n, n)
    cfg = tf.SimConfig(nsteps=50)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(50, 1, cfg.dt)
    coords = tf.default_source_coords(1, g.nx, g.ny, g.nz)

    sim = tf.Simulator(g, cfg, m, coords)
    state = sim.zero_state()
    compiled = sim._jit_run.lower(
        state, sim.engine.m, sim._src_slice(src, 0, 50), nsteps=50
    ).compile()
    print(f"  engine {sim.backend}; memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    state = sim.run(state, src)
    jax.block_until_ready(state)
    print(f"  Simulator.run: {time.perf_counter() - t0:.3f} s incl. compile")
    mx, nan = sim.state_field_stats(state)
    print(f"  Simulator.run: max |u| {mx:.6g}, NaN {nan}")
    if nan or not mx > 0:
        raise AssertionError("Simulator.run: NaN or zero field")
    got = sim.extract_state(state)
    finite_nonzero("Simulator.run u_N", got[1])
    del state

    u0 = np.zeros(g.padded_shape, np.float32)
    _, uc = tf.simulate(u0, u0, m, g, cfg, src, coords)
    finite_nonzero("simulate u_N", uc)
    check("simulate vs Simulator.run", rel_l2(uc, got[1]), KERNEL_TOL)
    stats = jax.devices()[0].memory_stats()
    print(f"  peak_bytes_in_use {stats['peak_bytes_in_use']}"
          f" of bytes_limit {stats['bytes_limit']}", flush=True)


def phase_kernel(tf, jax, card):
    from tpufdtd.stepper import resolve_backend
    from tpufdtd.utils.peaks import detect_peaks

    print("\n== phase 4: plane-sweep kernel vs XLA's jnp fusion ==", flush=True)
    peaks = detect_peaks()
    n = 512
    g = tf.Grid3D(n, n, n)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(50, 1, 0.001)
    coords = tf.default_source_coords(1, g.nx, g.ny, g.nz)
    out = {}
    for backend in ("jnp", "plane_sweep"):
        sim = tf.Simulator(g, tf.SimConfig(backend=backend), m, coords)
        state = sim.run(sim.zero_state(), src)
        out[backend] = sim.extract_state(state)
        del sim, state
    finite_nonzero("plane_sweep 512^3 u_N", out["plane_sweep"][1])
    check("plane_sweep vs jnp 512^3 x 50, all ring levels",
          max(rel_l2(a, b) for a, b in zip(out["plane_sweep"], out["jnp"])),
          KERNEL_TOL)
    del out

    reps = 7
    for n, order in ((128, 4), (256, 4), (512, 4), (1024, 4), (512, 2),
                     (512, 8), (512, 12)):
        g = tf.Grid3D(n, n, n, order=order)
        m = np.full(g.padded_shape, 1.5, np.float32)
        coords = tf.default_source_coords(1, g.nx, g.ny, g.nz)
        cfg = tf.SimConfig(nsteps=50, warmup_steps=5)
        sims = {b: tf.Simulator(g, tf.SimConfig(nsteps=50, backend=b), m, coords)
                for b in ("jnp", "plane_sweep")}
        del m
        times = {b: [] for b in sims}
        for rep in range(reps + 1):  # rep 0 compiles; sides alternate
            sides = list(sims) if rep % 2 else list(sims)[::-1]
            for b in sides:
                _, secs = sims[b].run_timed(sims[b].zero_state(), src)
                if rep:
                    times[b].append(secs / (cfg.nsteps - cfg.warmup_steps))
        for b, ts in times.items():
            ts = np.array(ts)
            med = float(np.median(ts))
            cells = g.interior_cells
            gbps = 16.0 * cells / med / 1e9
            print(f"  {n}^3 order {order} {b:11s}: {med * 1e3:.4f} ms/step median"
                  f" ({ts.min() * 1e3:.4f}-{ts.max() * 1e3:.4f}, {reps} reps),"
                  f" {cells / med / 1e9:.2f} Gcell/s, {gbps:.1f} GB/s at 16 B/pt ="
                  f" {100 * gbps / peaks.hbm_gbps:.1f}% of {peaks.hbm_gbps:.0f}"
                  f" GB/s [{card}]", flush=True)
        ratio = np.median(times["jnp"]) / np.median(times["plane_sweep"])
        auto = resolve_backend(tf.SimConfig(), g)
        print(f"  {n}^3 order {order} plane_sweep speed-up over jnp:"
              f" {ratio:.3f}x; auto picks {auto}", flush=True)
        del sims


def phase_cli():
    from tpufdtd.harness import cli

    print("\n== phase 5: benchmark CLI ==", flush=True)
    rc = cli.main(["--sizes", "32", "64", "--grids", "64", "128", "512",
                   "--steps", "50", "--reps", "5", "--csv", "benchmark.csv"])
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")


def phase_four(tf, jax):
    from tpufdtd.parallel import ShardedSimulator, make_mesh

    print("\n== four GPUs: sharded 512^3 x 50 vs one GPU ==", flush=True)
    n = 512
    g = tf.Grid3D(n, n, n)
    m = np.full(g.padded_shape, 1.5, np.float32)
    u0 = np.zeros(g.padded_shape, np.float32)
    src = tf.ricker_table(50, 1, 0.001)
    # x index nx/4 - 0.5: the trilinear corners straddle the cut between
    # shards 0 and 1 of a 4-way split
    coords = np.array([[(g.nx / 4 - 0.5) * g.hx, 0.39 * g.ny * g.hy,
                        0.61 * g.nz * g.hz]], np.float32)
    cfg = tf.SimConfig(nsteps=50, backend="jnp")

    sim = ShardedSimulator(g, cfg, m, make_mesh(4), src_coords=coords)
    state, m_sh, packed = sim.prepare(u0, u0, m)
    devs = [str(s.device) for s in state[1].addressable_shards]
    print(f"  shards on: {devs}", flush=True)
    if len(set(devs)) != 4:
        raise AssertionError(f"shards not on 4 distinct devices: {devs}")
    t0 = time.perf_counter()
    state = sim.run(state, m_sh, packed, src, 50)
    jax.block_until_ready(state)
    print(f"  sharded run {time.perf_counter() - t0:.3f} s incl. compile")
    ring4 = sim.extract_state(state)
    del state

    # the same jnp step on one card: only the halo exchange differs
    sim1 = tf.Simulator(g, cfg, m, coords)
    ring1 = sim1.extract_state(sim1.run(sim1.prepare_state(u0, u0), src))
    finite_nonzero("sharded u_N", ring4[1])
    check("4-GPU sharded vs 1-GPU Simulator, all ring levels",
          max(rel_l2(a, b) for a, b in zip(ring4, ring1)), KERNEL_TOL)
    del ring4, ring1

    # steady state of both compiled 50-step programs (state made untimed)
    def run4():
        st, ms, pk = sim.prepare(u0, u0, m)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        jax.block_until_ready(sim.run(st, ms, pk, src, 50))
        return time.perf_counter() - t0

    def run1():
        st = jax.block_until_ready(sim1.zero_state())
        t0 = time.perf_counter()
        jax.block_until_ready(sim1.run(st, src))
        return time.perf_counter() - t0

    for name, fn in (("4 GPUs, sharded", run4), ("1 GPU, jnp", run1)):
        ts = np.array([fn() for _ in range(5)]) / 50
        print(f"  {n}^3 x 50 {name}: {np.median(ts) * 1e3:.4f} ms/step median"
              f" ({ts.min() * 1e3:.4f}-{ts.max() * 1e3:.4f}, 5 reps),"
              f" {g.interior_cells / np.median(ts) / 1e9:.2f} Gcell/s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-GPU sharded phase")
    args = p.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices", file=sys.stderr)
        return 1
    if args.four and len(devs) < 4:
        print(f"--four needs 4 GPUs; found {len(devs)}", file=sys.stderr)
        return 1

    import tpufdtd as tf
    from tpufdtd.utils.envcfg import enable_compile_cache
    from tpufdtd.utils.peaks import card_name_and_power

    enable_compile_cache()
    card = card_name_and_power()
    print("== phase 1: device ==")
    print(f"  JAX: {devs[0].platform} {devs[0].device_kind} x{len(devs)};"
          f" card: {card}", flush=True)

    if args.four:
        phase_four(tf, jax)
    else:
        phase_correctness(tf)
        phase_headline(tf, jax)
        phase_kernel(tf, jax, card)
        phase_cli()

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
