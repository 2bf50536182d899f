"""Time the plane-sweep kernel against XLA's fusion of the jnp step on a GPU.

    python scripts/kernel_vs_xla.py --cases 256:4 512:8 64x512x512:4
    python scripts/kernel_vs_xla.py --cases 512:4 --trace chiprun_out/trace
    python scripts/kernel_vs_xla.py --cases 128:4 --launch 8x64x4 16x64x2

A case is `N:order` (an N^3 grid) or `NXxNYxNZ:order`. Per case both
engines run in the same Simulator ring (50 steps, the first 5 untimed, one
Ricker source, m = 1.5) in one process, reps alternating between engines;
the script prints ms/step (median and min-max), Gcell/s and GB/s under the
16 B/pt one step moves, and the kernel's speed-up over jnp.

--launch adds kernel rows under fixed (ty x tz x xc) launches in place of
stencil_gpu.choose_launch. --trace DIR traces 5 steps of each engine and
prints the device time per step of every event name (step fusion or
kernel, ring copies, scatter).
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS, WARMUP, TRACE_STEPS = 50, 5, 5


def parse_case(s: str):
    dims, order = s.split(":")
    n = tuple(int(v) for v in dims.split("x"))
    return (n * 3 if len(n) == 1 else n), int(order)


def parse_launch(s: str):
    from tpufdtd.ops.stencil_gpu import Launch

    return Launch(*(int(v) for v in s.split("x")))


def make_sim(tf, grid, backend, launch=None):
    m = np.full(grid.padded_shape, 1.5, np.float32)
    coords = tf.default_source_coords(1, grid.nx, grid.ny, grid.nz)
    cfg = tf.SimConfig(nsteps=STEPS, warmup_steps=WARMUP, backend=backend)
    sim = tf.Simulator(grid, cfg, m, coords)
    if launch is not None:
        from tpufdtd.ops import stencil_gpu

        # before the first run: the jitted ring traces engine.step lazily
        sim.engine.step_fn = partial(stencil_gpu.leapfrog_step, grid=grid,
                                     dt=cfg.dt, launch=launch)
    return sim


def device_ms_per_event(jax, sim, src, log_dir):
    """Device time per step of each event name over TRACE_STEPS steps."""
    sim.run(sim.zero_state(), src, TRACE_STEPS)  # compile outside the trace
    state = jax.block_until_ready(sim.zero_state())
    with jax.profiler.trace(log_dir, create_perfetto_trace=True):
        jax.block_until_ready(sim.run(state, src, TRACE_STEPS))
    path = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.trace.json.gz")))[-1]
    events = json.load(gzip.open(path))["traceEvents"]
    gpu = {e["pid"] for e in events if e.get("ph") == "M"
           and e.get("name") == "process_name"
           and e["args"]["name"].startswith("/device:GPU")}
    us, count = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e["pid"] in gpu:
            us[e["name"]] += e["dur"]
            count[e["name"]] += 1
    return [(k, v / 1e3 / TRACE_STEPS, count[k] / TRACE_STEPS)
            for k, v in us.most_common()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", nargs="+", required=True)
    p.add_argument("--launch", nargs="*", default=[])
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--trace", default=None, help="trace directory")
    args = p.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU: JAX found " + jax.devices()[0].platform, file=sys.stderr)
        return 1

    import tpufdtd as tf
    from tpufdtd.utils.envcfg import enable_compile_cache
    from tpufdtd.utils.peaks import card_name_and_power, detect_peaks

    enable_compile_cache()
    peaks = detect_peaks()
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    src = tf.ricker_table(STEPS, 1, 0.001)
    for case in args.cases:
        shape, order = parse_case(case)
        g = tf.Grid3D(*shape, order=order)
        sims = {"jnp": make_sim(tf, g, "jnp"),
                "plane_sweep": make_sim(tf, g, "plane_sweep")}
        for lc in args.launch:
            sims[f"sweep {lc}"] = make_sim(tf, g, "plane_sweep",
                                           parse_launch(lc))
        times = {b: [] for b in sims}
        for rep in range(args.reps + 1):  # rep 0 compiles; order alternates
            names = list(sims) if rep % 2 else list(sims)[::-1]
            for b in names:
                _, secs = sims[b].run_timed(sims[b].zero_state(), src)
                if rep:
                    times[b].append(secs / (STEPS - WARMUP))
        name = "x".join(map(str, shape))
        cells = g.interior_cells
        for b, ts in times.items():
            ts = np.array(ts)
            med = float(np.median(ts))
            gbps = 16.0 * cells / med / 1e9
            print(f"{name} order {order} {b:16s}: {med * 1e3:.4f} ms/step"
                  f" ({ts.min() * 1e3:.4f}-{ts.max() * 1e3:.4f}, {args.reps}"
                  f" reps), {cells / med / 1e9:.2f} Gcell/s, {gbps:.1f} GB/s"
                  f" at 16 B/pt = {100 * gbps / peaks.hbm_gbps:.1f}%", flush=True)
        jnp_med = np.median(times["jnp"])
        for b in list(times)[1:]:
            print(f"{name} order {order} {b} speed-up over jnp:"
                  f" {jnp_med / np.median(times[b]):.3f}x", flush=True)
        if args.trace:
            for b in ("jnp", "plane_sweep"):
                d = os.path.join(args.trace, f"{name}_o{order}_{b}")
                for ev, ms, n in device_ms_per_event(jax, sims[b], src, d):
                    print(f"  trace {name} order {order} {b}: {ev}"
                          f" {ms:.4f} ms/step ({n:g} per step)", flush=True)
        del sims
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"wall {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
