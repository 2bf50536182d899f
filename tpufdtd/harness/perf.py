"""Performance phase — grid sweep with stats, models, analysis and CSV.

Reproduces the reference perf driver (main.cpp:258-508): grid sweep x 50
steps x 1 Ricker source x 5 reps; skips grids whose state exceeds the
device's memory; zero ICs, m = 1.5, h = 0.1, dt = 1e-3; 5 warmup physics
steps untimed (inside run_timed), and rates count the timed steps only;
the reference's FLOP constants and the streaming bytes model both engines
move (16 B/pt in f32; utils.metrics); efficiency vs the device's published
peaks;
memory-/compute-bound classification at 80% thresholds (main.cpp:456-463);
CSV append per config.

Times: each rep is timed on the host clock around work that ends in
`jax.block_until_ready`; one untimed rep compiles first. The CSV's
Device_Time is the median over reps and Device_Std their standard
deviation; the console also prints the min-max spread.

Section split: the whole scan is one XLA program, so the stencil/source
split is measured by a two-program difference: the same span re-run as a
stencil-only program (no source table -> no injection scatter), and
section1 = full - stencil_only (both medians).

Efficiencies need published peaks: on a device without a row in
utils/peaks.py they are an error; on the CPU they are "not measured".
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np

from ..config import Grid3D, SimConfig
from ..stepper import Simulator
from ..utils import metrics
from ..utils.csvio import append_row
from ..utils.peaks import detect_peaks
from ..utils.stats import compute_stats
from ..wavelets import default_source_coords, ricker_table

DEFAULT_GRIDS = (32, 64, 96, 128, 192, 256, 384, 512, 640, 768, 896, 1024)


def state_bytes(grid: Grid3D, storage_dtype: str = "float32") -> int:
    """Working-set estimate for the skip check (the reference's 40 GB guard,
    main.cpp:337-341): the donated 3-level carry, XLA's copies of the
    rotating carry and the step's temporaries, and m, as 6 levels."""
    esz = 2 if storage_dtype == "bfloat16" else 4
    volp = int(np.prod(grid.padded_shape))
    return 6 * volp * esz + (256 << 20)


def memory_budget_bytes() -> int:
    """Memory the process may use on its device: the allocator's limit
    where the device reports one (a GPU), else the host's physical memory."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _timed_reps(sim: Simulator, src, reps: int):
    """(device_seconds, total_seconds) per rep after one untimed rep."""
    dev, tot = [], []
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        state = sim.zero_state()
        state, secs = sim.run_timed(state, src)
        total = time.perf_counter() - t0
        del state
        if rep:
            dev.append(secs)
            tot.append(total)
    return dev, tot


def run_benchmark(
    method: str = "auto",
    grids: Iterable[int] = DEFAULT_GRIDS,
    timesteps: int = 50,
    nsrc: int = 1,
    reps: int = 5,
    csv_path: Optional[str] = "benchmark.csv",
    storage_dtype: str = "float32",
    verbose: bool = True,
    hbm_budget_frac: float = 0.6,
    order: int = 4,
):
    import jax

    dev0 = jax.devices()[0]
    platform, kind = dev0.platform, dev0.device_kind
    peaks = detect_peaks() if platform == "gpu" else None
    budget = memory_budget_bytes() * hbm_budget_frac
    results = []

    for gs in grids:
        grid = Grid3D(gs, gs, gs, order=order)
        need = state_bytes(grid, storage_dtype)
        if need > budget:
            if verbose:
                print(f"Skipping {gs}^3 grid (requires {need/2**30:.1f} GiB)")
            continue

        m = np.full(grid.padded_shape, 1.5, np.float32)
        src = ricker_table(timesteps, nsrc, 0.001) if nsrc > 0 else None
        coords = default_source_coords(nsrc, gs, gs, gs) if nsrc > 0 else None
        cfg = SimConfig(dt=0.001, nsteps=timesteps, backend=method,
                        storage_dtype=storage_dtype)
        sim = Simulator(grid, cfg, m, coords)
        label = f"{method}:{sim.backend}" if method == "auto" else method
        # both engines move the same bytes per step (utils.metrics)
        bytes_pt = metrics.bytes_streaming(2 if storage_dtype == "bfloat16"
                                           else 4)
        ai = metrics.arithmetic_intensity(order, bytes_pt)
        if verbose:
            print(
                f"Running {label} FDTD ({grid.order}th-order) on {platform}"
                f" ({kind})...\n"
                f"Grid: {gs}x{gs}x{gs} | Steps: {timesteps} | Sources: {nsrc}"
                f" | AI: {ai:.4g} FLOPs/byte"
            )

        device_times, total_times = _timed_reps(sim, src, reps)
        # steps inside the timed span (run_timed's warm-up is untimed)
        timed = timesteps - (cfg.warmup_steps
                             if timesteps > cfg.warmup_steps else 0)
        if nsrc > 0:
            nosrc_times, _ = _timed_reps(sim, None, reps)
            s1 = max(0.0, float(np.median(device_times) - np.median(nosrc_times)))
            s0_times = [t - s1 for t in device_times]
            s1_times = [s1 for _ in device_times]
        else:
            s0_times = list(device_times)
            s1_times = [0.0 for _ in device_times]
        overheads = [max(0.0, t - d) for t, d in zip(total_times, device_times)]

        dstats = compute_stats(device_times)
        tstats = compute_stats(total_times)
        s0stats = compute_stats(s0_times)
        s1stats = compute_stats(s1_times)
        ostats = compute_stats(overheads)
        gflops_vals = [
            metrics.gflops_model(gs, gs, gs, timed, d, grid.order)
            for d in device_times
        ]
        gbps_vals = [
            metrics.gbps_model(gs, gs, gs, timed, d, bytes_pt)
            for d in device_times
        ]
        gfstats = compute_stats(gflops_vals)
        gbstats = compute_stats(gbps_vals)

        compute_eff = memory_eff = None
        if peaks is not None:
            compute_eff = gfstats.median / peaks.fp32_gflops * 100.0
            memory_eff = gbstats.median / peaks.hbm_gbps * 100.0

        if verbose:
            print(
                f"Total time:   {tstats.median*1e3:.3f} ms median\n"
                f"Device time:  {dstats.median*1e3:.3f} ms median"
                f" ({dstats.min*1e3:.3f}-{dstats.max*1e3:.3f} over"
                f" {len(device_times)} reps;"
                f" section0={s0stats.median*1e3:.3f} ms,"
                f" section1={s1stats.median*1e3:.3f} ms)\n"
                f"Overhead:     {ostats.median*1e3:.3f} ms"
                "  (init/transfers/dispatch)\n"
                f"Perf:         {gfstats.median:.1f} GFLOP/s,"
                f" {gbstats.median:.1f} GB/s at {bytes_pt:g} B/pt"
            )
            if peaks is None:
                print(f"Device Analysis: efficiency vs peak not measured"
                      f" ({platform} has no published peaks)")
            else:
                print(
                    f"Device Analysis: {compute_eff:.1f}% compute, "
                    f"{memory_eff:.1f}% memory BW efficiency vs {peaks.name}"
                )
                if memory_eff > 80.0:
                    print("Status:       Memory-bound (optimal for this workload)")
                elif compute_eff > 80.0:
                    print("Status:       Compute-bound (good utilization)")
                else:
                    print(
                        "Status:       Optimization opportunity "
                        f"({max(compute_eff, memory_eff):.1f}% peak utilization)"
                    )

        if csv_path:
            append_row(
                csv_path,
                label,
                tstats.median,
                tstats.stddev,
                s0stats.median,
                s0stats.stddev,
                s1stats.median,
                s1stats.stddev,
                dstats.median,
                dstats.stddev,
                ostats.median,
                ostats.stddev,
                gfstats.median,
                gfstats.stddev,
                gbstats.median,
                gbstats.stddev,
                compute_eff,
                memory_eff,
                ai,
                gs,
                gs,
                gs,
                timesteps,
                nsrc,
                grid.order,
            )

        # invariant checks (main.cpp:475-486) on a zero-IC run, reduced on
        # the device; split into the same warmup/main spans so the compiled
        # programs are reused
        w = min(cfg.warmup_steps, timesteps)
        state = sim.zero_state()
        state = sim.run(state, src[:w] if src is not None else None, w)
        state = sim.run(
            state, src[w:] if src is not None else None, timesteps - w
        )
        max_val, has_nan = sim.state_field_stats(state)
        if verbose:
            if has_nan:
                print("NaN detected")
            print(f"Max field value: {max_val:g}\n")
        if nsrc == 0 and max_val > 1e-7:
            print(f"[FAIL] Non-zero field with nsrc==0: {max_val}")

        results.append(
            {
                "method": label,
                "platform": platform,
                "device_kind": kind,
                "size": gs,
                "device_time_s": dstats.median,
                "device_time_min_s": dstats.min,
                "device_time_max_s": dstats.max,
                "gflops": gfstats.median,
                "gbps": gbstats.median,
                "memory_eff_pct": memory_eff,
                "gcells_per_s": gs**3 * timed / dstats.median / 1e9,
                "nan": has_nan,
            }
        )
        del sim, state
    return results
