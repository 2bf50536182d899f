"""Sharded performance reporting — benchmark rows for multi-device runs.

The reference has no multi-GPU mode (grids over one device's memory are
simply skipped, main.cpp:337-341); this module reports the scaling axis the
sharded engine adds. Rows use the reference's 24-column CSV schema
(main.cpp:222-225) extended with Devices and Scaling_Eff(%) columns:

  * cells/s for the whole mesh and per device,
  * strong-scaling efficiency vs a 1-device run of the same grid.

Runs on the first N devices of the platform JAX found and raises when there
are fewer. Each row's method names the platform and device kind, so a run
on virtual CPU devices (the tests' 8-device host platform) is never read as
a GPU measurement; efficiencies against published peaks exist only for a
device with a row in utils/peaks.py.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np

from ..config import Grid3D, SimConfig
from ..utils import metrics
from ..utils.csvio import HEADER
from ..utils.stats import compute_stats
from ..wavelets import default_source_coords, ricker_table

SHARDED_HEADER = HEADER + ",Devices,Scaling_Eff(%)"


def _append_sharded_row(path: str, fields) -> None:
    exists = os.path.exists(path)
    with open(path, "a") as f:
        if not exists:
            f.write(SHARDED_HEADER + "\n")
        out = []
        for v in fields:
            if isinstance(v, str):
                out.append(v)
            elif isinstance(v, int):
                out.append(str(v))
            elif v is None:
                out.append("")
            else:
                out.append(f"{float(v):g}")
        f.write(",".join(out) + "\n")


def _timed_run(sim, grid: Grid3D, cfg: SimConfig, src) -> float:
    """Seconds of the post-warmup steps of one zero-IC sharded rep, on the
    host clock around work that ends in block_until_ready."""
    import jax

    u0 = np.zeros(grid.padded_shape, np.float32)
    m = np.full(grid.padded_shape, 1.5, np.float32)
    state, m_sh, packed = sim.prepare(u0, u0, m)
    w = min(cfg.warmup_steps, cfg.nsteps)
    state = sim.run(state, m_sh, packed, src[:w] if src is not None else None, w)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state = sim.run(
        state, m_sh, packed, src[w:cfg.nsteps] if src is not None else None,
        cfg.nsteps - w,
    )
    jax.block_until_ready(state)
    return time.perf_counter() - t0


def run_sharded_benchmark(
    n_devices: int,
    grids: Iterable[int] = (128, 256),
    timesteps: int = 50,
    nsrc: int = 1,
    reps: int = 5,
    csv_path: Optional[str] = "benchmark_sharded.csv",
    verbose: bool = True,
    baseline_single: bool = True,
):
    """Benchmark the sharded engine over an n-device mesh; returns row dicts.

    Strong-scaling efficiency compares the n-device time with a 1-device
    mesh run of the SAME global grid."""
    import jax

    from ..parallel import ShardedSimulator, make_mesh
    from ..utils.peaks import detect_peaks

    mesh = make_mesh(n_devices)  # raises when fewer devices exist
    dev0 = jax.devices()[0]
    platform, kind = dev0.platform, dev0.device_kind
    peaks = detect_peaks() if platform == "gpu" else None
    tag = f"sharded@{platform}:{kind}"
    results = []

    for gs in grids:
        grid = Grid3D(gs, gs, gs)
        if gs % n_devices:
            if verbose:
                print(f"Skipping {gs}^3 (nx % {n_devices} != 0)")
            continue
        cfg = SimConfig(dt=0.001, nsteps=timesteps, backend="jnp")
        src = ricker_table(timesteps, nsrc, cfg.dt) if nsrc else None
        coords = default_source_coords(nsrc, gs, gs, gs) if nsrc else None
        m = np.full(grid.padded_shape, 1.5, np.float32)

        sim = ShardedSimulator(grid, cfg, m, mesh, src_coords=coords)
        if verbose:
            print(f"Sharded {gs}^3 x {timesteps} on {n_devices} {platform}"
                  f" device(s) ({kind})")
        times = []
        for rep in range(reps + 1):  # rep 0 discarded (compile)
            secs = _timed_run(sim, grid, cfg, src)
            if rep:
                times.append(secs)
        dstats = compute_stats(times)
        timed = timesteps - min(cfg.warmup_steps, timesteps)  # _timed_run's span
        cells = gs**3 * timed
        gcells = cells / dstats.median / 1e9
        gflops = metrics.gflops_model(gs, gs, gs, timed, dstats.median,
                                      grid.order)
        gbps = metrics.gbps_model(gs, gs, gs, timed, dstats.median,
                                  metrics.BYTES_STREAMING_F32)
        compute_eff = memory_eff = None
        if peaks is not None:
            compute_eff = gflops / (peaks.fp32_gflops * n_devices) * 100.0
            memory_eff = gbps / (peaks.hbm_gbps * n_devices) * 100.0

        scal_eff = None
        if baseline_single and n_devices > 1:
            sim1 = ShardedSimulator(grid, cfg, m, make_mesh(1),
                                    src_coords=coords)
            t1 = [_timed_run(sim1, grid, cfg, src) for _ in range(2)][-1]
            scal_eff = t1 / (dstats.median * n_devices) * 100.0
            del sim1

        if verbose:
            line = (
                f"  device time {dstats.median*1e3:.3f} ms median"
                f" ({dstats.min*1e3:.3f}-{dstats.max*1e3:.3f})"
                f" | {gcells:.2f} Gcell/s ({gcells / n_devices:.2f}/dev)"
            )
            line += (f" | mem eff {memory_eff:.1f}%" if memory_eff is not None
                     else " | eff vs peak not measured")
            if scal_eff is not None:
                line += f" | strong scaling {scal_eff:.1f}%"
            print(line)

        if csv_path:
            s1_share = (8.0 * nsrc) / (grid.interior_cells + 8.0 * nsrc)
            _append_sharded_row(
                csv_path,
                [
                    tag,
                    dstats.median * 1e3, dstats.stddev * 1e3,
                    dstats.median * (1 - s1_share) * 1e3, 0.0,
                    dstats.median * s1_share * 1e3, 0.0,
                    dstats.median * 1e3, dstats.stddev * 1e3,
                    0.0, 0.0,
                    gflops, 0.0, gbps, 0.0,
                    compute_eff, memory_eff,
                    metrics.arithmetic_intensity(grid.order,
                                                 metrics.BYTES_STREAMING_F32),
                    gs, gs, gs, timesteps, nsrc, grid.order,
                    n_devices, scal_eff,
                ],
            )

        results.append(
            {
                "size": gs,
                "devices": n_devices,
                "platform": platform,
                "device_kind": kind,
                "device_time_s": dstats.median,
                "gcells_per_s": gcells,
                "gcells_per_s_per_device": gcells / n_devices,
                "memory_eff_pct": memory_eff,
                "scaling_eff_pct": scal_eff,
            }
        )
        del sim
    return results
