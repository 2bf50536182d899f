"""Headline benchmark: 512^3 x 50 steps, order 4, f32, one Ricker source, on
one GPU with the default engine.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Baseline: the reference's CUDA_Optimized kernel reached 28.3 % of H100 HBM
peak at 512^3x50 under its 12 B/pt/step "optimized" bytes model
(STABILITY_FIX_LOG.md:153, main.cpp:139-144). The headline is the same
model-percent against this card's published peak (utils/peaks.py), which
raises for a device without one: this script measures GPUs only.
"""

import json

import numpy as np


def main():
    import jax

    from tpufdtd.utils.envcfg import enable_compile_cache

    enable_compile_cache()

    import tpufdtd as tf
    from tpufdtd.harness.correctness import error_scan, make_ic
    from tpufdtd.oracle import truth_run_ring
    from tpufdtd.utils import metrics
    from tpufdtd.utils.peaks import detect_peaks

    peaks = detect_peaks()

    # ---- the timed configuration: 512^3 x 50 with the default engine -------
    n = 512
    grid = tf.Grid3D(n, n, n)
    cfg = tf.SimConfig(dt=0.001, nsteps=50, warmup_steps=5)
    m = np.full(grid.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(cfg.nsteps, 1, cfg.dt)
    sim = tf.Simulator(grid, cfg, m, tf.default_source_coords(1, n, n, n))

    # ---- correctness gate: the timed engine at 128^3 vs f64 truth ----------
    g_c = tf.Grid3D(128, 128, 128, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m_c = make_ic(g_c)
    _, uc_t, _ = truth_run_ring(up0, uc0, m_c, g_c, 0.001, 50)
    _, uc = tf.simulate(up0, uc0, m_c, g_c,
                        tf.SimConfig(dt=0.001, nsteps=50, backend=sim.backend))
    l2 = error_scan(uc, uc_t)[2]

    # ---- performance (median of 5 reps after a compile rep) ----------------
    times = []
    for _ in range(6):
        _, secs = sim.run_timed(sim.zero_state(), src)
        times.append(secs)
    device_time = float(np.median(times[1:]))

    # reference convention: model uses the FULL step count against the timed
    # (post-warmup) device time (main.cpp:429-431)
    gflops = metrics.gflops_model(n, n, n, cfg.nsteps, device_time, grid.order)
    gbps_opt = metrics.gbps_model(n, n, n, cfg.nsteps, device_time,
                                  metrics.BYTES_OPTIMIZED)
    mem_eff = gbps_opt / peaks.hbm_gbps * 100.0
    rest = cfg.nsteps - cfg.warmup_steps
    # what one step of either engine moves: read u_cur, u_prev, m; write
    gbps_16 = metrics.gbps_model(n, n, n, rest, device_time,
                                 metrics.BYTES_STREAMING_F32)
    print(
        json.dumps(
            {
                "metric": "512^3x50 HBM efficiency (12B/pt model) vs card peak",
                "value": mem_eff,
                "unit": "%",
                "vs_baseline": mem_eff / 28.3,
                "ms_per_step": device_time / rest * 1e3,
                "gcells_per_s_timed": n**3 * rest / device_time / 1e9,
                "gflops_model": gflops,
                "gbps_16B_per_pt": gbps_16,
                "hbm_eff_16B_per_pt_pct": gbps_16 / peaks.hbm_gbps * 100.0,
                "rel_l2_vs_oracle_128": l2,
                "correctness_pass": bool(l2 < 1e-4),
                "engine": sim.backend,
                "device": jax.devices()[0].device_kind,
                "card_peak_gbps": peaks.hbm_gbps,
                "baseline": "CUDA_Optimized 28.3% of H100 peak (STABILITY_FIX_LOG.md:153)",
            }
        )
    )


if __name__ == "__main__":
    main()
