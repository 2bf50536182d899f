"""Unified benchmark CLI — the reference's main() flow (main.cpp:767-835):
detect device -> print config -> Step 1 correctness -> Step 2 performance
sweep over all backends (fresh CSV) -> Step 3 echo the CSV.

Usage:
  python -m tpufdtd.harness.cli                       # full run
  python -m tpufdtd.harness.cli --sizes 32 64 128 --grids 64 128 512
  python -m tpufdtd.harness.cli --skip-correctness --backends plane_sweep
  python -m tpufdtd.harness.cli --sharded 4 --grids 512   # 4 real devices
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils.envcfg import enable_compile_cache, storage_dtype
from .correctness import run_correctness
from .perf import DEFAULT_GRIDS, run_benchmark


def default_backends(storage: str = "float32"):
    """Every engine this platform runs for this storage dtype: jnp
    everywhere, plus the float32 plane-sweep kernel on a GPU."""
    import jax

    if jax.default_backend() == "gpu" and storage == "float32":
        return ["jnp", "plane_sweep"]
    return ["jnp"]


def main(argv=None):
    enable_compile_cache()
    p = argparse.ArgumentParser(description="3D acoustic FDTD benchmark")
    p.add_argument("--sizes", type=int, nargs="*",
                   default=[32, 64, 128, 256, 512],
                   help="correctness grid sizes (the reference ladder"
                        " 32..512, main.cpp:679; the XLA-on-CPU f64 truth"
                        " makes 512^3 routine)")
    p.add_argument("--grids", type=int, nargs="*", default=list(DEFAULT_GRIDS),
                   help="performance grid sizes")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sources", type=int, default=1)
    p.add_argument("--backends", nargs="*", default=None,
                   help="engines to run (default: every engine this"
                        " platform runs)")
    p.add_argument("--csv", default="benchmark.csv")
    p.add_argument("--skip-correctness", action="store_true")
    p.add_argument("--skip-perf", action="store_true")
    p.add_argument("--hbm-frac", type=float, default=0.6,
                   help="fraction of the device's memory the working-set"
                        " guard may use (the reference's 40 GB guard,"
                        " main.cpp:337-341)")
    p.add_argument("--order", type=int, default=4,
                   help="spatial stencil order for the perf phase (the"
                        " reference's STENCIL_ORDER macro, main.cpp:26-29)")
    p.add_argument("--append-csv", action="store_true",
                   help="append to an existing CSV instead of replacing it "
                        "(the reference always starts fresh, main.cpp:796)")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="benchmark the sharded engine over N devices of"
                        " this platform; emits benchmark_sharded.csv rows"
                        " with Devices and Scaling_Eff columns")
    args = p.parse_args(argv)

    import jax

    if args.sharded:
        from .perf_sharded import run_sharded_benchmark

        run_sharded_benchmark(
            args.sharded,
            grids=args.grids,
            timesteps=args.steps,
            nsrc=args.sources,
            reps=args.reps,
            csv_path="benchmark_sharded.csv",
        )
        if os.path.exists("benchmark_sharded.csv"):
            print("\n=== Sharded results (benchmark_sharded.csv) ===")
            with open("benchmark_sharded.csv") as f:
                sys.stdout.write(f.read())
        return 0

    storage = storage_dtype()
    backends = args.backends or default_backends(storage)
    dev = jax.devices()[0]
    print("==========================================")
    print(" 3D acoustic FDTD benchmark")
    print("==========================================")
    print(f"Device: {dev.platform} {dev.device_kind} x{jax.device_count()}")
    if dev.platform == "gpu":
        from ..utils.peaks import detect_peaks

        peaks = detect_peaks()
        print(f"Published peaks: {peaks.hbm_gbps:.0f} GB/s HBM |"
              f" {peaks.fp32_gflops:.0f} GFLOP/s fp32 | {peaks.hbm_gb:.0f} GB")
    else:
        print("Published peaks: none for this platform (efficiencies not"
              " measured)")
    print(f"Runtime config: backends={','.join(backends)} storage={storage}")

    ok = True
    if not args.skip_correctness:
        print("\n=== Step 1: Correctness ===")
        reports = run_correctness(args.sizes, args.steps, backends)
        ok = all(r.passed for r in reports)

    if not args.skip_perf:
        print("\n=== Step 2: Performance ===")
        if args.csv and os.path.exists(args.csv) and not args.append_csv:
            os.remove(args.csv)
        for backend in backends:
            run_benchmark(
                method=backend,
                grids=args.grids,
                timesteps=args.steps,
                nsrc=args.sources,
                reps=args.reps,
                csv_path=args.csv,
                storage_dtype=storage,
                hbm_budget_frac=args.hbm_frac,
                order=args.order,
            )
        if args.csv and os.path.exists(args.csv):
            print("\n=== Step 3: Results (benchmark.csv) ===")
            with open(args.csv) as f:
                sys.stdout.write(f.read())

    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
