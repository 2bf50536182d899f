"""Published device peaks, keyed on the `device_kind` JAX reports.

The reference queries the CUDA device and derives peak HBM bandwidth and a
rough FP32 peak (main.cpp:155-199). Here the peaks are a table of data-sheet
numbers; a device that is not in the table is an error, never a default, so
no efficiency is ever computed against the wrong card.

H100 SXM row: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part, dense
rates): 3.35 TB/s HBM3, 67 TFLOP/s FP32 outside the tensor cores (the
stencil never uses them), 80 GB. The rates assume the card's full 700 W
power limit; report `power.limit` beside every percentage.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    name: str
    hbm_gbps: float  # peak HBM bandwidth, GB/s
    fp32_gflops: float  # FP32 peak outside the tensor cores, GFLOP/s
    hbm_gb: float  # device memory, GB


TABLE = {
    "NVIDIA H100 80GB HBM3": DevicePeaks("NVIDIA H100 SXM5 80GB", 3350.0, 67000.0, 80.0),
}


def peaks_for(device_kind: str) -> DevicePeaks:
    try:
        return TABLE[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add a row"
            " with its data-sheet source to tpufdtd/utils/peaks.py"
        ) from None


def card_name_and_power() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them (a
    child process that stays off JAX). The published rates assume the full
    power limit, so this goes beside every measured number."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def detect_peaks() -> DevicePeaks:
    """Peaks of jax.devices()[0]; raises for a device not in the table
    (the CPU included)."""
    import jax

    return peaks_for(jax.devices()[0].device_kind)
