"""Reference-compatible kernel entry point.

The reference exposes exactly one function signature per backend
(main.cpp:53-72): a complete self-contained simulation run over a 3-level
ring array with inclusive interior bounds, geometry scalars, source/time
ranges and a two-section profiler out-param. `kernel_tpu` (named after the
package) reproduces that call contract on this engine so a driver written against the reference's
ABI maps 1:1 (numpy arrays in place of dataobj buffers; deviceid/devicerm
accepted for signature parity — device residency is managed by JAX).

Ring semantics match exactly: on entry u[time_m%3] is the current level,
u[(time_m+2)%3] the previous, u[(time_m+1)%3] the first write target
(cuda.cu:233-235); on exit the three levels sit in the rotated slots the
reference leaves them in, per-level frozen rims included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import Grid3D, SimConfig
from .stepper import Simulator


@dataclasses.dataclass
class Profiler:
    """Two-section timer (main.cpp:47-50). section0 = stencil, section1 =
    source injection; split estimated like the optimized reference kernel
    (cuda_optimized.cu:466-470)."""

    section0: float = 0.0
    section1: float = 0.0


def kernel_tpu(
    m: np.ndarray,
    src: Optional[np.ndarray],
    src_coords: Optional[np.ndarray],
    u: np.ndarray,
    x_M: int,
    x_m: int,
    y_M: int,
    y_m: int,
    z_M: int,
    z_m: int,
    dt: float,
    h_x: float,
    h_y: float,
    h_z: float,
    o_x: float,
    o_y: float,
    o_z: float,
    p_src_M: int,
    p_src_m: int,
    time_M: int,
    time_m: int,
    deviceid: int = 0,
    devicerm: int = 1,
    timers: Optional[Profiler] = None,
    backend: str = "auto",
) -> int:
    """Run the simulation over u[3, nxp, nyp, nzp] in place; returns 0.

    Bounds are inclusive interior index ranges like the reference
    (x_m..x_M); p_src_M == -1 means no sources; time range time_m..time_M is
    inclusive and all steps are physics steps (the first 5 are the untimed
    warmup, cuda.cu:232).
    """
    del deviceid, devicerm  # signature parity; JAX owns device placement
    if (x_m, y_m, z_m) != (0, 0, 0):
        raise ValueError("interior bounds must start at 0")
    nx, ny, nz = x_M + 1, y_M + 1, z_M + 1
    grid = Grid3D(nx, ny, nz, h_x, h_y, h_z, o_x, o_y, o_z)
    if u.shape != (3,) + grid.padded_shape:
        raise ValueError(f"u has shape {u.shape}, expected {(3,) + grid.padded_shape}")

    nsteps = time_M - time_m + 1
    if nsteps <= 0:
        return 0
    nsrc = p_src_M - p_src_m + 1
    have_src = src is not None and src_coords is not None and nsrc > 0
    coords = np.asarray(src_coords, np.float32)[p_src_m : p_src_M + 1] if have_src else None
    src_rows = (
        np.asarray(src, np.float32)[time_m : time_M + 1, p_src_m : p_src_M + 1]
        if have_src
        else None
    )

    cfg = SimConfig(dt=dt, nsteps=nsteps, backend=backend)
    sim = Simulator(grid, cfg, m, coords)

    # entry ring mapping (cuda.cu:233-235)
    t0 = time_m % 3
    t1 = (time_m + 2) % 3
    t2 = (time_m + 1) % 3
    state = sim.prepare_state(u[t1], u[t0], u[t2])

    state, secs = sim.run_timed(state, src_rows)
    levels = sim.extract_state(state)  # (u_{N-1}, u_N, u_{N-2})

    # exit ring mapping: newest level lands at (time_M+1)%3
    u[(time_M + 1) % 3] = levels[1]
    u[time_M % 3] = levels[0]
    u[(time_M + 2) % 3] = levels[2]

    if timers is not None:
        interior = grid.interior_cells
        s1_share = (8.0 * max(0, nsrc)) / (interior + 8.0 * max(0, nsrc))
        timers.section0 += secs * (1.0 - s1_share)
        timers.section1 += secs * s1_share
    return 0
