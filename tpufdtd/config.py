"""Core types and constants for the 3D acoustic FDTD engine.

Physics contract (see SURVEY.md §2.6; reference: /root/reference):
  PDE         m * d2u/dt2 = Lap(u) + source     (m ~ slowness^2 medium field)
  Spatial     central differences of order `stencil_order` (radius = order//2)
              per axis, scaled by 1/h_axis^2      [cuda_optimized.cu:39]
  Temporal    2nd-order leapfrog over two carried time levels:
              u_next = 2*u_cur - u_prev + dt^2 * Lap(u_cur) / m
              (the reference stores 3 levels in a %3 ring, cuda.cu:233-235;
              stepper.run_scan carries the same 3-level ring through lax.scan)
  Storage     halo-padded float32 arrays [nxp, nyp, nzp], nxp = nx + 2*halo,
              halo = stencil_order (NOT the radius; main.cpp:31-32 pads by 4
              for the radius-2 order-4 stencil and DEBUG.md:299-305 records
              that shrinking it is an ABI-breaking bug).
  Boundary    none applied: the halo rim keeps its initial value and acts as a
              frozen Dirichlet boundary (the stencil only writes the interior).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Pad per side. The reference always pads by STENCIL_ORDER cells (= 2x the
# stencil radius) even though the stencil only reads `radius` cells outward
# (main.cpp:32, cuda_optimized.cu:36).
DEFAULT_ORDER = 4

# f32 literals exactly as the reference oracle writes them (openacc.cpp:102-106):
# -8.33333333e-2F, 1.333333330F, -2.50F. Index = distance from center.
_ORDER4_WEIGHTS = (np.float32(-2.50), np.float32(1.333333330), np.float32(-8.33333333e-2))

# Standard central second-difference weights for other orders, rounded to f32.
# weights[d] multiplies (u[i-d] + u[i+d]) for d>0; weights[0] multiplies u[i].
_STENCIL_WEIGHTS = {
    2: (np.float32(-2.0), np.float32(1.0)),
    4: _ORDER4_WEIGHTS,
    6: (
        np.float32(-49.0 / 18.0),
        np.float32(3.0 / 2.0),
        np.float32(-3.0 / 20.0),
        np.float32(1.0 / 90.0),
    ),
    8: (
        np.float32(-205.0 / 72.0),
        np.float32(8.0 / 5.0),
        np.float32(-1.0 / 5.0),
        np.float32(8.0 / 315.0),
        np.float32(-1.0 / 560.0),
    ),
    # orders 10/12 complete the reference's STENCIL_ORDER macro range 4..12
    # (main.cpp:26-29)
    10: (
        np.float32(-5269.0 / 1800.0),
        np.float32(5.0 / 3.0),
        np.float32(-5.0 / 21.0),
        np.float32(5.0 / 126.0),
        np.float32(-5.0 / 1008.0),
        np.float32(1.0 / 3150.0),
    ),
    12: (
        np.float32(-5369.0 / 1800.0),
        np.float32(12.0 / 7.0),
        np.float32(-15.0 / 56.0),
        np.float32(10.0 / 189.0),
        np.float32(-1.0 / 112.0),
        np.float32(2.0 / 1925.0),
        np.float32(-1.0 / 16632.0),
    ),
}

# Source amplitude prefactor (cuda.cu:165, openacc.cpp:134).
SOURCE_SCALE = np.float32(1.0e-2)


def stencil_weights(order: int) -> Tuple[np.float32, ...]:
    """Central-difference second-derivative weights for a given even order.

    Returns (w0, w1, ..., wR): w0 is the center weight, wd multiplies the
    symmetric pair at distance d. For order 4 these are the exact f32 literals
    of the reference (openacc.cpp:102-106).
    """
    try:
        return _STENCIL_WEIGHTS[order]
    except KeyError:
        raise ValueError(
            f"unsupported stencil order {order}; supported: {sorted(_STENCIL_WEIGHTS)}"
        ) from None


def halo_for_order(order: int) -> int:
    """Pad cells per side: the reference's HALO == STENCIL_ORDER convention."""
    return order


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Interior grid extents and geometry (main.cpp:285-287)."""

    nx: int
    ny: int
    nz: int
    hx: float = 0.1
    hy: float = 0.1
    hz: float = 0.1
    ox: float = 0.0
    oy: float = 0.0
    oz: float = 0.0
    order: int = DEFAULT_ORDER

    @property
    def halo(self) -> int:
        return halo_for_order(self.order)

    @property
    def radius(self) -> int:
        return self.order // 2

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        h2 = 2 * self.halo
        return (self.nx + h2, self.ny + h2, self.nz + h2)

    @property
    def interior_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def interior_slices(self) -> Tuple[slice, slice, slice]:
        h = self.halo
        return (slice(h, h + self.nx), slice(h, h + self.ny), slice(h, h + self.nz))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Time integration + backend configuration.

    The reference runs `nsteps` physics steps of which the first
    `warmup_steps` are untimed (cuda.cu:56, openacc.cpp:5) — all steps are
    real physics; warmup only affects the timing convention.
    """

    dt: float = 0.001
    nsteps: int = 50
    warmup_steps: int = 5
    # "auto" = the Hopper plane-sweep kernel for float32 storage on a GPU
    # where it measured faster (stepper.PLANE_SWEEP_WINS), the XLA-fused
    # jnp step everywhere else; "jnp" / "plane_sweep" force one engine
    # (stepper.resolve_backend)
    backend: str = "auto"
    # bf16 storage / f32 compute mixed precision (the analogue of the
    # reference's FP16-main-array + FP32-shadow design,
    # cuda_optimized.cu:296-343); runs on the jnp engine
    storage_dtype: str = "float32"  # "float32" | "bfloat16"
