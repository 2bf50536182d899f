"""Fused-jnp leapfrog step — the XLA backend and the on-device oracle partner.

Same arithmetic as tpufdtd.oracle (which mirrors openacc.cpp:94-111), written
as shifted interior slices so XLA fuses the whole 13/19/25-point stencil +
leapfrog update into a single elementwise pass over the grid. Used as:
  * the portable backend ("jnp") on any JAX platform,
  * the differential-test partner of the plane-sweep kernel,
  * the per-shard compute inside the sharded stepper.

Arrays are in the reference layout [n + 2*halo]^3 of the grid.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np

from ..config import Grid3D, stencil_weights


def _shifted(grid: Grid3D, axis: int, d: int):
    """Interior-sized slices shifted by d along `axis`."""
    h = grid.halo
    n = (grid.nx, grid.ny, grid.nz)
    return tuple(
        slice(h + (d if ax == axis else 0), h + (d if ax == axis else 0) + n[ax])
        for ax in range(3)
    )


def leapfrog_step(
    u_cur: jnp.ndarray,
    u_prev: jnp.ndarray,
    m: jnp.ndarray,
    target: jnp.ndarray | None = None,
    *,
    grid: Grid3D,
    dt: float,
) -> jnp.ndarray:
    """One leapfrog step on full padded arrays.

    `target` is the ring buffer the update is written into (u[t2] in the
    reference, openacc.cpp:107): only its interior changes, so its own rim is
    preserved — the per-ring-level frozen boundary. Defaults to u_cur.
    Computes in f32 regardless of the storage dtype of u (bf16 storage /
    f32 compute mixed precision, SURVEY.md §7 layer 5).
    """
    storage = u_cur.dtype
    u0 = u_cur.astype(jnp.float32)
    u1 = u_prev.astype(jnp.float32)

    dt32 = np.float32(dt)
    hx, hy, hz = np.float32(grid.hx), np.float32(grid.hy), np.float32(grid.hz)
    r1 = np.float32(1.0) / (dt32 * dt32)
    rax = (
        np.float32(1.0) / (hx * hx),
        np.float32(1.0) / (hy * hy),
        np.float32(1.0) / (hz * hz),
    )
    W = stencil_weights(grid.order)

    interior = grid.interior_slices()
    u0c = u0[interior]
    u1c = u1[interior]
    mc = m[interior].astype(jnp.float32)

    r5 = W[0] * u0c
    lap = jnp.zeros_like(u0c)
    for axis in range(3):
        acc = r5
        for d in range(grid.radius, 0, -1):
            acc = acc + W[d] * (
                u0[_shifted(grid, axis, -d)] + u0[_shifted(grid, axis, d)]
            )
        lap = lap + rax[axis] * acc

    upd = (
        dt32 * dt32 * (lap - (np.float32(-2.0) * r1 * u0c + r1 * u1c) * mc) / mc
    )
    base = u_cur if target is None else target
    return base.at[interior].set(upd.astype(storage))


def make_step(grid: Grid3D, dt: float):
    """Bind the static config; returns step(u_cur, u_prev, m, target) -> u_next."""
    return partial(leapfrog_step, grid=grid, dt=dt)
