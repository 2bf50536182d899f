"""Hopper plane-sweep leapfrog step (Pallas, Triton route).

The reference's `stencil_update_h100_scalar_pipelined_kernel` is a 2.5-D
plane sweep: each block owns a (y, z) tile and marches along x, keeping the
x-neighbour planes on chip (SURVEY.md §2.4). This is that design for one
H100, written as a drop-in for `stencil_jnp.leapfrog_step`:

  * the grid is (y tiles, z tiles, x chunks); z is the contiguous axis, so
    every tile row is one coalesced load;
  * a program loads its tile of the first 2R planes, then per x step loads
    one new plane and carries the 2R+1 planes of u_cur in registers (the
    loop carry), so each u_cur plane crosses HBM once per program;
  * the y/z neighbours of the centre plane are shifted tile loads that hit
    L1/L2 (the centre plane was loaded R steps earlier);
  * u_prev and m are read once per point, the update is written into the
    interior of `target` (aliased to the output), so rims are untouched;
  * edge tiles are masked, so any grid size and orders 2-12 work.

Arithmetic follows stencil_jnp term for term; only FMA contraction can
differ. The kernel has an interpret mode for CPU tests (`interpret=True`);
without it the kernel needs a CUDA device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import Grid3D, stencil_weights


class Launch(NamedTuple):
    """(y, z) tile and x chunk of one call."""

    ty: int
    tz: int
    xc: int


# z = 64 f32 is two 128-byte lines per tile row. The x chunk is the longest
# (at most 64 planes) that still gives MIN_PROGRAMS programs, several waves
# over the H100's 132 SMs: 256 tiles x 8 chunks at 512^3. Planes narrower
# than 256 rows take 8-row tiles: faster than 16-row ones at 64^3, tied at
# 128^3 (scripts/kernel_vs_xla.py --launch; PERF.md).
TILE_Z = 64
X_CHUNK = 64
MIN_PROGRAMS = 1024


def _pow2_cover(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at cap."""
    return min(cap, 1 << max(0, (n - 1).bit_length()))


def choose_launch(grid: Grid3D) -> Launch:
    ty = _pow2_cover(grid.ny, 16 if grid.ny >= 256 else 8)
    tz = _pow2_cover(grid.nz, TILE_Z)
    tiles = pl.cdiv(grid.ny, ty) * pl.cdiv(grid.nz, tz)
    chunks = max(pl.cdiv(grid.nx, X_CHUNK), pl.cdiv(MIN_PROGRAMS, tiles))
    return Launch(ty, tz, pl.cdiv(grid.nx, chunks))


def _kernel(u0_ref, u1_ref, m_ref, tgt_ref, out_ref, *, grid: Grid3D,
            dt: float, ty: int, tz: int, xc: int):
    del tgt_ref  # aliased to out_ref: its rim is what the output keeps
    H, R = grid.halo, grid.radius
    W = stencil_weights(grid.order)
    dt32 = np.float32(dt)
    r1 = np.float32(1.0) / (dt32 * dt32)
    rax = tuple(
        np.float32(1.0) / (np.float32(h) * np.float32(h))
        for h in (grid.hx, grid.hy, grid.hz)
    )

    y0 = H + pl.program_id(0) * ty
    z0 = H + pl.program_id(1) * tz
    x0 = H + pl.program_id(2) * xc
    nsteps = jnp.minimum(xc, H + grid.nx - x0)
    ys = y0 + jnp.arange(ty, dtype=jnp.int32)[:, None]
    zs = z0 + jnp.arange(tz, dtype=jnp.int32)[None, :]
    mask = (ys < H + grid.ny) & (zs < H + grid.nz)

    def load(ref, x, dy=0, dz=0, other=0.0):
        tile = ref.at[x, pl.ds(y0 + dy, ty), pl.ds(z0 + dz, tz)]
        return plgpu.load(tile, mask=mask, other=other).astype(jnp.float32)

    def body(i, planes):
        x = x0 + i
        planes = planes + (load(u0_ref, x + R),)
        c = planes[R]
        r5 = W[0] * c
        ax = r5
        for d in range(R, 0, -1):
            ax = ax + W[d] * (planes[R - d] + planes[R + d])
        ay = r5
        for d in range(R, 0, -1):
            ay = ay + W[d] * (load(u0_ref, x, dy=-d) + load(u0_ref, x, dy=d))
        az = r5
        for d in range(R, 0, -1):
            az = az + W[d] * (load(u0_ref, x, dz=-d) + load(u0_ref, x, dz=d))
        lap = rax[0] * ax + rax[1] * ay + rax[2] * az
        mc = load(m_ref, x, other=1.0)
        upd = dt32 * dt32 * (
            lap - (np.float32(-2.0) * r1 * c + r1 * load(u1_ref, x)) * mc
        ) / mc
        out = out_ref.at[x, pl.ds(y0, ty), pl.ds(z0, tz)]
        plgpu.store(out, upd.astype(out_ref.dtype), mask=mask)
        return planes[1:]

    ring = tuple(load(u0_ref, x0 + d) for d in range(-R, R))
    jax.lax.fori_loop(0, nsteps, body, ring)


def leapfrog_step(u_cur, u_prev, m, target, *, grid: Grid3D, dt: float,
                  interpret: bool = False, launch: Optional[Launch] = None):
    """One leapfrog step on reference-layout arrays; writes only the
    interior of `target` (same contract as stencil_jnp.leapfrog_step)."""
    shape = grid.padded_shape
    for a in (u_cur, u_prev, m, target):
        if a.shape != shape:
            raise ValueError(f"expected padded shape {shape}, got {a.shape}")
    lc = choose_launch(grid) if launch is None else launch
    return pl.pallas_call(
        partial(_kernel, grid=grid, dt=dt, ty=lc.ty, tz=lc.tz, xc=lc.xc),
        out_shape=jax.ShapeDtypeStruct(shape, target.dtype),
        grid=(pl.cdiv(grid.ny, lc.ty), pl.cdiv(grid.nz, lc.tz),
              pl.cdiv(grid.nx, lc.xc)),
        input_output_aliases={3: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fdtd_plane_sweep",
    )(u_cur, u_prev, m, target)


def make_step(grid: Grid3D, dt: float, interpret: bool = False):
    """Bind the static config; returns step(u_cur, u_prev, m, target)."""
    return partial(leapfrog_step, grid=grid, dt=dt, interpret=interpret)
