"""Trilinear point-source injection.

The reference scatters each source into the 8 lattice corners around its
continuous coordinate with an atomicAdd per corner, recomputing positions and
weights every timestep (openacc.cpp:172-204, cuda.cu:112-170). Source
coordinates are static for a whole run, so this build precomputes the
corner indices and combined weights once on the host and reduces the per-step
work to one gather of src[t] and one scatter-add — the atomicAdd becomes a
`u.at[idx].add(...)` XLA scatter (on a GPU that scatter itself uses atomics,
so runs with sources are not bitwise reproducible there).

Semantics reproduced exactly (cuda.cu:145-165):
  pos?  = floor((coord - o)/h)            per axis, f32 math
  p?    = frac((coord - o)/h)
  corner (rx,ry,rz) in {0,1}^3 hits padded cell (pos + r + halo)
  valid iff pos+r in [-1, n] per axis     (one cell of slack beyond interior)
  added value = 1e-2 * wx*wy*wz * src[t,p] / m[pos + halo]
  where w = r ? p : (1-p) per axis and m is sampled at the *floor* cell for
  all 8 corners.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .config import SOURCE_SCALE, Grid3D


@dataclasses.dataclass(frozen=True)
class SourceTerm:
    """Precomputed scatter targets: flat arrays of length nsrc*8."""

    ix: np.ndarray  # int32, padded x index (clamped in-range)
    iy: np.ndarray  # int32
    iz: np.ndarray  # int32
    scale: np.ndarray  # f32: 1e-2 * trilinear weight / m[floor cell]; 0 if invalid
    src_idx: np.ndarray  # int32: which source each corner belongs to
    nsrc: int

    @property
    def empty(self) -> bool:
        return self.nsrc == 0


def build_source_term(
    grid: Grid3D,
    coords: np.ndarray | None,
    m: np.ndarray,
) -> SourceTerm:
    """Precompute corner indices/weights for static source coordinates.

    coords: [nsrc, 3] physical coordinates (or None for no sources).
    m:      reference-layout [nx+2H, ny+2H, nz+2H] medium field (host array).
    """
    halo = grid.halo
    tgt_shape = np.array(grid.padded_shape)
    if coords is None or coords.size == 0 or coords.shape[0] == 0:
        z = np.zeros((0,), dtype=np.int32)
        return SourceTerm(z, z, z, np.zeros((0,), np.float32), z, 0)

    coords = np.asarray(coords, dtype=np.float32)
    m = np.asarray(m, dtype=np.float32)
    nsrc = coords.shape[0]

    origins = np.array([grid.ox, grid.oy, grid.oz], dtype=np.float32)
    spacings = np.array([grid.hx, grid.hy, grid.hz], dtype=np.float32)
    sizes = np.array([grid.nx, grid.ny, grid.nz], dtype=np.int64)

    rel = (coords - origins[None, :]) / spacings[None, :]  # f32 [nsrc, 3]
    pos = np.floor(rel).astype(np.int64)  # floor cell, interior coords
    frac = (rel - np.floor(rel)).astype(np.float32)  # px, py, pz

    ix, iy, iz, scale, src_idx = [], [], [], [], []
    for p in range(nsrc):
        # m at the floor cell (used for all 8 corners, cuda.cu:145); clamp the
        # lookup so wildly out-of-range sources don't index OOB — their corners
        # are all invalid anyway and get zero weight.
        mi = np.clip(pos[p] + halo, 0, np.array(m.shape) - 1)
        m_floor = m[mi[0], mi[1], mi[2]]
        for rx in (0, 1):
            wx = frac[p, 0] if rx else np.float32(1.0) - frac[p, 0]
            for ry in (0, 1):
                wy = frac[p, 1] if ry else np.float32(1.0) - frac[p, 1]
                for rz in (0, 1):
                    wz = frac[p, 2] if rz else np.float32(1.0) - frac[p, 2]
                    cell = pos[p] + np.array([rx, ry, rz])
                    valid = bool(np.all(cell >= -1) and np.all(cell <= sizes))
                    w = SOURCE_SCALE * wx * wy * wz / m_floor if valid else np.float32(0.0)
                    padded = np.clip(cell + halo, 0, tgt_shape - 1)
                    ix.append(padded[0])
                    iy.append(padded[1])
                    iz.append(padded[2])
                    scale.append(np.float32(w))
                    src_idx.append(p)

    return SourceTerm(
        ix=np.asarray(ix, dtype=np.int32),
        iy=np.asarray(iy, dtype=np.int32),
        iz=np.asarray(iz, dtype=np.int32),
        scale=np.asarray(scale, dtype=np.float32),
        src_idx=np.asarray(src_idx, dtype=np.int32),
        nsrc=nsrc,
    )


def inject(u: jnp.ndarray, term: SourceTerm, src_t: jnp.ndarray) -> jnp.ndarray:
    """Scatter-add one timestep's source amplitudes into u (jnp path).

    src_t: [nsrc] amplitudes for this step. Duplicate corner indices
    accumulate exactly like the reference's atomicAdd.
    """
    if term.empty:
        return u
    vals = (src_t[term.src_idx] * term.scale).astype(u.dtype)
    return u.at[term.ix, term.iy, term.iz].add(vals, mode="drop")
