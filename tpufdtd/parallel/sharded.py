"""Multi-device FDTD via shard_map + ppermute halo exchange.

The capability the reference lacks (it skips any grid over one GPU's
memory, main.cpp:337-341): the grid is decomposed along x over a 1-D
`jax.sharding.Mesh`; every device owns [halo + nx/ndev + halo, nyp, nzp]
including private halo slots. Each timestep:

  1. `lax.ppermute` sends each shard's outermost `radius` interior planes to
     its neighbors (both directions; NCCL between GPUs);
  2. received planes are written into the halo slots (edge devices keep their
     frozen global-rim values — ppermute has no wraparound here);
  3. the ordinary single-chip leapfrog step runs on the local block, writing
     only the local interior of the target ring buffer.

The whole N-step scan sits INSIDE the shard_map region, so XLA compiles one
program per device with device-to-device collectives and zero host
involvement.

Ring/rim semantics match the single-chip path exactly; sources are
precomputed per shard (corners padded to a uniform count so every shard runs
the same program).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Grid3D, SimConfig
from ..ops import stencil_jnp
from ..sources import build_source_term


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first n_devices devices (default: all of them);
    raises when fewer exist."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"a {n}-device mesh needs {n} devices; found {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def _local_grid(grid: Grid3D, ndev: int) -> Grid3D:
    if grid.nx % ndev:
        raise ValueError(f"nx={grid.nx} does not split over {ndev} devices")
    return dataclasses.replace(grid, nx=grid.nx // ndev)


def shards_from_global(grid: Grid3D, ndev: int, arr: np.ndarray) -> np.ndarray:
    """Reference-layout global array [nx+2H, nyp, nzp] -> stacked local
    blocks [ndev*(lnx+2H), nyp, nzp]; each block's halo slots are filled with
    the correct initial content (neighbor planes / global rim)."""
    h = grid.halo
    lnx = grid.nx // ndev
    blocks = []
    for d in range(ndev):
        lo = d * lnx  # global interior index of this shard's first plane
        blocks.append(arr[lo : lo + lnx + 2 * h])
    return np.concatenate(blocks, axis=0)


def global_from_shards(grid: Grid3D, ndev: int, stacked: np.ndarray) -> np.ndarray:
    """Inverse of shards_from_global (halo slots of interior cuts dropped;
    the global rim comes from the edge shards)."""
    h = grid.halo
    lnx = grid.nx // ndev
    lxp = lnx + 2 * h
    parts = [np.asarray(stacked[0:h])]  # global lo rim from shard 0
    for d in range(ndev):
        blk = stacked[d * lxp : (d + 1) * lxp]
        parts.append(np.asarray(blk[h : h + lnx]))
    parts.append(np.asarray(stacked[-h:]))  # global hi rim from last shard
    return np.concatenate(parts, axis=0)


def _pad_terms(terms):
    """Stack per-shard SourceTerms into uniform arrays [ndev, K]."""
    K = max((t.ix.shape[0] for t in terms), default=0)
    if K == 0:
        return None
    ix = np.zeros((len(terms), K), np.int32)
    iy = np.zeros((len(terms), K), np.int32)
    iz = np.zeros((len(terms), K), np.int32)
    scale = np.zeros((len(terms), K), np.float32)
    sidx = np.zeros((len(terms), K), np.int32)
    for d, t in enumerate(terms):
        n = t.ix.shape[0]
        ix[d, :n] = t.ix
        iy[d, :n] = t.iy
        iz[d, :n] = t.iz
        scale[d, :n] = t.scale
        sidx[d, :n] = t.src_idx
    return ix, iy, iz, scale, sidx


class ShardedSimulator:
    """N-step sharded simulation compiled as one SPMD program.

    Host-facing arrays are global reference-layout; `prepare_state` shards
    them onto the mesh and `extract_state` gathers back.
    """

    def __init__(
        self,
        grid: Grid3D,
        cfg: SimConfig,
        m: np.ndarray,
        mesh: Mesh,
        src_coords: Optional[np.ndarray] = None,
    ):
        self.grid = grid
        self.cfg = cfg
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = mesh.devices.size
        self.lgrid = _local_grid(grid, self.ndev)
        self.h = grid.halo
        self.R = grid.radius
        self.lnx = self.lgrid.nx
        # per-shard step: the jnp step (f32 compute, bf16 storage upcast
        # per step like the single-device JnpEngine)
        self.step_fn = stencil_jnp.make_step(self.lgrid, cfg.dt)

        # per-shard source terms: the global term's corners (weights exactly
        # the single-device ones), each moved to the shard that owns its
        # global interior x index; edge-slack corners at -1 / nx belong to
        # the edge shards
        t = build_source_term(grid, src_coords, m)
        owner = np.clip((t.ix.astype(np.int64) - self.h) // self.lnx, 0,
                        self.ndev - 1)
        terms = []
        for d in range(self.ndev):
            keep = owner == d
            terms.append(
                dataclasses.replace(
                    t,
                    ix=t.ix[keep] - np.int32(d * self.lnx),
                    iy=t.iy[keep],
                    iz=t.iz[keep],
                    scale=t.scale[keep],
                    src_idx=t.src_idx[keep],
                )
            )
        self.packed_terms = _pad_terms(terms)

        self._build_program()

    # ---- device program ----------------------------------------------------

    def _exchange(self, u):
        """Fill u's x halo slots with neighbor interior planes (ppermute)."""
        h, R, lnx = self.h, self.R, self.lnx
        ax = self.axis
        n = self.ndev
        if n == 1:
            return u
        # my last R interior planes -> right neighbor's lo-halo
        from_left = jax.lax.ppermute(
            u[h + lnx - R : h + lnx], ax, [(i, i + 1) for i in range(n - 1)]
        )
        # my first R interior planes -> left neighbor's hi-halo
        from_right = jax.lax.ppermute(
            u[h : h + R], ax, [(i + 1, i) for i in range(n - 1)]
        )
        idx = jax.lax.axis_index(ax)
        # edge devices keep their frozen global rim (ppermute delivers zeros
        # to unpaired receivers)
        lo = jnp.where(idx == 0, u[h - R : h], from_left)
        hi = jnp.where(idx == n - 1, u[h + lnx : h + lnx + R], from_right)
        u = u.at[h - R : h].set(lo)
        u = u.at[h + lnx : h + lnx + R].set(hi)
        return u

    def _inject(self, u, term_arrays, src_row):
        if term_arrays is None:
            return u
        ix, iy, iz, scale, sidx = term_arrays
        vals = (src_row[sidx] * scale).astype(u.dtype)
        return u.at[ix, iy, iz].add(vals, mode="drop")

    def _build_program(self):
        axis = self.axis
        spec3 = P(axis)

        def body_plain(m_loc):
            def body(carry, _):
                Pb, Cb, Tb = carry
                Cx = self._exchange(Cb)
                un = self.step_fn(Cx, Pb, m_loc, Tb)
                # un's interior is new; its halo slots are Tb's (refreshed by
                # the exchange before every read, so staleness is harmless).
                return (Cb, un, Pb), None

            return body

        def program_plain(state, m_sh, nsteps):
            def local(st, m_loc):
                carry, _ = jax.lax.scan(body_plain(m_loc), st, None, length=nsteps)
                return carry

            f = jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=((spec3, spec3, spec3), spec3),
                out_specs=(spec3, spec3, spec3),
            )
            return f(state, m_sh)

        def program_src(state, m_sh, packed, src_table, nsteps):
            def local(st, m_loc, pk, srct):
                term_arrays = tuple(a[0] for a in pk)  # drop shard dim

                def body(carry, src_row):
                    Pb, Cb, Tb = carry
                    Cx = self._exchange(Cb)
                    un = self.step_fn(Cx, Pb, m_loc, Tb)
                    un = self._inject(un, term_arrays, src_row)
                    return (Cb, un, Pb), None

                carry, _ = jax.lax.scan(body, st, srct)
                return carry

            f = jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=(
                    (spec3, spec3, spec3),
                    spec3,
                    tuple(P(axis) for _ in packed),
                    P(),
                ),
                out_specs=(spec3, spec3, spec3),
            )
            return f(state, m_sh, packed, src_table)

        self._program_plain = jax.jit(
            program_plain, static_argnames=("nsteps",), donate_argnums=(0,)
        )
        self._program_src = jax.jit(
            program_src, static_argnames=("nsteps",), donate_argnums=(0,)
        )

    # ---- host API ----------------------------------------------------------

    def _shard(self, arr: np.ndarray, dtype=jnp.float32):
        stacked = shards_from_global(self.grid, self.ndev, np.asarray(arr))
        sh = NamedSharding(self.mesh, P(self.axis))
        return jax.device_put(jnp.asarray(stacked, dtype), sh)

    def prepare(self, u_prev, u_cur, m, u_target=None):
        ut = u_cur if u_target is None else u_target
        sdt = (
            jnp.bfloat16 if self.cfg.storage_dtype == "bfloat16"
            else jnp.float32
        )
        state = (
            self._shard(u_prev, sdt),
            self._shard(u_cur, sdt),
            self._shard(ut, sdt),
        )
        m_sh = self._shard(m)  # medium stays f32 (feeds f32 compute)
        packed = None
        if self.packed_terms is not None:
            sh = NamedSharding(self.mesh, P(self.axis))
            packed = tuple(
                jax.device_put(jnp.asarray(a), sh) for a in self.packed_terms
            )
        return state, m_sh, packed

    def run(self, state, m_sh, packed, src: Optional[np.ndarray], nsteps: int):
        if src is None or packed is None:
            return self._program_plain(state, m_sh, nsteps)
        src_table = jnp.asarray(src[:nsteps], jnp.float32)
        return self._program_src(state, m_sh, packed, src_table, nsteps)

    def extract_state(self, state):
        """Global reference-layout levels (u_{N-1}, u_N, u_{N-2})."""
        return tuple(
            global_from_shards(
                self.grid, self.ndev, np.asarray(jnp.asarray(x, jnp.float32))
            )
            for x in state
        )


def simulate_sharded(
    u_prev: np.ndarray,
    u_cur: np.ndarray,
    m: np.ndarray,
    grid: Grid3D,
    cfg: SimConfig,
    mesh: Mesh,
    src: Optional[np.ndarray] = None,
    src_coords: Optional[np.ndarray] = None,
):
    """One-shot sharded run; returns global (u_{N-1}, u_N, u_{N-2})."""
    sim = ShardedSimulator(grid, cfg, m, mesh, src_coords)
    state, m_sh, packed = sim.prepare(u_prev, u_cur, m)
    state = sim.run(state, m_sh, packed, src, cfg.nsteps)
    return sim.extract_state(state)
