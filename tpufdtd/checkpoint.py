"""Checkpoint / resume.

The reference has no checkpointing; its full state lives in the host `u`
array between kernel calls and is "trivially checkpointable by the caller"
(SURVEY.md §5). This build makes that explicit: the simulation state is a
ring of reference-layout arrays plus the step counter, saved/restored as npz.
Resuming mid-run reproduces the unsplit run exactly (the ring carries all
state the leapfrog needs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import Grid3D, SimConfig


@dataclasses.dataclass
class Checkpoint:
    step: int  # steps already taken
    u_prev: np.ndarray  # u_{step-1}, reference layout
    u_cur: np.ndarray  # u_step
    u_target: Optional[np.ndarray]  # next ring write buffer (exact ring only)
    grid: Grid3D
    dt: float


def save(path: str, ckpt: Checkpoint) -> None:
    g = ckpt.grid
    np.savez_compressed(
        path,
        step=ckpt.step,
        u_prev=ckpt.u_prev,
        u_cur=ckpt.u_cur,
        u_target=(
            ckpt.u_target if ckpt.u_target is not None else np.zeros(0, np.float32)
        ),
        grid=np.array(
            [g.nx, g.ny, g.nz, g.order], dtype=np.int64
        ),
        geom=np.array([g.hx, g.hy, g.hz, g.ox, g.oy, g.oz, ckpt.dt], np.float64),
    )


def load(path: str) -> Checkpoint:
    with np.load(path) as z:
        nx, ny, nz, order = (int(v) for v in z["grid"])
        hx, hy, hz, ox, oy, oz, dt = (float(v) for v in z["geom"])
        grid = Grid3D(nx, ny, nz, hx, hy, hz, ox, oy, oz, order)
        ut = z["u_target"]
        return Checkpoint(
            step=int(z["step"]),
            u_prev=z["u_prev"],
            u_cur=z["u_cur"],
            u_target=None if ut.size == 0 else ut,
            grid=grid,
            dt=dt,
        )


def run_with_checkpoints(
    sim,
    u_prev: np.ndarray,
    u_cur: np.ndarray,
    nsteps: int,
    src: Optional[np.ndarray] = None,
    checkpoint_every: Optional[int] = None,
    path_fmt: str = "ckpt_{step:06d}.npz",
) -> Tuple[np.ndarray, np.ndarray]:
    """Drive a Simulator in checkpointed spans; returns final (u_prev, u_cur).

    `src` rows are consumed by absolute step index, so a resumed run injects
    the same wavelet samples as an unbroken one.
    """
    state = sim.prepare_state(u_prev, u_cur)
    done = 0
    span = checkpoint_every or nsteps
    while done < nsteps:
        n = min(span, nsteps - done)
        chunk = src[done : done + n] if src is not None else None
        state = sim.run(state, chunk, n)
        done += n
        if checkpoint_every and done < nsteps:
            levels = sim.extract_state(state)
            ckpt = Checkpoint(
                step=done,
                u_prev=levels[0],
                u_cur=levels[1],
                u_target=levels[2] if len(levels) > 2 else None,
                grid=sim.grid,
                dt=sim.cfg.dt,
            )
            save(path_fmt.format(step=done), ckpt)
    levels = sim.extract_state(state)
    return levels[0], levels[1]


def resume(path: str, cfg: SimConfig, m: np.ndarray, nsteps_total: int,
           src: Optional[np.ndarray] = None, src_coords=None):
    """Resume a checkpointed run to nsteps_total; returns (u_prev, u_cur)."""
    from .stepper import Simulator

    ckpt = load(path)
    sim = Simulator(ckpt.grid, cfg, m, src_coords)
    state = sim.prepare_state(ckpt.u_prev, ckpt.u_cur, ckpt.u_target)
    rest = nsteps_total - ckpt.step
    chunk = src[ckpt.step : ckpt.step + rest] if src is not None else None
    state = sim.run(state, chunk, rest)
    levels = sim.extract_state(state)
    return levels[0], levels[1]


def run_sharded_with_checkpoints(
    sim,
    u_prev: np.ndarray,
    u_cur: np.ndarray,
    m: np.ndarray,
    nsteps: int,
    src: Optional[np.ndarray] = None,
    checkpoint_every: Optional[int] = None,
    path_fmt: str = "ckpt_sharded_{step:06d}.npz",
) -> Tuple[np.ndarray, np.ndarray]:
    """Drive a ShardedSimulator in checkpointed spans (gather -> npz).

    The device state is gathered to the host-side global reference layout
    at each checkpoint (ShardedSimulator.extract_state), so the npz file is
    mesh-shape independent: a run checkpointed on one mesh can resume on
    another (or single-chip via `resume`). `src` rows are consumed by
    absolute step index, exactly like the single-chip driver.
    """
    state, m_sh, packed = sim.prepare(u_prev, u_cur, m)
    done = 0
    span = checkpoint_every or nsteps
    while done < nsteps:
        n = min(span, nsteps - done)
        chunk = src[done : done + n] if src is not None else None
        state = sim.run(state, m_sh, packed, chunk, n)
        done += n
        if checkpoint_every and done < nsteps:
            levels = sim.extract_state(state)
            ckpt = Checkpoint(
                step=done,
                u_prev=levels[0],
                u_cur=levels[1],
                u_target=levels[2] if len(levels) > 2 else None,
                grid=sim.grid,
                dt=sim.cfg.dt,
            )
            save(path_fmt.format(step=done), ckpt)
    levels = sim.extract_state(state)
    return levels[0], levels[1]


def resume_sharded(path: str, cfg: SimConfig, m: np.ndarray, mesh,
                   nsteps_total: int, src: Optional[np.ndarray] = None,
                   src_coords=None) -> Tuple[np.ndarray, np.ndarray]:
    """Resume a checkpoint over a device mesh: load the host-side ring,
    re-shard it (prepare), and run the remaining steps with absolute-step
    source indexing. The checkpoint may come from a sharded OR single-chip
    run — the on-disk format is the global reference layout either way."""
    from .parallel import ShardedSimulator

    ckpt = load(path)
    sim = ShardedSimulator(ckpt.grid, cfg, m, mesh, src_coords=src_coords)
    state, m_sh, packed = sim.prepare(
        ckpt.u_prev, ckpt.u_cur, m, ckpt.u_target
    )
    rest = nsteps_total - ckpt.step
    chunk = src[ckpt.step : ckpt.step + rest] if src is not None else None
    state = sim.run(state, m_sh, packed, chunk, rest)
    levels = sim.extract_state(state)
    return levels[0], levels[1]
