"""On-device time loop: the whole N-step simulation is ONE compiled XLA program.

The reference launches one CUDA kernel (+ optional source kernel) per timestep
from the host (cuda_optimized.cu:435-460). Here the time loop is rolled into
`jax.lax.scan` carrying the three ring levels, so 50 steps compile to a
single dispatch with zero host round-trips. The rotating carry is not free:
on the H100, XLA's while loop copies whole levels to put each buffer back
in its carry slot (4 copies per step with the jnp step, 5 with the
plane-sweep kernel; PERF.md).

Carry is (P, C, T) = (u_{n-1}, u_n, write-target buffer); each step writes
T's interior and rotates to (C, u_new, P) — the exact dataflow of the
reference's t0/t1/t2 = n%3 ring, including the per-ring-level frozen rims.

Engines own the step function; both keep the reference layout:
  * jnp          — XLA-fused shifted-slice stencil (any platform)
  * plane_sweep  — the Hopper plane-sweep kernel (ops/stencil_gpu), float32
                   storage, CUDA devices only
backend="auto" picks plane_sweep on a GPU only where it measured faster end
to end than jnp on the H100 (PLANE_SWEEP_WINS; scripts/kernel_vs_xla.py,
PERF.md), and jnp everywhere else. The kernel is slower at order 2, at
order 4 below 256^3 cells (0.94-0.97x at 128^3) and on thin z extents at
orders 4 and 6, where the extra ring copy its step costs outweighs its
faster stencil.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Grid3D, SimConfig
from .ops import stencil_jnp
from .sources import build_source_term, inject

BACKENDS = ("auto", "jnp", "plane_sweep")
# order -> (min interior cells, min of ny and nz) from which the plane sweep
# measured faster end to end on an H100, f32, one source. Orders 4 and 6:
# faster from 256^3 cells with y and z extents of 192 and up, slower on a
# z extent of 40 or 100. Orders 8-12: faster from 64^3 cells at every shape
# timed (order 10 lies between 8 and 12 at 64^3). Order 2: never.
PLANE_SWEEP_WINS = {
    4: (256**3, 192),
    6: (256**3, 192),
    8: (64**3, 1),
    10: (64**3, 1),
    12: (64**3, 1),
}


def _storage_dtype(cfg: SimConfig):
    return jnp.bfloat16 if cfg.storage_dtype == "bfloat16" else jnp.float32


def plane_sweep_measured_faster(grid: Grid3D, storage_dtype: str) -> bool:
    """Whether this grid is where the plane sweep beat jnp on the H100."""
    if storage_dtype != "float32" or grid.order not in PLANE_SWEEP_WINS:
        return False
    cells, extent = PLANE_SWEEP_WINS[grid.order]
    return grid.interior_cells >= cells and min(grid.ny, grid.nz) >= extent


def resolve_backend(cfg: SimConfig, grid: Grid3D, interpret: bool = False) -> str:
    """The engine a config runs on this grid and platform ("jnp" or
    "plane_sweep").

    interpret=True lets tests run the plane-sweep kernel through the Pallas
    interpreter on the CPU; nothing else ever selects interpret mode."""
    if cfg.backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {cfg.backend!r}; expected one of {BACKENDS}"
        )
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backend == "auto":
        sweep = on_gpu and plane_sweep_measured_faster(grid, cfg.storage_dtype)
        return "plane_sweep" if sweep else "jnp"
    if cfg.backend == "plane_sweep":
        if cfg.storage_dtype != "float32":
            raise ValueError("backend='plane_sweep' needs float32 storage")
        if not (on_gpu or interpret):
            raise ValueError(
                "backend='plane_sweep' compiles only for a CUDA GPU (found"
                f" {jax.default_backend()!r}); use backend='auto' or 'jnp'"
            )
    return cfg.backend


class JnpEngine:
    """Reference-layout ring levels; one step = XLA's fusion of stencil_jnp."""

    def __init__(self, grid: Grid3D, cfg: SimConfig, m_ref: np.ndarray, coords):
        self.grid = grid
        self.cfg = cfg
        self.term = build_source_term(grid, coords, m_ref)
        self.m = jnp.asarray(np.asarray(m_ref, np.float32))
        self.step_fn = self._make_step()

    def _make_step(self):
        return stencil_jnp.make_step(self.grid, self.cfg.dt)

    def prepare_level(self, u_ref: np.ndarray):
        return jnp.asarray(np.asarray(u_ref), dtype=_storage_dtype(self.cfg))

    @staticmethod
    def extract_level(level) -> np.ndarray:
        return np.asarray(level)

    def step(self, C, P, T, m):
        return self.step_fn(C, P, m, T)

    def inject(self, un, src_row):
        return inject(un, self.term, src_row)

    @property
    def has_sources(self) -> bool:
        return not self.term.empty


class PlaneSweepEngine(JnpEngine):
    """Same ring and layout; one step = the Hopper plane-sweep kernel."""

    def __init__(self, grid, cfg, m_ref, coords, interpret: bool = False):
        self.interpret = interpret
        super().__init__(grid, cfg, m_ref, coords)

    def _make_step(self):
        from .ops import stencil_gpu

        return stencil_gpu.make_step(
            self.grid, self.cfg.dt, interpret=self.interpret
        )


def make_engine(grid: Grid3D, cfg: SimConfig, m_ref: np.ndarray, coords=None,
                interpret: bool = False):
    if resolve_backend(cfg, grid, interpret) == "plane_sweep":
        return PlaneSweepEngine(grid, cfg, m_ref, coords, interpret)
    return JnpEngine(grid, cfg, m_ref, coords)


def run_scan(state, m, src_table, *, engine, nsteps: int):
    """Scan nsteps ring steps; returns (u_{N-1}, u_N, u_{N-2}) levels."""

    if src_table is None or not engine.has_sources:

        def body(carry, _):
            P, C, T = carry
            un = engine.step(C, P, T, m)
            return (C, un, P), None

        carry, _ = jax.lax.scan(body, state, None, length=nsteps)
    else:

        def body(carry, src_row):
            P, C, T = carry
            un = engine.step(C, P, T, m)
            un = engine.inject(un, src_row)
            return (C, un, P), None

        carry, _ = jax.lax.scan(body, state, src_table)
    return carry


class Simulator:
    """Compiled simulation for one (grid, config, source-layout) combination.

    Host-facing arrays (ICs, medium, results) use the reference layout
    [n+2H]^3 (main.cpp:360-363), which is also the device layout.
    """

    def __init__(
        self,
        grid: Grid3D,
        cfg: SimConfig,
        m: np.ndarray,
        src_coords: Optional[np.ndarray] = None,
        interpret: bool = False,
    ):
        self.grid = grid
        self.cfg = cfg
        self.engine = make_engine(grid, cfg, m, src_coords, interpret)

        def _run(state, m, src_table, nsteps):
            return run_scan(state, m, src_table, engine=self.engine,
                            nsteps=nsteps)

        # One compiled program per nsteps value (warmup / main), cached by
        # jit. m crosses the jit boundary as an argument: a closure-captured
        # device array would be baked into the program as a constant.
        self._jit_run = jax.jit(
            _run, static_argnames=("nsteps",), donate_argnums=(0,)
        )

    @property
    def backend(self) -> str:
        """The engine this simulator runs: "jnp" or "plane_sweep"."""
        return "plane_sweep" if isinstance(self.engine, PlaneSweepEngine) else "jnp"

    def _run(self, state, src_table, nsteps):
        return self._jit_run(state, self.engine.m, src_table, nsteps)

    def prepare_state(
        self,
        u_prev: np.ndarray,
        u_cur: np.ndarray,
        u_target: Optional[np.ndarray] = None,
    ):
        """Device-resident ring state (P, C, T); T defaults to a copy of C,
        which reproduces both reference IC setups (see oracle_run_ring)."""
        e = self.engine
        ut = u_cur if u_target is None else u_target
        return (e.prepare_level(u_prev), e.prepare_level(u_cur),
                e.prepare_level(ut))

    def state_spec(self):
        """ShapeDtypeStruct pytree of prepare_state's result."""
        lvl = jax.ShapeDtypeStruct(self.grid.padded_shape,
                                   _storage_dtype(self.cfg))
        return (lvl, lvl, lvl)

    def zero_state(self):
        """All-zero ring state built on the device: the reference's perf
        setup (main.cpp:389) without a multi-GB host array and transfer."""
        return jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), self.state_spec()
        )

    def state_field_stats(self, state):
        """(max_abs, has_nan) of the ring levels, reduced on the device."""
        mx, nan = 0.0, False
        for leaf in jax.tree_util.tree_leaves(state):
            a = jnp.asarray(leaf, jnp.float32)
            mx = max(mx, float(jnp.max(jnp.abs(a))))
            nan = nan or bool(jnp.isnan(jnp.max(a)))
        return mx, nan

    def extract_state(self, state):
        """Back to host reference-layout arrays (u_{N-1}, u_N, u_{N-2})."""
        return tuple(self.engine.extract_level(x) for x in state)

    def _src_slice(self, src: Optional[np.ndarray], t0: int, t1: int):
        if src is None or not self.engine.has_sources:
            return None
        return jnp.asarray(src[t0:t1], dtype=jnp.float32)

    def run(self, state, src: Optional[np.ndarray] = None, nsteps: Optional[int] = None):
        """Run the simulation on a (P, C, T) ring state; returns new state."""
        n = self.cfg.nsteps if nsteps is None else nsteps
        if n == 0:
            return state
        return self._run(state, self._src_slice(src, 0, n), n)

    def run_timed(self, state, src: Optional[np.ndarray] = None):
        """Run cfg.nsteps steps; returns (state, seconds of the timed steps).

        The first `cfg.warmup_steps` physics steps run untimed (the
        reference convention, cuda.cu:232); the rest are timed on the host
        clock around work that ends in `jax.block_until_ready`; a run no
        longer than the warmup is timed whole. Source rows are uploaded
        before the clock starts.
        """
        n = self.cfg.nsteps
        w = self.cfg.warmup_steps if n > self.cfg.warmup_steps else 0
        rest = n - w
        if w:
            state = self._run(state, self._src_slice(src, 0, w), w)
        main_src = self._src_slice(src, w, n)
        jax.block_until_ready((state, main_src))
        t0 = time.perf_counter()
        state = self._run(state, main_src, rest)
        jax.block_until_ready(state)
        return state, time.perf_counter() - t0


def simulate_ring(
    u_prev: np.ndarray,
    u_cur: np.ndarray,
    m: np.ndarray,
    grid: Grid3D,
    cfg: SimConfig,
    src: Optional[np.ndarray] = None,
    src_coords: Optional[np.ndarray] = None,
    u_target: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot run; returns host-side ring state (u_{N-1}, u_N, u_{N-2})."""
    sim = Simulator(grid, cfg, m, src_coords)
    state = sim.prepare_state(u_prev, u_cur, u_target)
    state = sim.run(state, src, cfg.nsteps)
    return sim.extract_state(state)


def simulate(
    u_prev: np.ndarray,
    u_cur: np.ndarray,
    m: np.ndarray,
    grid: Grid3D,
    cfg: SimConfig,
    src: Optional[np.ndarray] = None,
    src_coords: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot convenience wrapper; returns host-side (u_{N-1}, u_N)."""
    P, C, _ = simulate_ring(u_prev, u_cur, m, grid, cfg, src, src_coords)
    return P, C
