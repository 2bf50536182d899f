"""tpufdtd — 3D acoustic FDTD engine in JAX.

A from-scratch JAX rebuild of the capabilities of
ycnliu/Accelerated-3D-Acoustic-FDTD-Kernel (see SURVEY.md): central-difference
spatial stencils of orders 2-12 (the reference's order 4 by default) +
2nd-order leapfrog time integration on a halo-padded regular grid, Ricker
point sources injected by trilinear scatter-add, a NumPy correctness oracle,
an XLA-fused jnp engine, a Hopper plane-sweep kernel (Pallas, Triton route),
bf16-storage mixed precision, a multi-device shard_map path with ppermute
halo exchange, and a benchmark harness reproducing the reference's
correctness phase and CSV performance schema.
"""

from .config import Grid3D, SimConfig, stencil_weights, halo_for_order  # noqa: F401
from .oracle import oracle_run, oracle_run_ring, oracle_step  # noqa: F401
from .sources import SourceTerm, build_source_term, inject  # noqa: F401
from .stepper import (  # noqa: F401
    Simulator,
    simulate,
    simulate_ring,
    run_scan,
)
from .wavelets import ricker, ricker_table, default_source_coords  # noqa: F401
from . import checkpoint, compat  # noqa: F401

__version__ = "0.1.0"
