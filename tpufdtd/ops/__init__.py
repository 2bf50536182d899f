"""Stencil steps: `stencil_jnp` (XLA-fused, any platform) and `stencil_gpu`
(the Hopper plane-sweep kernel, imported on use)."""

from . import stencil_jnp  # noqa: F401
