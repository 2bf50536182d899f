"""Multi-chip spatial domain decomposition (SURVEY.md §5: the reference is
strictly single-GPU and skips grids over 40 GB, main.cpp:337-341; this
build shards the grid over a device mesh instead)."""

from .sharded import (  # noqa: F401
    ShardedSimulator,
    global_from_shards,
    make_mesh,
    shards_from_global,
    simulate_sharded,
)
