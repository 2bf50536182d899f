"""Statistics over benchmark repetitions (main.cpp:93-111), plus the median
and range that the timing reports lead with."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Stats:
    mean: float
    stddev: float
    median: float = 0.0
    min: float = 0.0
    max: float = 0.0


def compute_stats(values: Sequence[float]) -> Stats:
    if not values:
        return Stats(0.0, 0.0)
    vals = sorted(values)
    n = len(vals)
    mean = sum(vals) / n
    median = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
    var = sum((v - mean) ** 2 for v in vals) / n
    return Stats(mean, math.sqrt(var), median, vals[0], vals[-1])
