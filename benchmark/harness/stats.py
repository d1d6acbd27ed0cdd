"""Statistics the metric readers share."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value with
    at least a share q of all values at or below it; None for no values."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def share(part: float, whole: float) -> Optional[float]:
    """part / whole in percent, None where there is no whole or no part."""
    if not whole or whole <= 0 or part is None or part <= 0:
        return None
    return 100.0 * part / whole
