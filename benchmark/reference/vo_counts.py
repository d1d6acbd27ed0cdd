"""The operations and bytes of the env step's VO pair kernel
(rvo3d_tpu_torch/csrc/vo_pairs.cu), from the launch shapes the port's
recorder counts (`vo_pairs.<mode>.<key>`, ops/vo_pairs.py), and the least
time they take on the card: a frozen restatement of chip_smoke.py's
`vo_bound` (commit 0b5fa531ca5d13cff09285b5f28947957b4c7c8f), summed over
launches.

Operations: VO_FLOPS_PER_PAIR IEEE operations a (row, candidate) pair,
outside the tensor cores (the float32 peak). Bytes: each input read once
(the rows' states [12] and actions [3], the `others` values, and in the
observe mode each building row [4] with its mask byte), each output
written once (reward: a flag and two values a row; observe: nm slots of 9
values and a mask byte each, a flag, a collision byte and a value a row).
"""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.reference.counts import F32_PEAK, HBM_BYTES_S

VO_FLOPS_PER_PAIR = 108
MODES = ("reward", "observe")


def mode_counts(counters: Dict[str, float], mode: str) -> Optional[Dict[str, float]]:
    """The launch counts of one mode, or None where it made no launch."""
    pre = f"vo_pairs.{mode}."
    c = {k[len(pre):]: v for k, v in counters.items() if k.startswith(pre)}
    return c if c.get("launches") else None


def vo_bound(c: Dict[str, float], mode: str, itemsize: int) -> Dict[str, float]:
    """The operations, bytes and least seconds of a mode's launches `c`
    (launches, rows, pairs, slots, others, buildings) in a float type of
    `itemsize` bytes."""
    rows = c.get("rows", 0)
    read = rows * 15 * itemsize + c.get("others", 0) * itemsize
    if mode == "observe":
        read += c.get("buildings", 0) * (4 * itemsize + 1)
        nm = c.get("slots", 0) / rows if rows else 0
        written = rows * (nm * 9 * itemsize + nm + 2 + itemsize)
    else:
        written = rows * (1 + 2 * itemsize)
    flops = c.get("pairs", 0) * VO_FLOPS_PER_PAIR
    nbytes = read + written
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / F32_PEAK, nbytes / HBM_BYTES_S)}


def bound_seconds(counters: Dict[str, float], itemsize: int) -> Optional[float]:
    """The summed least seconds of every counted launch, or None where the
    counters hold none."""
    modes = [(m, mode_counts(counters, m)) for m in MODES]
    found = [(m, c) for m, c in modes if c is not None]
    if not found:
        return None
    return sum(vo_bound(c, m, itemsize)["bound_s"] for m, c in found)
