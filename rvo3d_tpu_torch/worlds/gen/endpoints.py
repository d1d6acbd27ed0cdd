"""Random start/destination pair generation.

Capability of the reference's random_start_end.py (reference:
uaisa_env/world/random_start_end.py:7-63): integer start/end points with a
minimum mutual distance between every start/end of every pair, written as
{start_points, end_points}. Differences (deliberate fixes): seeded RNG, a
retry budget instead of a potential infinite loop (the reference only
re-rolls `end`, random_start_end.py:46), and distances that default to
something satisfiable for the given map.

The port's copy of rvo3d_tpu/worlds/gen/endpoints.py: host NumPy, the same
seeded draws, so the same seed gives the same world.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def random_endpoints(
    num_pairs: int = 8,
    map_size: Sequence[int] = (20, 20, 5),
    min_distance: Optional[float] = None,
    seed: int = 0,
    max_tries: int = 20000,
    margin: int = 0,
) -> Dict[str, List[Tuple[int, int, int]]]:
    """margin keeps points away from the map boundary (the city generator
    erects an occupied fence on the outer walls, citygen step 7)."""
    rng = np.random.default_rng(seed)
    w, h, d = map_size
    if min_distance is None:
        # satisfiable default: all 2*num_pairs points end up mutually
        # separated, so scale the diagonal down by the pair count
        diag = float(np.sqrt(w * w + h * h + d * d))
        min_distance = diag / max(2.0, num_pairs + 1.0)

    def draw() -> Tuple[int, int, int]:
        return (int(rng.integers(margin, w - margin)),
                int(rng.integers(margin, h - margin)),
                int(rng.integers(margin, d - margin)))

    def dist(a, b) -> float:
        return float(np.sqrt((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
                             + (a[2] - b[2]) ** 2))

    def ok(start, end, pairs) -> bool:
        if dist(start, end) < min_distance:
            return False
        for s, e in pairs:
            if (dist(start, s) < min_distance or dist(end, e) < min_distance
                    or dist(start, e) < min_distance
                    or dist(end, s) < min_distance):
                return False
        return True

    pairs: List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = []
    tries = 0
    while len(pairs) < num_pairs:
        start, end = draw(), draw()
        tries += 1
        if tries > max_tries:
            raise RuntimeError(
                f"could not place {num_pairs} pairs with min_distance="
                f"{min_distance:.2f} in map {tuple(map_size)}; "
                f"lower min_distance or num_pairs"
            )
        if ok(start, end, pairs):
            pairs.append((start, end))

    return {
        "start_points": [p[0] for p in pairs],
        "end_points": [p[1] for p in pairs],
    }


def save_endpoints_yaml(path: str, endpoints: Dict) -> None:
    """drone_paths.yaml schema (random_start_end.py:57-63)."""
    import yaml

    data = {
        "start_points": [list(p) for p in endpoints["start_points"]],
        "end_points": [list(p) for p in endpoints["end_points"]],
    }
    with open(path, "w") as f:
        yaml.dump(data, f, default_flow_style=False)


def load_endpoints_yaml(path: str) -> Dict:
    """Reads the reference's drone_paths.yaml (path_planning_main.py:20-46)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return {
        "start_points": [tuple(p) for p in data["start_points"]],
        "end_points": [tuple(p) for p in data["end_points"]],
    }
