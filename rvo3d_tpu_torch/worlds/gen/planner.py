"""Theta* any-angle path planning on the 3D voxel grid.

Capability of the reference's theta_star_3D (reference:
uaisa_env/world/theta_star_3D.py:5-124): A* over the 26-connected grid with
the Theta* parent-shortcut — when the current node's parent has line of
sight to a neighbor, the neighbor is re-parented directly (any-angle
paths) — and cost F = kg*G + kh*H + ke*E_safe[n] where the 0.5-valued
safety margin adds soft cost without blocking.

Implementation: standard heap-based A* (the reference rebuilds argmin over
a growing open array each iteration, O(n^2)); behavior-equivalent paths,
orders of magnitude faster on big grids.

The port's copy of rvo3d_tpu/worlds/gen/planner.py: host NumPy, the same
seeded draws, so the same seed gives the same world.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np

from rvo3d_tpu_torch.worlds.gen.lineofsight import line_of_sight_3d

_NEIGHBORS = [
    (dy, dx, dz)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if not (dy == 0 and dx == 0 and dz == 0)
]


def theta_star_3d(
    grid_safe: np.ndarray,
    start: Sequence[float],
    goal: Sequence[float],
    *,
    kg: float = 1.0,
    kh: float = 1.25,
    ke: float = 1.0,
    blocked_threshold: float = 1.0,
    use_native: Optional[bool] = None,
) -> Optional[Tuple[np.ndarray, int]]:
    """grid_safe: [Y, X, Z] (0 free / 0.5 margin / 1 blocked).
    start/goal: (y, x, z) continuous coords, floored/ceiled to the grid like
    the reference (theta_star_3D.py:12-18). Returns (path [K, 3], K) or
    None if unreachable.

    use_native=None auto-selects the C++ core (csrc/theta_star.cpp) when
    the toolchain is available — identical results, far faster on big
    grids; set RVO3D_NO_NATIVE=1 to force pure Python."""
    if use_native is None:
        from rvo3d_tpu_torch.worlds.gen.native import native_available

        use_native = native_available()
    if use_native:
        from rvo3d_tpu_torch.worlds.gen.native import theta_star_native

        return theta_star_native(
            grid_safe, start, goal, kg=kg, kh=kh, ke=ke,
            blocked_threshold=blocked_threshold,
        )
    ys, xs, zs = grid_safe.shape
    s = (int(np.floor(start[0])), int(np.floor(start[1])),
         int(np.floor(start[2])))
    g = (int(np.ceil(goal[0])), int(np.ceil(goal[1])), int(np.ceil(goal[2])))
    s = tuple(np.clip(s, 0, (ys - 1, xs - 1, zs - 1)))
    g = tuple(np.clip(g, 0, (ys - 1, xs - 1, zs - 1)))

    def h(n) -> float:
        return float(np.sqrt((n[0] - g[0]) ** 2 + (n[1] - g[1]) ** 2
                             + (n[2] - g[2]) ** 2))

    def dist(a, b) -> float:
        return float(np.sqrt((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
                             + (a[2] - b[2]) ** 2))

    G = {s: 0.0}
    parent = {s: s}
    counter = itertools.count()
    open_heap = [(kh * h(s), next(counter), s)]
    closed = set()

    while open_heap:
        _, _, cur = heapq.heappop(open_heap)
        if cur in closed:
            continue
        if cur == g:
            break
        closed.add(cur)
        for dy, dx, dz in _NEIGHBORS:
            nb = (cur[0] + dy, cur[1] + dx, cur[2] + dz)
            if not (0 <= nb[0] < ys and 0 <= nb[1] < xs and 0 <= nb[2] < zs):
                continue
            if nb in closed:
                continue
            if grid_safe[nb] >= blocked_threshold:
                continue
            par = parent[cur]
            # Theta* shortcut: connect straight to the grandparent when
            # visible (theta_star_3D.py:77-89)
            if line_of_sight_3d(grid_safe, par, nb) == 1:
                cand_parent, base = par, G[par]
            else:
                cand_parent, base = cur, G[cur]
            g_try = base + dist(cand_parent, nb)
            if g_try < G.get(nb, np.inf):
                G[nb] = g_try
                parent[nb] = cand_parent
                f = kg * g_try + kh * h(nb) + ke * float(grid_safe[nb])
                heapq.heappush(open_heap, (f, next(counter), nb))
    else:
        return None

    # backtrace (theta_star_3D.py:101-119)
    path = [g]
    node = g
    while node != s:
        node = parent.get(node)
        if node is None:
            return None
        path.append(node)
    path.reverse()
    arr = np.asarray(path, float)
    return arr, arr.shape[0]
