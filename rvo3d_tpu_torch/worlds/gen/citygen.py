"""Random cylinder-city occupancy generation.

Capability of the reference's grid_3D_safe_zone (reference:
uaisa_env/world/grid_3D_safe_zone.py:14-191), vectorized:

  1. obstacle seeds: iid N(0,1) field thresholded at k_sigma (:26-33)
  2. heights: N(0.8h, 0.5h) rounded, clamped to [3, z_size] (:46-57)
  3. start/end clearing: zero a (2*n_low+1)^2 patch around each endpoint (:61-71)
  4. E3d extrusion: level i occupied iff height >= z_grid[i] (:79-83)
  5. radius dilation: each seed gets an integer radius in {1,2}; cells within
     the square footprint inherit the height (stored building radius is
     radius-1, the reference's convention — the grid keeps a one-cell
     margin over the collision cylinder) (:89-106)
  6. safety margin: free cells 26-adjacent to occupied become 0.5 (:110-139)
  7. boundary fence: outer walls occupied (:145-157)

Returns (E, E_safe, E3d, E3d_safe, buildings) with buildings rows
[y, x, height, radius-1] matching the data_1.json building_list schema.
Deliberate fixes vs the reference: seeded RNG, no hard-coded forced seed at
[5,5], dilation loops replaced by array ops, and the dilation `break`-on-
boundary bug (grid_3D_safe_zone.py:96-101 stops the whole footprint at the
map edge) becomes a clip.

The port's copy of rvo3d_tpu/worlds/gen/citygen.py: host NumPy, the same
seeded draws, so the same seed gives the same world.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def cylinder_city(
    size: Sequence[int],
    starts: Sequence[Sequence[float]],
    ends: Sequence[Sequence[float]],
    *,
    n_low: int = 1,
    k_sigma: float = 2.0,
    h_mean_frac: float = 0.8,
    h_std_frac: float = 0.5,
    min_height: int = 3,
    seed: int = 0,
    fence: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[List[float]]]:
    y_size, x_size, z_size = int(size[0]), int(size[1]), int(size[2])
    rng = np.random.default_rng(seed)
    h = float(z_size)

    # 1. seeds
    field = rng.normal(0.0, 1.0, (y_size, x_size))
    seeds = field > k_sigma

    # 2. heights
    heights = np.rint(rng.normal(h_mean_frac * h, h_std_frac * h,
                                 (y_size, x_size))).astype(int)
    heights = np.clip(heights, min_height, z_size)
    E = np.where(seeds, heights, 0)

    # 3. clear around endpoints
    def clear(pt):
        cy, cx = int(np.ceil(pt[0])), int(np.ceil(pt[1]))
        y0, y1 = max(0, cy - n_low), min(y_size, cy + n_low + 1)
        x0, x1 = max(0, cx - n_low), min(x_size, cx + n_low + 1)
        E[y0:y1, x0:x1] = 0

    for p in list(starts) + list(ends):
        clear(p)
    seeds = E > 0

    # 5. radius dilation (before extrusion so E3d sees the footprint)
    E_safe = E.copy()
    buildings: List[List[float]] = []
    ys, xs = np.nonzero(seeds)
    radii = rng.integers(1, 3, size=len(ys))
    for (j, i, r) in zip(ys, xs, radii):
        hh = int(E[j, i])
        buildings.append([float(j), float(i), float(hh), float(r - 1)])
        y0, y1 = max(0, j - r), min(y_size, j + r + 1)
        x0, x1 = max(0, i - r), min(x_size, i + r + 1)
        patch = E_safe[y0:y1, x0:x1]
        np.maximum(patch, hh, out=patch)

    # 4. extrusion of the dilated height field
    z_grid = np.linspace(1, z_size, z_size)
    E3d = (E_safe[:, :, None] >= z_grid[None, None, :]).astype(float)

    # 6. 26-neighbor safety margin: dilate sequentially along each axis
    occ = E3d > 0
    d1 = occ.copy()
    for axis in range(3):
        grown = d1.copy()
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(1, None)
        sl_hi[axis] = slice(None, -1)
        grown[tuple(sl_lo)] |= d1[tuple(sl_hi)]
        grown[tuple(sl_hi)] |= d1[tuple(sl_lo)]
        d1 = grown
    E3d_safe = E3d.copy()
    E3d_safe[(~occ) & d1] = 0.5

    # 7. fence
    if fence:
        for arr, wall in ((E, z_size), (E_safe, z_size)):
            arr[0, :] = wall
            arr[-1, :] = wall
            arr[:, 0] = wall
            arr[:, -1] = wall
        for arr in (E3d, E3d_safe):
            arr[0, :, :] = 1
            arr[-1, :, :] = 1
            arr[:, 0, :] = 1
            arr[:, -1, :] = 1
            arr[:, :, 0] = 1
            arr[:, :, -1] = 1

    return E, E_safe, E3d, E3d_safe, buildings
