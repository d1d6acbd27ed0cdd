"""3D voxel line-of-sight.

Capability of the reference's line_sight_partial_3D (reference:
uaisa_env/world/line_sight_partial_3D.py:3-84): walk the voxels between two
grid points, interpolating z from the elevation angle, and report blocked
(0) iff any traversed voxel holds a FULL obstacle (value == 1; the 0.5
safety margin does not block sight — it only adds soft path cost).

Implementation: a uniform parametric sampling of the segment at sub-voxel
resolution (robust supercover; the reference's hand-rolled Bresenham with
integer-division edge cases is intentionally not replicated — this is
offline planning tooling, and the contract is "does the segment cross an
occupied voxel").

The port's copy of rvo3d_tpu/worlds/gen/lineofsight.py: host NumPy, the same
seeded draws, so the same seed gives the same world.
"""

from __future__ import annotations

import numpy as np


def line_of_sight_3d(grid: np.ndarray, p0, p1, samples_per_cell: float = 3.0
                     ) -> int:
    """grid: [Y, X, Z] with 1 == blocked. p0, p1: (y, x, z) grid coords.
    Returns 1 if the segment is free, 0 if blocked."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    dist = float(np.linalg.norm(p1 - p0))
    n = max(2, int(np.ceil(dist * samples_per_cell)) + 1)
    ts = np.linspace(0.0, 1.0, n)
    pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
    idx = np.floor(pts).astype(int)
    idx[:, 0] = np.clip(idx[:, 0], 0, grid.shape[0] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, grid.shape[1] - 1)
    idx[:, 2] = np.clip(idx[:, 2], 0, grid.shape[2] - 1)
    vals = grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return 0 if np.any(vals == 1) else 1
