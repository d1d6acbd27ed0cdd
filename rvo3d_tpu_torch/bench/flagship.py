"""The bench's flagship world: 8 drones on crossing 3-point corridor
routes over a 12 x 12 x 6 map with one cylinder building (the port's own
copy of the JAX package's `_flagship_world`, __graft_entry__.py:22-44,
mirroring the reference's world_8 fixture's scale)."""

from __future__ import annotations


def flagship_world() -> dict:
    """The world as data_1.json-schema lists (no file IO)."""
    waypoints = []
    n = 8
    for i in range(n):
        t = i / n
        if i % 2 == 0:
            s = [1.0 + 10.0 * t, 1.0, 1.0 + 4.0 * t]
            e = [11.0 - 10.0 * t, 11.0, 5.0 - 4.0 * t]
        else:
            s = [1.0, 1.0 + 10.0 * t, 5.0 - 4.0 * t]
            e = [11.0, 11.0 - 10.0 * t, 1.0 + 4.0 * t]
        mid = [(s[0] + e[0]) / 2, (s[1] + e[1]) / 2, (s[2] + e[2]) / 2 + 0.5]
        waypoints.append([s, mid, e])
    return dict(
        waypoints_list=waypoints,
        n_points_list=[3] * n,
        building_list=[[6.0, 6.0, 5.0, 0.8]],
        map_size=[12.0, 12.0, 6.0],
        drone_num=n,
    )
