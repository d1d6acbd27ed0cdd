"""World generation and the world registry in the port
(rvo3d_tpu_torch/worlds/{gen,registry}.py) against the JAX package's:
the same seeds give exactly the same endpoints, occupancy grids, building
lists, Theta* routes and saved files (byte for byte), for the Python and
the native planner; load_world resolves through the registry."""

import filecmp
import os

import numpy as np
import pytest

from rvo3d_tpu.worlds import gen as jgen
from rvo3d_tpu_torch.worlds import gen as pgen
from rvo3d_tpu_torch.worlds import load_world, register_world, world_search_paths
from rvo3d_tpu_torch.worlds.gen import native as pnative

SEEDS = range(4)
# (drones, map size): the CLI's default world, and world16_dense's drone count
SIZES = [(4, (12, 12, 6)), (16, (24, 24, 8))]
FILES = ("data_1.json", "E3d.npy", "E3d_safe.npy")


def _cases():
    return [(n, ms, s) for n, ms in SIZES for s in SEEDS]


@pytest.mark.parametrize("n,ms,seed", _cases())
def test_endpoints_and_city_equal_jax(n, ms, seed):
    a = jgen.random_endpoints(n, ms, seed=seed, margin=1)
    b = pgen.random_endpoints(n, ms, seed=seed, margin=1)
    assert a == b
    starts = [(p[1], p[0], p[2]) for p in a["start_points"]]
    ends = [(p[1], p[0], p[2]) for p in a["end_points"]]
    yxz = (ms[1], ms[0], ms[2])
    ja = jgen.cylinder_city(yxz, starts, ends, seed=seed)
    pa = pgen.cylinder_city(yxz, starts, ends, seed=seed)
    for x, y in zip(ja[:4], pa[:4]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ja[4] == pa[4]


@pytest.mark.parametrize("seed", SEEDS)
def test_line_of_sight_equals_jax(seed):
    rng = np.random.default_rng(seed)
    grid = (rng.random((12, 12, 6)) > 0.8).astype(float)
    grid[rng.random(grid.shape) > 0.9] = 0.5
    for _ in range(50):
        p0, p1 = rng.uniform(0, 11, 3), rng.uniform(0, 11, 3)
        want = jgen.line_of_sight_3d(grid, p0, p1)
        assert pgen.line_of_sight_3d(grid, p0, p1) == want
        assert pnative.los3d_native(grid, p0, p1) == want


@pytest.mark.parametrize("n,ms,seed", _cases())
def test_theta_star_python_and_native_equal_jax(n, ms, seed):
    eps = jgen.random_endpoints(n, ms, seed=seed, margin=1)
    starts = [(p[1], p[0], p[2]) for p in eps["start_points"]]
    ends = [(p[1], p[0], p[2]) for p in eps["end_points"]]
    _, _, _, safe, _ = jgen.cylinder_city((ms[1], ms[0], ms[2]), starts, ends, seed=seed)
    for st, en in zip(starts, ends):
        want = jgen.theta_star_3d(safe, st, en, use_native=False)
        for use_native in (False, True):
            got = pgen.theta_star_3d(safe, st, en, use_native=use_native)
            if want is None:
                assert got is None
                continue
            assert got[1] == want[1] and np.array_equal(got[0], want[0]), use_native


@pytest.mark.parametrize("n,ms,seed", _cases())
def test_generate_world_files_are_byte_identical_to_jax(tmp_path, monkeypatch, n, ms, seed):
    ref = jgen.generate_world("w", n, ms, seed=seed)
    ref.save(str(tmp_path / "jax"))
    real = pgen.pipeline.theta_star_3d
    for use_native in (False, True):
        monkeypatch.setattr(pgen.pipeline, "theta_star_3d",
                            lambda *a, **k: real(*a, use_native=use_native, **k))
        wd = pgen.generate_world("w", n, ms, seed=seed)
        out = tmp_path / f"port_{use_native}"
        wd.save(str(out))
        for f in FILES:
            assert filecmp.cmp(tmp_path / "jax" / f, out / f, shallow=False), (f, use_native)
        assert wd.waypoints_list == ref.waypoints_list
        assert wd.building_list == ref.building_list
    back = load_world(str(out))
    assert back.drone_num == n and back.name == out.name
    assert np.array_equal(back.e3d(safe=True), ref._e3d_safe)


def test_native_library_builds_outside_the_jax_tree():
    assert pnative.native_available(), pnative.UNAVAILABLE
    path = pnative.library_path()
    assert os.path.exists(path)
    assert os.path.join("build", "torch_kernels") in path


def test_load_world_through_the_env_path_and_the_registry(tmp_path, monkeypatch):
    wd = pgen.generate_world("made_here", 4, (12, 12, 6), seed=1)
    wd.save(str(tmp_path / "made_here"))
    with pytest.raises(FileNotFoundError):
        load_world("made_here")
    monkeypatch.setenv("RVO3D_WORLD_PATH", f"/nonexistent:{tmp_path}")
    assert world_search_paths()[:2] == ["/nonexistent", str(tmp_path)]
    got = load_world("made_here")
    assert got.name == "made_here" and got.waypoints_list == wd.waypoints_list
    monkeypatch.delenv("RVO3D_WORLD_PATH")
    register_world("alias_of_made_here", str(tmp_path / "made_here"))
    got = load_world("alias_of_made_here")
    assert got.name == "alias_of_made_here" and got.drone_num == 4
    assert load_world("gen_demo").drone_num == 4     # worlds_data/ still resolves


def test_missing_world_names_the_search_paths(monkeypatch, tmp_path):
    monkeypatch.setenv("RVO3D_WORLD_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        load_world("no_such_world")
    msg = str(err.value)
    assert "no_such_world" in msg and str(tmp_path) in msg and "worlds_data" in msg
