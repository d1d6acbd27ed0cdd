"""The port stands alone: nothing in rvo3d_tpu_torch/ or chip_smoke.py
imports JAX, its libraries or the JAX package, or names the JAX package's
run artifacts or reference fixtures; the port imports and steps with those
modules blocked; chip_smoke.py refuses to run without a CUDA card; and
utils/graphs.py and utils/profiler.py name no kernel module of ops/."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from rvo3d_tpu.utils.torch_import import REFERENCE_TRAIN_DIR
from rvo3d_tpu.worlds.registry import _REFERENCE_WORLDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "rvo3d_tpu"}
# the JAX package's trained runs, and the root of its reference fixtures
BANNED_PATHS = ("runs/", os.path.commonpath([_REFERENCE_WORLDS, REFERENCE_TRAIN_DIR]))


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "rvo3d_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_sources_found():
    files = port_sources()
    assert len(files) > 15
    assert any(f.endswith(os.path.join("ops", "masked_gru.py")) for f in files)


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_or_reference_paths(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, node.lineno, name)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for banned in BANNED_PATHS:
                assert banned not in node.value, (path, node.lineno, banned)


BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
sys.path.insert(0, {repo!r})
import torch
import rvo3d_tpu_torch.serving, rvo3d_tpu_torch.algo.evaluator
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.worlds import load_world
wd = load_world("gen_demo")
env = DroneEnv(wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num), num_envs=2)
state, out = env.reset()
state, out = env.step(state, torch.zeros(2, wd.drone_num, 3))
assert not any(m.split(".")[0] in {banned!r} for m in sys.modules)
print("isolated-ok")
"""


def test_port_runs_with_jax_blocked():
    code = BLOCKER.format(banned=sorted(BANNED), repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout


# the counterparts of the JAX side's entry points: each imports with JAX
# blocked and, asked for its default device without a card, raises
ENTRY_POINTS = {
    "rvo3d_tpu_torch.entry": [],
    "rvo3d_tpu_torch.diag.expert_eval": ["gen_demo"],
    "rvo3d_tpu_torch.diag.expert_noise_sweep": [],
    "rvo3d_tpu_torch.diag.conflict_diag": ["RUN_DIR", "gen_demo"],
    "rvo3d_tpu_torch.diag.bc_eval": ["gen_demo"],
    "rvo3d_tpu_torch.diag.bc_trace": ["gen_demo"],
    "rvo3d_tpu_torch.diag.w3_diag": ["gen_demo"],
    "rvo3d_tpu_torch.bench.detail": ["--world", "gen_demo"],
    "rvo3d_tpu_torch.examples.env_smoke": ["gen_demo"],
}
ENTRY_BLOCKER = BLOCKER.split("import torch\n")[0] + """import importlib
import torch
assert not torch.cuda.is_available()
for name, argv in {entry_points!r}.items():
    mod = importlib.import_module(name)
    try:
        mod.main(argv)
    except RuntimeError as e:
        assert "torch.cuda.is_available() is False" in str(e), (name, e)
    else:
        raise AssertionError(name + " ran without a card")
assert not any(m.split(".")[0] in {banned!r} for m in sys.modules)
print("entry-points-ok")
"""


def test_entry_points_import_isolated_and_need_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = ENTRY_BLOCKER.format(banned=sorted(BANNED), repo=REPO,
                                entry_points=ENTRY_POINTS)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "entry-points-ok" in proc.stdout


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    _assert_refused(proc)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    _assert_refused(proc)


OPTIONAL = {"matplotlib", "yaml", "imageio", "cv2"}
OPTIONAL_BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
sys.path.insert(0, {repo!r})
import torch
import rvo3d_tpu_torch.render, rvo3d_tpu_torch.worlds.gen, rvo3d_tpu_torch.parity
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.render import frames_to_gif, frames_to_mp4, record_trajectory
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world
wd = load_world("gen_demo")
env = DroneEnv(wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num))
traj = record_trajectory(env, waypoint_controller, steps=3)
assert traj["pos"].shape == (3, wd.drone_num, 3)
assert frames_to_gif([], "x.gif") is None and frames_to_mp4([], "x.mp4") is None
try:
    rvo3d_tpu_torch.render.ScenePlotter(wd.map_size, wd.building_list)
except ImportError:
    pass
else:
    raise AssertionError("ScenePlotter needs matplotlib")
assert not any(m.split(".")[0] in {banned!r} for m in sys.modules)
print("optional-ok")
"""


def test_render_and_worldgen_import_without_optional_libraries():
    """The card machine has no matplotlib, PyYAML, imageio or cv2: the
    render and worldgen modules import and record there, and only drawing
    needs matplotlib."""
    code = OPTIONAL_BLOCKER.format(banned=sorted(OPTIONAL | BANNED), repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "optional-ok" in proc.stdout


@pytest.mark.parametrize("name,allowed", [("graphs", set()), ("profiler", {"_build"})])
def test_utilities_reach_no_kernel_module(name, allowed):
    """utils/graphs.py imports nothing of ops/, and utils/profiler.py only
    ops/_build.py (its stamp's launcher): adding a kernel edits neither."""
    path = os.path.join(REPO, "rvo3d_tpu_torch", "utils", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    reached = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for parts in (m.split(".") for m in mods):
            if parts[:2] == ["rvo3d_tpu_torch", "ops"]:
                reached.add(parts[2] if len(parts) > 2 else "ops")
    assert reached <= allowed, (name, reached)
