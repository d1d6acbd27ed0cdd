"""The port stands alone: nothing in rvo3d_tpu_torch/ or chip_smoke.py
imports JAX, its libraries or the JAX package, or names the JAX package's
run artifacts or reference fixtures; the port imports and steps with those
modules blocked; and chip_smoke.py refuses to run without a CUDA card."""

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
