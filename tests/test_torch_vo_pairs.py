"""The VO pair kernel's host side (rvo3d_tpu_torch/ops/vo_pairs.py), which
the CPU reaches: the launch geometry covers every row once with a group of
threads at least as wide as its candidates (or 32 and a loop), the keys fit
the block's shared memory, the ctypes parameters follow the C struct of
csrc/vo_pairs.cu field by field, and CPU tensors keep the plain PyTorch
path; chip_smoke.py's bound of a launch counts its bytes and operations.
The kernel itself is held to that path on a card (tests/test_torch_cuda.py)."""

import importlib.util
import math
import os
import re

import pytest
import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import rvo
from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.ops import vo_pairs as vp


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 15, 16, 17, 32, 33, 64, 300])
def test_geometry_covers_each_row_once(m, itemsize):
    for rows in (1, 7, 255, 256, 4096, 32768):
        geo = vp.launch_geometry(rows, m, itemsize)
        assert geo.group & (geo.group - 1) == 0 and geo.group <= 32
        assert geo.group >= m or geo.group == 32       # else chunks of 32
        assert geo.group < 2 * m or geo.group == 1     # the narrowest that fits
        assert geo.rows_per_block * geo.group == vp.THREADS
        assert (geo.blocks - 1) * geo.rows_per_block < rows <= geo.blocks * geo.rows_per_block
        assert geo.smem_bytes == geo.rows_per_block * m * (2 * itemsize + 1)
        assert geo.smem_bytes <= vp.MAX_SMEM


def test_geometry_refuses_what_the_kernel_cannot_take():
    for args in ((0, 8, 4), (8, 0, 4), (8, 8, 2)):
        with pytest.raises(ValueError):
            vp.launch_geometry(*args)
    with pytest.raises(ValueError, match="shared memory"):
        vp.launch_geometry(8, 400, 8)


def test_ctypes_parameters_follow_the_c_struct():
    with open(os.path.join(_build.CSRC_DIR, "vo_pairs.cu")) as f:
        body = re.search(r"struct VoParams \{(.*?)\};", f.read(), re.S).group(1)
    kinds = {"int64_t": "i64", "double": "f64", "int": "i32"}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        if "*" in decl:
            fields.append((decl.split("*")[-1].strip(), "ptr"))
            continue
        ctype, names = decl.split(None, 1)
        fields += [(n.strip(), kinds[ctype]) for n in names.split(",")]
    ctype_kind = {vp.ctypes.c_void_p: "ptr", vp.ctypes.c_int64: "i64",
                  vp.ctypes.c_double: "f64", vp.ctypes.c_int: "i32"}
    assert [(n, ctype_kind[t]) for n, t in vp._Params._fields_] == fields


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bound_counts_bytes_and_operations(dtype):
    cs = chip_smoke()
    states, actions = torch.zeros(1024, 32, 12, dtype=dtype), torch.zeros(1024, 32, 3, dtype=dtype)
    bld, mask = torch.zeros(20, 4, dtype=dtype), torch.zeros(20, dtype=torch.bool)
    if dtype == torch.float64:      # timed at the float32 peak alone
        with pytest.raises(ValueError, match="float32"):
            cs.vo_bound(states, actions)
        return
    rows, pairs = 1024 * 32, 1024 * 32 * 32
    read = rows * 15 * 4
    rew = cs.vo_bound(states, actions)
    assert rew["flops"] == pairs * cs.VO_FLOPS_PER_PAIR
    assert rew["bytes"] == read + rows * (1 + 2 * 4)
    obs = cs.vo_bound(states, actions, nm=10, buildings=bld, building_mask=mask)
    assert obs["bytes"] == read + 20 * 4 * 4 + 20 + rows * (10 * 9 * 4 + 10 + 2 + 4)
    for b in (rew, obs):
        want = max(b["flops"] / cs.F32_PEAK, b["bytes"] / cs.HBM_BYTES_S) * 1e3
        assert b["bound_ms"] == pytest.approx(want)
    assert obs["bound_by"] == "bytes"     # obs_nbr, dense, is most of the traffic
    others = torch.zeros(1024, 35, 8, dtype=dtype)
    assert cs.vo_bound(states, actions, others)["flops"] == rows * 35 * cs.VO_FLOPS_PER_PAIR


def test_chip_smoke_gate_holds_flags_and_values_to_two_ulp():
    from vo_cases import dense_cluster

    cs = chip_smoke()
    states, actions, bld, mask = dense_cluster((4, 4, 2), dtype=torch.float32)
    p = EnvParams(num_drones=states.shape[-2])
    want = rvo.vo_observe_plain(states, actions, bld, mask, p)
    assert bool(want.obs_mask.any())
    assert cs.vo_within(want, want, "same") == 0.0
    def up(x, ulps):
        for _ in range(ulps):
            x = torch.nextafter(x, torch.full_like(x, math.inf))
        return x

    nbr = want.obs_nbr
    assert cs.vo_within(want._replace(obs_nbr=up(nbr, 2)), want, "2 ulp") > 0
    with pytest.raises(AssertionError, match="beyond 2 ulp"):
        cs.vo_within(want._replace(obs_nbr=up(nbr, 3)), want, "3 ulp")
    flipped = want.obs_mask.clone()
    flipped[0, 0, -1] = ~flipped[0, 0, -1]
    with pytest.raises(AssertionError, match="flags"):
        cs.vo_within(want._replace(obs_mask=flipped), want, "mask")
    fin = torch.isfinite(want.min_exp_time)
    assert bool(fin.any())
    gone = want.min_exp_time.clone()
    gone[fin.nonzero()[0].unbind()] = math.inf
    with pytest.raises(AssertionError, match="non-finite"):
        cs.vo_within(want._replace(min_exp_time=gone), want, "inf")
    with pytest.raises(ValueError, match="float32"):
        cs.vo_within(tuple(x.double() for x in want), tuple(x.double() for x in want), "f64")


def test_cpu_tensors_keep_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called for CPU tensors")
    monkeypatch.setattr(vp, "observe", refuse)
    monkeypatch.setattr(vp, "reward_info", refuse)
    g = torch.Generator().manual_seed(0)
    states = torch.rand(3, 6, 12, generator=g) * 4
    actions = torch.rand(3, 6, 3, generator=g)
    p = EnvParams(num_drones=6)
    bld, mask = torch.tensor([[2.0, 2.0, 5.0, 0.5]]), torch.tensor([True])
    before = vp.launches
    for a, b in zip(rvo.vo_observe(states, actions, bld, mask, p),
                    rvo.vo_observe_plain(states, actions, bld, mask, p)):
        assert torch.equal(a, b)
    for a, b in zip(rvo.vo_reward_info(states, actions, p),
                    rvo.vo_reward_info_plain(states, actions, p)):
        assert torch.equal(a, b)
    assert vp.launches == before


def test_the_wrapper_refuses_cpu_tensors():
    p = EnvParams(num_drones=4)
    with pytest.raises(ValueError, match="CUDA"):
        vp.reward_info(torch.zeros(4, 12), torch.zeros(4, 3), p)
