"""The env step's per-drone passes (rvo3d_tpu_torch/ops/env_drones.py,
csrc/env_drones.cu) and the env functions that take them.

On the CPU: the ctypes parameters follow the C struct field by field; the
passes' input checks raise on wrong shapes, unsupported dtypes, mixed
devices and, last, on CPU tensors; `step`, `observe` and `reset_where` on
CPU tensors are `step_plain`, `observe_plain` and `reset_where_plain` and
never reach the passes; the passes' source, built for the host by g++
(tests/host_cuda/ shims the CUDA names) and launched by ops/_build.launcher
in place of the card's library, equals the plain path on the CPU in
float64 over 30 chained steps (values within 1e-12, flags equal).

On a card (marked gpu; skips without one): the passes against the plain
PyTorch path on the card over 60 chained steps (the plain path's chain; the
passes run on each of its states): the flagship world, world16_dense,
world32_mix, a world32_mix lane world with reversed routes in alternate
lanes, and a world with sphere obstacles; float32, and float64 states with
float64 and with float32 actions; control noise, safe rewards, progress
shaping, eval-mode collisions and no parity rounding. Flags, waypoint
indices, masks and the non-finite pattern must be equal, values equal or
within the VO kernel tests' limit (2 ulp of the larger value in float32,
1e-12 in float64). The launches a call makes, by the counters: step 3
passes and 2 VO launches, observe 2 and 1, reset_where 1; and a graphed
eval chunk equal to its eager body with 6 passes a step counted through
the replays. This file imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_env_drones.py
"""

import contextlib
import ctypes
import dataclasses
import math
import os
import re
import shutil
import subprocess

import pytest
import torch

import vo_cases
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.state import DroneState
from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.ops import env_drones as ed
from rvo3d_tpu_torch.ops import vo_pairs
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world

STEPS = 60


def _world(name, device, dtype, lanes=None):
    """(world, drones) for a world name, "lane" (world32_mix with its
    route reversal in alternate lanes of `lanes`, LANES by default) or
    "spheres"."""
    from rvo3d_tpu_torch.bench import core
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.env.state import make_world_spec
    from rvo3d_tpu_torch.worlds.multi import reverse_routes, stack_worlds, worlds_for_lanes

    if name == "flagship":
        return core.world_spec(flagship_world(), device, dtype), 8
    if name == "spheres":
        return make_world_spec(vo_cases.SPHERE_WAYPOINTS, vo_cases.SPHERE_BUILDINGS,
                               vo_cases.SPHERE_MAP, spheres=vo_cases.SPHERES, dtype=dtype,
                               device=device), 12
    if name == "lane":
        a = load_world("world32_mix").spec(dtype=dtype, device=device)
        alternate = torch.arange(lanes or LANES, device=device) % 2
        return worlds_for_lanes(stack_worlds([a, reverse_routes(a)]), alternate), 32
    wd = load_world(name)
    return wd.spec(dtype=dtype, device=device), wd.drone_num


LANES = 32


# ---- the CPU: the binding, the checks, the dispatch ----

def test_ctypes_parameters_follow_the_c_struct():
    with open(os.path.join(_build.CSRC_DIR, "env_drones.cu")) as f:
        body = re.search(r"struct DroneParams \{(.*?)\};", f.read(), re.S).group(1)
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
    ctype_kind = {ed.ctypes.c_void_p: "ptr", ed.ctypes.c_int64: "i64",
                  ed.ctypes.c_double: "f64", ed.ctypes.c_int: "i32"}
    assert [(n, ctype_kind[t]) for n, t in ed._Params._fields_] == fields


def _cpu_case(dtype=torch.float32, lanes=4):
    world, n = _world("world16_dense", "cpu", dtype)
    p = EnvParams(num_drones=n)
    state = tenv.reset(world, p, (lanes,), dtype)
    return world, p, state


def test_passes_refuse_cpu_tensors_after_every_other_check():
    world, p, state = _cpu_case()
    s12 = torch.zeros(state.pos.shape[:-1] + (12,))
    flag = torch.zeros(state.yaw.shape, dtype=torch.bool)
    calls = {
        "pre": lambda: ed.pre(world, state, p),
        "obs": lambda: ed.obs(world, state, p),
        "mid": lambda: ed.mid(world, state, s12, state.vel, flag, state.yaw, p),
        "reset": lambda: ed.reset(world, state, flag),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


@pytest.mark.parametrize("case", ["pos_shape", "wp_dtype", "half_states", "int_actions",
                                  "f64_actions_f32_states", "world_dtype", "world_lanes",
                                  "mask_shape", "mask_dtype", "noise_missing",
                                  "noise_shape", "drones"])
def test_passes_refuse_what_they_do_not_take(case):
    world, p, state = _cpu_case()
    s12 = torch.zeros(state.pos.shape[:-1] + (12,))
    flag = torch.zeros(state.yaw.shape, dtype=torch.bool)
    act, mask, noise = state.vel, None, None
    if case == "pos_shape":
        state = state._replace(pos=state.pos[..., :2])
    elif case == "wp_dtype":
        state = state._replace(wp_idx=state.wp_idx.long())
    elif case == "half_states":
        state = DroneState(*[t.half() if t.is_floating_point() else t for t in state])
    elif case == "int_actions":
        act = act.int()
    elif case == "f64_actions_f32_states":
        act = act.double()
    elif case == "world_dtype":
        world = world._replace(route_len=world.route_len.double())
    elif case == "world_lanes":
        world = world._replace(waypoints=world.waypoints[None].expand(3, -1, -1, -1))
    elif case == "mask_shape":
        mask = flag[:, :-1]
    elif case == "mask_dtype":
        mask = flag.int()
    elif case.startswith("noise"):
        p = dataclasses.replace(p, noise=True)
        noise = torch.zeros(state.pos.shape[:-1]) if case == "noise_shape" else None
    elif case == "drones":
        world = world._replace(waypoints=world.waypoints[:-1])
    with pytest.raises((ValueError, TypeError)) as err:
        if mask is None:
            ed.mid(world, state, s12, act, flag, state.yaw, p, noise)
        else:
            ed.reset(world, state, mask)
    assert "CUDA tensors" not in str(err.value)


@pytest.mark.parametrize("what", ["actions", "world", "mask"])
def test_passes_refuse_mixed_devices(what):
    world, p, state = _cpu_case()
    s12 = torch.zeros(state.pos.shape[:-1] + (12,))
    flag = torch.zeros(state.yaw.shape, dtype=torch.bool)
    act = state.vel
    if what == "actions":
        act = act.to("meta")
    elif what == "world":
        world = world._replace(radius=world.radius.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        if what == "mask":
            ed.reset(world, state, flag.to("meta"))
        else:
            ed.mid(world, state, s12, act, flag, state.yaw, p)


def _equal(a, b, msg):
    """Trees of tuples of tensors equal bit for bit (NaN where NaN)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, msg
        assert torch.equal(a.isnan(), b.isnan()), msg
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), msg
        return
    assert len(a) == len(b), msg
    for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        _equal(x, y, f"{msg}.{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_take_the_plain_path(dtype, monkeypatch):
    world, p, state = _cpu_case(dtype)

    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensors reached the passes")
    for name in ("pre", "mid", "post", "obs", "post_obs", "reset"):
        monkeypatch.setattr(ed, name, refuse)
    g = torch.Generator().manual_seed(0)
    for t in range(8):
        _equal(tenv.observe(world, state, p), tenv.observe_plain(world, state, p),
               f"observe {t}")
        act = geo.rnd(waypoint_controller(state, world)
                      + torch.randn(state.pos.shape, generator=g, dtype=dtype), 2)
        got = tenv.step(world, state, act, p)
        _equal(got, tenv.step_plain(world, state, act, p), f"step {t}")
        state, out = got
        mask = out.done | (torch.rand(out.done.shape, generator=g) < 0.2)
        got = tenv.reset_where(world, state, mask)
        _equal(got, tenv.reset_where_plain(world, state, mask), f"reset {t}")
        state = got


# ---- the CPU: the passes' source compiled for the host ----

HOST_CUDA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")


@pytest.fixture(scope="module")
def host_passes(tmp_path_factory):
    """csrc/env_drones.cu built for the host by g++ (tests/host_cuda/ shims
    the CUDA names it uses; a launch runs every thread in turn), as the
    library the passes' launcher calls."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the passes for the host")
    with open(os.path.join(_build.CSRC_DIR, "env_drones.cu")) as f:
        src, n = re.subn(r"(env_drones_kernel<T, TA, \w+>)<<<blocks, THREADS, 0, s>>>\(\*p\)",
                         r"host_launch(blocks, THREADS, [&] { \1(*p); })", f.read())
    assert n == 6
    d = tmp_path_factory.mktemp("host_passes")
    cpp, so = d / "env_drones_host.cpp", d / "env_drones_host.so"
    cpp.write_text(src + "\nHostIndex threadIdx, blockIdx;\n")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{HOST_CUDA}", f"-I{_build.CSRC_DIR}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("name,act_dtype,setting", [
    ("flagship", None, None), ("world16_dense", None, None),
    ("world32_mix", torch.float32, None), ("lane", None, None), ("spheres", None, None),
    ("world16_dense", torch.float32, "noise"), ("world16_dense", None, "progress"),
    ("world16_dense", None, "eval_mode"), ("world16_dense", None, "no_parity_rounding")])
def test_passes_built_for_the_host_equal_plain_in_float64(host_passes, monkeypatch, name,
                                                          act_dtype, setting):
    """The passes' arithmetic and control flow on the CPU: float64, where
    the host's libm and PyTorch's CPU kernels part from the card's only
    in the last bits, so values within 1e-12 and every flag equal."""
    @contextlib.contextmanager
    def host_stream(device):
        assert device.type == "cpu"
        yield None

    monkeypatch.setitem(_build._LIBS, "env_drones", host_passes)
    monkeypatch.setattr(_build, "_stream", host_stream)
    monkeypatch.setattr(ed, "launches", 0)
    world, n = _world(name, "cpu", torch.float64, lanes=8)
    p = EnvParams(num_drones=n, **SETTINGS.get(setting, {}))
    worst, listed, resets, finished = _chain(world, p, torch.float64, act_dtype, "cpu",
                                             lanes=8, steps=30)
    assert resets > 0 and ed.launches > 0
    if name == "spheres":
        assert finished > 0


# ---- the card: the passes against the plain path ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, msg):
    """Flags and integers equal; floats with the same non-finite pattern
    and within 2 ulp of the larger value (float32) or 1e-12 (float64).
    Returns the largest |difference|."""
    if isinstance(got, tuple):
        assert len(got) == len(want), msg
        names = getattr(got, "_fields", range(len(got)))
        return max([_close(g, w, f"{msg}.{n}") for n, g, w in zip(names, got, want)] + [0.0])
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    if not want.is_floating_point():
        assert torch.equal(got, want), (msg, int((got != want).sum()))
        return 0.0
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), (msg, test.__name__)
    fin = torch.isfinite(want)
    g, w = got[fin], want[fin]
    if not g.numel():
        return 0.0
    diff = (g - w).abs()
    if want.dtype == torch.float64:
        assert float(diff.max()) <= 1e-12, (msg, float(diff.max()))
    else:
        big = torch.maximum(g.abs(), w.abs())
        ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
        assert bool((diff <= 2 * ulp).all()), (msg, float(diff.max()))
    return float(diff.max())


def _chain(world, p, dtype, act_dtype, device, lanes=LANES, steps=STEPS, seed=0):
    """The plain path's chain of `steps` steps (waypoint controller plus
    noise; resets where done, and every 7th step also where finished, at
    random and in lane 0; an observation every 5th), with the passes run
    on each of its states and held to it. Returns (largest |difference|,
    listed slots, resets, finished drone-steps)."""
    g = torch.Generator(device=device).manual_seed(seed)
    state = tenv.reset(world, p, (lanes,), dtype)
    worst = _close(tenv._observe_passes(world, state, p),
                   tenv.observe_plain(world, state, p), "observe")
    listed = resets = finished = 0
    for t in range(steps):
        act = geo.rnd(waypoint_controller(state, world)
                      + 0.5 * torch.randn(state.pos.shape, generator=g, device=device,
                                          dtype=dtype), 2).to(act_dtype or dtype)
        noise = (torch.randn(state.pos.shape, generator=g, device=device, dtype=dtype)
                 if p.noise else None)
        want = tenv.step_plain(world, state, act, p, noise)
        worst = max(worst, _close(tenv._step_passes(world, state, act, p, noise), want,
                                  f"step {t}"))
        state, out = want
        listed += int(out.obs_mask.sum())
        finished += int(out.finish.sum())
        mask = out.done.clone()      # finished drones fly on, frozen, to the 7th step
        if t % 7 == 3:
            mask |= out.finish | (torch.rand(mask.shape, generator=g, device=device) < 0.1)
            mask[0] = True           # a whole lane: the sphere obstacles reset too
        resets += int(mask.sum())
        want = tenv.reset_where_plain(world, state, mask)
        worst = max(worst, _close(tenv._reset_where_passes(world, state, mask), want,
                                  f"reset {t}"))
        state = want
        if t % 5 == 4:
            want = tenv.observe_plain(world, state, p)
            worst = max(worst, _close(tenv._observe_passes(world, state, p), want,
                                      f"observe {t}"))
    return worst, listed, resets, finished


DTYPES = [(torch.float32, None), (torch.float64, None), (torch.float64, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,act_dtype", DTYPES)
@pytest.mark.parametrize("name", ["flagship", "world16_dense", "world32_mix", "lane",
                                  "spheres"])
def test_passes_equal_plain_over_chained_steps(cuda, name, dtype, act_dtype):
    world, n = _world(name, cuda, dtype)
    p = EnvParams(num_drones=n)
    worst, listed, resets, finished = _chain(world, p, dtype, act_dtype, cuda)
    assert listed > 0 and resets > 0, (listed, resets)
    if name == "spheres":
        assert finished > 0


SETTINGS = {"noise": dict(noise=True), "safe_rewards": dict(safe_rewards=True),
            "progress": dict(mov_p_progress=0.7, safe_rewards=True),
            "eval_mode": dict(env_train=False),
            "no_parity_rounding": dict(parity_rounding=False)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_passes_equal_plain_under_settings(cuda, setting, dtype):
    world, n = _world("world16_dense", cuda, dtype)
    p = EnvParams(num_drones=n, **SETTINGS[setting])
    _chain(world, p, dtype, None, cuda)


def _profiled():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.gpu
def test_each_call_launches_only_the_passes_and_the_vo_kernel(cuda):
    from rvo3d_tpu_torch.utils import profiler

    world, n = _world("world32_mix", cuda, torch.float32)
    p = EnvParams(num_drones=n)
    state = tenv.reset(world, p, (64,))
    tenv.observe(world, state, p)                # builds the libraries
    act = torch.zeros_like(state.vel)
    calls = {"step": (lambda: tenv.step(world, state, act, p), {"pre": 1, "mid": 1, "post": 1}, 2),
             "observe": (lambda: tenv.observe(world, state, p), {"obs": 1, "post": 1}, 1),
             "reset_where": (lambda: tenv.reset_where(world, state, state.arrive_flag),
                             {"reset": 1}, 0)}
    for name, (call, passes, vo) in calls.items():
        profiler.clear()
        before, vo_before = ed.launches, vo_pairs.launches
        with _profiled() as prof:
            call()
            torch.cuda.synchronize()
        c = profiler.recorded().counters
        profiler.clear()
        assert ed.launches - before == sum(passes.values()), name
        assert vo_pairs.launches - vo_before == vo, name
        want = {f"env_drones.{k}.{x}": (1 if x == "launches" else 64 * n)
                for k in passes for x in ("launches", "rows")}
        assert {k: v for k, v in c.items() if k.startswith("env_drones.")} == want, name
        kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        assert kernels and all("env_drones_kernel" in k or "vo_pairs_kernel" in k
                               for k in kernels), (name, sorted(set(kernels)))


@pytest.mark.gpu
def test_graphed_eval_chunk_equals_eager_and_counts_the_passes(cuda):
    from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry, make_eval_chunk
    from rvo3d_tpu_torch.config import ModelConfig
    from rvo3d_tpu_torch.models import ActorCritic

    world, n = _world("world16_dense", cuda, torch.float32)
    p = EnvParams(num_drones=n)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    kw = dict(max_ep_len=10, std_factor=1.0, action_mode="direct")
    c0 = init_eval_carry(world, p, 32)
    g1 = torch.Generator(device=cuda).manual_seed(1)
    g2 = torch.Generator(device=cuda).manual_seed(1)
    chunk = make_eval_chunk(ac, world, p, chunk=16, **kw)
    before = ed.launches
    got = chunk(c0, g1)
    # a step: pre, mid, post; the reset; the re-observation's obs and post
    assert ed.launches - before == 6 * 16
    assert got[1].ended.any()
    _equal(got, eval_chunk(ac, world, p, c0, g2, 16, **kw), "chunk")


def test_chip_smoke_bound_counts_each_pass_bytes():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows, nm, slots = 16384 * 8, 10, 5000
    b = cs.env_drones_bound(rows, 4, 4, nm, slots)
    assert set(b) == {"pre", "mid", "post", "obs", "post_obs", "reset"}
    assert b["pre"]["bytes"] == rows * (6 * 4 + 4 + 12 * 4)
    assert b["post_obs"]["bytes"] == rows * (nm + 4 + 1) + 2 * slots * 9 * 4
    assert b["reset"]["bytes"] == rows * (1 + 2 * (11 * 4 + 7 + 12))
    for v in b.values():
        assert v["bound_ms"] == pytest.approx(v["bytes"] / cs.HBM_BYTES_S * 1e3)
    # float64 states move twice the floats; without parity rounding no obs_self
    b64 = cs.env_drones_bound(rows, 8, 4, nm, slots)
    assert b64["pre"]["bytes"] == rows * (6 * 8 + 4 + 12 * 8)
    assert cs.env_drones_bound(rows, 4, 4, nm, slots, parity=False)["obs"]["bytes"] \
        == b["obs"]["bytes"] - rows * 12 * 4
