"""The port on a card: the CUDA masked-GRU kernel against its plain torch
version at the shapes of the serving path (B = 256 lanes x 16 drones,
H = 256, S = 10), with a ragged B, an all-empty mask and the encoder's
strided reverse direction; over B in {1, 31, 2048, 4089, 4096, 65536} and
H in {32, 100, 256} with random, empty, full and env-like suffix masks, one
direction each way and both directions fused in one launch; the policy
through the kernel against the same policy on the CPU; a short evaluate
that must launch the kernel; and the training path's gradients (kernel
forward, plain backward) of masked_bigru_scan and of the ActorCritic pi-
and v-losses at B = 2048 (a rollout step of 128 lanes x 16 drones) and
16384 (the PPO minibatch) against the same on the CPU; the RVO expert on
a world32_mix lane world (float64: the same candidate indices as on the
CPU; float32: at most 1 % flips), and a BC fit step at B = 4096 (the
kernel forward under autograd) against the same step on the CPU; and the
four step loops as CUDA graphs (utils/graphs.py) against their eager
bodies on the card, bit for bit: the flagship bench chunk (float64 and
float32), the eval chunk (the kernel's launches counted through the
replays), two rollout epochs in both action modes, and PolicyServer.act
at B = 1, 64 and 4096, deterministic and stochastic; a capture made
while the garbage collector frees dropped graphs; and the learner's device
programs as CUDA graphs against their bodies called eagerly on the card,
bit for bit: two PPO updates of one PPOUpdate (biGRU-256, 2048 rows) with
the KL stop never firing, firing midway, and in the per-agent schedule
(params, both Adams' states, metrics), and 8 BC fit steps at B = 2048, the
replays after each capture run under torch.cuda.set_sync_debug_mode
("error"), so a host read left on those paths fails the test; and the
recorder (utils/profiler.py) on the card: the device stamps of the graphed
eval and rollout steps rise within and across steps and lie between eager
stamps taken just before and after each step, the eval masks kept from
the graphed chunk equal those its eager body ran, and MAX_GRAPHS + 1
shapes served in turn give one `serve.evict`, one `serve.capture` and a
device time on each `serve.replay`; and the env step's all-pairs VO kernel
(ops/vo_pairs.py) against the plain PyTorch path on the card, both modes,
float64 and float32: the four in-repo worlds flown by the noisy waypoint
controller (neighbours listed), dense clusters where every row flags more
than nm candidates with exact ties in both sort keys (M = 16, 32, 64), a
world with sphere obstacles (M > N), a two-world lane world, float32
actions beside float64 states, and the calls captured in a CUDA graph and
replayed; the env on the card never reaching the plain pair path; the
graphed eval and rollout steps launching it three times a step; and the
bench loop's records: the VO kernel's launch counters, empty with the
recorder off and counting each replay's launches with it on, and the
graphed bench step's device stamps written and in order.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
Tolerance: atol 1e-4 in f32 with TF32 off (summation order over 265 terms
and 10 steps); gradients: max |card - CPU| <= 1e-3 of the largest |CPU|
gradient of each tensor, or, for the ActorCritic losses, no more than
twice the card's plain path's distance from the CPU (see that test)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import vo_cases
from rvo3d_tpu_torch.config import EnvParams, ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.ops import masked_gru as mg
from rvo3d_tpu_torch.ops import vo_pairs

pytestmark = pytest.mark.gpu

S, IN, H = 10, 9, 256
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def gru_inputs(b, device, seed=0, empty=False):
    g = torch.Generator().manual_seed(seed)
    nbr = torch.randn(b, S, IN, generator=g)
    mask = (torch.rand(b, S, generator=g) > 0.4).float()
    if empty:
        mask.zero_()
    bound = 1.0 / H ** 0.5
    w = [torch.empty(shape).uniform_(-bound, bound, generator=g)
         for shape in ((IN, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    return [t.to(device) for t in (nbr, mask, *w)]


@pytest.mark.parametrize("b,empty,reverse", [(4096, False, False),
                                             (4096, False, True),
                                             (4096 - 7, False, True),
                                             (4096, True, False)])
def test_kernel_matches_plain(cuda, b, empty, reverse):
    nbr, mask, *w = gru_inputs(b, cuda, empty=empty)
    xs, ms = nbr.transpose(0, 1), mask.t()        # the encoder's strided views
    before = mg.launches
    got = mg.masked_gru_scan_cuda(xs, ms, *w, reverse=reverse)
    torch.cuda.synchronize()
    assert mg.launches == before + 1
    ref = mg.masked_gru_scan_plain(xs, ms, *w, reverse=reverse)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)


def masks(kind, b, g):
    if kind == "random":
        return (torch.rand(S, b, generator=g) > 0.4).float()
    if kind == "empty":
        return torch.zeros(S, b)
    if kind == "full":
        return torch.ones(S, b)
    # the env's layout: the valid neighbours fill the last k slots
    k = torch.randint(0, S + 1, (b,), generator=g)
    return (torch.arange(S)[:, None] >= S - k[None, :]).float()


@pytest.mark.parametrize("kind", ["random", "empty", "full", "suffix"])
@pytest.mark.parametrize("hidden", [32, 100, 256])
@pytest.mark.parametrize("b", [1, 31, 2048, 4089, 4096, 65536])
def test_kernel_matches_plain_over_shapes_and_masks(cuda, b, hidden, kind):
    g = torch.Generator().manual_seed(b * 1000 + hidden)
    nbr = torch.randn(b, S, IN, generator=g).to(cuda)
    mask = masks(kind, b, g).to(cuda)
    bound = 1.0 / hidden ** 0.5
    fwd, bwd = ([torch.empty(shape).uniform_(-bound, bound, generator=g).to(cuda)
                 for shape in ((IN, 3 * hidden), (hidden, 3 * hidden),
                               (3 * hidden,), (3 * hidden,))] for _ in range(2))
    xs = nbr.transpose(0, 1)
    before = mg.launches
    one = [mg.masked_gru_scan_cuda(xs, mask, *fwd, reverse=r) for r in (False, True)]
    both = mg.masked_bigru_scan_cuda(xs, mask, fwd, bwd)
    torch.cuda.synchronize()
    assert mg.launches == before + 3
    for r, got in zip((False, True), one):
        ref = mg.masked_gru_scan_plain(xs, mask, *fwd, reverse=r)
        torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    ref = mg.masked_bigru_scan_plain(xs, mask, fwd, bwd)
    torch.testing.assert_close(both, ref, rtol=0, atol=ATOL)
    if kind == "empty":
        assert torch.count_nonzero(both) == 0


@pytest.mark.parametrize("s_len", [64, 65, 130])
def test_kernel_matches_plain_past_one_window_of_steps(cuda, s_len):
    """The kernel reads which steps are active 64 at a time."""
    g = torch.Generator().manual_seed(s_len)
    b, hidden = 100, 64
    xs = torch.randn(s_len, b, IN, generator=g).to(cuda)
    mask = (torch.rand(s_len, b, generator=g) > 0.97).float()
    mask[:, :3] = 1.0
    mask = mask.to(cuda)
    bound = 1.0 / hidden ** 0.5
    fwd, bwd = ([torch.empty(shape).uniform_(-bound, bound, generator=g).to(cuda)
                 for shape in ((IN, 3 * hidden), (hidden, 3 * hidden),
                               (3 * hidden,), (3 * hidden,))] for _ in range(2))
    got = mg.masked_bigru_scan_cuda(xs, mask, fwd, bwd)
    torch.testing.assert_close(got, mg.masked_bigru_scan_plain(xs, mask, fwd, bwd),
                               rtol=0, atol=ATOL)


def test_empty_batch_launches_nothing(cuda):
    nbr, mask, *w = gru_inputs(0, cuda)
    before = mg.launches
    out = mg.masked_bigru_scan_cuda(nbr.transpose(0, 1), mask.t(), w, w)
    assert out.shape == (0, H) and mg.launches == before


def test_policy_on_card_matches_cpu(cuda):
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(1),
                     device=cuda)
    ac_cpu = ActorCritic(ModelConfig(), device="cpu")
    ac_cpu.load_state_dict(ac.state_dict())
    g = torch.Generator().manual_seed(2)
    obs_self = torch.randn(4096, 12, generator=g)
    nbr = torch.randn(4096, 10, 9, generator=g)
    mask = torch.rand(4096, 10, generator=g) > 0.5
    mask[:64] = False
    with torch.no_grad():
        got = ac(obs_self.to(cuda), nbr.to(cuda), mask.to(cuda))
        ref = ac_cpu(obs_self, nbr, mask)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.cpu(), r, rtol=0, atol=ATOL)


def test_evaluate_launches_kernel(cuda):
    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.worlds import load_world

    wd = load_world("gen_demo")
    ac = ActorCritic(ModelConfig(), device=cuda)
    before = mg.launches
    m = evaluate(ac, wd.spec(device=cuda), EnvParams(num_drones=wd.drone_num),
                 num_episodes=4, num_lanes=4, max_ep_len=20, chunk_len=20,
                 max_chunks=2)
    assert mg.launches > before
    assert m["episodes"] == 4 and np.isfinite(m["mean_speed"])


@pytest.mark.parametrize("b", [2048, 16384])
def test_bigru_grads_kernel_forward_match_cpu(cuda, b):
    g = torch.Generator().manual_seed(b)
    xs = torch.randn(S, b, IN, generator=g)
    mask = masks("suffix", b, g)
    bound = 1.0 / H ** 0.5
    w = [torch.empty(shape).uniform_(-bound, bound, generator=g)
         for _ in range(2) for shape in ((IN, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    up = torch.randn(b, H, generator=g)

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in [xs] + w]
        before = mg.launches
        out = mg.masked_bigru_scan(leaves[0], mask.to(device), leaves[1:5], leaves[5:])
        launched = mg.launches - before
        (out * up.to(device)).sum().backward()
        return [t.grad.cpu() for t in leaves], launched

    got, launched = grads(cuda)
    ref, _ = grads("cpu")
    assert launched == 1
    for i, (a, r) in enumerate(zip(got, ref)):
        assert (a - r).abs().max() <= 1e-3 * r.abs().max(), i


@pytest.mark.parametrize("b", [2048, 16384])
def test_actor_critic_loss_grads_match_cpu(cuda, b, monkeypatch):
    """The kernel path's pi- and v-loss gradients against the CPU's, with
    the card's plain path (the encoder's biGRU through the plain scans on
    the card) as the yardstick: at B = 16384 the card's float32 pi-loss
    gradients can differ from the CPU's by more than 1e-3 of a tensor's
    largest gradient with or without the kernel
    (tests/torch_grad_precision.py), so each tensor must be within 1e-3
    of its largest CPU gradient, or no further from the CPU than twice
    the card's plain path is."""
    import rvo3d_tpu_torch.models.encoder as encoder
    from rvo3d_tpu_torch.algo import ppo

    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(3),
                     device=cuda)
    ac_cpu = ActorCritic(ModelConfig(), device="cpu")
    ac_cpu.load_state_dict(ac.state_dict())
    g = torch.Generator().manual_seed(4)
    k = torch.randint(0, 11, (b, 1), generator=g)
    mask = torch.arange(10)[None, :] >= 10 - k
    nbr = torch.randn(b, 10, 9, generator=g) * mask[..., None]
    obs_self = torch.randn(b, 12, generator=g)
    with torch.no_grad():
        mu, std, v = ac_cpu(obs_self, nbr, mask)
        act = torch.round(mu + std * torch.randn(mu.shape, generator=g), decimals=2)
        logp = ac_cpu.logp(obs_self, nbr, mask, act)
    batch = ppo.AgentData(obs_self, nbr, mask, act, torch.randn(b, generator=g),
                          v + torch.randn(b, generator=g), logp, v)
    card_batch = ppo.AgentData(*[x.to(cuda) for x in batch])

    def grads(model, data):
        out = []
        for loss_fn in (lambda: ppo.pi_loss_fn(model, data, 0.2)[0],
                        lambda: ppo.v_loss_fn(model, data)):
            model.zero_grad(set_to_none=True)
            loss_fn().backward()
            out.append({n: p.grad.cpu() for n, p in model.named_parameters()
                        if p.grad is not None})
        return out

    before = mg.launches
    kernel = grads(ac, card_batch)
    assert mg.launches == before + 2
    with monkeypatch.context() as m:
        m.setattr(encoder, "masked_bigru_scan", mg.masked_bigru_scan_plain)
        plain = grads(ac, card_batch)
    assert mg.launches == before + 2
    for g_kernel, g_plain, g_cpu in zip(kernel, plain, grads(ac_cpu, batch)):
        assert g_kernel.keys() == g_cpu.keys() == g_plain.keys()
        for n, r in g_cpu.items():
            err = (g_kernel[n] - r).abs().max()
            yardstick = (g_plain[n] - r).abs().max()
            assert err <= max(1e-3 * r.abs().max(), 2 * yardstick) + 1e-12, (
                n, float(err), float(yardstick), float(r.abs().max()))


def _lane_world_states(device, dtype, lanes=8, steps=12):
    from rvo3d_tpu_torch.env import geometry as geo
    from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
    from rvo3d_tpu_torch.worlds import load_world
    from rvo3d_tpu_torch.worlds.multi import MultiWorldEnv, reverse_routes

    wd = load_world("world32_mix")
    spec = wd.spec(dtype=dtype, device=device)
    p = EnvParams(num_drones=wd.drone_num)
    env = MultiWorldEnv([spec, reverse_routes(spec)], torch.arange(lanes) % 2, p)
    st, _ = env.reset_batch()
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        noise = 0.3 * torch.randn(st.pos.shape, generator=g, dtype=dtype).to(device)
        st, out = env.step_batch(st, geo.rnd(waypoint_controller(st, env.lane_worlds)
                                             + noise, 2))
        st = env.reset_where_batch(st, out.done | out.finish)
    return env.lane_worlds, st, p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rvo_expert_on_card_matches_cpu(cuda, dtype):
    from rvo3d_tpu_torch.env.rvo_policy import rvo_choice

    (wc, sc, p), (wg, sg, _) = (_lane_world_states(d, dtype) for d in ("cpu", cuda))
    flips = total = 0
    for margin, slow in ((None, False), (0.3, True), (0.8, False)):
        ref, _ = rvo_choice(wc, sc, p, margin=margin, slowdown=slow)
        got, _ = rvo_choice(wg, sg, p, margin=margin, slowdown=slow)
        flips += int((got.cpu() != ref).sum())
        total += ref.numel()
    if dtype == torch.float64:
        assert flips == 0
    else:
        assert flips <= 0.01 * total, (flips, total)


def test_bc_fit_step_on_card_matches_cpu(cuda):
    """The BC loss (conflict weight 30) and its gradients at B = 4096 with
    the kernel forward against the CPU's plain path (1e-3 of each tensor's
    largest gradient), and a 3-step fit that launches the kernel once a
    step."""
    from rvo3d_tpu_torch.algo import bc

    g = torch.Generator().manual_seed(0)
    b, nm = 4096, 10
    k = torch.randint(0, 3, (b, 1), generator=g)
    mask = torch.arange(nm)[None, :] >= nm - k
    data = (torch.randn(b, 12, generator=g),
            torch.randn(b, nm, 9, generator=g) * mask[..., None], mask,
            torch.rand(b, 3, generator=g) * 2 - 1)
    idx = torch.randperm(b, generator=g)
    out = []
    for dev in ("cpu", cuda):
        ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(1),
                         device=dev)
        before = mg.launches
        loss = bc.bc_loss(ac, tuple(x.to(dev) for x in data), idx.to(dev), 30.0)
        loss.backward()
        out.append((float(loss), mg.launches - before,
                    {n: q.grad.cpu() for n, q in ac.named_parameters()
                     if q.grad is not None}))
    (loss_c, n_c, g_c), (loss_g, n_g, g_g) = out
    assert n_c == 0 and n_g == 1
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    assert g_g.keys() == g_c.keys()
    for name, ref in g_c.items():
        assert (g_g[name] - ref).abs().max() <= 1e-3 * ref.abs().max(), name
    ac = ActorCritic(ModelConfig(), device=cuda)
    before = mg.launches
    loss = bc.fit(ac, tuple(x.to(cuda) for x in data), b, 3, b, 1e-3, None,
                  indices=lambda s: idx)
    assert mg.launches - before == 3 and np.isfinite(loss)


# ---- the step loops as CUDA graphs (utils/graphs.py) against their eager
# bodies on the card: the same kernels in the same order on the same
# inputs, so every leaf must be equal bit for bit ----

def _equal_trees(a, b, msg=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), msg
    elif isinstance(a, tuple):
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            _equal_trees(x, y, f"{msg}.{name}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_bench_chunk_equals_eager(cuda, dtype, monkeypatch):
    from rvo3d_tpu_torch.bench import core
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.env.env import reset
    from rvo3d_tpu_torch.utils import graphs

    made, real = [], graphs.StepGraph
    monkeypatch.setattr(graphs, "StepGraph",
                        lambda *a: made.append(real(*a)) or made[-1])
    wd = flagship_world()
    world = core.world_spec(wd, cuda, dtype)
    p = EnvParams(num_drones=wd["drone_num"])
    s0 = reset(world, p, lead=(256,))
    chunk = core.make_chunk(world, p)
    got = chunk(chunk(s0, 20), 20)
    _equal_trees(got, core.run_chunk(world, s0, p, 40), "state")
    # one graph; 40 steps: the eager warm-up, then the capture's replay and 38 more
    assert [g.replays for g in made] == [39]


def test_graphed_eval_chunk_equals_eager(cuda):
    from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry, make_eval_chunk
    from rvo3d_tpu_torch.worlds import load_world

    wd = load_world("world16_dense")
    world = wd.spec(device=cuda)
    p = EnvParams(num_drones=wd.drone_num)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    kw = dict(max_ep_len=10, std_factor=1.0, action_mode="direct")
    c0 = init_eval_carry(world, p, 32)
    g1 = torch.Generator(device=cuda).manual_seed(1)
    g2 = torch.Generator(device=cuda).manual_seed(1)
    chunk = make_eval_chunk(ac, world, p, chunk=16, **kw)
    before, vo_before = mg.launches, vo_pairs.launches
    got = chunk(c0, g1)
    assert mg.launches - before == 16          # one biGRU launch a step, replays included
    # the VO kernel: the reward's pass, the step's observation, the reset's
    assert vo_pairs.launches - vo_before == 3 * 16
    _equal_trees(got, eval_chunk(ac, world, p, c0, g2, 16, **kw), "chunk")
    assert got[1].ended.any()


@pytest.mark.parametrize("mode", ["direct", "increment"])
def test_graphed_rollout_equals_eager(cuda, mode):
    from rvo3d_tpu_torch.algo.rollout import init_rollout_carry, make_rollout, rollout_epoch
    from rvo3d_tpu_torch.config import TrainConfig
    from rvo3d_tpu_torch.worlds import load_world

    wd = load_world("world16_dense")
    world = wd.spec(device=cuda)
    p = EnvParams(num_drones=wd.drone_num, noise=mode == "increment")
    cfg = TrainConfig(steps_per_epoch=12, num_envs=32, max_ep_len=8, action_mode=mode)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    runs = []
    for graphed in (True, False):
        carry = init_rollout_carry(world, p, 32, torch.Generator(device=cuda).manual_seed(2))
        roll = make_rollout(ac, world, p, cfg) if graphed else (
            lambda c: rollout_epoch(ac, world, p, cfg, c))
        batches = []
        vo_before = vo_pairs.launches
        for _ in range(2):
            carry, batch = roll(carry)
            batches.append(tuple(x.clone() for x in batch))
        assert vo_pairs.launches - vo_before == 3 * 2 * 12   # replays included
        runs.append((carry, batches))
    (c1, b1), (c2, b2) = runs
    _equal_trees(c1._replace(generator=None), c2._replace(generator=None), "carry")
    _equal_trees(tuple(b1), tuple(b2), "batches")


@pytest.mark.parametrize("deterministic", [True, False])
def test_graphed_act_equals_eager(cuda, deterministic):
    from rvo3d_tpu_torch.serving import PolicyServer

    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    srv = PolicyServer(ac, deterministic=deterministic, std_factor=0.5)
    rng = np.random.default_rng(0)
    for b in (1, 64, 4096, 64):
        obs = (rng.normal(size=(b, 12)).astype(np.float32),
               rng.normal(size=(b, 10, 9)).astype(np.float32), rng.random((b, 10)) > 0.5)
        gen = None if deterministic else torch.Generator(device=cuda).manual_seed(b)
        got = srv.act(*obs, generator=gen)
        x = [torch.as_tensor(o, device=cuda) for o in obs]
        eps = None if deterministic else torch.randn(
            b, 3, generator=torch.Generator(device=cuda).manual_seed(b), device=cuda)
        np.testing.assert_array_equal(got, srv.policy(*x, eps).cpu().numpy())
    assert len(srv._graphs) == 3


def test_a_capture_survives_the_collector_freeing_dropped_graphs(cuda):
    import gc

    from rvo3d_tpu_torch.utils import graphs

    x = torch.arange(8.0, device=cuda)
    loop = graphs.GraphedLoop(lambda c, i, t: (c * 2, None), cuda)
    old = gc.get_threshold()
    gc.disable()
    try:
        for _ in range(4):        # captured, then dropped in reference cycles
            graphs.GraphedLoop(lambda c, i, t: (c + 1, None), cuda)(x, 3)
        got, _ = loop(x, 1)       # the eager warm-up; nothing collected yet
        gc.set_threshold(1, 1, 1)
        gc.enable()               # the collector now runs at almost every allocation
        got, _ = loop(got, 3)     # captured and replayed
    finally:
        gc.set_threshold(*old)
        gc.enable()
    assert torch.equal(got, x * 16)


# ---- the learner's device programs (algo/ppo.PPOUpdate, algo/bc.fit) as
# CUDA graphs against their bodies called eagerly on the card, bit for bit;
# the replays run with host syncs turned into errors ----

def _learner_batch(ac, cuda, lead=(16, 8, 16), seed=0):
    """A rollout-like AgentData [T, E, N, ...] on the card: env-like
    suffix masks, actions around the policy's mean, their logp."""
    from rvo3d_tpu_torch.algo.ppo import AgentData

    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, 3, lead + (1,), generator=g)
    mask = torch.arange(S) >= S - k
    obs = [torch.randn(lead + (12,), generator=g),
           torch.randn(lead + (S, IN), generator=g) * mask[..., None], mask]
    obs = [x.to(cuda) for x in obs]
    with torch.no_grad():
        mu, std, v = ac(*obs)
        act = mu + std * torch.randn(lead + (3,), generator=g).to(cuda)
        logp = ac.logp(*obs, act)
    return AgentData(*obs, act, torch.randn(lead, generator=g).to(cuda),
                     torch.randn(lead, generator=g).to(cuda), logp, v)


def _learner_runs(cuda, monkeypatch, cfg, updates=2):
    """`updates` updates of one PPOUpdate from the same start, graphed and
    eager: per run the params, both Adams' states and the metrics; the
    graphed run's updates after the first (warm-up and capture) under
    set_sync_debug_mode("error")."""
    from rvo3d_tpu_torch.algo import ppo
    from rvo3d_tpu_torch.utils import graphs

    runs = []
    for graphed in (True, False):
        monkeypatch.setattr(graphs, "on_card", lambda device, g=graphed: g)
        ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0),
                         device=cuda)
        learner = ppo.PPOUpdate(ac, cfg, *ppo.make_optimizers(cfg, ac))
        gen = torch.Generator().manual_seed(3)
        metrics = []
        for i in range(updates):
            learner.load(_learner_batch(ac, cuda, seed=i))
            torch.cuda.synchronize()
            if graphed and i:
                torch.cuda.set_sync_debug_mode("error")
            try:
                metrics.append(learner.update(gen))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in ac.state_dict().items()},
                     [[{k: v.clone() for k, v in opt.state[p].items()}
                       for grp in opt.param_groups for p in grp["params"]]
                      for opt in (learner.pi_opt, learner.vf_opt)], metrics))
    return runs


def _kl_target_midway(cuda, monkeypatch, cfg):
    """A target_kl under the kl an update reaches after half its policy
    iterations when nothing stops it, so that the stop fires midway."""
    half = dataclasses.replace(cfg, train_pi_iters=cfg.train_pi_iters // 2,
                               target_kl=1e9)
    eager = _learner_runs(cuda, monkeypatch, half, updates=1)[1]
    return 0.9 * float(eager[2][0].kl[0])


@pytest.mark.parametrize("kind", ["stop_never", "stop_midway", "per_agent"])
def test_graphed_update_equals_eager(cuda, kind, monkeypatch):
    from rvo3d_tpu_torch.config import TrainConfig

    per_agent = kind == "per_agent"
    cfg = TrainConfig(train_pi_iters=8, train_v_iters=4, minibatch=64 if per_agent else 1024,
                      pi_lr=1e-3, target_kl=1e9, batched_update=not per_agent,
                      max_update_num=3)
    if kind == "stop_midway":
        cfg = dataclasses.replace(cfg, target_kl=_kl_target_midway(cuda, monkeypatch, cfg))
    (p1, s1, m1), (p2, s2, m2) = _learner_runs(cuda, monkeypatch, cfg)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for a, b in zip(s1, s2):                     # pi-Adam, vf-Adam
        for x, y in zip(a, b):
            _equal_trees(tuple(x.values()), tuple(y.values()), "adam")
    _equal_trees(tuple(m1), tuple(m2), "metrics")
    first = m1[0].pi_iters.tolist()
    if kind == "stop_midway":
        assert all(0 < i < cfg.train_pi_iters for i in first), first
    else:
        assert torch.cat([m.pi_iters for m in m1]).tolist() == [cfg.train_pi_iters] * (
            2 * len(first))


def test_graphed_bc_fit_equals_eager(cuda, monkeypatch):
    """A fit of 8 steps at B = 2048 of a 4096-row set, graphed and eager;
    the graphed fit's replays after the capture (steps 2-7) under
    set_sync_debug_mode("error")."""
    from rvo3d_tpu_torch.algo import bc
    from rvo3d_tpu_torch.utils import graphs

    g = torch.Generator().manual_seed(0)
    n, rows, steps = 4096, 2048, 8
    k = torch.randint(0, 3, (n, 1), generator=g)
    mask = torch.arange(S)[None, :] >= S - k
    data = tuple(x.to(cuda) for x in (torch.randn(n, 12, generator=g),
                                      torch.randn(n, S, IN, generator=g) * mask[..., None],
                                      mask, torch.rand(n, 3, generator=g) * 2 - 1))
    idx = [torch.randint(0, n, (rows,), generator=g).to(cuda) for _ in range(steps)]
    out = []
    for graphed in (True, False):
        monkeypatch.setattr(graphs, "on_card", lambda device, x=graphed: x)
        ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(1),
                         device=cuda)

        def indices(s, graphed=graphed):
            if graphed and s == 2:           # warm-up at 0, capture at 1
                torch.cuda.set_sync_debug_mode("error")
            return idx[s]
        torch.cuda.synchronize()
        before = mg.launches
        try:
            loss = bc.fit_steps(ac, data, n, steps, rows, 1e-3, None, 30.0, indices)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out.append((loss.item(), mg.launches - before,
                    {k: v.clone() for k, v in ac.state_dict().items()}))
    (l1, n1, p1), (l2, n2, p2) = out
    assert l1 == l2 and n1 == n2 == steps       # one launch a step, replays counted
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name


# ---- the recorder on a card (utils/profiler.py): the device stamps inside
# the graphed rollout and eval steps, the kept eval masks, the timed serving
# replays, and the capture and eviction spans past MAX_GRAPHS shapes ----

def _profiled():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.parametrize("loop", ["eval", "rollout"])
def test_stamps_rise_and_lie_inside_each_replay(cuda, loop, monkeypatch):
    from rvo3d_tpu_torch.algo.evaluator import init_eval_carry, make_eval_chunk
    from rvo3d_tpu_torch.algo.rollout import init_rollout_carry, make_rollout
    from rvo3d_tpu_torch.config import TrainConfig
    from rvo3d_tpu_torch.utils import graphs, profiler
    from rvo3d_tpu_torch.worlds import load_world

    steps = 12
    outer = torch.zeros((steps, 3), dtype=torch.int64, device=cuda)
    at = torch.zeros(1, dtype=torch.int64, device=cuda)
    made = []

    class Bracketed(graphs.StepGraph):
        """Eager stamps on the stream just before and after each step."""

        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)

        def step(self):
            profiler.stamp(outer, at, 0)
            super().step()
            profiler.stamp(outer, at, 2)
            at.add_(1)
    monkeypatch.setattr(graphs, "StepGraph", Bracketed)
    wd = load_world("world16_dense")
    world = wd.spec(device=cuda)
    p = EnvParams(num_drones=wd.drone_num)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    if loop == "eval":
        chunk = make_eval_chunk(ac, world, p, max_ep_len=5, chunk=steps,
                                action_mode="direct")
        gen = torch.Generator(device=cuda).manual_seed(1)
        run = lambda: chunk(init_eval_carry(world, p, 32), gen)  # noqa: E731
    else:
        cfg = TrainConfig(steps_per_epoch=steps, num_envs=32, max_ep_len=5)
        roll = make_rollout(ac, world, p, cfg)
        run = lambda: roll(init_rollout_carry(  # noqa: E731
            world, p, 32, torch.Generator(device=cuda).manual_seed(2)))

    def check(got):
        torch.cuda.synchronize()
        got, out = got.tolist(), outer.tolist()
        assert len(got) == steps
        for t, (start, policy, end) in enumerate(got):
            assert out[t][0] <= start < policy < end <= out[t][2], (t, got[t], out[t])
            if t:
                assert got[t - 1][2] <= start
        at.zero_()
    run()            # the eager warm-up, the capture's replay and 10 more
    check(made[0].body.__self__.stamps.clone())
    profiler.clear()
    with _profiled():
        run()        # 12 replays, the stamps kept
    (got,) = profiler.recorded().kept[f"{loop}.stamps"]
    profiler.clear()
    check(got)


def test_kept_eval_masks_equal_those_the_eager_loop_ran(cuda):
    from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry, make_eval_chunk
    from rvo3d_tpu_torch.utils import profiler
    from rvo3d_tpu_torch.worlds import load_world

    wd = load_world("world16_dense")
    world = wd.spec(device=cuda)
    p = EnvParams(num_drones=wd.drone_num)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    kw = dict(max_ep_len=4, std_factor=1.0, action_mode="direct")
    c0 = init_eval_carry(world, p, 32)
    chunk = make_eval_chunk(ac, world, p, chunk=10, **kw)
    chunk(c0, torch.Generator(device=cuda).manual_seed(5))     # warm-up and capture
    kept = []
    for graphed in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(1)
        profiler.clear()
        with _profiled():
            if graphed:
                chunk(c0, gen)
            else:
                eval_chunk(ac, world, p, c0, gen, 10, **kw)
        kept.append(profiler.recorded().kept["eval.obs_mask"])
    profiler.clear()
    assert len(kept[0]) == len(kept[1]) == 10
    for t, (a, b) in enumerate(zip(*kept)):
        assert torch.equal(a, b), t


def test_past_max_graphs_one_shape_is_evicted_and_one_captured(cuda):
    from rvo3d_tpu_torch import serving
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils import profiler

    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0), device=cuda)
    srv = PolicyServer(ac)
    rng = np.random.default_rng(0)

    def obs(b):
        return (rng.normal(size=(b, 12)).astype(np.float32),
                rng.normal(size=(b, 10, 9)).astype(np.float32), rng.random((b, 10)) > 0.5)
    sizes = [8 * (i + 1) for i in range(serving.MAX_GRAPHS + 1)]
    for b in sizes[:-1]:
        for _ in range(2):                     # eager warm-up, then the capture
            srv.act(*obs(b))
    profiler.clear()
    with _profiled():
        for _ in range(2):
            x = obs(sizes[-1])
            got = srv.act(*x)
            want = srv.policy(*[torch.as_tensor(o, device=cuda) for o in x]).cpu().numpy()
            np.testing.assert_array_equal(got, want)
    spans = profiler.recorded().spans
    profiler.clear()
    evicts = [s for s in spans if s.name == "serve.evict"]
    captures = [s for s in spans if s.name == "serve.capture"]
    assert len(evicts) == 1 and evicts[0].attrs["shape"][0] == (sizes[0], 12)
    assert len(captures) == 1 and captures[0].attrs["shape"][0] == (sizes[-1], 12)
    replays = [s for s in spans if s.name == "serve.replay"]
    assert len(replays) == 2 and all(s.attrs["device_ms"] > 0 for s in replays)
    assert len(srv._graphs) == serving.MAX_GRAPHS


# ---- the env step's all-pairs VO kernel (ops/vo_pairs.py) against the
# plain PyTorch path on the card, on inputs where neighbours are listed.
# The kernel repeats the plain path's IEEE-rounded operations in their
# order, so the two should agree bit for bit. The tolerances leave room for
# the CUDA math library's asin and acos of the toolkit that built the
# kernel against those of the one that built PyTorch's kernels: 1e-12 in
# float64 (each within an ulp, ~1e-16, of a value below 10^3) and 2 ulp of
# the larger value in float32 (an ulp each side). Flags, masks, the
# non-finite pattern and the selected slots must be equal. ----

def _vo_close(got, want, dtype, what):
    for name, g, w in zip(got._fields, got, want):
        msg = f"{what}: {name}"
        assert g.shape == w.shape and g.dtype == w.dtype, msg
        if g.dtype == torch.bool:
            assert torch.equal(g, w), msg
            continue
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(g), test(w)), msg
        fin = torch.isfinite(w)
        g, w = g[fin], w[fin]
        if not g.numel():
            continue
        if dtype == torch.float64:
            err = float((g - w).abs().max())
            assert err <= 1e-12, (msg, err)
        else:
            big = torch.maximum(g.abs(), w.abs())
            ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
            assert bool(((g - w).abs() <= 2 * ulp).all()), (msg, float((g - w).abs().max()))


def _vo_check(states, actions, bld, bmask, p, others=None, what=""):
    """Both modes by the kernel against the plain path, all on the card;
    returns the observation's listed slots."""
    from rvo3d_tpu_torch.env import rvo

    before = vo_pairs.launches
    got_r = rvo.vo_reward_info(states, actions, p, others)
    got_o = rvo.vo_observe(states, actions, bld, bmask, p, others)
    assert vo_pairs.launches - before == 2
    _vo_close(got_r, rvo.vo_reward_info_plain(states, actions, p, others),
              states.dtype, f"{what} reward")
    _vo_close(got_o, rvo.vo_observe_plain(states, actions, bld, bmask, p, others),
              states.dtype, f"{what} observe")
    return int(got_o.obs_mask.sum())


def _on(device, *xs):
    return [None if x is None else x.to(device) for x in xs]


def _world(name, device, dtype):
    from rvo3d_tpu_torch.bench import core
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.worlds import load_world

    if name == "flagship":
        wd = flagship_world()
        return core.world_spec(wd, device, dtype), wd["drone_num"]
    wd = load_world(name)
    return wd.spec(dtype=dtype, device=device), wd.drone_num


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["gen_demo", "world16_dense", "world32_mix", "flagship"])
def test_vo_kernel_matches_plain_on_flown_worlds(cuda, name, dtype):
    from rvo3d_tpu_torch.env.env import DroneEnv

    world, n = _world(name, "cpu", dtype)
    card, _ = _world(name, cuda, dtype)
    p = EnvParams(num_drones=n)
    listed = 0
    for t, (s12, act, others) in enumerate(
            vo_cases.flown_inputs(DroneEnv(world, p, num_envs=256, dtype=dtype), world, p)):
        listed += _vo_check(*_on(cuda, s12, act), card.buildings, card.building_mask, p,
                            _on(cuda, others)[0], what=f"{name} step {2 * t}")
    assert listed > 0


@pytest.mark.parametrize("dtype,act_dtype", [(torch.float64, None), (torch.float32, None),
                                             (torch.float64, torch.float32)])
@pytest.mark.parametrize("dims,env_train", vo_cases.CLUSTERS)
def test_vo_kernel_matches_plain_on_dense_clusters(cuda, dims, env_train, dtype, act_dtype):
    states, actions, bld, bmask = vo_cases.dense_cluster(dims, dtype, act_dtype=act_dtype)
    p = EnvParams(num_drones=states.shape[-2], env_train=env_train)
    listed = _vo_check(*_on(cuda, states, actions, bld, bmask), p, what=str(dims))
    assert listed == states.shape[0] * states.shape[1] * p.neighbor_num


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("parity", [True, False])
def test_vo_kernel_matches_plain_with_spheres(cuda, dtype, parity):
    from rvo3d_tpu_torch.env.env import DroneEnv
    from rvo3d_tpu_torch.env.state import make_world_spec

    world, card = (make_world_spec(vo_cases.SPHERE_WAYPOINTS, vo_cases.SPHERE_BUILDINGS,
                                   vo_cases.SPHERE_MAP, spheres=vo_cases.SPHERES,
                                   dtype=dtype, device=d) for d in ("cpu", cuda))
    p = EnvParams(num_drones=12, parity_rounding=parity)
    listed = 0
    for s12, act, others in vo_cases.flown_inputs(DroneEnv(world, p, num_envs=64, dtype=dtype),
                                                  world, p):
        assert others.shape[-2] == 15
        listed += _vo_check(*_on(cuda, s12, act), card.buildings, card.building_mask, p,
                            others.to(cuda), what="spheres")
    assert listed > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vo_kernel_matches_plain_on_a_lane_world(cuda, dtype):
    from rvo3d_tpu_torch.worlds import load_world
    from rvo3d_tpu_torch.worlds.multi import MultiWorldEnv, reverse_routes

    wd = load_world("world16_dense")
    p = EnvParams(num_drones=wd.drone_num)

    def specs(device):
        a = wd.spec(dtype=dtype, device=device)
        b = reverse_routes(a)     # another building set, one fewer (padded, masked)
        moved = b.buildings[:-1] + torch.tensor([1.0, -1.0, 0.0, 0.0], dtype=dtype,
                                                device=device)
        return [a, b._replace(buildings=moved, building_mask=b.building_mask[:-1])]
    env = MultiWorldEnv(specs("cpu"), torch.arange(64) % 2, p)
    card = MultiWorldEnv(specs(cuda), torch.arange(64) % 2, p).lane_worlds
    assert card.buildings.dim() == 3 and not torch.equal(card.buildings[0], card.buildings[1])
    listed = 0
    for s12, act, _ in vo_cases.flown_inputs(env, env.lane_worlds, p, lane_world=True):
        listed += _vo_check(*_on(cuda, s12, act), card.buildings, card.building_mask, p,
                            what="lane world")
    assert listed > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vo_kernel_captured_in_a_graph_and_replayed(cuda, dtype):
    from rvo3d_tpu_torch.env import rvo
    from rvo3d_tpu_torch.env.env import DroneEnv
    from rvo3d_tpu_torch.ops import _build
    from rvo3d_tpu_torch.utils.graphs import StepGraph

    world, n = _world("world32_mix", "cpu", dtype)
    card, _ = _world("world32_mix", cuda, dtype)
    p = EnvParams(num_drones=n)
    kept = vo_cases.flown_inputs(DroneEnv(world, p, num_envs=64, dtype=dtype), world, p)
    states, actions = _on(cuda, *kept[0][:2])
    out = {}

    def body():
        out["reward"] = rvo.vo_reward_info(states, actions, p)
        out["observe"] = rvo.vo_observe(states, actions, card.buildings,
                                        card.building_mask, p)
    graph = StepGraph(body, cuda)
    listed = 0
    for t, (s12, act, _) in enumerate(kept):
        states.copy_(s12)
        actions.copy_(act)
        before = vo_pairs.launches
        graph.step()      # the eager warm-up, then the capture's replay, then replays
        assert vo_pairs.launches - before == 2, t
        _vo_close(out["reward"], rvo.vo_reward_info_plain(states, actions, p), dtype,
                  f"replay {t} reward")
        want = rvo.vo_observe_plain(states, actions, card.buildings, card.building_mask, p)
        _vo_close(out["observe"], want, dtype, f"replay {t} observe")
        listed += int(want.obs_mask.sum())
    assert graph.replays == len(kept) - 1 and listed > 0
    assert [name for add, name, _ in graph.counts
            if add is _build.add_launches] == ["vo_pairs"] * 2


def test_env_on_the_card_never_takes_the_plain_pair_path(cuda, monkeypatch):
    from rvo3d_tpu_torch.env import rvo
    from rvo3d_tpu_torch.env.env import DroneEnv

    def refuse(*args, **kwargs):
        raise AssertionError("CUDA tensors reached the plain pair path")
    monkeypatch.setattr(rvo, "pairwise_vo", refuse)
    world, n = _world("world16_dense", cuda, torch.float32)
    env = DroneEnv(world, EnvParams(num_drones=n), num_envs=4)
    before = vo_pairs.launches
    state, _ = env.reset()                               # an observation
    state, out = env.step(state, torch.zeros_like(state.vel))   # the reward's, the step's
    env.observe(state)
    torch.cuda.synchronize()
    assert vo_pairs.launches - before == 4
    with pytest.raises(AssertionError, match="plain pair path"):
        rvo.vo_observe_plain(state.pos.new_zeros(4, n, 12), state.vel,
                             world.buildings, world.building_mask, env.params)


# ---- the bench loop's records (the `sim` cell's): the VO kernel's launch
# counters through graph replays and the graphed bench step's stamps ----

def _flagship_chunk(cuda, lanes=256):
    from rvo3d_tpu_torch.bench import core
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.env.env import reset

    world = core.world_spec(flagship_world(), cuda)
    p = EnvParams(num_drones=8)
    chunk = core.make_chunk(world, p)
    return chunk, chunk(reset(world, p, lead=(lanes,)), 3)   # warm-up, capture, replay


def test_vo_counters_count_graph_replays(cuda):
    from rvo3d_tpu_torch.utils import profiler

    chunk, state = _flagship_chunk(cuda)
    profiler.clear()
    state = chunk(state, 5)                       # recorder off: nothing counted
    assert profiler.recorded().counters == {}
    before = vo_pairs.launches
    with _profiled():
        chunk(state, 10)                          # 10 replays, 2 launches each
    c = profiler.recorded().counters
    profiler.clear()
    assert vo_pairs.launches - before == 20
    for mode in ("reward", "observe"):
        assert c[f"vo_pairs.{mode}.launches"] == 10
        assert c[f"vo_pairs.{mode}.rows"] == 10 * 256 * 8
        assert c[f"vo_pairs.{mode}.pairs"] == 10 * 256 * 8 * 8
    assert c["vo_pairs.observe.slots"] == 10 * 256 * 8 * 10
    assert c["vo_pairs.observe.buildings"] == 10


def test_bench_stamps_are_written_in_order(cuda):
    from rvo3d_tpu_torch.utils import profiler

    chunk, state = _flagship_chunk(cuda)
    profiler.clear()
    with _profiled():
        chunk(state, 12)
    (got,) = profiler.recorded().kept["bench.stamps"]
    profiler.clear()
    got = got.tolist()
    assert len(got) == 12
    for t, (start, mark, end) in enumerate(got):
        assert 0 < start < mark < end, (t, got[t])
        if t:
            assert got[t - 1][2] <= start
