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
kernel forward under autograd) against the same step on the CPU.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
Tolerance: atol 1e-4 in f32 with TF32 off (summation order over 265 terms
and 10 steps); gradients: max |card - CPU| <= 1e-3 of the largest |CPU|
gradient of each tensor, or, for the ActorCritic losses, no more than
twice the card's plain path's distance from the CPU (see that test)."""

import numpy as np
import pytest
import torch

from rvo3d_tpu_torch.config import EnvParams, ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.ops import masked_gru as mg

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
