"""The port on a card: the CUDA masked-GRU kernel against its plain torch
version at the shapes of the serving path (B = 256 lanes x 16 drones,
H = 256, S = 10), with a ragged B, an all-empty mask and the encoder's
strided reverse direction; the policy through the kernel against the same
policy on the CPU; and a short evaluate that must launch the kernel.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
Tolerance: atol 1e-4 in f32 with TF32 off (summation order over 265 terms
and 10 steps)."""

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
