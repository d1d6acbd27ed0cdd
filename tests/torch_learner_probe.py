"""The port's learner run eagerly on a CUDA card at full width, profiled:
the w16_r4 product's PPO update (128 x 16, T = 300, minibatch 16384) and a
BC step at B = 4096 on a world32_mix demo set (the RVO expert, 32 lanes x
32 drones x 25 steps). Prints one JSON line each: the eager update's
seconds, then per pi iteration, v iteration and BC step the wall ms, the
device's busy ms (kernels only: Adam's record_function span is left out),
the idle share, the kernels per call and the 12 ops with the most device
time. Every graph is off (utils/graphs.on_card says no after the rollout
that makes the batch), so this is the eager learner; chip_smoke.py's
`learner_graphs` phase measures the graphed learner beside it.

Run from the repo root on a machine with a card (no JAX needed):
    python3 tests/torch_learner_probe.py
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from rvo3d_tpu_torch.algo import bc, ppo  # noqa: E402
from rvo3d_tpu_torch.algo.rollout import RolloutBatch, make_rollout  # noqa: E402
from rvo3d_tpu_torch.algo.trainer import Trainer  # noqa: E402
from rvo3d_tpu_torch.config import from_dict  # noqa: E402
from rvo3d_tpu_torch.models import ActorCritic  # noqa: E402
from rvo3d_tpu_torch.utils import graphs  # noqa: E402
from rvo3d_tpu_torch.utils.profiler import trace  # noqa: E402
from rvo3d_tpu_torch.worlds import load_world  # noqa: E402


def profiled(fn, reset, n=5):
    """n calls of fn unprofiled (their wall time), then n profiled."""
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    reset()
    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = cs.cuda_ops(prof)
    busy = sum(cs.device_us(e) for e in ops) / 1e3
    return {"wall_ms_per_call": wall / n, "busy_ms_per_call": busy / n,
            "idle_share": 1 - busy / wall, "kernels_per_call": sum(e.count for e in ops) / n,
            "gru_ms_per_call": sum(cs.device_us(e) for e in ops
                                   if "masked_gru" in e.key) / 1e3 / n,
            "top": [(e.key[:60], cs.device_us(e) / 1e3 / n, e.count / n) for e in ops[:12]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_learner_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip(), "torch": torch.__version__}), flush=True)

    with open(cs.PRODUCT_CONFIG) as f:
        run_cfg = from_dict(json.load(f))
    product = torch.load(cs.PRODUCT_PARAMS, map_location="cpu", weights_only=True)
    world = load_world(run_cfg.world).spec(device=dev)
    tr = run_cfg.train
    trainer = Trainer(run_cfg, world, device=dev)
    trainer.ac.load_state_dict(product["state_dict"])
    _, rb = make_rollout(trainer.ac, world, run_cfg.env, tr)(trainer.carry)
    batch = RolloutBatch(*[x.clone() for x in rb])
    del trainer, rb
    graphs.on_card = lambda device: False       # the eager learner from here on

    ac = ActorCritic(run_cfg.model, device=dev)
    ac.load_state_dict(product["state_dict"])
    learner = ppo.PPOUpdate(ac, tr, *ppo.make_optimizers(tr, ac))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.prepare(batch)
    m = learner.update(torch.Generator().manual_seed(tr.seed))
    torch.cuda.synchronize()

    def reset():
        for t in (learner.i_pi, learner.i_v, learner.stopped):
            t.zero_()
    print(json.dumps({"update_eager_s": time.perf_counter() - t0,
                      "pi_iters": m.pi_iters.tolist(),
                      "pi_eager": profiled(learner._pi_body, reset),
                      "v_eager": profiled(learner._v_body, reset)}), flush=True)

    with open(cs.W32_CONFIG) as f:
        w32_cfg = from_dict(json.load(f))
    p32 = dataclasses.replace(w32_cfg.env, noise=False)
    data = bc.collect_demos(load_world("world32_mix").spec(device=dev), p32, 32, 25,
                            torch.Generator(device=dev).manual_seed(0), expert="rvo",
                            action_mode=w32_cfg.train.action_mode, explore_std=0.1,
                            expert_margin=0.3, expert_slowdown=True)
    n = data[0].shape[0]
    bac = ActorCritic(w32_cfg.model, generator=torch.Generator().manual_seed(0), device=dev)
    opt = bc.Adam([q for q in bac.parameters() if q.requires_grad], lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(0)

    def bc_step():
        idx = torch.randint(0, n, (4096,), generator=gen, device=dev)
        opt.zero_grad(set_to_none=True)
        bc.bc_loss(bac, data, idx).backward()
        opt.step()
    for _ in range(3):
        bc_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        bc_step()
    torch.cuda.synchronize()
    print(json.dumps({"bc_eager_ms_per_step_30": 1e3 * (time.perf_counter() - t0) / 30,
                      "set_rows": n, "bc_eager": profiled(bc_step, lambda: None)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
