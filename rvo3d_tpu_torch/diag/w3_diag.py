"""Deterministic-clone diagnosis (counterpart of scripts/w3_diag.py).

A BC clone can succeed with its Gaussian's noise (std factor 1) and fail
deterministically: the mean breaks at a crossing that noise-broken
symmetry gets through. This script trains the clone once and saves its
params, then traces the deterministic rollout (the evaluator's
round(mu, 2)) step by step: per-drone positions, waypoint indices, the
minimum pairwise distance, and the expert's command at the same states --
to show where and why the mean fails (collision, overshoot, freeze).

    python -m rvo3d_tpu_torch.diag.w3_diag [world] [params.pt] [--reuse] [--device cuda]

The params file is the clone's state dict (torch.save); it defaults to
<temp dir>/<world>_bc_torch.pt, and --reuse reads it back instead of
training when it exists.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from rvo3d_tpu_torch.config import EnvParams, ModelConfig
from rvo3d_tpu_torch.diag.bc_trace import clone_rvo, closed_loop, fresh_policy, step_summary
from rvo3d_tpu_torch.env.state import WorldSpec
from rvo3d_tpu_torch.models import ActorCritic


def trace(ac: ActorCritic, world: WorldSpec, p: EnvParams, steps: int = 80) -> None:
    for t, (state, out, a, ea) in enumerate(closed_loop(ac, world, p, steps)):
        pos, wp, d0, fin, done = step_summary(world, state, out)
        n = pos.shape[0]
        dmat = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        dmat[np.arange(n), np.arange(n)] = np.inf
        print(f"t={t:3d} wp={wp} |d_wp|={np.round(d0, 2)} "
              f"min_pair={dmat.min():.2f} fin={fin} done={done}", flush=True)
        for i in range(n):
            print(f"    d{i} pos={np.round(pos[i], 2)} "
                  f"a={np.round(a[i], 2)} "
                  f"ea={np.round(ea[i], 2)}", flush=True)
        if fin.all() or done.any():
            print("episode end", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", nargs="?", default="world_3")
    ap.add_argument("params", nargs="?", default=None)
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path = args.params or os.path.join(tempfile.gettempdir(),
                                       f"{args.world}_bc_torch.pt")
    ac, world, p = fresh_policy(args.world, ModelConfig(log_std_init=-2.3), args.device)
    if args.reuse and os.path.exists(path):
        ac.load_state_dict(torch.load(path, map_location=world.device, weights_only=True))
        print(f"reused params from {path}", flush=True)
    else:
        loss = clone_rvo(ac, world, p, 2000, 0.1)
        print(f"BC loss {loss:.5f}", flush=True)
        torch.save(ac.state_dict(), path)
    trace(ac, world, p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
