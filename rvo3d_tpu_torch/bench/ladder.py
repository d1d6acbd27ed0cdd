"""Config-ladder rungs 4 and 5 (the port's counterpart of
scripts/ladder_bench.py), env-only stepping with the analytic controller
as in core.py:

  rung 4: world16_dense, 16 drones in dense conflict, 8192 lanes, 60 steps
  rung 5: world32_mix, 32 drones, 2048 lanes, 60 steps, two scenario
          populations in alternate lanes of one lane world

Both step through core.make_chunk (on a card, one captured step replayed).

    python -m rvo3d_tpu_torch.bench.ladder [--device cuda]

Writes runs_torch/bench/ladder_bench.json.
"""

from __future__ import annotations

import argparse
import json

import torch

from rvo3d_tpu_torch.bench.core import (bench_env, best_seconds, device_name, make_chunk,
                                        write_results)
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset
from rvo3d_tpu_torch.env.state import WorldSpec
from rvo3d_tpu_torch.utils.device import resolve_device
from rvo3d_tpu_torch.worlds import load_world
from rvo3d_tpu_torch.worlds.multi import stack_worlds, worlds_for_lanes

RUNG4_LANES, RUNG5_LANES, STEPS, REPEATS = 8192, 2048, 60, 2


def rung4(device="cuda") -> float:
    """Best env-steps/s of world16_dense at 8192 lanes (ladder_bench.py:33-42)."""
    wd = load_world("world16_dense")
    w16 = {"waypoints_list": wd.waypoints_list, "building_list": wd.building_list,
           "map_size": wd.map_size, "drone_num": wd.drone_num}
    return bench_env(w16, RUNG4_LANES, STEPS, REPEATS, device)[0]


def rung5_lane_worlds(num_envs: int, device="cuda",
                      dtype=torch.float32) -> WorldSpec:
    """world32_mix in the even lanes and its flipped variant in the odd
    ones. ladder_bench.py:59 flips the *padded* waypoint array
    (waypoints[:, ::-1, :]); that is not reverse_routes: a 2-point route
    padded to [a, b, b, b] becomes [b, b, b, a] with n_points still 2, so
    its drone starts on its destination. The flip is copied so that the
    port steps the JAX script's traffic."""
    spec = load_world("world32_mix").spec(dtype=dtype, device=device)
    flipped = spec._replace(waypoints=torch.flip(spec.waypoints, dims=[1]))
    return worlds_for_lanes(stack_worlds([spec, flipped]),
                            torch.arange(num_envs) % 2)


def rung5(device="cuda", num_envs: int = RUNG5_LANES, steps: int = STEPS,
          repeats: int = REPEATS) -> float:
    """Best env-steps/s of rung 5: a warm-up chunk, then `repeats` chunks
    each from the same reset state (ladder_bench.py:84-92)."""
    dev = resolve_device(device)
    lanes = rung5_lane_worlds(num_envs, dev)
    p = EnvParams(num_drones=lanes.num_drones)
    state = reset(lanes, p, (num_envs,))
    chunk = make_chunk(lanes, p)
    return num_envs * steps / best_seconds(lambda: chunk(state, steps), dev, repeats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    results = {"device": device_name(dev)}
    r16 = rung4(dev)
    results[f"world16_dense_E{RUNG4_LANES}_env_steps_per_sec"] = round(r16, 1)
    print(f"world16_dense E={RUNG4_LANES}: {r16:,.0f} env-steps/s", flush=True)
    r32 = rung5(dev)
    results[f"world32_mix_E{RUNG5_LANES}_env_steps_per_sec"] = round(r32, 1)
    print(f"world32_mix (2-scenario stacked) E={RUNG5_LANES}: {r32:,.0f} env-steps/s",
          flush=True)
    print(f"wrote {write_results(results, 'ladder_bench.json')}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
