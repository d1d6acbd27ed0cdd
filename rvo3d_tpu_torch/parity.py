"""Fixed-seed parity harness: the port's env against its NumPy oracle
(counterpart of rvo3d_tpu/parity.py).

Identical trajectories, rewards and episode flags under a scripted action
sequence. With x64 the env runs in float64 like the oracle and the
comparison is held to 1e-12; in float32 the maximum deviations are held to
the JAX harness's tolerances. The env runs on `device` (the card by
default), the oracle on the host:

    python -m rvo3d_tpu_torch.cli parity --x64 --device cuda
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset, reset_where, step
from rvo3d_tpu_torch.env.oracle import OracleEnv
from rvo3d_tpu_torch.utils.device import resolve_device
from rvo3d_tpu_torch.worlds import load_world

# x64: positions and rewards; float32: positions, rewards
TOL_X64 = 1e-12
TOL_F32_POS, TOL_F32_REWARD = 3e-5, 6e-3


def _spec_undefined(err: ValueError, env_train: bool) -> bool:
    """The oracle's eval-mode asin domain error: with env_train=False a
    neighbour inside r+mr but outside the shrunk collision radius, and
    approaching, takes asin of (r+mr)/dis > 1, and the reference raises
    there (rvo_inter.py:139-150, vel_obs3D.py:8-17). The env clamps the
    ratio to 1 by design (PARITY.md, known deviation 2), so that step has
    no reference value to compare with."""
    return not env_train and str(err) == "math domain error"


def _boundary_margin(oracle, i: int) -> float:
    """Min |signed distance| of drone i's post-step oracle state to any
    episode-flag decision boundary (map edge, drone/building collision
    radius, waypoint/destination goal threshold). In noise mode velocities
    are rounded to 2 decimals (drone.py:163), so positions ride exactly on
    such boundaries and the comparison is an ulp coin-flip there: those
    steps are knife-edge ties, not semantic mismatches."""
    d = oracle.drones[i]
    pos = np.asarray(d.state, float)
    m = min(abs(float(c)) for c in pos)
    m = min(m, min(abs(float(ms - c)) for ms, c in zip(oracle.map_size, pos)))
    for j, o in enumerate(oracle.drones):
        if j == i:
            continue
        dis = float(np.linalg.norm(pos - np.asarray(o.state, float)))
        m = min(m, abs(dis - (d.radius + o.radius)))
    for b in oracle.building_list:
        # each term is gated on the complementary half of the collision
        # predicate (dis2d <= r+R AND z <= h): the radial boundary decides
        # only under the roof, the height boundary only inside the
        # cylinder's footprint; the top rim is the distance to the rim circle
        dis2d = float(np.linalg.norm(pos[:2] - np.asarray(b[:2], float)))
        r_sum = float(b[3]) + d.radius
        if pos[2] <= float(b[2]):
            m = min(m, abs(dis2d - r_sum))
        if dis2d <= r_sum:
            m = min(m, abs(float(b[2]) - pos[2]))
        if pos[2] > float(b[2]) and dis2d > r_sum:
            m = min(m, float(np.hypot(dis2d - r_sum, pos[2] - float(b[2]))))
    m = min(m, abs(float(np.linalg.norm(pos - d.current_des)) - d.goal_threshold))
    m = min(m, abs(float(np.linalg.norm(pos - d.destination)) - d.goal_threshold))
    return m


def run_parity(worlds: List[str], steps: int = 200, x64: bool = False,
               seed: int = 7, env_train: bool = True, noise: bool = False,
               device="cuda") -> int:
    """Step the env on `device` and the oracle side by side on each world;
    print one [OK ]/[FAIL] line per world; 0 when every world passes.
    env_train=False exercises the eval-mode collision branch (exp_radius
    shrink, rvo_inter.py:139-150). noise=True hands the same control-noise
    samples, drawn from a CPU generator, to both implementations."""
    dev = resolve_device(device)
    dtype = torch.float64 if x64 else torch.float32
    overall_ok = True
    mode = ("train" if env_train else "eval") + ("+noise" if noise else "")

    for world_name in worlds:
        wd = load_world(world_name)
        p = EnvParams(num_drones=wd.drone_num, env_train=env_train, noise=noise)
        spec = wd.spec(dtype=dtype, device=dev)
        oracle = OracleEnv(wd, env_train=env_train)
        oracle.reset()
        state = reset(spec, p, (), dtype)

        rng = np.random.default_rng(seed)
        noise_gen = torch.Generator().manual_seed(seed + 101)
        n = wd.drone_num
        max_pos = max_rew = 0.0
        flags_ok = True
        episodes = 0
        ties = 0
        undefined = 0

        for _ in range(steps):
            des = np.stack([d.cal_des_vel() for d in oracle.drones])
            acts = np.round(des + 0.3 * rng.standard_normal((n, 3)), 2)

            z = torch.randn((n, 3), generator=noise_gen, dtype=dtype) if noise else None
            nvals = (z * p.control_std).numpy() if noise else None
            state, out = step(spec, state, torch.as_tensor(acts, dtype=dtype, device=dev),
                              p, None if z is None else z.to(dev))
            try:
                _, o_rew, o_done, o_info, o_fin = oracle.step(acts, nvals)
            except ValueError as e:
                if not _spec_undefined(e, env_train):
                    raise
                # nothing to compare this step with: restart the world in both
                undefined += 1
                oracle.reset()
                state = reset(spec, p, (), dtype)
                episodes += 1
                continue

            pos_err_i = np.max(np.abs(state.pos.cpu().numpy()
                                      - np.stack([d.state for d in oracle.drones])),
                               axis=-1)  # [N]
            t_rew = out.reward.cpu().numpy()
            both_fin = np.isfinite(np.asarray(o_rew)) & np.isfinite(t_rew)
            rew_err_i = np.where(both_fin, np.abs(np.asarray(o_rew) - t_rew), 0.0)
            td = out.done.cpu().tolist()
            tf = out.finish.cpu().tolist()
            ti = out.info_arrive.cpu().tolist()
            disagree = [i for i in range(n)
                        if td[i] != o_done[i] or tf[i] != o_fin[i] or ti[i] != o_info[i]]
            if disagree and all(_boundary_margin(oracle, i) < 1e-9 for i in disagree):
                # knife-edge tie: both sit on a decision boundary to within
                # float noise. The tied drones reset in both and leave this
                # step's error accounting; every other drone still counts.
                ties += 1
                mask = np.zeros(n, bool)
                mask[disagree] = True
                max_pos = max(max_pos, float(np.max(np.where(mask, 0.0, pos_err_i),
                                                    initial=0.0)))
                max_rew = max(max_rew, float(np.max(np.where(mask, 0.0, rew_err_i),
                                                    initial=0.0)))
                for i in disagree:
                    oracle.reset_one(i)
                state = reset_where(spec, state, torch.as_tensor(mask, device=dev))
                o_done = [d and not m for d, m in zip(o_done, mask)]
            else:
                max_pos = max(max_pos, float(np.max(pos_err_i)))
                max_rew = max(max_rew, float(np.max(rew_err_i)))
                flags_ok &= not disagree

            if any(o_done):
                mask = np.array(o_done)
                for i in range(n):
                    if mask[i]:
                        oracle.reset_one(i)
                state = reset_where(spec, state, torch.as_tensor(mask, device=dev))
                episodes += 1
            if all(o_fin):
                oracle.reset()
                state = reset(spec, p, (), dtype)
                episodes += 1

        tol_pos, tol_rew = (TOL_X64, TOL_X64) if x64 else (TOL_F32_POS, TOL_F32_REWARD)
        ok = flags_ok and max_pos <= tol_pos and max_rew <= tol_rew
        overall_ok &= ok
        status = "OK " if ok else "FAIL"
        tie_note = f", {ties} knife-edge tie(s)" if ties else ""
        if undefined:
            tie_note += (f", {undefined} step(s) the reference leaves undefined "
                         "(eval-mode asin domain error; world reset)")
        print(f"[{status}] {world_name} [{mode}]: {steps} steps, "
              f"{episodes} episode boundaries, max |pos err|={max_pos:.3e}, "
              f"max |reward err|={max_rew:.3e}, flags "
              f"{'exact' if flags_ok else 'MISMATCH'}{tie_note} "
              f"({'x64' if x64 else 'f32'})", flush=True)

    return 0 if overall_ok else 1
