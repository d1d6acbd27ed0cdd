"""The env and the rollout lifecycle of the plain reference: the frozen
oracle (reference/oracle.py) driven lane by lane, its observations laid
out as the policy reads them, and the two checks the cells make with it.

  - `replay_lane`: a training lane replayed from its reset with the
    actions the program recorded; the lifecycle is the upstream rollout's
    (multi_ppo.training_loop as the configuration states it): a collided
    drone resets; a lane whose drones all arrived, or whose epoch ends,
    resets whole; otherwise, where any drone finished or ran past
    max_ep_len, those drones reset; the path is cut after the step in the
    last two cases and at the epoch's end; a lane that reset anything is
    observed anew (zero action). Compared: each step's rewards, the cut and
    the next observation.
  - `step_from`: one evaluation step of a lane from the program's state
    (the evaluator's lifecycle: the episode ends on any collision, at
    max_ep_len or when every drone finished). Compared: the step's record.
  - `obs_check`: a lane's observation as the program holds it beside its
    state, held to what the state alone decides. An observation after a
    step depends on that step's action too (a neighbour is listed only
    while the action keeps it inside its VO cone, and the cone's expected
    collision time reads the action), and the evaluation window keeps no
    action from before a call. So compared are: each drone's own 12
    entries; each listed neighbour's first 8 entries (the cone's apex,
    the relative position, the half-angle, the distance), which have to
    be those of one other drone that the state makes a candidate (within
    range, approaching, not colliding), each drone listed once; its
    expected-time entry inside the range a listed neighbour has; the
    listed slots last and in ascending urgency.

The program steps in float32, the oracle in float64, and the env is
discontinuous (decimal roundings, flags, reward buckets, the VO cone's
rounded angles). Observations one 2-decimal step off and rewards up to
two 3-decimal steps off are rounding. A step that disagrees by more is
tried again from perturbed copies of the oracle's state, each drone moved
by float32's distance from it (`perturb`), and with the action moved by
`ACT_DELTA`, over float32's spacing of a 2-decimal action: a 2-decimal
action square to a 3-decimal desired velocity has a dot product of 0 in
decimals, and float32 and float64 give it opposite signs, so the angle
reward's bucket at 90 degrees (0 or -4) splits them. Where one agrees, the
step was a knife-edge tie, not a fault: it is counted, and a replay stops
there (after it the two lanes need not agree).
"""

from __future__ import annotations

import copy
import json
import os
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np

from benchmark.reference.oracle import OracleEnv

# the oracle's hard-coded constants, which a configuration must match
ORACLE_ENV = {"goal_threshold": 0.4, "dt": 1.0, "vel_max": 1.0, "max_acc": 1.0,
              "max_angle_change": 90.0, "drone_range": 10.0, "building_range": 5.0,
              "building_z_slack": 2.0, "noise": False, "rvo_p_base": -2.5,
              "rvo_p_urgent": -8.0, "mov_p_way": 3.0, "mov_p_dest": 20.0,
              "mov_p_exlen": -0.3, "mov_collision": -50.0, "mov_p_progress": 0.0,
              "parity_rounding": True}
FLIP = 0.01 + 1e-4      # one step of 2-decimal rounding, and float32 noise
# two steps of the rewards' 3-decimal rounding (the rvo and the movement
# term are rounded apart), and float32 noise
REWARD_TOL = 0.002 + 1e-4
FLAGS = ("ended", "success", "all_info", "ep_len")
ACT_DELTA = 1e-6


def load_world(path: str) -> SimpleNamespace:
    with open(os.path.join(path, "data_1.json")) as f:
        d = json.load(f)
    return SimpleNamespace(drone_num=int(d["drone_num"]), map_size=d["map_size"],
                           waypoints_list=d["waypoints_list"],
                           n_points_list=d["n_points_list"],
                           building_list=d["building_list"])


def make_oracle(world, env: dict) -> OracleEnv:
    bad = {k: env.get(k) for k, v in ORACLE_ENV.items() if env.get(k, v) != v}
    if bad:
        raise ValueError(f"the reference env holds other constants than {bad}")
    return OracleEnv(world, neighbor_num=env["neighbor_num"], env_train=env["env_train"],
                     exp_radius=env["exp_radius"], ctime_threshold=env["ctime_threshold"],
                     delta_t=env["delta_t"], radius=env["radius"],
                     priority=env["priority"], safe_rewards=env["safe_rewards"])


def policy_obs(obs_list, nm: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The oracle's flat observations (12 + 9k each) as (self [N, 12],
    neighbours [N, nm, 9], mask [N, nm]): the k blocks in the last k slots,
    an all-zero block being padding."""
    n = len(obs_list)
    obs_self = np.zeros((n, 12))
    nbr = np.zeros((n, nm, 9))
    mask = np.zeros((n, nm), bool)
    for i, o in enumerate(obs_list):
        o = np.asarray(o, float)
        obs_self[i] = o[:12]
        blocks = o[12:].reshape(-1, 9)
        k = len(blocks)
        nbr[i, nm - k:] = blocks
        mask[i, nm - k:] = ~np.all(blocks == 0, axis=-1)
    return obs_self, nbr, mask


def obs_mismatch(ref, prog) -> Tuple[int, int]:
    """(entries beyond one rounding step, entries one rounding step off) of
    the program's observation `prog` against the reference's `ref`, each
    (self, neighbours, mask); neighbours are compared where both masks
    hold, and a mask entry that differs counts as beyond."""
    (rs, rn, rm), (ps, pn, pm) = ref, prog
    both = rm & pm
    d = np.concatenate([np.abs(rs - ps).ravel(), np.abs(rn - pn)[both].ravel()])
    beyond = int((d > FLIP).sum()) + int((rm != pm).sum())
    return beyond, int(((d > 1e-4) & (d <= FLIP)).sum())


def perturb(oracle: OracleEnv, rng: np.random.Generator, delta: float) -> None:
    """Every drone's position, velocity, yaw and pitch (degrees) moved by up
    to `delta`: float32's distance from the float64 state, so a step that
    lands elsewhere under it sits on a discontinuity of the env (a
    rounding, a flag, a reward bucket)."""
    for d in oracle.drones:
        d.state = d.state + rng.uniform(-delta, delta, 3)
        d.vel = d.vel + rng.uniform(-delta, delta, 3)
        d.yaw += float(rng.uniform(-delta, delta))
        d.pitch += float(rng.uniform(-delta, delta))


def tie_search(snapshot, advance, agrees, rng: np.random.Generator, delta: float,
               tries: int, n_act: int = 0):
    """The first of `tries` perturbed copies of `snapshot` whose step
    (`advance(copy, jitter)`, jitter [n_act, 3] within ACT_DELTA to add to
    the action, or None where there is no action) agrees with the program,
    as (copy, result), or None."""
    for _ in range(tries):
        trial = copy.deepcopy(snapshot)
        perturb(trial[0] if isinstance(trial, tuple) else trial, rng, delta)
        jitter = rng.uniform(-ACT_DELTA, ACT_DELTA, (n_act, 3)) if n_act else None
        res = advance(trial, jitter)
        if agrees(res):
            return trial, res
    return None


def replay_lane(world, env: dict, max_ep_len: int, lane: Dict[str, np.ndarray],
                steps: int, tie: dict) -> dict:
    """Replay one training lane from its reset. `lane` holds the program's
    records of that lane for the epoch: obs_self [T, N, 12], obs_nbr
    [T, N, nm, 9], obs_mask [T, N, nm], act [T, N, 3] (the absolute
    actions), rew [T, N], cut [T]. A step whose rewards, cut or next
    observation disagree is tried again from perturbed copies of the
    oracle's state before it (`tie`: delta, tries, seed, and `searches`,
    the most tie searches a lane gets); one that agrees is a knife-edge
    tie, and the replay stops there. Returns the widest reward gap, the
    entries and flags beyond a rounding step, the one-step flips, the steps
    compared and whether a tie stopped the replay."""
    nm = env["neighbor_num"]
    t_len = lane["act"].shape[0]
    n = world.drone_num
    oracle = make_oracle(world, env)
    obs = policy_obs(oracle.reset(), nm)
    prog = lambda t: (lane["obs_self"][t], lane["obs_nbr"][t], lane["obs_mask"][t])  # noqa: E731
    beyond, flips = obs_mismatch(obs, prog(0))
    rng = np.random.default_rng(tie["seed"])

    def advance(snap, t, jitter=None):
        oracle, ep_len = snap
        act = lane["act"][t].astype(float)
        obs_l, rew, done, _, fin = oracle.step(act if jitter is None else act + jitter)
        rew = np.asarray(rew, float)
        ep_len += 1
        fin, done = np.asarray(fin, bool), np.asarray(done, bool)
        arrive_all = bool(fin.all())
        terminal = bool(fin.any()) or bool(ep_len.max() > max_ep_len)
        for i in np.flatnonzero(done):
            oracle.reset_one(i)
        ep_len[done] = 0
        full = arrive_all or t == t_len - 1
        term = np.zeros(n, bool)
        if full:
            for i in range(n):
                oracle.reset_one(i)
            ep_len[:] = 0
        elif terminal:
            term = fin | (ep_len > max_ep_len)
            for i in np.flatnonzero(term):
                oracle.reset_one(i)
            ep_len[term] = 0
        cut = arrive_all or terminal or t == t_len - 1
        if bool(done.any()) or full or bool(term.any()):
            obs_l = oracle.env_observation()
        p_rew = lane["rew"][t].astype(float)
        finite = np.isfinite(rew) & np.isfinite(p_rew)
        gap = float(np.max(np.abs(rew - p_rew)[finite], initial=0.0))
        gap = gap if (np.isfinite(rew) == np.isfinite(p_rew)).all() else np.inf
        b, f = (obs_mismatch(policy_obs(obs_l, nm), prog(t + 1)) if t + 1 < t_len
                else (0, 0))
        return {"gap": gap, "beyond": b + int(bool(cut) != bool(lane["cut"][t])),
                "flips": f}

    def agrees(res):
        return res["gap"] <= REWARD_TOL and res["beyond"] == 0

    snap = (oracle, np.zeros(n, int))
    reward_gap, compared, tied, searches = 0.0, 0, False, 0
    for t in range(min(steps, t_len)):
        before = copy.deepcopy(snap)
        res = advance(snap, t)
        if not agrees(res) and searches < tie["searches"]:
            searches += 1
            if tie_search(before, lambda s, j, t=t: advance(s, t, j), agrees, rng,
                          tie["delta"], tie["tries"], n) is not None:
                tied = True
                break
        reward_gap = max(reward_gap, res["gap"])
        beyond += res["beyond"]
        flips += res["flips"]
        compared += 1
    return {"reward_gap": reward_gap, "beyond": beyond, "flips": flips,
            "steps": compared, "tie": tied}


def vo_candidates(oracle: OracleEnv, states, i: int):
    """The first 8 observed entries, rounded as observed, of every drone
    that drone i could list: within range, approaching and not colliding
    (the branch of the oracle's `_config_vo_circle2` that builds a cone;
    those entries do not read the action)."""
    s = states[i]
    odro, _ = oracle._preprocess(s, [o for j, o in enumerate(states) if j != i])
    out = []
    for o in odro:
        res = oracle._config_vo_circle2(s, o, np.zeros(3))
        rel = np.asarray(o[0:3]) - np.asarray(s[0:3])
        if res[3] or s[3] * rel[0] + s[4] * rel[1] + s[5] * rel[2] <= 0:
            continue
        out.append(np.round(np.asarray(res[0][:8], float), 2))
    return out


def obs_state_mismatch(oracle: OracleEnv, prog, ctime_threshold: float
                       ) -> Tuple[int, int, int]:
    """(entries or slots beyond one rounding step, entries one step off,
    listed neighbour slots) of the program's observation `prog` (self [N, 12], neighbours [N, nm, 9],
    mask [N, nm]) against the oracle's state, as `obs_check` compares."""
    p_self, p_nbr, p_mask = prog
    states = oracle.total_states()
    e_lo, e_hi = round(1.0 / (ctime_threshold + 0.2), 2) - FLIP, 1.0 / 0.2 + FLIP
    beyond = flips = slots = 0
    for i, s in enumerate(states):
        d = np.abs(np.round(s, 2) - p_self[i])
        beyond += int((d > FLIP).sum())
        flips += int(((d > 1e-4) & (d <= FLIP)).sum())
        m = p_mask[i].astype(bool)
        k = int(m.sum())
        slots += k
        beyond += int(m[:len(m) - k].any())
        e = p_nbr[i][m, 8]
        beyond += int(((e < e_lo) | (e > e_hi)).sum()) + int((np.diff(e) < -1e-6).sum())
        cand = vo_candidates(oracle, states, i)
        for slot in p_nbr[i][m, :8]:
            gaps = [float(np.max(np.abs(c - slot))) for c in cand]
            j = int(np.argmin(gaps)) if gaps else -1
            if j < 0 or gaps[j] > FLIP:
                beyond += 1
                continue
            flips += int(gaps[j] > 1e-4)
            cand.pop(j)
    return beyond, flips, slots


def obs_check(world, env: dict, state: Dict[str, np.ndarray], prog, tie: dict) -> dict:
    """A lane's observation `prog` (self, neighbours, mask; [N, ...] numpy)
    against the program's state `state` of that lane (DroneState leaves,
    [N, ...] numpy): the entries and slots beyond a rounding step and one
    step off. Where any is beyond, the oracle's state is moved by float32's
    distance (`tie`: delta, tries, seed); a copy that agrees makes it a
    knife-edge tie ("tie": True); "slots" counts the listed neighbours."""
    oracle = make_oracle(world, env)
    for i in range(world.drone_num):
        set_drone(oracle, i, {k: v[i] for k, v in state.items()})
    ct = env["ctime_threshold"]
    beyond, flips, slots = obs_state_mismatch(oracle, prog, ct)
    tied = bool(beyond) and tie_search(
        oracle, lambda o, _: obs_state_mismatch(o, prog, ct)[0], lambda b: b == 0,
        np.random.default_rng(tie["seed"]), tie["delta"], tie["tries"]) is not None
    return {"beyond": 0 if tied else beyond, "flips": flips, "slots": slots, "tie": tied}


def set_drone(oracle: OracleEnv, i: int, s: Dict[str, np.ndarray]) -> None:
    """Drone i of the oracle put in the program's state `s` (one drone's
    leaves of the program's DroneState, as numpy)."""
    d = oracle.drones[i]
    d.state = np.asarray(s["pos"], float)
    d.previous_state = np.asarray(s["prev_pos"], float)
    d.vel = np.asarray(s["vel"], float)
    d.yaw, d.pitch = float(s["yaw"]), float(s["pitch"])
    d.i = int(s["wp_idx"])
    d.current_des = d.waypoints[d.i]
    d.previous_des = d.waypoints[max(d.i - 1, 0)]
    d.arrive_flag = bool(s["arrive_flag"])
    d.dest_arrive_flag = bool(s["dest_arrive_flag"])
    d.collision_flag = bool(s["collision_flag"])
    d.real_route_len = float(s["real_route_len"])
    d.extra_len = float(s["extra_len"])
    d.max_deviation = float(s["max_deviation"])
    d.velocity = float(np.linalg.norm(d.vel))


def step_from(world, env: dict, max_ep_len: int, state: Dict[str, np.ndarray],
              carry: Dict[str, float], action: np.ndarray, record: dict,
              tie: dict) -> dict:
    """One evaluation step of one lane from the program's state `state`
    (DroneState leaves of the lane, [N, ...] numpy) and its episode carry
    (ep_len, speed_sum, ret0), with the absolute `action` [N, 3]: the
    step's record as the evaluator writes it. Where its flags or drone 0's
    return disagree with the program's `record`, the step is tried again
    from perturbed copies of the state (`tie`: delta, tries, seed); one that
    agrees makes the record a knife-edge tie ("tie": True); `tie` None
    tries nothing."""
    oracle = make_oracle(world, env)
    for i in range(world.drone_num):
        set_drone(oracle, i, {k: v[i] for k, v in state.items()})

    def advance(o, jitter=None):
        act = action.astype(float)
        _, rew, done, info, fin = o.step(act if jitter is None else act + jitter)
        speed = float(np.mean([np.linalg.norm(d.vel) for d in o.drones]))
        ep_len = int(carry["ep_len"]) + 1
        success = bool(np.all(fin))
        return {"ended": bool(np.any(done)) or ep_len == max_ep_len or success,
                "success": success, "all_info": bool(np.all(info)), "ep_len": ep_len,
                "speed": (float(carry["speed_sum"]) + speed) / max(ep_len, 1),
                "ret0": float(carry["ret0"]) + float(rew[0]), "tie": False}

    def agrees(res):
        return (all(res[f] == record[f] for f in FLAGS)
                and abs(res["ret0"] - record["ret0"]) <= REWARD_TOL)

    before = copy.deepcopy(oracle)
    res = advance(oracle)
    if tie is not None and not agrees(res):
        found = tie_search(before, advance, agrees, np.random.default_rng(tie["seed"]),
                           tie["delta"], tie["tries"], world.drone_num)
        if found is not None:
            res = {**found[1], "tie": True}
    return res
