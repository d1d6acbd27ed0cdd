"""The numbers each cell compares with the plain reference, and their
readings for the program and for the lower-precision control.

Training (`train_readings`), each after the checked epochs:
  loss_gap      worst epoch's gap of the first policy iteration's loss
                (over the mean |advantage| of its window) and of the last
                value iteration's loss (over the reference's)
  moment_gap    worst leaf, both Adams, of the gap between the norms of the
                first moments after the first epoch, over the larger of the
                reference leaf's norm and the median leaf's
  change_gap    the same for the parameters' change over the checked epochs
  value_gap     widest gap of the rollout's values on a sample of each
                checked epoch's rows, over the largest reference value there
  logp_gap      widest gap of the rollout's recorded logp on those rows
                (of the sample before rounding)
  act_mismatch  recorded action entries on those rows that differ from the
                reference's sample rounded to 2 decimals; entries whose
                reference sample lies within `action_tie_tol` of a rounding
                tie, in units of the 0.01 step, are left out
  reward_gap    widest reward gap of the replayed lanes (oracle env)
  env_mismatch  observation entries, masks and cuts of the replayed lanes
                beyond one 2-decimal rounding step
  Leaves whose first gradient in the reference is under a thousandth of
  its Adam's median leaf's are left out of moment_gap and change_gap:
  they move by round-off alone. The last three numbers follow the program
  step by step: the reference policy runs at the parameters the program's
  rollout started each epoch from (kept by the driver) and redraws the
  rollout's standard normals from its generator's state at that start;
  the update that made those parameters is held apart, by the first three
  numbers, to the reference learner's own chain from the product.
Evaluation (`eval_readings`), one step of the sampled lanes from the
program's state: speed_gap, ret0_gap (widest gaps of the step's records)
and record_mismatch (ended, success, all-arrived and length flags that
differ where no drone sits on a flag boundary; lanes where the
reference's action lies within `action_tie_tol` of a rounding tie, in
units of the 0.01 step, are left out), plus the steps of the sampled
lanes whose episode length breaks the evaluator's lifecycle (one more
than the step before's, 1 after an episode's end, the end at max_ep_len
at the latest).
Serving (`serve_readings`): act_gap, the widest gap of an action.

The control is the reference with TF32 matmuls, put in the program's
place: `control=True` reads the same numbers for it (the env numbers have
no control: the program's actions drive the replay).
"""

from __future__ import annotations

import os
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import envcheck
from benchmark.reference import learner as lrn
from benchmark.reference import policy as ref


def limits_of(run, readings: Dict[str, float]) -> List[dict]:
    """The limited numbers, each with its limit; every reading is kept in
    run.window["readings"]."""
    run.window["readings"] = readings
    lim = run.workload["limits"]
    missing = set(lim) - set(readings)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return [{"name": k, "value": readings[k], "limit": lim[k]} for k in lim]


def reference_params(run, device):
    path = os.path.join(run.root, run.config["product"]["path"])
    return ref.load_params(path, run.config["product"]["sha256"], device)


# ---- training ----

def follow(run, kept, p0, train: dict, tf32: bool):
    """The reference learner over the kept epochs' batches from p0, its
    GAE its own: (per-epoch EpochUpdate, first-epoch moments, final params)."""
    dev = p0[next(iter(p0))].device
    p = {n: v.clone() for n, v in p0.items()}
    pi_names, vf_names = lrn.optimizer_names(p, train["vf_encoder"])
    pi_opt = lrn.Adam(p, pi_names, train["pi_lr"])
    vf_opt = lrn.Adam(p, vf_names, train["vf_lr"])
    gen = torch.Generator().manual_seed(run.seed)
    ups, moments = [], None
    with ref.tf32(tf32):
        for k, epoch in enumerate(kept):
            b = {n: v.to(dev) for n, v in epoch["batch"].items()}
            adv, ret = lrn.gae(b["rew"], b["val"], b["cut"], train["gamma"], train["lam"])
            flat = lrn.Window(*[x.reshape(-1, *x.shape[3:]) for x in (
                b["obs_self"], b["obs_nbr"], b["obs_mask"], b["act"], adv, ret, b["logp"])])
            rows, mb = flat.act.shape[0], train["minibatch"]
            offsets = lrn.draw_offsets(gen, rows, mb, train["train_pi_iters"],
                                       train["train_v_iters"]) if 0 < mb < rows else None
            ups.append(lrn.run_epoch_update(p, pi_opt, vf_opt, flat, offsets, train))
            if k == 0:
                moments = {"pi": {n: m.cpu().clone() for n, m in pi_opt.m.items()},
                           "vf": {n: m.cpu().clone() for n, m in vf_opt.m.items()}}
            del b, flat, adv, ret
    return ups, moments, {n: v.cpu().clone() for n, v in p.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref_: Dict[str, torch.Tensor], names):
    """(worst leaf's gap of norms, that leaf's name)."""
    norms = {n: float(ref_[n].double().norm()) for n in names}
    med = statistics.median(norms.values())
    return max((abs(float(prog[n].double().norm()) - norms[n]) / max(norms[n], med, 1e-30),
                n) for n in names)


def kept_leaves(first_grads: Dict[str, float], prefix: str) -> List[str]:
    g = {k[len(prefix):]: v for k, v in first_grads.items() if k.startswith(prefix)}
    med = statistics.median(g.values())
    return [n for n, v in g.items() if v >= 1e-3 * med]


def learner_readings(prog: dict, ref_side: dict, p0) -> Dict[str, float]:
    """loss_gap, moment_gap, change_gap of one side (`prog`: the program's
    per-epoch losses, first-epoch moments and final params) against the
    reference side."""
    ups, moments, p_end = ref_side["ups"], ref_side["moments"], ref_side["params"]
    loss = 0.0
    for (pi_l, v_l), u in zip(prog["losses"], ups):
        loss = max(loss, abs(pi_l - u.first_pi_loss) / max(u.adv_scale, 1e-30),
                   abs(v_l - u.last_v_loss) / max(abs(u.last_v_loss), 1e-30))
    first = ups[0].first_grads
    keep = {"pi": kept_leaves(first, "pi:"), "vf": kept_leaves(first, "vf:")}
    moment = max(leaf_gap(prog["moments"][a], moments[a], keep[a]) for a in ("pi", "vf"))
    held = sorted(set(keep["pi"]) | set(keep["vf"]))
    d_prog = {n: prog["params"][n] - p0[n] for n in held}
    d_ref = {n: p_end[n] - p0[n] for n in held}
    change = leaf_gap(d_prog, d_ref, held)
    return {"loss_gap": loss, "moment_gap": moment[0], "change_gap": change[0],
            "moment_leaf": moment[1], "change_leaf": change[1]}


def rollout_rows(run, batch, epoch: int) -> torch.Tensor:
    n = batch["val"].numel()
    rng = np.random.default_rng([run.seed, 3, epoch])
    k = min(run.workload["params"]["rollout_rows"], n)
    return torch.as_tensor(np.sort(rng.choice(n, k, replace=False)))


def rollout_draws(epoch: dict, dev) -> torch.Tensor:
    """The standard normals [T * E * N, act_dim] the rollout drew for its
    sample, one [E, N, act_dim] draw a step from its generator's state at
    the epoch's start."""
    t_len, e, n, act_dim = epoch["batch"]["act"].shape
    g = torch.Generator(device=dev)
    g.set_state(epoch["gen_state"])
    return torch.stack([torch.randn((e, n, act_dim), generator=g, dtype=torch.float32,
                                    device=dev) for _ in range(t_len)]).reshape(-1, act_dim)


def rollout_readings(run, kept, control: bool = False) -> Dict[str, float]:
    """value_gap, logp_gap, act_mismatch of the rollout records of every
    checked epoch against the reference policy at the parameters the
    program's rollout started that epoch from; with `control`, of the TF32
    reference's records in the program's place."""
    dev = torch.device(run.device)
    tol = run.workload["params"]["action_tie_tol"]
    out = {"value_gap": 0.0, "logp_gap": 0.0, "act_mismatch": 0, "act_ties": 0}
    for k, epoch in enumerate(kept):
        b = epoch["batch"]
        rows = rollout_rows(run, b, k)
        pick = lambda x: x.reshape(-1, *x.shape[3:])[rows].to(dev)  # noqa: E731
        obs = [pick(b[key]) for key in ("obs_self", "obs_nbr", "obs_mask")]
        eps = rollout_draws(epoch, dev)[rows.to(dev)]
        p = {n: v.to(dev) for n, v in epoch["params"].items()}
        with ref.tf32(False), torch.no_grad():
            mu, val = ref.actor_critic(p, *obs)
        sd = ref.std(p)
        a = mu + sd * eps
        if control:
            with ref.tf32(True), torch.no_grad():
                mu_c, val_c = ref.actor_critic(p, *obs)
            a_c = mu_c + sd * eps
            got = {"val": val_c, "act": ref.round2(a_c), "logp": ref.logp_of(mu_c, sd, a_c)}
        else:
            got = {"val": pick(b["val"]), "act": pick(b["act"]), "logp": pick(b["logp"])}
        ties = ref.tie_distance(a) < tol
        out["value_gap"] = max(out["value_gap"], float(
            (got["val"] - val).abs().max() / val.abs().max().clamp_min(1e-30)))
        out["logp_gap"] = max(out["logp_gap"], float(
            (got["logp"] - ref.logp_of(mu, sd, a)).abs().max()))
        out["act_mismatch"] += int(((got["act"] != ref.round2(a)) & ~ties).sum())
        out["act_ties"] += int(ties.sum())
    return out


def replay_readings(run, batch, cfg_world_dir: str) -> Dict[str, float]:
    prog = run.config["program"]
    tr = run.workload["params"]
    world = envcheck.load_world(cfg_world_dir)
    e = batch["act"].shape[1]
    rng = np.random.default_rng([run.seed, 4])
    out = {"reward_gap": 0.0, "env_mismatch": 0, "env_flips": 0, "env_steps": 0,
           "env_ties": 0}
    for lane in rng.choice(e, tr["replay_lanes"], replace=False):
        data = {k: batch[k][:, lane].numpy() for k in
                ("obs_self", "obs_nbr", "obs_mask", "act", "rew", "cut")}
        tie = {"delta": tr["tie_delta"], "tries": tr["tie_tries"], "searches": 3,
               "seed": [run.seed, lane]}
        r = envcheck.replay_lane(world, prog["env"], prog["train"]["max_ep_len"], data,
                                 tr["replay_steps"], tie)
        out["reward_gap"] = max(out["reward_gap"], r["reward_gap"])
        out["env_mismatch"] += r["beyond"]
        out["env_flips"] += r["flips"]
        out["env_steps"] += r["steps"]
        out["env_ties"] += int(r["tie"])
    return out


def train_readings(st, run, cfg, control: bool = False) -> Dict[str, float]:
    """The training numbers of the program, or (`control`) of the TF32
    reference in its place."""
    import dataclasses

    dev = torch.device(run.device)
    train = dataclasses.asdict(cfg.train)
    p0 = reference_params(run, dev)
    ups, moments, p_end = follow(run, st.kept, p0, train, tf32=False)
    ref_side = {"ups": ups, "moments": moments, "params": p_end}
    p0_cpu = {n: v.cpu() for n, v in p0.items()}
    if control:
        c_ups, c_mom, c_end = follow(run, st.kept, p0, train, tf32=True)
        side = {"losses": [(u.first_pi_loss, u.last_v_loss) for u in c_ups],
                "moments": c_mom, "params": c_end}
    else:
        side = {"losses": [(k["pi_loss"], k["v_loss"]) for k in st.kept],
                "moments": st.moments, "params": st.p_checked}
    out = learner_readings(side, ref_side, p0_cpu)
    out.update(rollout_readings(run, st.kept, control))
    if not control:
        world_dir = os.path.join(run.root, "benchmark", "configs", "worlds", cfg.world)
        out.update(replay_readings(run, st.kept[0]["batch"], world_dir))
    return out


def train_checks(st, run, cfg) -> List[dict]:
    return limits_of(run, train_readings(st, run, cfg))


# ---- evaluation ----

def lifecycle_breaks(ended: np.ndarray, ep_len: np.ndarray, start_len: np.ndarray,
                     max_ep_len: int) -> int:
    """Steps of records [T, L] whose episode length is not the evaluator's:
    the lane's length before the call (`start_len` [L]) plus one, then one
    more each step, 1 after an ended step; an episode ends at max_ep_len."""
    prev_len, prev_end = start_len.astype(np.int64), np.zeros_like(start_len, bool)
    breaks = 0
    for t in range(ended.shape[0]):
        want = np.where(prev_end, 1, prev_len + 1)
        breaks += int((ep_len[t] != want).sum())
        breaks += int(((ep_len[t] >= max_ep_len) & ~ended[t]).sum())
        prev_len, prev_end = ep_len[t].astype(np.int64), ended[t]
    return breaks


def eval_readings(st, run, control: bool = False) -> Dict[str, float]:
    prog = run.config["program"]
    tr = run.workload["params"]
    dev = torch.device(run.device)
    p = reference_params(run, dev)
    world = envcheck.load_world(os.path.join(run.root, "benchmark", "configs",
                                             "worlds", prog["world"]))
    n_lanes, n = tr["lanes"], world.drone_num
    out = {"speed_gap": 0.0, "ret0_gap": 0.0, "record_mismatch": 0, "obs_mismatch": 0,
           "eval_checked": 0, "eval_action_ties": 0, "eval_flag_ties": 0,
           "eval_obs_flips": 0, "eval_obs_slots": 0, "eval_obs_ties": 0}
    calls = 0
    for k in st.kept:
        obs_np = [x.numpy() for x in k["obs"]]
        for j in range(len(k["lanes"])):
            o = envcheck.obs_check(world, prog["env"],
                                   {f: v[j].numpy() for f, v in k["state"].items()},
                                   [x[j] for x in obs_np],
                                   {"delta": tr["tie_delta"], "tries": tr["tie_tries"],
                                    "seed": [run.seed, 7, len(k["lanes"]) * calls + j]})
            out["obs_mismatch"] += o["beyond"]
            out["eval_obs_flips"] += o["flips"]
            out["eval_obs_slots"] += o["slots"]
            out["eval_obs_ties"] += int(o["tie"])
        out["record_mismatch"] += lifecycle_breaks(k["lengths"]["ended"].numpy(),
                                                   k["lengths"]["ep_len"].numpy(),
                                                   k["carry"]["ep_len"].numpy(),
                                                   tr["max_ep_len"])
        g = torch.Generator(device=dev)
        g.set_state(k["gen_state"])
        eps = torch.randn((n_lanes, n, 3), generator=g, dtype=torch.float32,
                          device=dev).index_select(0, k["lanes"].to(dev))
        obs = [x.to(dev) for x in k["obs"]]
        with ref.tf32(False), torch.no_grad():
            mu = ref.mean_action(p, *obs)
            sd = ref.std(p, tr["std_factor"])
            a = mu + sd * eps
        ties = (ref.tie_distance(a) < tr["action_tie_tol"]).reshape(
            len(k["lanes"]), -1).any(-1)
        if control:
            with ref.tf32(True), torch.no_grad():
                a_prog = ref.round2(ref.mean_action(p, *obs) + sd * eps)
        act = ref.round2(a)
        for j in range(len(k["lanes"])):
            if bool(ties[j]):
                out["eval_action_ties"] += 1
                continue
            state = {f: v[j].numpy() for f, v in k["state"].items()}
            carry = {f: v[j].item() for f, v in k["carry"].items()}
            tie = {"delta": tr["tie_delta"], "tries": tr["tie_tries"],
                   "seed": [run.seed, len(k["lanes"]) * calls + j]}
            if control:
                record = envcheck.step_from(world, prog["env"], tr["max_ep_len"], state,
                                            carry, a_prog[j].cpu().numpy(), {}, None)
            else:
                record = {f: v[j].item() for f, v in k["rec"].items()}
            r = envcheck.step_from(world, prog["env"], tr["max_ep_len"], state, carry,
                                   act[j].cpu().numpy(), record, tie)
            if r["tie"]:
                out["eval_flag_ties"] += 1
                continue
            out["record_mismatch"] += sum(bool(r[f] != record[f]) for f in envcheck.FLAGS)
            out["speed_gap"] = max(out["speed_gap"], abs(r["speed"] - record["speed"]))
            out["ret0_gap"] = max(out["ret0_gap"], abs(r["ret0"] - record["ret0"]))
            out["eval_checked"] += 1
        calls += 1
    return out


def eval_checks(st, run) -> List[dict]:
    return limits_of(run, eval_readings(st, run))


# ---- serving ----

def serve_sample(st, run) -> List[int]:
    tr = run.workload["params"]
    n = len(st.outputs)
    rng = np.random.default_rng([run.seed, 5])
    idx = sorted(rng.choice(n, min(tr["check_requests"], n), replace=False).tolist())
    big = max(tr["batch_sizes"])
    if not any(st.sizes[i] == big for i in idx):
        idx.append(st.sizes.index(big))
    return idx


def serve_readings(st, run, control: bool = False) -> Dict[str, float]:
    dev = torch.device(run.device)
    p = reference_params(run, dev)
    tr = run.workload["params"]
    gap = 0.0
    for i in serve_sample(st, run):
        b = st.sizes[i]
        obs = [torch.as_tensor(x, device=dev) for x in st.pool[b][i % tr["pool"]]]
        with ref.tf32(False), torch.no_grad():
            want = ref.mean_action(p, *obs)
        if control:
            with ref.tf32(True), torch.no_grad():
                got = ref.mean_action(p, *obs)
        else:
            got = torch.as_tensor(st.outputs[i], device=dev)
        gap = max(gap, float((got - want).abs().max()))
    return {"act_gap": gap}


def serve_checks(st, run) -> List[dict]:
    return limits_of(run, serve_readings(st, run))
