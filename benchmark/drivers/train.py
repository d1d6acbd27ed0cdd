"""Driver `train`: whole PPO epochs through `Trainer.run_epoch`.

Set-up builds one Trainer from the configuration (its seeds from --seed),
loads the product's weights into it (fresh optimizers), and runs the
traffic's `checked_epochs` epochs through run_epoch: the first warms up
and captures the graphs, and all of them are what the check follows. The
parameters and the rollout generator's state at each one's "rollout"
phase mark are kept, and its rollout batch reaches the harness at the
"gae" mark and goes to the host. The
window then runs whole epochs until --seconds have passed; the epoch that
begins before they run out is counted whole. A traced run records CUDA
events at the phase marks of every window epoch and profiles the window's
second epoch.

The check (after the window, the trainer freed) follows the checked epochs
with the plain reference: the learner on each epoch's rollout batch from
the product's weights and fresh Adams (reference/learner.py), the actor
and critic, at the parameters each epoch's rollout started from, on a
sample of each epoch's rows with the rollout's own standard normals, and
the oracle env
on a sample of the first epoch's lanes (reference/envcheck.py). Compared
numbers (workload `limits`): loss_gap, moment_gap, change_gap, value_gap,
logp_gap, act_mismatch, reward_gap, env_mismatch (the module docstring
of benchmark/checks.py).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import counts
from benchmark.reference import policy as ref


def program_config(run):
    from rvo3d_tpu_torch.config import from_dict

    cfg = from_dict(run.config["program"])
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=run.seed))


def world_dir(run, name: str) -> str:
    return os.path.join(run.root, "benchmark", "configs", "worlds", name)


def product_path(run) -> str:
    return os.path.join(run.root, run.config["product"]["path"])


class State:
    def __init__(self):
        self.trainer = None
        self.kept = []          # per checked epoch: its rollout batch and metrics
        self.marks = []         # traced run: (name, cuda event) per phase mark
        self.phase = None


def _hook(state: State, run):
    def hook(name, data):
        if state.phase is not None:
            run.close_span(state.phase)
            state.phase = None
        if run.trace:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            state.marks.append((name, ev))
        if name == "rollout" and state.kept and state.kept[-1].get("open"):
            state.kept[-1].update(
                gen_state=state.trainer.carry.generator.get_state(),
                params={n: p.detach().cpu().clone()
                        for n, p in state.trainer.ac.named_parameters()})
        if name == "gae" and state.kept and state.kept[-1].get("open"):
            state.kept[-1]["batch"] = {k: v.cpu() for k, v in data._asdict().items()}
        if name != "end":
            state.phase = run.open_span("epoch." + name)
    return hook


def named_moments(opt, names_of):
    return {names_of[id(p)]: st["exp_avg"].detach().cpu().clone()
            for p, st in opt.state.items() if st}


def setup(run):
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.worlds.loader import load_world_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = program_config(run)
    dev = torch.device(run.device)
    world = load_world_dir(world_dir(run, cfg.world)).spec(device=dev)
    st = State()
    path = product_path(run)
    if ref.sha256_of(path) != run.config["product"]["sha256"]:
        raise ValueError(f"{path} is not the configuration's product")
    product = torch.load(path, map_location="cpu", weights_only=True)
    with run.span("trainer.build"):
        st.trainer = Trainer(cfg, world, device=dev)
        st.trainer.ac.load_state_dict(product["state_dict"])
    names_of = {id(p): n for n, p in st.trainer.ac.named_parameters()}
    st.trainer.phase_hook = _hook(st, run)
    for k in range(run.workload["params"]["checked_epochs"]):
        st.kept.append({"open": True})
        with run.span("epoch", checked=k):
            m = st.trainer.run_epoch()
        st.kept[-1].update(open=False, pi_loss=m["pi_loss"][0], v_loss=m["v_loss"][0])
        if k == 0:
            st.moments = {"pi": named_moments(st.trainer.pi_opt, names_of),
                          "vf": named_moments(st.trainer.vf_opt, names_of)}
    st.p_checked = {n: p.detach().cpu().clone()
                    for n, p in st.trainer.ac.named_parameters()}
    run.sync()
    return st


def window(st: State, run):
    tr = st.trainer
    cfg = tr.cfg.train
    env_steps = cfg.steps_per_epoch * cfg.num_envs
    st.marks.clear()
    ends = []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while not ends or ends[-1] < deadline:
        if run.trace and len(ends) == 1:
            st.traced = len(ends)
            st.gen_state = tr.update_generator.get_state()
            tr.phase_hook = _traced_hook(st, run)
            from benchmark.harness.trace import Tracer
            with Tracer(run), run.span("epoch"):
                tr.run_epoch()
            tr.phase_hook = _hook(st, run)
        else:
            with run.span("epoch"):
                tr.run_epoch()
        ends.append(time.perf_counter())
    run.window.update(start=t0, epoch_ends=ends, env_steps_per_epoch=env_steps)
    run.count("attempted", len(ends))
    if run.trace:
        _phase_times(st, run)
        _traced_counts(st, run)


def _traced_hook(st, run):
    inner = _hook(st, run)

    def hook(name, data):
        inner(name, data)
        if name == "gae":
            st.traced_mask = data.obs_mask.clone()
    return hook


def _phase_times(st, run):
    """Mean ms of rollout ("rollout" -> "gae") and update ("update" ->
    "end") over the window's epochs, the profiled one left out."""
    torch.cuda.synchronize()
    epochs, cur = [], {}
    for name, ev in st.marks:
        cur[name] = ev
        if name == "end":
            epochs.append(cur)
            cur = {}
    untraced = [e for i, e in enumerate(epochs) if i != st.traced]
    run.window["rollout_ms"] = float(np.mean([e["rollout"].elapsed_time(e["gae"])
                                              for e in untraced]))
    run.window["update_ms"] = float(np.mean([e["update"].elapsed_time(e["end"])
                                             for e in untraced]))
    e = epochs[st.traced]
    run.window["traced_epoch_s"] = e["rollout"].elapsed_time(e["end"]) * 1e-3


def _traced_counts(st, run):
    """The traced epoch's masked-GRU launch bounds and model FLOPs, from the
    masks of the rows each launch was given: the rollout's T steps of
    [E * N] rows; each policy and value iteration's window of the same rows
    flattened in [T, E, N] order (the update's batch), at offsets drawn as
    the update drew them."""
    from benchmark.reference.learner import draw_offsets

    tr = st.trainer
    cfg, model = tr.cfg.train, run.config["program"]["model"]
    in_dim, hidden = model["rnn_input_dim"], model["rnn_hidden_dim"]
    roll = ref.encoder_mask(st.traced_mask)          # [T, E, N, nm]
    flat = roll.reshape(-1, roll.shape[-1])           # the update's rows
    bound, flops = 0.0, 0.0
    for t in range(roll.shape[0]):
        m = roll[t].reshape(-1, roll.shape[-1]).t()
        bound += counts.gru_bound(m, in_dim, hidden)["bound_s"]
        flops += counts.policy_flops(m, model, "both")
    rows = flat.shape[0]
    mb = cfg.minibatch if 0 < cfg.minibatch < rows else rows
    g = torch.Generator()
    g.set_state(st.gen_state)
    pi_off, v_off = (draw_offsets(g, rows, mb, cfg.train_pi_iters, cfg.train_v_iters)
                     if mb < rows else ([0] * cfg.train_pi_iters, [0] * cfg.train_v_iters))
    for offs, head in ((pi_off, "actor"), (v_off, "critic")):
        for off in offs:
            m = flat[off:off + mb].t()
            bound += counts.gru_bound(m, in_dim, hidden)["bound_s"]
            if head == "critic" and not cfg.vf_encoder:
                flops += (counts.encoder_flops(m, in_dim, hidden)
                          + counts.head_flops(mb, model, head, backward=True))
            else:
                flops += counts.policy_flops(m, model, head, backward=True)
    run.window.update(traced_gru_bound_s=bound, traced_flops=flops)


def release(st: State):
    st.trainer = None
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(st: State, run):
    return checks.train_checks(st, run, program_config(run))
