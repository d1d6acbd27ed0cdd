"""Behavior-cloning warm start from an analytic expert, with DAgger rounds
(counterpart of rvo3d_tpu/algo/bc.py).

PPO from scratch on the reference's reward falls into a "slam the brakes"
attractor; the cure is to start the policy near a sensible controller.
Roll out the waypoint controller or the RVO expert (env/rvo_policy.py),
label every visited state with the expert's clean command (in the policy's
action space), and regress the policy mean onto it. DAgger rounds roll the
current clone instead, relabel its states with the expert, aggregate the
dataset and refit. Everything runs on the policy's device; the random
draws come from an explicit torch.Generator.

A fit's step reads static tensors only: the rows it trains on are drawn
before it, outside it, into one index buffer, with the same call on the
same generator as an eager loop would make. On a card the step (forward
through the masked-GRU kernel, the plain-scan backward, algo/adam.py's
step) is captured once per fit as a CUDA graph and replayed, as the JAX
fit runs its steps as one jitted scan (utils/graphs.py); the CPU calls it
as it is. The loss is read once, after the last step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from rvo3d_tpu_torch.algo.adam import Adam
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import rvo_policy
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.state import WorldSpec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import graphs
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

# randn(kind, shape) -> standard normals for the DART exploration noise
# (kind "explore", [E, N, 3]) and the env's control noise ("env", [E, N, 3])
Randn = Callable[[str, Tuple[int, ...]], torch.Tensor]
# behavior_fn(obs_self, obs_nbr, obs_mask) -> the executed action [E, N, 3]
BehaviorFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# on_round(round, ac, loss): after each fit, with the clone as that fit left it
OnRound = Callable[[int, ActorCritic, float], None]


@torch.no_grad()
def collect_demos(world: WorldSpec, p: EnvParams, num_envs: int, steps: int,
                  generator: Optional[torch.Generator] = None,
                  cruise_speed: float = 0.6, expert: str = "waypoint",
                  action_mode: str = "increment", explore_std: float = 0.0,
                  expert_margin: Optional[float] = None,
                  behavior_fn: Optional[BehaviorFn] = None,
                  expert_slowdown: bool = False, env_noise: bool = False,
                  randn: Optional[Randn] = None):
    """Roll an analytic expert ('waypoint' = pure tracking, 'rvo' = the
    cone-dodging controller) over num_envs lanes for `steps` steps; returns
    (obs_self, obs_nbr, obs_mask, target) with leading axis
    [steps * num_envs * N].

    The stored obs is the one the policy would act on: the previous step's
    output obs, refreshed by observe() only for lanes that reset anything
    (the rollout's feed). The target is the expert's clean command,
    clipped to +-0.999 ('direct') or its velocity-anchored increment
    ('increment'). explore_std > 0 executes a noised action (DART) while
    the label stays clean. behavior_fn, if given, drives the rollout
    (DAgger) while the expert still labels. env_noise turns the env's
    control noise on (else it is off, whatever p.noise says). `randn`
    replaces the draws from `generator` (tests inject another package's)."""
    p = dataclasses.replace(p, noise=bool(env_noise))
    dtype, dev = world.dtype, world.device
    if randn is None:
        if generator is None:
            raise ValueError("collect_demos needs a generator or randn")

        def randn(kind, shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=dev)

    if expert == "rvo":
        kw = {} if expert_margin is None else {"margin": expert_margin}
        if expert_slowdown:
            kw["slowdown"] = True

        def expert_fn(st):
            return rvo_policy.rvo_controller(st, world, p, **kw)
    elif expert == "waypoint":
        def expert_fn(st):
            return waypoint_controller(st, world, cruise_speed=cruise_speed)
    else:
        raise ValueError(f"unknown expert {expert!r}")

    state = reset(world, p, (num_envs,))
    out, state = observe(world, state, p)
    obs = (out.obs_self, out.obs_nbr, out.obs_mask)
    stored: List[Tuple[torch.Tensor, ...]] = []
    for _ in range(steps):
        cmd = expert_fn(state)
        if action_mode == "direct":
            target = torch.clamp(cmd, -0.999, 0.999)
        else:
            target = torch.clamp((cmd - state.vel) / p.acceler, -0.999, 0.999)
        executed = behavior_fn(*obs) if behavior_fn is not None else target
        if explore_std > 0.0:
            executed = torch.clamp(
                executed + explore_std * randn("explore", tuple(target.shape)), -1.0, 1.0)
        if action_mode == "direct":
            abs_eff = executed
        else:
            # step with the achievable command: abs = acceler * a + vel
            abs_eff = p.acceler * executed + state.vel
        noise = randn("env", tuple(abs_eff.shape)) if p.noise else None
        stored.append(obs + (target,))
        state, o = step(world, state, abs_eff, p, noise)
        need = o.done | o.finish
        state = reset_where(world, state, need)
        re_out, state = observe(world, state, p)
        r3 = torch.any(need, dim=1)[:, None, None]
        obs = (torch.where(r3, re_out.obs_self, o.obs_self),
               torch.where(r3[..., None], re_out.obs_nbr, o.obs_nbr),
               torch.where(r3, re_out.obs_mask, o.obs_mask))

    # [T, E, N, ...] -> [T*E*N, ...]
    return tuple(torch.stack(xs).flatten(0, 2) for xs in zip(*stored))


def bc_loss(ac: ActorCritic, data, idx: torch.Tensor,
            conflict_weight: float = 1.0) -> torch.Tensor:
    """Mean squared error of the policy mean on rows `idx`; with
    conflict_weight != 1, rows with any flagged VO neighbour weigh
    conflict_weight (normalized by 3 * sum of the weights)."""
    obs_self, obs_nbr, obs_mask, target = data
    mask = obs_mask[idx]
    mu, _, _ = ac(obs_self[idx], obs_nbr[idx], mask)
    err = (mu - target[idx]) ** 2
    if conflict_weight != 1.0:
        w = 1.0 + (conflict_weight - 1.0) * torch.any(mask, -1).to(err.dtype)
        return torch.sum(w[:, None] * err) / (3.0 * torch.sum(w))
    return torch.mean(err)


def fit(ac: ActorCritic, data, n_valid: int, steps: int, batch: int, lr: float,
        generator: Optional[torch.Generator], conflict_weight: float = 1.0,
        indices: Optional[Callable[[int], torch.Tensor]] = None) -> float:
    """`steps` Adam steps (fresh moments: optax.adam's defaults) on
    minibatches of `batch` rows drawn uniformly from the first n_valid;
    indices(step) replaces the draws. On a card the step is one CUDA graph,
    captured for this fit (the module's docstring). Returns the last step's
    loss."""
    return float(fit_steps(ac, data, n_valid, steps, batch, lr, generator,
                           conflict_weight, indices))


def fit_steps(ac: ActorCritic, data, n_valid: int, steps: int, batch: int, lr: float,
              generator: Optional[torch.Generator], conflict_weight: float = 1.0,
              indices: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
    """fit's steps, with no host read: the last step's loss as a tensor."""
    opt = Adam([q for q in ac.parameters() if q.requires_grad], lr=lr)
    dev = data[0].device
    idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    loss = torch.zeros((), dtype=torch.promote_types(torch.float32, data[3].dtype),
                       device=dev)

    def body():
        with torch.enable_grad():
            opt.zero_grad(set_to_none=True)
            out = bc_loss(ac, data, idx, conflict_weight)
            out.backward()
        with torch.no_grad():
            opt.step()
            opt.zero_grad(set_to_none=True)
            loss.copy_(out)
    run = graphs.StepGraph(body, dev).step if graphs.on_card(dev) else body
    for s in range(steps):
        idx.copy_(indices(s) if indices is not None else torch.randint(
            0, n_valid, (batch,), generator=generator, device=generator.device))
        run()
    return loss


def bc_pretrain(ac: ActorCritic, world: Union[WorldSpec, Sequence[WorldSpec]],
                p: EnvParams, generator: torch.Generator, *, num_envs: int = 32,
                demo_steps: int = 200, train_steps: int = 500, batch: int = 4096,
                lr: float = 1e-3, cruise_speed: float = 0.6, expert: str = "waypoint",
                action_mode: str = "increment", explore_std: float = 0.0,
                expert_margin: Optional[float] = None, dagger_rounds: int = 0,
                conflict_weight: float = 1.0, expert_slowdown: bool = False,
                env_noise: bool = False,
                randn: Optional[Randn] = None,
                indices: Optional[Callable[[int, int], torch.Tensor]] = None,
                on_round: Optional[OnRound] = None) -> float:
    """Behavior cloning with DAgger rounds; trains `ac` in place and returns
    the final loss on the aggregate set.

    Round 0 rolls the (noised) expert; each DAgger round rolls the current
    clone's mean action (plus the same exploration noise), relabels every
    visited state with the expert, appends to the aggregate set, and refits
    with fresh Adam moments. `world` may be a sequence of worlds: every
    round then collects from each (in order) into one set. Minibatches have
    min(batch, capacity) rows, capacity counting every round. The draws
    come from `generator` (on the policy's device); `randn(kind, shape)`
    and `indices(round, step)` replace them. on_round(r, ac, loss) runs
    after round r's fit (r = 0 the expert's round, r >= 1 the DAgger
    rounds), as the JAX package's callback does; `ac` is the clone itself,
    trained in place, so whatever the callback evaluates is the current
    clone."""
    worlds = [world] if isinstance(world, WorldSpec) else list(world)
    round_n = demo_steps * num_envs * p.num_drones * len(worlds)
    cap = round_n * (dagger_rounds + 1)
    rows = min(batch, cap)
    data: Optional[Tuple[torch.Tensor, ...]] = None
    n_valid = 0

    def behavior_fn(obs_self, obs_nbr, obs_mask):
        return ac(obs_self, obs_nbr, obs_mask)[0]

    loss = float("nan")
    for r in range(dagger_rounds + 1):
        for w in worlds:
            new = collect_demos(w, p, num_envs, demo_steps, generator, cruise_speed,
                                expert, action_mode, explore_std, expert_margin,
                                behavior_fn=behavior_fn if r else None,
                                expert_slowdown=expert_slowdown, env_noise=env_noise,
                                randn=randn)
            if data is None:
                data = tuple(torch.empty((cap,) + x.shape[1:], dtype=x.dtype,
                                         device=x.device) for x in new)
            for buf, x in zip(data, new):
                buf[n_valid:n_valid + x.shape[0]] = x
            n_valid += new[0].shape[0]
        loss = fit(ac, data, n_valid, train_steps, rows, lr, generator, conflict_weight,
                   None if indices is None else (lambda s, r=r: indices(r, s)))
        if on_round is not None:
            on_round(r, ac, loss)
    return loss
