"""PPO learner: clipped surrogate, KL early stop and the per-agent update
schedule (counterpart of rvo3d_tpu/algo/ppo.py; reference multi_ppo.update):

  - agents updated in a shuffled order, capped at max_update_num, or, with
    `batched_update`, all agents in one joint batch;
  - per agent: up to train_pi_iters policy steps with the KL early stop
    checked BEFORE the step is applied, then train_v_iters value steps;
  - two Adams with their own learning rates, moments and step counts share
    the encoder: pi-Adam holds {encoder, actor, log_std}, vf-Adam
    {encoder, critic} (`vf_encoder=False` drops the encoder from vf,
    `freeze_encoder` from both);
  - the policy gradient is clipped to global norm `grad_clip_norm` over the
    pi-Adam's parameters only, as optax.clip_by_global_norm computes it.

torch.optim.Adam's update equals optax.adam's, lr * mu_hat / (sqrt(nu_hat)
+ eps), so it serves with eps 1e-8. The parameters and both optimizers'
states are updated in place. The one host read is the KL stop: one per
policy iteration.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from rvo3d_tpu_torch.config import TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.parallel.tensor_parallel import global_sq_norm


class PPOState(NamedTuple):
    """The policy (its parameters) and the two optimizers over them."""

    ac: ActorCritic
    pi_opt: torch.optim.Adam
    vf_opt: torch.optim.Adam


class AgentData(NamedTuple):
    """A flattened batch, leaves [B, ...] (or [T, E, N, ...] before
    ppo_update flattens it)."""

    obs_self: torch.Tensor
    obs_nbr: torch.Tensor
    obs_mask: torch.Tensor
    act: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor
    logp: torch.Tensor
    val: torch.Tensor  # rollout value estimate (for value clipping)

    def window(self, offset: int, size: int) -> "AgentData":
        return AgentData(*[x[offset:offset + size] for x in self])


class UpdateMetrics(NamedTuple):
    pi_loss: torch.Tensor   # [n_upd] first-iteration policy loss per updated agent
    v_loss: torch.Tensor    # [n_upd] final value loss
    kl: torch.Tensor        # [n_upd] kl at the stop (or the last iteration)
    pi_iters: torch.Tensor  # [n_upd] applied policy steps before the stop


def _is_encoder(name: str) -> bool:
    return not name.startswith(("actor.", "critic.", "log_std"))


def optimizer_masks(cfg: TrainConfig, ac: ActorCritic) -> Tuple[List[str], List[str]]:
    """Names of the parameters that pi-Adam and vf-Adam update."""
    names = [n for n, _ in ac.named_parameters()]
    pi = [n for n in names if not n.startswith("critic.")
          and not (cfg.freeze_encoder and _is_encoder(n))]
    vf = [n for n in names if not n.startswith(("actor.", "log_std"))
          and not ((cfg.freeze_encoder or not cfg.vf_encoder) and _is_encoder(n))]
    return pi, vf


def make_optimizers(cfg: TrainConfig, ac: ActorCritic
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """pi-Adam over {encoder, actor, log_std}, vf-Adam over {encoder,
    critic}; torch-default Adam hyperparameters. A parameter outside an
    optimizer is not moved by it."""
    params = dict(ac.named_parameters())
    pi, vf = optimizer_masks(cfg, ac)
    pi_opt = torch.optim.Adam([params[n] for n in pi], lr=cfg.pi_lr,
                              betas=(0.9, 0.999), eps=1e-8)
    vf_opt = torch.optim.Adam([params[n] for n in vf], lr=cfg.vf_lr,
                              betas=(0.9, 0.999), eps=1e-8)
    return pi_opt, vf_opt


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on the parameters' .grad:
    g * max_norm / |g| where |g| >= max_norm, over these parameters only
    (whole: a tensor-parallel shard's squares are summed over its model
    row). Returns |g|."""
    held = [p for p in params if p.grad is not None]
    grads = [p.grad for p in held]
    g_norm = torch.sqrt(global_sq_norm(grads, held))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def pi_loss_fn(ac: ActorCritic, batch: AgentData, clip_ratio: float,
               adv_norm: bool = False, ent_coef: float = 0.0):
    """(loss, kl, clip fraction) of the clipped surrogate."""
    logp = ac.logp(batch.obs_self, batch.obs_nbr, batch.obs_mask, batch.act)
    adv = batch.adv
    if adv_norm:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    # a clamped log-ratio: exp of an unbounded difference overflows
    ratio = torch.exp(torch.clamp(logp - batch.logp, -20.0, 20.0))
    clip_adv = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    loss = -torch.mean(torch.minimum(ratio * adv, clip_adv))
    if ent_coef:
        loss = loss - ent_coef * torch.mean(ac.entropy())
    kl = torch.mean(batch.logp - logp)
    clipped = (ratio > 1 + clip_ratio) | (ratio < 1 - clip_ratio)
    return loss, kl.detach(), clipped.to(torch.float32).mean()


def v_loss_fn(ac: ActorCritic, batch: AgentData, value_clip: float = 0.0):
    v = ac.value(batch.obs_self, batch.obs_nbr, batch.obs_mask)
    if value_clip > 0.0:
        # PPO2-style: the new prediction moves at most value_clip from the
        # rollout estimate per update phase
        v_clip = batch.val + torch.clamp(v - batch.val, -value_clip, value_clip)
        return torch.mean(torch.maximum((v - batch.ret) ** 2, (v_clip - batch.ret) ** 2))
    return torch.mean((v - batch.ret) ** 2)


def draw_offsets(cfg: TrainConfig, batch_size: int,
                 generator: torch.Generator) -> Optional[Tuple[List[int], List[int]]]:
    """Window offsets of the pi and v iterations when cfg.minibatch cuts
    the batch; None for the full batch."""
    mb = cfg.minibatch
    if not 0 < mb < batch_size:
        return None
    hi = batch_size - mb + 1
    pi = torch.randint(0, hi, (cfg.train_pi_iters,), generator=generator)
    v = torch.randint(0, hi, (cfg.train_v_iters,), generator=generator)
    return pi.tolist(), v.tolist()


def update_one_agent(ac: ActorCritic, cfg: TrainConfig, pi_opt, vf_opt,
                     batch: AgentData, generator: Optional[torch.Generator] = None,
                     offsets: Optional[Tuple[Sequence[int], Sequence[int]]] = None):
    """The per-agent inner loops. With 0 < cfg.minibatch < B every
    iteration takes a contiguous window of cfg.minibatch rows at an offset
    drawn from `generator` (or the given `offsets`: pi offsets, v offsets).
    Returns (first pi loss, last v loss, kl, applied pi steps) as tensors."""
    b = batch.act.shape[0]
    mb = cfg.minibatch if 0 < cfg.minibatch < b else 0
    if mb and offsets is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        offsets = draw_offsets(cfg, b, generator)

    def sub_batch(i, phase):
        return batch.window(offsets[phase][i], mb) if mb else batch

    if cfg.fresh_logp:
        with torch.no_grad():
            batch = batch._replace(logp=ac.logp(
                batch.obs_self, batch.obs_nbr, batch.obs_mask, batch.act))

    pi_params = [p for g in pi_opt.param_groups for p in g["params"]]
    dev = batch.act.device
    first_loss = torch.zeros((), device=dev)
    kl = torch.zeros((), device=dev)
    iters = 0
    for i in range(cfg.train_pi_iters):
        ac.zero_grad(set_to_none=True)
        loss, kl, _ = pi_loss_fn(ac, sub_batch(i, 0), cfg.clip_ratio,
                                 cfg.adv_norm, cfg.ent_coef)
        if i == 0:
            first_loss = loss.detach()
        if kl.item() > cfg.target_kl:   # stop before applying this step
            break
        loss.backward()
        clip_by_global_norm_(pi_params, cfg.grad_clip_norm)
        pi_opt.step()
        iters += 1

    v_loss = torch.zeros((), device=dev)
    for i in range(cfg.train_v_iters):
        ac.zero_grad(set_to_none=True)
        loss = v_loss_fn(ac, sub_batch(i, 1), cfg.value_clip)
        loss.backward()
        vf_opt.step()
        v_loss = loss.detach()
    ac.zero_grad(set_to_none=True)
    return first_loss, v_loss, kl, torch.tensor(iters, dtype=torch.int32, device=dev)


def ppo_update(ac: ActorCritic, cfg: TrainConfig, pi_opt, vf_opt,
               data: AgentData, generator: Optional[torch.Generator] = None,
               perm: Optional[Sequence[int]] = None,
               offsets: Optional[Sequence] = None) -> UpdateMetrics:
    """data: AgentData with leaves [T, E, N, ...]. `generator` (CPU) draws
    the agent order and the minibatch offsets; tests may give `perm` (the
    agent order) and `offsets` (one (pi, v) pair per updated agent).

    cfg.batched_update flattens all agents, in [T, E, N] order, into one
    joint batch and runs one policy and one value phase; otherwise the
    first max_update_num agents of the shuffled order are updated in turn,
    each on its [T*E] rows, the Adam moments carrying across agents."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    if cfg.batched_update:
        batch = AgentData(*[x.reshape((-1,) + x.shape[3:]) for x in data])
        out = update_one_agent(ac, cfg, pi_opt, vf_opt, batch, generator,
                               None if offsets is None else offsets[0])
        return UpdateMetrics(*[x[None] for x in out])

    n_agents = data.act.shape[2]
    n_upd = min(cfg.max_update_num, n_agents)
    if perm is None:
        perm = torch.randperm(n_agents, generator=generator).tolist()
    rows = []
    for k in range(n_upd):
        r = int(perm[k])
        batch = AgentData(*[x[:, :, r].reshape((-1,) + x.shape[3:]) for x in data])
        rows.append(update_one_agent(ac, cfg, pi_opt, vf_opt, batch, generator,
                                     None if offsets is None else offsets[k]))
    return UpdateMetrics(*[torch.stack(col) for col in zip(*rows)])
