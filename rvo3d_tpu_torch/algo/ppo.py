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

The Adams are algo/adam.py's: optax.adam's update, torch.optim.Adam's
state, every number on the device. The parameters and both optimizers'
states are updated in place.

PPOUpdate runs the update as the JAX package runs it, one device program
with no host read (its lax.while_loop over the policy iterations, its
fori_loops over the value iterations and the agents):
  - the batch is copied into static buffers (`load`; the trainer's
    `prepare` computes GAE into them as one more step);
  - each iteration is one call of a step body over static tensors: its
    window is the rows (off[i] + arange(mb)) * stride + r of the flattened
    batch, gathered at the device iteration index i, where off holds the
    agent's drawn offsets (drawn on the CPU generator as the eager loop
    drew them, copied to the device once per update) and r the agent
    (stride N; r = 0 and stride 1 for the joint batch);
  - the KL stop is a device flag: each of the train_pi_iters policy
    iterations computes its loss, kl and gradients, and Adam applies the
    step only while no iteration's kl has exceeded target_kl (`keep`), as
    the JAX loop `_select`s the params and the optimizer state back; kl
    keeps the stopping iteration's value, `iters` counts the applied
    steps. The host replays every iteration and reads nothing: where the
    stop fires at iteration j, the last train_pi_iters - j iterations run
    and change nothing.
On a card each body is captured once as a CUDA graph and replayed
(utils/graphs.StepGraph; the policy and value steps share one memory
pool), with the masked-GRU kernel's launches counted through the replays.
The CPU calls the same bodies as they are, and so does a tensor-parallel
policy on a card: its forward's and the clip's gloo all_reduces
(parallel/tensor_parallel.py) cannot be captured.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from rvo3d_tpu_torch.algo.adam import Adam
from rvo3d_tpu_torch.algo.gae import gae_advantages
from rvo3d_tpu_torch.config import TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.parallel.tensor_parallel import global_sq_norm, is_sharded
from rvo3d_tpu_torch.utils import graphs, profiler


class PPOState(NamedTuple):
    """The policy (its parameters) and the two optimizers over them."""

    ac: ActorCritic
    pi_opt: Adam
    vf_opt: Adam


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


def make_optimizers(cfg: TrainConfig, ac: ActorCritic) -> Tuple[Adam, Adam]:
    """pi-Adam over {encoder, actor, log_std}, vf-Adam over {encoder,
    critic}; torch-default Adam hyperparameters. A parameter outside an
    optimizer is not moved by it."""
    params = dict(ac.named_parameters())
    pi, vf = optimizer_masks(cfg, ac)
    return (Adam([params[n] for n in pi], lr=cfg.pi_lr),
            Adam([params[n] for n in vf], lr=cfg.vf_lr))


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


class PPOUpdate:
    """The update of one policy and its two optimizers as a device program
    (the module's docstring). `load(data)` or `prepare(batch)` fills the
    static buffers, `update(generator, perm, offsets)` runs the schedule on
    them; the buffers and the captured steps are made at the first call and
    kept, so every later call must bring a batch of the same shapes."""

    def __init__(self, ac: ActorCritic, cfg: TrainConfig, pi_opt: Adam, vf_opt: Adam):
        self.ac, self.cfg, self.pi_opt, self.vf_opt = ac, cfg, pi_opt, vf_opt
        self.data = self.gae_in = None
        self.layout = None       # (stride, rows per agent, window rows)
        self._gae_step = self._pi_step = self._v_step = None

    # ---- the static buffers ----

    def load(self, data: AgentData) -> AgentData:
        """`data` (leaves [T, E, N, ...], or one agent's [B, ...]) copied
        into the static buffers; returns them."""
        self.data = graphs.fill_static(self.data, data, data.act.device)
        return self.data

    def prepare(self, batch) -> AgentData:
        """The trainer's rollout batch (algo/rollout.RolloutBatch: leaves
        [T, E, N, ...], cut [T, E]) into the static buffers, with the GAE
        advantages and returns (cfg.gamma, cfg.lam) computed into their
        `adv` and `ret` by one more step: the counterpart of the JAX epoch's
        GAE scan, compiled into the program of its update. Returns the
        buffers (AgentData [T, E, N, ...])."""
        self.load(AgentData(obs_self=batch.obs_self, obs_nbr=batch.obs_nbr,
                            obs_mask=batch.obs_mask, act=batch.act, adv=batch.val,
                            ret=batch.val, logp=batch.logp, val=batch.val))
        self.gae_in = graphs.fill_static(self.gae_in, (batch.rew, batch.cut),
                                         batch.rew.device)
        if self._gae_step is None:
            self._gae_step = self._runner(self._gae_body)
        self._gae_step()
        return self.data

    def _runner(self, body, pool=None):
        dev = self.data.act.device
        if graphs.on_card(dev) and not is_sharded(self.ac):
            return graphs.StepGraph(body, dev, pool=pool).step
        # the CPU, and a tensor-parallel policy: its gloo all_reduces
        # cannot be captured
        return body

    # ---- the step bodies (static tensors in, static tensors out) ----

    def _gae_body(self) -> None:
        rew, cut = self.gae_in
        adv, ret = gae_advantages(rew, self.data.val, cut[:, :, None],
                                  self.cfg.gamma, self.cfg.lam)
        self.data.adv.copy_(adv)
        self.data.ret.copy_(ret)

    def _window(self, offsets: torch.Tensor, i: torch.Tensor) -> AgentData:
        off = offsets.index_select(0, i.reshape(1))
        rows = (off + self.arange) * self.layout[0] + self.agent
        return AgentData(*[x.index_select(0, rows) for x in self.flat])

    def _pi_body(self) -> None:
        cfg, ac = self.cfg, self.ac
        with torch.enable_grad():
            ac.zero_grad(set_to_none=True)
            loss, kl, _ = pi_loss_fn(ac, self._window(self.pi_off, self.i_pi),
                                     cfg.clip_ratio, cfg.adv_norm, cfg.ent_coef)
            loss.backward()
        with torch.no_grad():
            stop = self.stopped | (kl > cfg.target_kl)
            # the optimizer's parameters as they are now: tensor parallelism
            # swaps in shards after the learner is made
            clip_by_global_norm_([p for g in self.pi_opt.param_groups for p in g["params"]],
                                 cfg.grad_clip_norm)
            self.pi_opt.step(keep=~stop)
            ac.zero_grad(set_to_none=True)
            self.first_loss.copy_(torch.where(self.i_pi == 0, loss, self.first_loss))
            self.kl.copy_(torch.where(self.stopped, self.kl, kl))
            self.iters.add_((~stop).to(torch.int32))
            self.stopped.copy_(stop)
            self.i_pi.add_(1)

    def _v_body(self) -> None:
        with torch.enable_grad():
            self.ac.zero_grad(set_to_none=True)
            loss = v_loss_fn(self.ac, self._window(self.v_off, self.i_v),
                             self.cfg.value_clip)
            loss.backward()
        with torch.no_grad():
            self.vf_opt.step()
            self.ac.zero_grad(set_to_none=True)
            self.v_loss.copy_(loss)
            self.i_v.add_(1)

    @torch.no_grad()
    def _fresh_logp(self) -> None:
        """The agent's stored logp replaced by the current policy's, over
        all its rows at once (eager: once per agent)."""
        stride, rows, _ = self.layout
        idx = torch.arange(rows, device=self.agent.device) * stride + self.agent
        obs = [x.index_select(0, idx) for x in self.flat[:4]]
        self.flat.logp.index_copy_(0, idx, self.ac.logp(*obs))

    # ---- the schedule ----

    def _static(self, stride: int) -> None:
        """The device scalars and window buffers, made once."""
        rows = self.data.adv.numel() // stride
        mb = self.cfg.minibatch if 0 < self.cfg.minibatch < rows else rows
        if self.layout is not None:
            if self.layout != (stride, rows, mb):
                raise ValueError(f"a batch laid out as {(stride, rows, mb)} after "
                                 f"{self.layout}: this update holds one layout")
            return
        dev = self.data.act.device
        self.layout = (stride, rows, mb)
        lead = self.data.act.dim() - 1     # [T, E, N] or [B]
        self.flat = AgentData(*[x.view((-1,) + x.shape[lead:]) for x in self.data])
        self.arange = torch.arange(mb, device=dev)
        self.agent = torch.zeros((), dtype=torch.int64, device=dev)
        self.pi_off = torch.zeros(self.cfg.train_pi_iters, dtype=torch.int64, device=dev)
        self.v_off = torch.zeros(self.cfg.train_v_iters, dtype=torch.int64, device=dev)
        self.i_pi, self.i_v = (torch.zeros((), dtype=torch.int64, device=dev)
                               for _ in range(2))
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.iters = torch.zeros((), dtype=torch.int32, device=dev)
        self.first_loss, self.kl, self.v_loss = (torch.zeros((), device=dev)
                                                 for _ in range(3))
        pool = graphs.SharedPool()
        self._pi_step = self._runner(self._pi_body, pool)
        self._v_step = self._runner(self._v_body, pool)

    def _agents(self, agents: Sequence[int], stride: int, generator, offsets):
        """(first pi loss, last v loss, kl, applied pi steps) of each
        agent in turn, device scalars."""
        self._static(stride)
        cfg = self.cfg
        _, rows, mb = self.layout
        n_pi, n_v = cfg.train_pi_iters, cfg.train_v_iters
        with profiler.span("update.plan"):
            plan = []
            for k, r in enumerate(agents):
                off = offsets[k] if offsets is not None else None
                if mb < rows and off is None:
                    off = draw_offsets(cfg, rows, generator)
                if mb == rows or off is None:
                    off = ([0] * n_pi, [0] * n_v)
                plan.append([int(r)] + list(off[0]) + list(off[1]))
            plan = torch.tensor(plan, dtype=torch.int64)
            dev = self.agent.device
            plan = (plan.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
                    else plan.to(dev))
        out = []
        for k in range(len(agents)):
            with profiler.span("update.pi", agent=int(agents[k])):
                self.agent.copy_(plan[k, 0])
                self.pi_off.copy_(plan[k, 1:1 + n_pi])
                self.v_off.copy_(plan[k, 1 + n_pi:])
                for t in (self.i_pi, self.i_v, self.stopped, self.iters, self.first_loss,
                          self.kl, self.v_loss):
                    t.zero_()
                if cfg.fresh_logp:
                    self._fresh_logp()
                for _ in range(n_pi):
                    self._pi_step()
            with profiler.span("update.v", agent=int(agents[k])):
                for _ in range(n_v):
                    self._v_step()
                out.append(tuple(t.clone() for t in (self.first_loss, self.v_loss,
                                                     self.kl, self.iters)))
        return out

    def update(self, generator: Optional[torch.Generator] = None,
               perm: Optional[Sequence[int]] = None,
               offsets: Optional[Sequence] = None) -> UpdateMetrics:
        """The schedule over the loaded batch [T, E, N, ...]. `generator`
        (CPU) draws the agent order and the minibatch offsets; tests may
        give `perm` (the agent order) and `offsets` (one (pi, v) pair per
        updated agent).

        cfg.batched_update updates all agents, in [T, E, N] order, as one
        joint batch with one policy and one value phase; otherwise the first
        max_update_num agents of the shuffled order are updated in turn,
        each on its [T*E] rows, the Adam moments carrying across agents."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if cfg.batched_update:
            agents, stride = [0], 1
        else:
            n_agents = self.data.act.shape[2]
            if perm is None:
                perm = torch.randperm(n_agents, generator=generator).tolist()
            agents, stride = perm[:min(cfg.max_update_num, n_agents)], n_agents
        rows = self._agents(agents, stride, generator, offsets)
        return UpdateMetrics(*[torch.stack(col) for col in zip(*rows)])


def update_one_agent(ac: ActorCritic, cfg: TrainConfig, pi_opt, vf_opt,
                     batch: AgentData, generator: Optional[torch.Generator] = None,
                     offsets: Optional[Tuple[Sequence[int], Sequence[int]]] = None):
    """The per-agent inner loops on one batch [B, ...]. With
    0 < cfg.minibatch < B every iteration takes a contiguous window of
    cfg.minibatch rows at an offset drawn from `generator` (or the given
    `offsets`: pi offsets, v offsets). Returns (first pi loss, last v loss,
    kl, applied pi steps) as tensors."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    learner = PPOUpdate(ac, cfg, pi_opt, vf_opt)
    learner.load(batch)
    return learner._agents([0], 1, generator, None if offsets is None else [offsets])[0]


def ppo_update(ac: ActorCritic, cfg: TrainConfig, pi_opt, vf_opt,
               data: AgentData, generator: Optional[torch.Generator] = None,
               perm: Optional[Sequence[int]] = None,
               offsets: Optional[Sequence] = None) -> UpdateMetrics:
    """One update on `data` (AgentData, leaves [T, E, N, ...]) through a
    PPOUpdate of its own (PPOUpdate.update says what the arguments do)."""
    learner = PPOUpdate(ac, cfg, pi_opt, vf_opt)
    learner.load(data)
    return learner.update(generator, perm, offsets)
