"""The plain reference of the PPO learner the training cells run: GAE,
the clipped surrogate with its KL stop, the value loss, the global-norm
clip and Adam, one epoch's update schedule over the rollout batch.

Semantics (upstream multi_ppo.update as the configurations state it):
  - GAE-lambda over [T, E, N] with the lane's path cut after step t:
      delta[t] = r[t] + gamma (1 - cut[t]) v[t+1] - v[t]
      adv[t] = delta[t] + gamma lam (1 - cut[t]) adv[t+1]
      ret[t] = r[t] + gamma (1 - cut[t]) ret[t+1]
    with v[T] = 0;
  - the batched update: the batch flattened in [T, E, N] order, each
    iteration on the window of `minibatch` rows at an offset drawn from a
    CPU generator seeded with the training seed (pi offsets, then v
    offsets, once per epoch: torch.randint(0, rows - minibatch + 1, (n,)));
  - train_pi_iters policy iterations: the loss
    -mean(min(ratio adv, clip(ratio, 1 -+ clip_ratio) adv)) with ratio
    exp(clamp(logp - logp_old, -20, 20)), kl = mean(logp_old - logp); the
    step is applied only while no iteration's kl has exceeded target_kl;
    the gradient is clipped to global norm grad_clip_norm over the policy
    optimizer's parameters; then train_v_iters value iterations of
    mean((v - ret)^2);
  - two Adams (lr pi_lr over encoder, actor and log_std; lr vf_lr over
    encoder and critic, or critic alone when vf_encoder is false), with
    optax's arithmetic: count += 1, m = 0.1 g + 0.9 m, v = 0.001 g^2 +
    0.999 v, p -= lr (m / (1 - 0.9^count)) / (sqrt(v / (1 - 0.999^count))
    + 1e-8), the count a float32.

Restated, not imported, from the port at commit
9c4d68f085eba6da2a2a461640d8c4e22e7131e6 (algo/gae.py, algo/ppo.py,
algo/adam.py).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference import policy as ref

Params = Dict[str, torch.Tensor]


def gae(rew: torch.Tensor, val: torch.Tensor, cut: torch.Tensor, gamma: float,
        lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(adv, ret), each [T, ...], for rew, val [T, E, N] and cut [T, E]."""
    cont = (~cut).to(rew.dtype)[..., None].expand_as(rew)
    adv = torch.empty_like(rew)
    ret = torch.empty_like(rew)
    a_next = torch.zeros_like(rew[0])
    r_next = torch.zeros_like(rew[0])
    v_next = torch.zeros_like(val[0])
    for t in range(rew.shape[0] - 1, -1, -1):
        delta = rew[t] + gamma * cont[t] * v_next - val[t]
        a_next = delta + gamma * lam * cont[t] * a_next
        r_next = rew[t] + gamma * cont[t] * r_next
        adv[t], ret[t] = a_next, r_next
        v_next = val[t]
    return adv, ret


class Adam:
    """Adam over the named parameters, optax's arithmetic (module docstring)."""

    def __init__(self, params: Params, names: List[str], lr: float):
        self.params, self.names, self.lr = params, names, lr
        self.m = {n: torch.zeros_like(params[n]) for n in names}
        self.v = {n: torch.zeros_like(params[n]) for n in names}
        self.count = torch.zeros((), dtype=torch.float32, device=params[names[0]].device)

    @torch.no_grad()
    def step(self, grads: Params, keep: torch.Tensor) -> None:
        count = self.count + 1.0
        for n in self.names:
            g = grads[n]
            m = 0.1 * g + 0.9 * self.m[n]
            v = 0.001 * (g * g) + 0.999 * self.v[n]
            m_hat = m / (1 - torch.pow(0.9, count))
            v_hat = v / (1 - torch.pow(0.999, count))
            new = self.params[n] - self.lr * (m_hat / (torch.sqrt(v_hat) + 1e-8))
            self.params[n].copy_(torch.where(keep, new, self.params[n]))
            self.m[n].copy_(torch.where(keep, m, self.m[n]))
            self.v[n].copy_(torch.where(keep, v, self.v[n]))
        self.count = torch.where(keep, count, self.count)


def optimizer_names(params: Params, vf_encoder: bool) -> Tuple[List[str], List[str]]:
    names = list(params)
    pi = [n for n in names if not n.startswith("critic.")]
    vf = [n for n in names if not n.startswith(("actor.", "log_std"))
          and (vf_encoder or n.startswith("critic."))]
    return pi, vf


class Window(NamedTuple):
    obs_self: torch.Tensor
    obs_nbr: torch.Tensor
    obs_mask: torch.Tensor
    act: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor
    logp: torch.Tensor


def pi_loss(p: Params, w: Window, clip_ratio: float):
    lp = ref.logp(p, w.obs_self, w.obs_nbr, w.obs_mask, w.act)
    ratio = torch.exp(torch.clamp(lp - w.logp, -20.0, 20.0))
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * w.adv
    loss = -torch.mean(torch.minimum(ratio * w.adv, clipped))
    return loss, torch.mean(w.logp - lp).detach()


def v_loss(p: Params, w: Window):
    return torch.mean((ref.value(p, w.obs_self, w.obs_nbr, w.obs_mask) - w.ret) ** 2)


def draw_offsets(generator: torch.Generator, rows: int, minibatch: int,
                 n_pi: int, n_v: int) -> Tuple[List[int], List[int]]:
    hi = rows - minibatch + 1
    pi = torch.randint(0, hi, (n_pi,), generator=generator)
    v = torch.randint(0, hi, (n_v,), generator=generator)
    return pi.tolist(), v.tolist()


class EpochUpdate(NamedTuple):
    first_pi_loss: float
    last_v_loss: float
    adv_scale: float            # mean |adv| of the first policy window
    first_grads: Dict[str, float]   # per-leaf norm of each Adam's first gradient


def grads_of(loss: torch.Tensor, p: Params, names: List[str]) -> Params:
    leaves = [p[n] for n in names]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(p[n]))
            for n, g in zip(names, got)}


def run_epoch_update(p: Params, pi_opt: Adam, vf_opt: Adam, flat: Window,
                     offsets, train: dict) -> EpochUpdate:
    """One epoch's batched update on the flattened batch `flat` (rows in
    [T, E, N] order), in place on `p` and the two Adams."""
    mb = train["minibatch"]
    rows = flat.act.shape[0]
    if not 0 < mb < rows:
        mb = rows
        offsets = ([0] * train["train_pi_iters"], [0] * train["train_v_iters"])
    pi_off, v_off = offsets

    def window(off):
        return Window(*[x[off:off + mb] for x in flat])

    stopped = torch.zeros((), dtype=torch.bool, device=flat.act.device)
    first_loss, first_grads, adv_scale = None, {}, None
    for i, off in enumerate(pi_off):
        w = window(off)
        for n in pi_opt.names:
            p[n].requires_grad_(True)
        loss, kl = pi_loss(p, w, train["clip_ratio"])
        g = grads_of(loss, p, pi_opt.names)
        for n in pi_opt.names:
            p[n].requires_grad_(False)
        with torch.no_grad():
            stop = stopped | (kl > train["target_kl"])
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
            max_norm = train["grad_clip_norm"]
            g = {n: torch.where(norm < max_norm, x, (x / norm) * max_norm)
                 for n, x in g.items()}
            if i == 0:
                first_loss, adv_scale = float(loss), float(w.adv.abs().mean())
                first_grads.update({"pi:" + n: float(x.norm()) for n, x in g.items()})
            pi_opt.step(g, ~stop)
            stopped = stop
    last_v = None
    for i, off in enumerate(v_off):
        w = window(off)
        for n in vf_opt.names:
            p[n].requires_grad_(True)
        loss = v_loss(p, w)
        g = grads_of(loss, p, vf_opt.names)
        for n in vf_opt.names:
            p[n].requires_grad_(False)
        with torch.no_grad():
            if i == 0:
                first_grads.update({"vf:" + n: float(x.norm()) for n, x in g.items()})
            vf_opt.step(g, torch.ones((), dtype=torch.bool, device=loss.device))
            last_v = float(loss)
    return EpochUpdate(first_loss, last_v, adv_scale, first_grads)
