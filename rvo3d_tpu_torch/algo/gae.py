"""GAE-lambda advantages and discounted returns (counterpart of
rvo3d_tpu/algo/gae.py): a reverse loop over the fixed [T] buffers, where
`cut[t]` marks a path boundary after step t (epoch end, every drone of the
lane arrived, or terminal). Collision resets do not cut: the value
bootstraps across them, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   cut: torch.Tensor, gamma: float, lam: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rewards, values: [T, ...]; cut: [T, ...] bool, broadcastable to
    rewards, True where the path ends after step t with bootstrap value 0.
    Returns (advantages, returns), both [T, ...]:

      adv[t] = delta[t] + gamma*lam*(1-cut[t])*adv[t+1]
      delta[t] = r[t] + gamma*(1-cut[t])*v[t+1] - v[t]
      ret[t] = r[t] + gamma*(1-cut[t])*ret[t+1]
    """
    cont = torch.where(cut, 0.0, 1.0).to(rewards.dtype).broadcast_to(rewards.shape)
    v_next = torch.cat([values[1:], torch.zeros_like(values[:1])], dim=0)
    deltas = rewards + gamma * cont * v_next - values
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    adv_next = torch.zeros_like(rewards[0])
    ret_next = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv_next = deltas[t] + gamma * lam * cont[t] * adv_next
        ret_next = rewards[t] + gamma * cont[t] * ret_next
        adv[t] = adv_next
        ret[t] = ret_next
    return adv, ret
