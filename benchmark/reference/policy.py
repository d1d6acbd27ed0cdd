"""The plain reference of the benchmarked policy: the biGRU neighbour
encoder, the Gaussian actor and the critic, in plain PyTorch on a params
dict, with no kernel, cache or batching trick.

Semantics (the reference's train/rl_utils shared GRU actor-critic as the
configurations state it):
  - a row's neighbour slots [nm, 9] with a validity mask; a GRU (gate
    order r, z, n, weights [in, 3H] / [H, 3H]) runs over the slots, its
    carry moving only on valid slots; the biGRU sums the forward run's and
    the reversed run's final states; a row with no valid slot runs its
    last (all-zero) slot;
  - features = LayerNorm(concat(self_state [12], h [H])), eps 1e-5;
  - actor: Linear-ReLU-Linear-ReLU-Linear-tanh -> mu; critic the same
    without the tanh -> v; std = clamp(std_factor * exp(log_std) + 1e-6,
    1e-4, 10); logp of an action summed over its 3 components.
Weights are the product file's tensors under their names in that file
(`encoder.fwd.w_ih`, `actor.layers.0.weight`, ...), read by `load_params`.

float32 throughout; `tf32(True)` switches TF32 matmuls on, which is the
lower-precision control of the benchmark's comparisons, and `tf32(False)`
(the default of every reference call) keeps them off.

Restated, not imported, from the port at commit
9c4d68f085eba6da2a2a461640d8c4e22e7131e6: the scan is
ops/masked_gru.py's `masked_gru_scan_plain`, the mask rule chip_smoke.py's
`encoder_view`, the heads models/actor_critic.py's.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Dict

import torch
import torch.nn.functional as F

LOG_2PI = 1.8378770664093453
Params = Dict[str, torch.Tensor]


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load_params(path: str, sha256: str, device) -> Params:
    """The product file's tensors (float32, on `device`); refuses a file
    whose sha256 is not `sha256`."""
    got = sha256_of(path)
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got}, the configuration names {sha256}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in ckpt["state_dict"].items()}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls on or off inside the block (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def encoder_mask(obs_mask: torch.Tensor) -> torch.Tensor:
    """The slots the GRU runs: the mask, or the last slot alone where a row
    has none."""
    nm = obs_mask.shape[-1]
    last = torch.zeros(nm, dtype=torch.bool, device=obs_mask.device)
    last[-1] = True
    return torch.where(obs_mask.any(-1, keepdim=True), obs_mask.bool(), last)


def gru_run(x: torch.Tensor, mask: torch.Tensor, p: Params, prefix: str,
            reverse: bool) -> torch.Tensor:
    """Final hidden state [B, H] of one direction over x [B, S, IN]."""
    w_ih, w_hh = p[prefix + "w_ih"], p[prefix + "w_hh"]
    b_ih, b_hh = p[prefix + "b_ih"], p[prefix + "b_hh"]
    h = x.new_zeros(x.shape[0], w_hh.shape[0])
    slots = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for s in slots:
        gi = x[:, s] @ w_ih + b_ih
        gh = h @ w_hh + b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = torch.where(mask[:, s, None], (1.0 - z) * n + z * h, h)
    return h


def features(p: Params, obs_self, obs_nbr, obs_mask) -> torch.Tensor:
    lead = obs_self.shape[:-1]
    x = obs_nbr.reshape(-1, *obs_nbr.shape[-2:]).float()
    m = encoder_mask(obs_mask.reshape(-1, obs_mask.shape[-1]))
    h = (gru_run(x, m, p, "encoder.fwd.", False)
         + gru_run(x, m, p, "encoder.bwd.", True))
    feat = torch.cat([obs_self.reshape(-1, obs_self.shape[-1]).float(), h], dim=-1)
    feat = F.layer_norm(feat, feat.shape[-1:], p["encoder.ln.weight"],
                        p["encoder.ln.bias"], eps=1e-5)
    return feat.reshape(*lead, feat.shape[-1])


def mlp(p: Params, prefix: str, x: torch.Tensor, n_layers: int = 3) -> torch.Tensor:
    for i in range(n_layers):
        x = F.linear(x, p[f"{prefix}layers.{i}.weight"], p[f"{prefix}layers.{i}.bias"])
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def mean_action(p: Params, obs_self, obs_nbr, obs_mask) -> torch.Tensor:
    return torch.tanh(mlp(p, "actor.", features(p, obs_self, obs_nbr, obs_mask)))


def value(p: Params, obs_self, obs_nbr, obs_mask) -> torch.Tensor:
    return mlp(p, "critic.", features(p, obs_self, obs_nbr, obs_mask)).squeeze(-1)


def actor_critic(p: Params, obs_self, obs_nbr, obs_mask):
    """(mean action, value) on one pass of the encoder."""
    f = features(p, obs_self, obs_nbr, obs_mask)
    return torch.tanh(mlp(p, "actor.", f)), mlp(p, "critic.", f).squeeze(-1)


def std(p: Params, std_factor: float = 1.0) -> torch.Tensor:
    return torch.clamp(std_factor * torch.exp(p["log_std"]) + 1e-6, 1e-4, 10.0)


def logp_of(mu, sd, act) -> torch.Tensor:
    z = (act - mu) / sd
    return torch.sum(-0.5 * z * z - torch.log(sd) - 0.5 * LOG_2PI, dim=-1)


def logp(p: Params, obs_self, obs_nbr, obs_mask, act) -> torch.Tensor:
    return logp_of(mean_action(p, obs_self, obs_nbr, obs_mask), std(p), act)


def round2(x: torch.Tensor) -> torch.Tensor:
    """The env's action rounding in float32: x * 100 rounded half to even,
    times 0.01."""
    return torch.round(x * 100.0) * 0.01


def tie_distance(x: torch.Tensor) -> torch.Tensor:
    """How far x * 100 lies from a rounding boundary (k + 0.5)."""
    y = x.double() * 100.0
    return (y - torch.floor(y) - 0.5).abs()

