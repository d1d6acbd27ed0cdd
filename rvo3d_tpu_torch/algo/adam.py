"""Adam for the learner's device programs: optax.adam's arithmetic in
torch.optim.Adam's state layout, with every number on the parameters'
device and a device flag that holds a step back.

The JAX learner steps with optax.adam inside one compiled program, and its
KL early stop `_select`s the params and the optimizer state back where the
stop fired (rvo3d_tpu/algo/ppo.py). For the port to run that program as a
CUDA graph (utils/graphs.py), the step may read nothing on the host:

  - the step count is a float32 tensor on the parameter's device, and the
    bias corrections are computed there as optax computes them:
    mu_hat = mu / (1 - b1**count), nu_hat = nu / (1 - b2**count), the
    update -lr * mu_hat / (sqrt(nu_hat) + eps), with count the float32
    count after the increment;
  - step(keep=flag) takes a bool tensor: where it is false the params, both
    moments and the count keep their values bit for bit.

The state keeps torch.optim.Adam's layout ({"step", "exp_avg",
"exp_avg_sq"} per parameter; the param groups are torch.optim.Adam's), so
checkpoints (utils/checkpoint.py), the optax <-> torch conversion
(utils/convert.py) and the tensor-parallel gathers read it unchanged. A
parameter without a gradient is skipped, as torch.optim.Adam skips it.
The same code runs on the CPU and on a card (torch.optim.Adam's own
`capturable` mode refuses CPU tensors).
"""

from __future__ import annotations

import torch


class Adam(torch.optim.Adam):
    """Adam(params, lr, betas=(0.9, 0.999), eps=1e-8); the module's
    docstring. load_state_dict writes into the state tensors this optimizer
    already holds, so a captured step goes on reading the loaded state."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif st["step"].device != p.device or st["step"].dtype != torch.float32:
            # a state loaded with its count on the CPU (torch.optim.Adam's)
            st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
        return st

    @torch.no_grad()
    def step(self, closure=None, keep: torch.Tensor = None):
        """One step of every parameter with a gradient; `keep` (a bool
        tensor, None for always) applies it only where true."""
        if closure is not None:
            raise ValueError("this Adam takes no closure")
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._state(p)
                g = p.grad
                count = st["step"] + 1.0
                m = (1 - b1) * g + b1 * st["exp_avg"]
                v = (1 - b2) * (g * g) + b2 * st["exp_avg_sq"]
                m_hat = m / (1 - torch.pow(b1, count))
                v_hat = v / (1 - torch.pow(b2, count))
                new = p + (m_hat / (torch.sqrt(v_hat) + eps)) * (-lr)
                for old, x in ((p, new), (st["step"], count), (st["exp_avg"], m),
                               (st["exp_avg_sq"], v)):
                    old.copy_(x if keep is None else torch.where(keep, x, old))
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """torch.optim.Adam's load, the count on the parameter's device; a
        parameter that already has state keeps its tensors and gets the
        loaded values copied in (zeros, a fresh state, where the loaded
        dict has none for it)."""
        held = {p: st for p, st in self.state.items() if st}
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                loaded = self.state[p] if p in self.state else {}
                if loaded:
                    loaded = self._state(p)
                old = held.get(p)
                if old is None:
                    continue
                for name, t in old.items():
                    if loaded:
                        t.copy_(loaded[name])
                    else:
                        t.zero_()
                self.state[p] = old
