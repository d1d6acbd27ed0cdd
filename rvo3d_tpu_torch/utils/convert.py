"""Carry policy weights between the JAX package and the port.

The JAX package's ActorCritic params are a nested dict in the flax layout
(dense kernels [in, out]); the port's ActorCritic state_dict uses
nn.Linear's [out, in]. GRU weights keep the [in, 3H] / [H, 3H] layout in
both. Names:

  params/encoder/{fwd,bwd}/{w_ih,w_hh,b_ih,b_hh} <-> encoder.{fwd,bwd}.*
  params/encoder/ln/{scale,bias}                 <-> encoder.ln.{weight,bias}
  params/{actor,critic}/dense_i/kernel           <-> {actor,critic}.layers.i.weight (transposed)
  params/{actor,critic}/dense_i/bias             <-> {actor,critic}.layers.i.bias
  params/log_std                                 <-> log_std

The arrays are copied unchanged, so a round trip is exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_GRU = ("w_ih", "w_hh", "b_ih", "b_hh")


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': {...}} of numpy arrays (flax layout) -> port state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.array(a, copy=True))

    enc = p["encoder"]
    for direction in ("fwd", "bwd"):
        if direction in enc:
            for w in _GRU:
                put(f"encoder.{direction}.{w}", enc[direction][w])
    put("encoder.ln.weight", enc["ln"]["scale"])
    put("encoder.ln.bias", enc["ln"]["bias"])
    for head in ("actor", "critic"):
        layers = sorted(p[head], key=lambda k: int(k.split("_")[1]))
        for i, name in enumerate(layers):
            put(f"{head}.layers.{i}.weight", np.asarray(p[head][name]["kernel"]).T)
            put(f"{head}.layers.{i}.bias", p[head][name]["bias"])
    put("log_std", p["log_std"])
    return sd


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state_dict -> {'params': {...}} of numpy arrays (flax layout)."""
    def a(name):
        return sd[name].detach().cpu().numpy().copy()

    enc: Dict[str, Any] = {}
    for direction in ("fwd", "bwd"):
        if f"encoder.{direction}.w_ih" in sd:
            enc[direction] = {w: a(f"encoder.{direction}.{w}") for w in _GRU}
    enc["ln"] = {"scale": a("encoder.ln.weight"), "bias": a("encoder.ln.bias")}
    out: Dict[str, Any] = {"encoder": enc}
    for head in ("actor", "critic"):
        n = sum(1 for k in sd if k.startswith(f"{head}.layers.") and k.endswith(".weight"))
        out[head] = {f"dense_{i}": {"kernel": a(f"{head}.layers.{i}.weight").T.copy(),
                                    "bias": a(f"{head}.layers.{i}.bias")}
                     for i in range(n)}
    out["log_std"] = a("log_std")
    return {"params": out}
