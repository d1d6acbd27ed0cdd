"""Import a policy trained by the reference's PyTorch code into the port
(counterpart of rvo3d_tpu/utils/torch_import.py, which builds flax params).

The reference saves `{model_state, pi_optimizer, vf_optimizer}` state-dict
checkpoints and whole pickled modules (multi_ppo.py). A state dict (plain,
or under "model_state") becomes the port's `ActorCritic.state_dict()`
directly. A pickled module needs the reference's training classes to
unpickle; the port does not import them, and refuses such a file.

Reference name -> port name (the port's dense layers keep nn.Linear's
[out, in]; its recurrent weights are stored [in, gates*H]):
  pi.rnn_reader.rnn_net.weight_ih_l0[_reverse] -> encoder.{fwd,bwd}.w_ih (transposed)
  pi.rnn_reader.rnn_net.weight_hh_l0[_reverse] -> encoder.{fwd,bwd}.w_hh (transposed)
  pi.rnn_reader.rnn_net.bias_{ih,hh}_l0[_reverse] -> encoder.{fwd,bwd}.b_{ih,hh}
  pi.rnn_reader.ln.{weight,bias}               -> encoder.ln.{weight,bias}
  pi.net_out.{0,2,4}.{weight,bias}             -> actor.layers.{0,1,2}.*
  v.v_net.{0,2,4}.{weight,bias}                -> critic.layers.{0,1,2}.*
  pi.log_std                                   -> log_std
The GRU keeps torch's gate order (r, z, n), the LSTM (i, f, g, o).
"""

from __future__ import annotations

import pickle
from typing import Dict

import torch

_RNN = "pi.rnn_reader.rnn_net"


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's policy state dict (name -> tensor)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} is not a state dict: a whole pickled module needs the "
            "reference's training code (its policy classes) to unpickle, which "
            "rvo3d_tpu_torch does not import; save the module's state_dict() "
            "(or {'model_state': state_dict}) and import that") from e
    sd = obj["model_state"] if isinstance(obj, dict) and "model_state" in obj else obj
    if not (isinstance(sd, dict) and all(isinstance(v, torch.Tensor) for v in sd.values())):
        raise ValueError(f"{path} holds no state dict of tensors")
    return sd


def convert_to_state_dict(sd: Dict[str, torch.Tensor], rnn_mode: str = "biGRU"
                          ) -> Dict[str, torch.Tensor]:
    """The port's ActorCritic state dict from a reference state dict."""
    if rnn_mode not in ("GRU", "biGRU", "LSTM"):
        raise ValueError(f"unknown rnn mode {rnn_mode!r} (GRU, biGRU, LSTM)")

    def t(name, transpose=False):
        x = sd[name].detach()
        return (x.t() if transpose else x).contiguous().clone()

    out = {}
    dirs = [("fwd", "")] + ([("bwd", "_reverse")] if rnn_mode == "biGRU" else [])
    for d, suffix in dirs:
        out[f"encoder.{d}.w_ih"] = t(f"{_RNN}.weight_ih_l0{suffix}", True)
        out[f"encoder.{d}.w_hh"] = t(f"{_RNN}.weight_hh_l0{suffix}", True)
        out[f"encoder.{d}.b_ih"] = t(f"{_RNN}.bias_ih_l0{suffix}")
        out[f"encoder.{d}.b_hh"] = t(f"{_RNN}.bias_hh_l0{suffix}")
    out["encoder.ln.weight"] = t("pi.rnn_reader.ln.weight")
    out["encoder.ln.bias"] = t("pi.rnn_reader.ln.bias")
    for head, prefix in (("actor", "pi.net_out"), ("critic", "v.v_net")):
        for i, idx in enumerate((0, 2, 4)):
            out[f"{head}.layers.{i}.weight"] = t(f"{prefix}.{idx}.weight")
            out[f"{head}.layers.{i}.bias"] = t(f"{prefix}.{idx}.bias")
    out["log_std"] = t("pi.log_std")
    return out


def load_reference_policy(path: str, rnn_mode: str = "biGRU") -> Dict[str, torch.Tensor]:
    """A reference checkpoint -> the port's ActorCritic state dict."""
    return convert_to_state_dict(load_torch_state_dict(path), rnn_mode)
