"""Reference-policy import (rvo3d_tpu_torch/utils/torch_import.py) against
the JAX package's (rvo3d_tpu/utils/torch_import.py): a synthetic state dict
in the reference's naming, for each of GRU, biGRU and LSTM, goes through
JAX's convert_to_flax and the JAX ActorCritic, and through the port's
import and ActorCritic; mu, std and v agree at 1e-5 on ragged and empty
neighbour masks. Also: a `{"model_state": ...}` checkpoint loads as the
plain state dict does; a whole pickled module is refused with a message
that names what it needs, and the port's import leaves sys.path as it
was; `eval --torch_checkpoint` writes its results line in the JAX CLI's
format.
"""

import re
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.utils.torch_import import convert_to_flax
from rvo3d_tpu_torch import cli
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.torch_import import load_reference_policy
from test_torch_models import ragged_obs
from torch_threads import one_intra_op_thread  # noqa: F401

H = 16
NUM = r"-?[\d.]+(?:e-?\d+)?"
EVAL = re.compile(rf"^world=gen_demo success_rate={NUM}% EpLen={NUM}±{NUM} "
                  rf"speed={NUM}±{NUM} ret0=(?:{NUM}|inf|-inf|nan) \((\d+) episodes\)$")


def reference_state_dict(mode, seed=0, hidden=H, heads=(32, 32)):
    """Random tensors under the reference policy's names and shapes
    (torch layouts: nn.GRU/nn.LSTM [gates*H, in], nn.Linear [out, in])."""
    g = torch.Generator().manual_seed(seed)
    gates = 4 if mode == "LSTM" else 3

    def r(*shape):
        return torch.rand(shape, generator=g) - 0.5

    sd = {}
    for suffix in ("", "_reverse") if mode == "biGRU" else ("",):
        rnn = "pi.rnn_reader.rnn_net"
        sd[f"{rnn}.weight_ih_l0{suffix}"] = r(gates * hidden, 9)
        sd[f"{rnn}.weight_hh_l0{suffix}"] = r(gates * hidden, hidden)
        sd[f"{rnn}.bias_ih_l0{suffix}"] = r(gates * hidden)
        sd[f"{rnn}.bias_hh_l0{suffix}"] = r(gates * hidden)
    sd["pi.rnn_reader.ln.weight"] = 1.0 + r(12 + hidden)
    sd["pi.rnn_reader.ln.bias"] = r(12 + hidden)
    for prefix, out in (("pi.net_out", 3), ("v.v_net", 1)):
        dims = [12 + hidden, *heads, out]
        for idx, (a, b) in zip((0, 2, 4), zip(dims, dims[1:])):
            sd[f"{prefix}.{idx}.weight"] = r(b, a)
            sd[f"{prefix}.{idx}.bias"] = r(b)
    sd["pi.log_std"] = torch.full((3,), -1.3)
    return sd


@pytest.mark.parametrize("mode", ["GRU", "biGRU", "LSTM"])
def test_reference_state_dict_forward_matches_jax(mode, tmp_path):
    sd = reference_state_dict(mode)
    path = str(tmp_path / "policy.pt")
    torch.save(sd, path)
    kw = dict(rnn_mode=mode, rnn_hidden_dim=H, hidden_sizes_ac=(32, 32),
              hidden_sizes_v=(32, 32))
    jparams = convert_to_flax({k: v.numpy() for k, v in sd.items()}, rnn_mode=mode)
    jac = JActorCritic(JModelConfig(**kw))
    ac = ActorCritic(ModelConfig(**kw), device="cpu")
    ac.load_state_dict(load_reference_policy(path, mode))
    obs = ragged_obs(seed=6)
    ref = jac.apply(jparams, *map(jnp.asarray, obs), 1.0)
    with torch.no_grad():
        got = ac(*map(torch.from_numpy, obs))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-6)


def test_model_state_wrapper_and_pickled_module(tmp_path):
    sd = reference_state_dict("biGRU")
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({"model_state": sd, "pi_optimizer": {}, "vf_optimizer": {}},
               tmp_path / "wrapped.pt")
    plain = load_reference_policy(str(tmp_path / "plain.pt"))
    wrapped = load_reference_policy(str(tmp_path / "wrapped.pt"))
    assert plain.keys() == wrapped.keys()
    assert all(torch.equal(plain[k], wrapped[k]) for k in plain)

    torch.save(torch.nn.Linear(3, 3), tmp_path / "module.pt")
    path_before = list(sys.path)
    with pytest.raises(ValueError, match="pickled module needs the reference's training"):
        load_reference_policy(str(tmp_path / "module.pt"))
    assert sys.path == path_before


def test_eval_torch_checkpoint_line_matches_the_jax_format(tmp_path):
    """The eval line's format is the JAX CLI's (rvo3d_tpu/cli.py cmd_eval;
    tests/test_torch_cli.py runs both CLIs' eval and matches the same
    pattern); an LSTM-256 policy at the CLI's default heads."""
    sd = reference_state_dict("LSTM", hidden=256, heads=(256, 256))
    path = str(tmp_path / "policy.pt")
    torch.save({"model_state": sd}, path)
    res = str(tmp_path / "results.txt")
    assert cli.main(["eval", "--device", "cpu", "--world", "gen_demo",
                     "--torch_checkpoint", path, "--rnn_mode", "LSTM", "--episodes", "4",
                     "--lanes", "4", "--max_ep_len", "20", "--results_file", res]) == 0
    lines = open(res).read().splitlines()
    assert len(lines) == 1 and EVAL.match(lines[0]), lines
    assert int(EVAL.match(lines[0]).group(1)) == 4
