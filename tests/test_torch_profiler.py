"""The port's profiling helpers (rvo3d_tpu_torch/utils/profiler.py) on the
CPU: `trace` writes a Chrome trace holding the named regions and the ops
under them, and yields the profiler for key_averages(); `debug_nans`
raises on the first non-finite module output and restores autograd's
anomaly mode on exit; StepTimer counts steps and rates.
"""

import json
import time

import pytest
import torch

from rvo3d_tpu_torch.config import EnvParams, ModelConfig
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.profiler import StepTimer, debug_nans, trace
from rvo3d_tpu_torch.worlds import load_world

SMALL = ModelConfig(rnn_hidden_dim=16, hidden_sizes_ac=(16,), hidden_sizes_v=(16,))


def test_trace_writes_the_named_regions(tmp_path):
    wd = load_world("gen_demo")
    env = DroneEnv(wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num), num_envs=2)
    ac = ActorCritic(SMALL, device="cpu")
    state, out = env.reset()
    with trace(str(tmp_path)) as prof:
        for _ in range(2):
            with torch.profiler.record_function("policy"), torch.no_grad():
                act = ac(out.obs_self, out.obs_nbr, out.obs_mask)[0]
            with torch.profiler.record_function("env_step"):
                state, out = env.step(state, act)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("policy") == 2 and names.count("env_step") == 2
    ops = {e.key: e.count for e in prof.key_averages()}
    assert ops["policy"] == 2 and ops.get("aten::linear", 0) > 0


def test_debug_nans_raises_and_restores():
    ac = ActorCritic(SMALL, device="cpu")
    obs = (torch.zeros(3, 12), torch.zeros(3, 10, 9), torch.zeros(3, 10, dtype=torch.bool))
    with debug_nans():
        ac(*obs)                                    # finite: nothing raised
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        bad = (obs[0].clone().fill_(float("nan")),) + obs[1:]
        with pytest.raises(FloatingPointError, match="non-finite output of LayerNorm"):
            ac(*bad)
    assert not torch.is_anomaly_enabled()
    ac(obs[0].clone().fill_(float("nan")), *obs[1:])   # off again: no hook left
    with debug_nans(False):
        assert not torch.is_anomaly_enabled()


def test_step_timer():
    timer = StepTimer(ema=0.5)
    assert timer.steps_per_sec == 0.0
    time.sleep(0.01)
    first = timer.tick(10)
    time.sleep(0.01)
    second = timer.tick(30)
    assert timer.total_steps == 40 and 0 < first and 0 < second
    assert timer.steps_per_sec == pytest.approx(0.5 * first + 0.5 * second)
