"""The port's env in its other two modes against the NumPy oracle, 200
float64 steps, positions/rewards/observations to 1e-12, flags exact:

  - noise: the same pre-drawn control-noise samples go into both (the
    port scales standard normals by control_std, as the JAX env does);
  - eval (env_train=False): the shrunk collision radius. world16_dense is
    left out: on its trajectory the oracle itself raises (math domain
    error in asin at oracle.py:276, a pair inside r_a + r_b but outside
    the shrunk radius), where the JAX package and the port clamp.
"""

import pytest

from test_torch_env import WORLDS, get_world, run_oracle_parity

CASES = ([("noise", w) for w in WORLDS]
         + [("eval", w) for w in WORLDS if w != "world16_dense"])


@pytest.mark.parametrize("mode,world", CASES)
def test_f64_step_matches_oracle_in_mode(mode, world):
    max_pos, max_rew, max_obs, flags_ok, _ = run_oracle_parity(
        get_world(world), noise=mode == "noise", env_train=mode != "eval")
    assert flags_ok
    assert max_pos <= 1e-12 and max_rew <= 1e-12 and max_obs <= 1e-12, (
        max_pos, max_rew, max_obs)
