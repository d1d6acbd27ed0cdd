"""The port's GAE (rvo3d_tpu_torch/algo/gae.py) against the JAX package's
gae_advantages and against the reference's lfilter form (the same one
tests/test_algo.py holds the JAX function to).

Tolerances: port vs JAX in float32 at atol 1e-6 plus rtol 1e-5 (the same
recursion; XLA contracts the multiply-adds into FMAs, so single-ulp
differences build up over the 48 steps); port vs the float64 lfilter form at atol 1e-4 in
float32 (as tests/test_algo.py) and 1e-10 in float64.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import scipy.signal
import torch

from rvo3d_tpu.algo.gae import gae_advantages as j_gae
from rvo3d_tpu_torch.algo.gae import gae_advantages

GAMMA, LAM = 0.99, 0.97


def discount_cumsum(x, discount):
    return scipy.signal.lfilter([1], [1, float(-discount)], x[::-1], axis=0)[::-1]


def lfilter_paths(rews, vals, cut, gamma, lam):
    """finish_path(0) of the reference over segments that end at cuts."""
    adv, ret = np.zeros(len(rews)), np.zeros(len(rews))
    start = 0
    for t in range(len(rews)):
        if cut[t]:
            r = np.append(rews[start:t + 1], 0.0)
            v = np.append(vals[start:t + 1], 0.0)
            deltas = r[:-1] + gamma * v[1:] - v[:-1]
            adv[start:t + 1] = discount_cumsum(deltas, gamma * lam)
            ret[start:t + 1] = discount_cumsum(r, gamma)[:-1]
            start = t + 1
    return adv, ret


def random_case(seed, t_len=48, e=4, n=3):
    rng = np.random.default_rng(seed)
    rews = rng.standard_normal((t_len, e, n)).astype(np.float32)
    vals = rng.standard_normal((t_len, e, n)).astype(np.float32)
    cut = rng.random((t_len, e)) < 0.15
    cut[-1] = True                       # an epoch always ends with a cut
    return rews, vals, cut


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_matches_jax(seed):
    rews, vals, cut = random_case(seed)
    adv_j, ret_j = j_gae(jnp.asarray(rews), jnp.asarray(vals),
                         jnp.asarray(cut[:, :, None]), GAMMA, LAM)
    adv, ret = gae_advantages(torch.from_numpy(rews), torch.from_numpy(vals),
                              torch.from_numpy(cut[:, :, None]), GAMMA, LAM)
    assert adv.dtype == torch.float32 and adv.shape == rews.shape
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-4), (np.float64, 1e-10)])
def test_gae_matches_reference_lfilter(dtype, atol):
    rews, vals, cut = random_case(3)
    adv, ret = gae_advantages(torch.from_numpy(rews.astype(dtype)),
                              torch.from_numpy(vals.astype(dtype)),
                              torch.from_numpy(cut[:, :, None]), GAMMA, LAM)
    for e in range(rews.shape[1]):
        for i in range(rews.shape[2]):
            ref_adv, ref_ret = lfilter_paths(rews[:, e, i].astype(np.float64),
                                             vals[:, e, i].astype(np.float64),
                                             cut[:, e], GAMMA, LAM)
            np.testing.assert_allclose(adv[:, e, i].numpy(), ref_adv, atol=atol, rtol=0)
            np.testing.assert_allclose(ret[:, e, i].numpy(), ref_ret, atol=atol, rtol=0)


def test_collision_resets_do_not_cut():
    """Without a cut the value bootstraps across the whole path."""
    adv, ret = gae_advantages(torch.ones(3), torch.full((3,), 0.5),
                              torch.tensor([False, False, True]), 1.0, 1.0)
    assert float(ret[0]) == pytest.approx(3.0)
    assert float(adv[0]) == pytest.approx(2.5)
