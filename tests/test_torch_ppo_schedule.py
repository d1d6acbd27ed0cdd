"""The port's ppo_update and a resume from the JAX package's optimizer
state, against rvo3d_tpu/algo/ppo.py (helpers and the small policy of
tests/test_torch_ppo.py):

  - ppo_update in batched and in sequential mode, with the JAX agent order
    and minibatch offsets injected: metrics and params after the update
    at rtol 1e-4 (plus atol 1e-6 for params and first_loss, 1e-7 for kl);
  - a resume: the JAX optimizer states after one update, carried to the
    port's Adams by utils/convert.py, then one more update on both sides,
    at the same tolerances; the state written back into the optax tree
    equals the JAX one exactly before the second update, and its moments
    after it agree at rtol 1e-3 (atol 1e-9: second moments of small
    gradients);
  - a JAX state whose mask differs from the optimizer's is refused.
"""

import jax
import numpy as np
import optax
import pytest

from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu_torch.algo import ppo
from rvo3d_tpu_torch.utils.convert import (flax_to_state_dict, optax_adam_to_torch,
                                           torch_adam_to_optax)
from test_torch_ppo import (as_jax, as_port, assert_metrics_match,
                            assert_params_match, configs, jax_offsets, jax_state,
                            make_data, policies)


@pytest.mark.parametrize("batched", [True, False])
def test_ppo_update_matches_jax(batched):
    jcfg, tcfg = configs(batched_update=batched, max_update_num=2, minibatch=24)
    jac, params, ac = policies()
    data = make_data(jac, params, (8, 2, 3))            # [T, E, N]
    key = jax.random.PRNGKey(11)
    pi_tx, vf_tx, state = jax_state(jcfg, params)
    new_state, jm = jax.jit(lambda s, d: jppo.ppo_update(
        jac, jcfg, pi_tx, vf_tx, s, d, key))(state, as_jax(data))
    if batched:
        perm, offsets = None, [jax_offsets(jcfg, key, 48)]
    else:
        perm = np.asarray(jax.random.permutation(key, 3)).tolist()
        offsets = [jax_offsets(jcfg, jax.random.fold_in(key, k), 16) for k in range(2)]
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    got = ppo.ppo_update(ac, tcfg, pi_opt, vf_opt, as_port(data), perm=perm,
                         offsets=offsets)
    n_upd = 1 if batched else 2
    assert all(x.shape == (n_upd,) for x in got)
    for k in range(n_upd):
        assert_metrics_match([x[k] for x in got], [x[k] for x in jm])
    assert_params_match(ac, new_state.params)


def test_resume_from_jax_optimizer_state():
    jcfg, tcfg = configs()
    jac, params, ac = policies()
    pi_tx, vf_tx, state = jax_state(jcfg, params)
    upd = jax.jit(lambda s, d, k: jppo.update_one_agent(
        jac, jcfg, pi_tx, vf_tx, s, d, key=k))
    first = make_data(jac, params, (96,), seed=2)
    state, _ = upd(state, as_jax(first), jax.random.PRNGKey(3))
    np_state = jax.tree_util.tree_map(np.asarray, state)

    # carry the JAX state across, then one more update on both sides
    ac.load_state_dict(flax_to_state_dict(np_state.params))
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    optax_adam_to_torch(np_state.pi_opt, pi_opt, ac)
    optax_adam_to_torch(np_state.vf_opt, vf_opt, ac)
    for opt, jopt in ((pi_opt, np_state.pi_opt), (vf_opt, np_state.vf_opt)):
        back = torch_adam_to_optax(opt, ac, jopt)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jopt)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jopt)

    second = make_data(jac, state.params, (96,), seed=4)
    key = jax.random.PRNGKey(5)
    state2, jm = upd(state, as_jax(second), key)
    got = ppo.update_one_agent(ac, tcfg, pi_opt, vf_opt, as_port(second),
                               offsets=jax_offsets(jcfg, key, 96))
    assert_metrics_match(got, jm)
    assert_params_match(ac, state2.params)
    back = torch_adam_to_optax(pi_opt, ac, np_state.pi_opt)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state2.pi_opt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-9)


def test_optax_state_must_match_the_optimizer():
    jcfg, tcfg = configs(vf_encoder=False)
    _, params, ac = policies()
    pi_tx, _ = jppo.make_optimizers(configs()[0], params)
    state = jax.tree_util.tree_map(np.asarray, pi_tx.init(params))
    _, vf_opt = ppo.make_optimizers(tcfg, ac)
    with pytest.raises(ValueError, match="mask"):
        optax_adam_to_torch(state, vf_opt, ac)
    assert isinstance(optax.MaskedNode(), tuple)
