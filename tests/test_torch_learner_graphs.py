"""The port's learner as device programs (algo/adam.py, algo/ppo.PPOUpdate,
the trainer's GAE step, algo/bc.fit), on the CPU.

A CUDA graph runs only on a card, so here graphs.StepGraph is replaced by
tests/test_torch_graphs.py's EagerSteps stand-in (the body at every step)
and graphs.on_card says yes to the CPU, so the learner builds its
graph-ready steps: the static buffers, the windows gathered at a device
iteration index, the KL stop as a device flag with Adam's `keep`, GAE
into the static batch, the BC step over a static index buffer. Small
policy: H = 32, heads (32, 32); gen_demo for the trainer.

  - Adam against optax.adam over 50 float32 steps (rtol 1e-5, atol 1e-9
    on the second moments, which start at zero) and against
    torch.optim.Adam (rtol 1e-5: the two round the bias correction
    differently, and torch's first moment, a lerp, another way: atol 1e-7
    there, where it passes through zero); a `keep=False` step leaves params, moments and the count
    equal; the state dict round-trips through utils/checkpoint.py (into
    the tensors the optimizer holds) and through utils/convert.py.
  - The graph-ready update against JAX's update_one_agent / ppo_update at
    tests/test_torch_ppo.py's tolerances (rtol 1e-4, atol 1e-6; kl atol
    1e-7; iters exact): batched, per agent in the JAX order, minibatch
    windows, the KL stop at iteration 0, midway and never, freeze_encoder
    with adv_norm, vf_encoder=False with value_clip, fresh_logp with
    ent_coef.
  - The graph-ready update equal (torch.equal) to its own bodies called
    eagerly: params, both Adams' states, metrics; the iterations after a
    KL stop change nothing (the same as an update that ends there).
  - GAE computed into the static batch equal to gae_advantages and to
    JAX's at tests/test_torch_gae.py's atol 1e-6 / rtol 1e-5.
  - The graph-ready BC fit against JAX's bc_pretrain at
    tests/test_torch_bc.py's tolerance (params rtol 1e-4, atol 1e-6; loss
    rtol 1e-4) and equal to its eager body.
  - Two epochs of make_train_epoch on gen_demo, graph-ready, against the
    JAX trainer's at tests/test_torch_trainer.py's tolerances.
The graphs themselves are held to these bodies on the card by the `gpu`
cases of tests/test_torch_cuda.py and chip_smoke.py's `learner_graphs`.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from rvo3d_tpu.algo import bc as jbc
from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu.algo.gae import gae_advantages as j_gae
from rvo3d_tpu.algo.rollout import init_rollout_carry as j_init
from rvo3d_tpu.algo.trainer import make_train_epoch as j_make_train_epoch
from rvo3d_tpu.config import Config as JConfig
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu_torch.algo import bc, ppo
from rvo3d_tpu_torch.algo.adam import Adam
from rvo3d_tpu_torch.algo.gae import gae_advantages
from rvo3d_tpu_torch.algo.rollout import RolloutBatch, init_rollout_carry
from rvo3d_tpu_torch.algo.trainer import make_train_epoch
from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import graphs
from rvo3d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from rvo3d_tpu_torch.utils.convert import (flax_to_state_dict, optax_adam_to_torch,
                                           torch_adam_to_optax)
from rvo3d_tpu_torch.worlds import load_world
from test_torch_bc import STEPS, JaxDraws
from test_torch_bc import E as BC_E
from test_torch_bc import N as BC_N
from test_torch_bc import worlds as bc_worlds
from test_torch_graphs import eager_graphs  # noqa: F401  (a fixture)
from test_torch_ppo import (as_jax, as_port, assert_metrics_match, assert_params_match,
                            jax_offsets, make_data)
from test_torch_rollout import compare_carry, inject, jax_eps, np_

SMALL = dict(rnn_hidden_dim=32, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))
BASE = dict(pi_lr=3e-3, vf_lr=3e-3, train_pi_iters=4, train_v_iters=3,
            minibatch=40, target_kl=0.05)
JAC = JActorCritic(JModelConfig(**SMALL))
LEAD = (6, 4, 4)        # T, E, N of the update's batch: 96 rows, 24 an agent


@functools.lru_cache(maxsize=None)
def _init(seed):
    return jax.jit(JAC.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 12)),
                             jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))


def policies(seed=0):
    """(flax module, its params, the port's policy with the same params)."""
    params = _init(seed)
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return JAC, params, ac


def configs(**kw):
    kw = {**BASE, **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def opt_state(opt):
    """Every state tensor of an optimizer, cloned, in parameter order."""
    return [{k: v.clone() for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"] if p in opt.state]


def assert_states_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


# ---- algo/adam.py ----

def adam_problem(seed=0, n_steps=50):
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(n_steps)]
    return p0, grads


def test_adam_matches_optax_and_torch_adam():
    lr = 3e-3
    p0, grads = adam_problem()
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    jp = [jnp.asarray(x) for x in p0]
    st = tx.init(jp)
    upd = jax.jit(tx.update)
    for g in grads:
        u, st = upd([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)

    ours = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    ref = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt, topt = Adam(ours, lr=lr), torch.optim.Adam(ref, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        for p, q, x in zip(ours, ref, g):
            p.grad, q.grad = torch.from_numpy(x.copy()), torch.from_numpy(x.copy())
        opt.step()
        topt.step()
    mu, nu = st[0].mu, st[0].nu
    for p, q, j, m, v in zip(ours, ref, jp, mu, nu):
        s = opt.state[p]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=1e-5)
        np.testing.assert_allclose(s["exp_avg"].numpy(), np.asarray(m), rtol=1e-5)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-9)
        assert float(s["step"]) == int(st[0].count) == len(grads)
        assert s["step"].dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5)
        ts = topt.state[q]
        np.testing.assert_allclose(s["exp_avg"].numpy(), ts["exp_avg"].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(), ts["exp_avg_sq"].numpy(),
                                   rtol=1e-5)


def test_adam_keep_false_changes_nothing():
    p0, grads = adam_problem(seed=1, n_steps=6)
    params = [torch.nn.Parameter(torch.from_numpy(x)) for x in p0]
    twin = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt, opt2 = Adam(params, lr=1e-2), Adam(twin, lr=1e-2)
    for i, g in enumerate(grads):
        for p, q, x in zip(params, twin, g):
            p.grad, q.grad = torch.from_numpy(x.copy()), torch.from_numpy(x.copy())
        before = ([p.detach().clone() for p in params], opt_state(opt))
        keep = torch.tensor(i % 2 == 0)
        opt.step(keep=keep)
        if keep:
            opt2.step()
            for p, q in zip(params, twin):         # keep=True is a plain step
                assert torch.equal(p, q)
            assert_states_equal(opt_state(opt), opt_state(opt2))
        else:                                      # held back bit for bit
            for p, b in zip(params, before[0]):
                assert torch.equal(p, b)
            assert_states_equal(opt_state(opt), before[1])
            for p, q in zip(params, twin):
                q.data.copy_(p.data)


def test_adam_state_round_trips(tmp_path):
    jcfg, tcfg = configs()
    jac, params, ac = policies()
    cfg = Config(model=ModelConfig(**SMALL), train=tcfg)
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    data = make_data(jac, params, (96,))
    ppo.update_one_agent(ac, tcfg, pi_opt, vf_opt, as_port(data))
    state = ppo.PPOState(ac, pi_opt, vf_opt)
    save_checkpoint(str(tmp_path), 0, state, cfg)
    saved = [opt_state(o) for o in (pi_opt, vf_opt)]

    # into a fresh policy's optimizers, and into optimizers that hold
    # state already: the loaded values go into the tensors they hold
    fresh = policies(1)[2]
    fresh_state = ppo.PPOState(fresh, *ppo.make_optimizers(tcfg, fresh))
    restore_checkpoint(str(tmp_path), fresh_state)
    for opt, ref in zip(fresh_state[1:], saved):
        assert_states_equal(opt_state(opt), ref)
    ppo.update_one_agent(fresh, tcfg, *fresh_state[1:], as_port(data))
    held = [[t.data_ptr() for s in opt.state.values() for t in s.values()]
            for opt in fresh_state[1:]]
    restore_checkpoint(str(tmp_path), fresh_state)
    for opt, ref, ptrs in zip(fresh_state[1:], saved, held):
        assert_states_equal(opt_state(opt), ref)
        assert [t.data_ptr() for s in opt.state.values() for t in s.values()] == ptrs

    # optax <-> torch: the JAX optimizer states from these, and back
    for opt, tx in zip((pi_opt, vf_opt), jppo.make_optimizers(jcfg, params)):
        template = jax.tree_util.tree_map(np.asarray, tx.init(params))
        back = type(opt)(list(opt.param_groups[0]["params"]), lr=opt.param_groups[0]["lr"])
        optax_adam_to_torch(torch_adam_to_optax(opt, ac, template), back, ac)
        assert_states_equal(opt_state(back), opt_state(opt))


# ---- algo/ppo.PPOUpdate against JAX ----

UPDATE_CASES = {
    "batched": dict(batched_update=True),
    "per_agent": dict(minibatch=16, max_update_num=3),
    "kl_stop_0": dict(shift=0.5),
    "kl_stop_mid": dict(target_kl=2e-3, train_pi_iters=10, pi_lr=1e-2),
    "kl_never": dict(target_kl=10.0),
    "freeze_encoder_adv_norm": dict(freeze_encoder=True, adv_norm=True),
    "vf_encoder_value_clip": dict(vf_encoder=False, value_clip=0.05),
    "fresh_logp_ent": dict(fresh_logp=True, ent_coef=0.01),
}


def run_update(case, with_jax=True):
    """The case's update on the port (as the test has set up graphs) and
    its JAX reference: (port config, policy, optimizers, metrics, JAX
    state, JAX metrics), metrics as (pi_loss, v_loss, kl, pi_iters) rows
    per agent; without JAX the last two are None."""
    kw = dict(UPDATE_CASES[case])
    shift = kw.pop("shift", 0.0)
    jcfg, tcfg = configs(**kw)
    jac, params, ac = policies()
    pi_tx, vf_tx = jppo.make_optimizers(jcfg, params)
    state = jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    key = jax.random.PRNGKey(7)
    if case in ("batched", "per_agent"):
        data = make_data(jac, params, LEAD)
        new, jm = jax.jit(lambda s, d: jppo.ppo_update(
            jac, jcfg, pi_tx, vf_tx, s, d, key))(state, as_jax(data)) if with_jax else (
            None, None)
        n = LEAD[2]
        if tcfg.batched_update:
            perm, offsets = None, [jax_offsets(jcfg, key, data["act"].size // 3)]
        else:
            perm = np.asarray(jax.random.permutation(key, n)).tolist()
            offsets = [jax_offsets(jcfg, jax.random.fold_in(key, k), LEAD[0] * LEAD[1])
                       for k in range(min(tcfg.max_update_num, n))]
        got = ppo.ppo_update(ac, tcfg, pi_opt, vf_opt, as_port(data), perm=perm,
                             offsets=offsets)
        rows = [[x[k] for x in got] for k in range(got.pi_loss.shape[0])]
        jrows = jm and [[x[k] for x in jm] for k in range(jm.pi_loss.shape[0])]
    else:
        data = make_data(jac, params, (96,), logp_shift=shift)
        new, jm = jax.jit(lambda s, d: jppo.update_one_agent(
            jac, jcfg, pi_tx, vf_tx, s, d, key=key))(state, as_jax(data)) if with_jax else (
            None, None)
        got = ppo.update_one_agent(ac, tcfg, pi_opt, vf_opt, as_port(data),
                                   offsets=jax_offsets(jcfg, key, 96))
        rows, jrows = [list(got)], jm and [list(jm)]
    return tcfg, ac, (pi_opt, vf_opt), rows, new, jrows


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_graph_ready_update_matches_jax(eager_graphs, case):  # noqa: F811
    tcfg, ac, _, rows, new, jrows = run_update(case)
    for got, ref in zip(rows, jrows):
        assert_metrics_match(got, ref)
    assert_params_match(ac, new.params)
    iters = [int(r[3]) for r in rows]
    n_pi = tcfg.train_pi_iters
    if case == "kl_stop_0":
        assert iters == [0]
    elif case == "kl_stop_mid":
        assert 0 < iters[0] < n_pi
    elif case == "kl_never":
        assert iters == [n_pi]
    # one policy and one value step, captured once, replayed per agent
    assert [g.steps for g in eager_graphs] == [len(rows) * n_pi,
                                               len(rows) * tcfg.train_v_iters]


@pytest.mark.parametrize("case", ["per_agent", "kl_stop_mid", "fresh_logp_ent"])
def test_graph_ready_update_equals_its_eager_body(eager_graphs, monkeypatch, case):  # noqa: F811
    runs = []
    for card in (True, False):
        monkeypatch.setattr(graphs, "on_card", lambda device, card=card: card)
        _, ac, opts, rows, _, _ = run_update(case, with_jax=False)
        runs.append(({k: v.clone() for k, v in ac.state_dict().items()},
                     [opt_state(o) for o in opts], rows))
    assert len(eager_graphs) == 2                 # the graph-ready run's pi and v steps
    (p1, s1, m1), (p2, s2, m2) = runs
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for a, b in zip(s1, s2):
        assert_states_equal(a, b)
    for a, b in zip(m1, m2):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_iterations_after_a_kl_stop_change_nothing(eager_graphs):  # noqa: F811
    """Stopped at iteration j of 10: the same params, Adam states, first
    loss, v loss and step count as an update of j iterations that never
    stops (kl differs: the stopped update keeps the stopping kl)."""
    jac, params, _ = policies()
    data = as_port(make_data(jac, params, (96,)))
    _, tcfg = configs(target_kl=2e-3, train_pi_iters=10, pi_lr=1e-2)
    offsets = jax_offsets(tcfg, jax.random.PRNGKey(7), 96)
    out = []
    for n_pi, target in ((10, 2e-3), (None, 10.0)):
        ac = policies()[2]
        if n_pi is None:                     # the stopped run's applied steps
            n_pi = int(out[0][2][3])
            assert 0 < n_pi < 10
        cfg = dataclasses.replace(tcfg, train_pi_iters=n_pi, target_kl=target)
        opts = ppo.make_optimizers(cfg, ac)
        got = ppo.update_one_agent(ac, cfg, *opts, data,
                                   offsets=(offsets[0][:n_pi], offsets[1]))
        out.append((ac.state_dict(), [opt_state(o) for o in opts], got))
    (p1, s1, m1), (p2, s2, m2) = out
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for a, b in zip(s1, s2):
        assert_states_equal(a, b)
    for i in (0, 1, 3):
        assert torch.equal(m1[i], m2[i])


# ---- GAE into the static batch ----

def test_gae_step_equals_gae_advantages_and_jax(eager_graphs):  # noqa: F811
    rng = np.random.default_rng(3)
    t_len, e, n = 48, 3, 4
    rew = rng.standard_normal((t_len, e, n)).astype(np.float32)
    val = rng.standard_normal((t_len, e, n)).astype(np.float32)
    cut = rng.random((t_len, e)) < 0.1
    cut[-1] = True
    z = lambda *s: torch.zeros(s)                                       # noqa: E731
    batch = RolloutBatch(obs_self=z(t_len, e, n, 12), obs_nbr=z(t_len, e, n, 10, 9),
                         obs_mask=torch.zeros(t_len, e, n, 10, dtype=torch.bool),
                         act=z(t_len, e, n, 3), rew=torch.from_numpy(rew),
                         val=torch.from_numpy(val), logp=z(t_len, e, n),
                         cut=torch.from_numpy(cut))
    _, tcfg = configs()
    ac = policies()[2]
    learner = ppo.PPOUpdate(ac, tcfg, *ppo.make_optimizers(tcfg, ac))
    for _ in range(2):                       # the warm-up, then the captured step
        data = learner.prepare(batch)
    adv, ret = gae_advantages(batch.rew, batch.val, batch.cut[:, :, None],
                              tcfg.gamma, tcfg.lam)
    assert torch.equal(data.adv, adv) and torch.equal(data.ret, ret)
    jadv, jret = j_gae(jnp.asarray(rew), jnp.asarray(val), jnp.asarray(cut)[:, :, None],
                       tcfg.gamma, tcfg.lam)
    for a, b in ((data.adv, jadv), (data.ret, jret)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)
    assert [g.steps for g in eager_graphs] == [2]


# ---- algo/bc.fit ----

def bc_run(conflict_weight=30.0):
    jw, tw = bc_worlds()
    jp, tp = JEnvParams(num_drones=BC_N), EnvParams(num_drones=BC_N)
    jac, params, ac = policies(seed=2)
    kw = dict(num_envs=BC_E, demo_steps=STEPS, train_steps=20, batch=64, lr=1e-3,
              expert="rvo", action_mode="direct", explore_std=0.1, expert_margin=0.3,
              dagger_rounds=1, conflict_weight=conflict_weight)
    key = jax.random.PRNGKey(5)
    draws, idx = JaxDraws(), {}
    cap = STEPS * BC_E * BC_N * 2
    k = key
    for r in range(2):          # tests/test_torch_bc.py's JAX key schedule
        k_round, k_train, k = jax.random.split(k, 3)
        k_round, k_demo = jax.random.split(k_round)
        draws.add_demo(k_demo, STEPS, (BC_E, BC_N, 3), True, False)
        n_valid = STEPS * BC_E * BC_N * (r + 1)
        for s in range(20):
            k_train, ks = jax.random.split(k_train)
            idx[(r, s)] = torch.from_numpy(np.asarray(
                jax.random.randint(ks, (min(64, cap),), 0, n_valid)).astype(np.int64))
    loss = bc.bc_pretrain(ac, tw, tp, torch.Generator(), randn=draws,
                          indices=lambda r, s: idx[(r, s)], **kw)
    assert not draws.queue
    return ac, loss, (jac, params, jw, jp, key, kw)


def test_graph_ready_bc_fit_matches_jax_and_its_eager_body(eager_graphs, monkeypatch):  # noqa: F811
    ac, loss, (jac, params, jw, jp, key, kw) = bc_run()
    assert [g.steps for g in eager_graphs] == [20, 20]      # one step per fit
    jparams, jloss = jbc.bc_pretrain(jac, params, jw, jp, key, **kw)
    assert_params_match(ac, jparams)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    monkeypatch.setattr(graphs, "on_card", lambda device: False)
    eager_ac, eager_loss, _ = bc_run()
    assert len(eager_graphs) == 2 and eager_loss == loss
    for k, v in ac.state_dict().items():
        assert torch.equal(v, eager_ac.state_dict()[k]), k


# ---- two trainer epochs ----

def test_two_graph_ready_epochs_match_jax(eager_graphs):  # noqa: F811
    e, t_len = 4, 12
    wd = load_world("gen_demo")
    n = wd.drone_num
    train = dict(steps_per_epoch=t_len, num_envs=e, max_ep_len=5, train_pi_iters=3,
                 train_v_iters=3, minibatch=32, pi_lr=1e-3, vf_lr=1e-3,
                 action_mode="direct", batched_update=True)
    jcfg = JConfig(env=JEnvParams(num_drones=n), model=JModelConfig(**SMALL),
                   train=JTrainConfig(**train))
    tcfg = Config(env=EnvParams(num_drones=n), model=ModelConfig(**SMALL),
                  train=TrainConfig(**train))
    jac, params, ac = policies()
    pi_tx, vf_tx = jppo.make_optimizers(jcfg.train, params)
    jstate = jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size)
    jcarry = jax.jit(lambda k: j_init(jspec, jcfg.env, e, k))(jax.random.PRNGKey(1))
    jepoch = jax.jit(j_make_train_epoch(jac, jspec, jcfg, pi_tx, vf_tx))
    keys = [jax.random.PRNGKey(2), jax.random.PRNGKey(3)]
    outs, eps = [], []
    for key in keys:
        eps += jax_eps(jcarry.rng, t_len, n)
        out = jepoch(jstate, jcarry, key)
        outs.append(out)
        jstate, jcarry = out.ppo_state, out.carry

    pi_opt, vf_opt = ppo.make_optimizers(tcfg.train, ac)
    tspec = wd.spec(device="cpu")
    tcarry = init_rollout_carry(tspec, tcfg.env, e, torch.Generator())
    inject(ac, eps)
    epoch = make_train_epoch(ac, tspec, tcfg, pi_opt, vf_opt)
    for key, out in zip(keys, outs):
        got = epoch(tcarry, torch.Generator(), None,
                    [jax_offsets(jcfg.train, key, t_len * e * n)])
        um, jum = got.update_metrics, out.update_metrics
        assert int(um.pi_iters.max()) > 0
        assert_metrics_match([x[0] for x in um], [x[0] for x in jum])
        assert_params_match(ac, out.ppo_state.params)
        np.testing.assert_allclose(float(got.mean_reward), float(out.mean_reward),
                                   rtol=1e-4)
        compare_carry(got.carry, out.carry, 1e-4)
        for a, b in zip(got.stats, out.stats):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4, rtol=1e-5)
        tcarry = got.carry
    # rollout, GAE, policy and value steps: made once, stepped every epoch
    assert [g.steps for g in eager_graphs] == [2 * t_len, 2, 2 * 3, 2 * 3]
