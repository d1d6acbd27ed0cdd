"""The port's graph-ready step loops (utils/graphs.GraphedLoop and its
users: bench/core.make_chunk, bench/detail.make_policy_chunk,
algo/evaluator.make_eval_chunk, algo/rollout.make_rollout, PolicyServer's
per-shape graphs), on the CPU.

A CUDA graph runs only on a card, so here graphs.StepGraph is replaced by
EagerSteps, which calls the body at every step, and graphs.on_card says
yes to the CPU, so the factories build their graphed loops. What the loops
add around the step (static buffers copied in and out, draws made outside
the step into static buffers, records stored at a device step index, the
epoch-end flag read from that index) then runs on the CPU, and:

  - each graph-ready loop equals the eager loop it replaces exactly
    (torch.equal on every leaf, float64 and float32): run_chunk on the
    flagship world, bench.detail's rollout_chunk there, eval_chunk on
    world16_dense (noise mode too), rollout_epoch on gen_demo over two epochs (noise mode too, both action
    modes), PolicyServer.policy at three batch shapes, deterministic and
    stochastic; the generators end in the same state; the server keeps at
    most MAX_GRAPHS shapes' graphs;
  - the same loops against the JAX package: bench.py's jit(vmap(scan))
    loop at 1e-12 in float64 and 1e-5 in float32, flags exactly (as
    tests/test_torch_bench.py); the JAX evaluator's make_eval_chunk and
    rollout_epoch in float64 with a constant policy far from any rounding
    tie (as tests/test_torch_rollout.py's exact lifecycle test): records
    and flags exactly, values at 1e-12; the JAX PolicyServer at 1e-5;
  - StepGraph refuses a CPU device, a capture runs with the cyclic
    garbage collector off (it runs just before), and (with stubs in place
    of the stream, the capture and the graph) what the body counts while
    captured is one list: each replay adds its kernel launches, so a
    kernel's `launches` is the warm-up's plus the capture's times the
    replays, and its recorder counters once a replay while the recorder is
    on and not at all while it is off; GraphedLoop writes records at the
    device step index and goes on from its carry.
The graphs themselves are held to the eager loops on the card by the
`gpu` cases of tests/test_torch_cuda.py and chip_smoke.py's `graphs` phase.
"""

import collections
import contextlib
import functools
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo.evaluator import EvalCarry as JEvalCarry
from rvo3d_tpu.algo.evaluator import make_eval_chunk as j_make_eval_chunk
from rvo3d_tpu.algo.rollout import init_rollout_carry as j_init
from rvo3d_tpu.algo.rollout import rollout_epoch as j_rollout
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.env.env import observe as j_observe
from rvo3d_tpu.env.env import reset as j_reset
from rvo3d_tpu.env.env import reset_where as j_reset_where
from rvo3d_tpu.env.env import step as j_step
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.utils.heuristic import waypoint_controller as j_controller
from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry, make_eval_chunk
from rvo3d_tpu_torch.algo.rollout import init_rollout_carry, make_rollout, rollout_epoch
from rvo3d_tpu_torch.bench import core
from rvo3d_tpu_torch.bench.flagship import flagship_world
from rvo3d_tpu_torch.config import EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.env.env import reset
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.ops import _build, env_drones
from rvo3d_tpu_torch.ops import masked_gru as mg
from rvo3d_tpu_torch.ops import vo_pairs
from rvo3d_tpu_torch import serving
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils import graphs, profiler
from rvo3d_tpu_torch.worlds import load_world
from test_torch_rollout import policies, specs
from test_torch_serving import rand_obs, servers  # noqa: F401  (a fixture)
from torch_threads import one_intra_op_thread  # noqa: F401

SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))
TIE_FREE_MU = ([0.2512, 0.4987, -0.7489], -0.75)   # tests/test_torch_rollout.py
DTYPES = {"float64": torch.float64, "float32": torch.float32}


class EagerSteps:
    """Stands in for graphs.StepGraph on the CPU: the body at every step."""

    def __init__(self, body, device, made, pool=None):
        self.body, self.steps, self.pool = body, 0, pool
        made.append(self)

    def step(self):
        self.steps += 1
        with torch.no_grad():
            self.body()


@pytest.fixture
def eager_graphs(monkeypatch):
    """The stand-ins made while the test runs."""
    made = []
    monkeypatch.setattr(graphs, "StepGraph", functools.partial(EagerSteps, made=made))
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    return made


def assert_trees_equal(a, b, msg=""):
    """Every tensor of two trees of NamedTuples/tuples: same dtype, equal."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), msg
    elif isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            assert_trees_equal(x, y, f"{msg}.{name}")


def close(a, b, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=msg)


# ---- utils/graphs.py ----

def test_step_graph_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraph(lambda: None, "cpu")


@pytest.mark.parametrize("recorder", ["off", "on"])
def test_what_the_capture_counted_is_added_by_each_replay(monkeypatch, recorder):
    """One list of what the capture counted: each replay adds the kernels'
    launches always and the recorder's counters while it is on."""
    class Graph:
        replays = 0

        def replay(self):        # a replay runs no Python launch
            Graph.replays += 1

    def body():                  # the GRU kernel twice, the VO kernel 3 times, 6 env passes
        for name, n in (("masked_gru", 2), ("vo_pairs", 3), ("env_drones", 6)):
            for _ in range(n):
                profiler.tally(_build.add_launches, name)
        profiler.count("body.steps")
        profiler.count("body.rows", 64)

    def capture(fn, stream, pool=None):
        fn()
        return Graph()
    for mod in (mg, vo_pairs, env_drones):
        monkeypatch.setattr(mod, "launches", 0)
    monkeypatch.setattr(graphs, "_side_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "_on_stream", lambda stream, fn: fn())
    monkeypatch.setattr(graphs, "_capture", capture)
    profiler.clear()
    g = graphs.StepGraph(body, "cuda")
    g.step()                                         # the eager warm-up, recorder off
    assert (mg.launches, vo_pairs.launches, env_drones.launches, g.graph) == (2, 3, 6, None)
    on = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with on if recorder == "on" else contextlib.nullcontext():
        for _ in range(5):                           # capture + 5 replays
            g.step()
    got = profiler.recorded().counters
    profiler.clear()
    launched = collections.Counter(name for add, name, _ in g.counts
                                   if add is _build.add_launches)
    assert launched == {"masked_gru": 2, "vo_pairs": 3, "env_drones": 6}
    assert [(name, n) for add, name, n in g.counts if add is not _build.add_launches] == [
        ("body.steps", 1), ("body.rows", 64)]
    assert (g.replays, Graph.replays) == (5, 5) and not profiler.counting()
    assert (mg.launches, vo_pairs.launches, env_drones.launches) == (2 + 5 * 2, 3 + 5 * 3,
                                                                    6 + 5 * 6)
    assert got == ({"body.steps": 5, "body.rows": 5 * 64} if recorder == "on" else {})


def test_graphed_loop_records_at_the_step_index_and_goes_on(eager_graphs):
    def step(c, x, t):                 # carry + draw; records: the new carry, t
        return c + x, (c + x, t.clone())

    def records(c):
        return torch.empty((3,) + c.shape), torch.empty((3, 1), dtype=torch.int64)
    loop = graphs.GraphedLoop(step, "cpu", draw=lambda c, g: torch.randn(2, generator=g),
                              records=records)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    c, (rec, ts) = loop(torch.zeros(2), 3, g1)
    want = torch.cumsum(torch.randn(3, 2, generator=g2), 0)
    assert torch.equal(rec, want) and torch.equal(c, want[-1])
    assert ts.flatten().tolist() == [0, 1, 2]
    c.add_(100.0)                      # the returned carry is a clone
    c, (rec, _) = loop(None, 2, g1)    # goes on from the static carry
    want = want[-1] + torch.cumsum(torch.randn(2, 2, generator=g2), 0)
    assert torch.equal(c, want[-1]) and torch.equal(rec[:2], want)
    c, _ = loop(torch.ones(2), 1, g1)  # a new carry is copied in
    assert torch.equal(c, 1 + torch.randn(2, generator=g2))
    with pytest.raises(ValueError):
        loop(torch.zeros(3), 1, g1)
    assert [g.steps for g in eager_graphs] == [3 + 2 + 1]


def test_capture_runs_without_the_cyclic_collector(monkeypatch):
    seen = []

    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        yield
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    collected = []
    monkeypatch.setattr(gc, "collect", lambda: collected.append(1))
    assert gc.isenabled()
    assert isinstance(graphs._capture(lambda: seen.append(gc.isenabled()), None), Graph)
    assert seen == [False] and collected == [1] and gc.isenabled()
    with pytest.raises(RuntimeError):      # a failed capture raises, the collector back on
        graphs._capture(lambda: (_ for _ in ()).throw(RuntimeError("capture")), None)
    assert gc.isenabled()


def test_copy_tree_refuses_another_dtype_or_shape():
    buf = (torch.zeros(3), torch.zeros(2, dtype=torch.int32))
    graphs.copy_tree_(buf, (torch.ones(3), torch.ones(2, dtype=torch.int32)))
    assert buf[0].sum() == 3
    with pytest.raises(ValueError):
        graphs.copy_tree_(buf, (torch.ones(3, dtype=torch.float64), buf[1]))
    with pytest.raises(ValueError):
        graphs.copy_tree_(buf, (torch.ones(4), buf[1]))


# ---- the bench chunk ----

@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_graphed_chunk_equals_run_chunk(eager_graphs, dtype):
    wd = flagship_world()
    world = core.world_spec(wd, "cpu", dtype)
    p = EnvParams(num_drones=wd["drone_num"])
    s0 = reset(world, p, lead=(3,))
    chunk = core.make_chunk(world, p)
    got = chunk(chunk(s0, 12), 9)                   # a chunk going on from the last
    want = core.run_chunk(world, core.run_chunk(world, s0, p, 12), p, 9)
    assert_trees_equal(got, want, "state")
    assert int((want.real_route_len == 0).sum()) < want.real_route_len.numel()
    assert_trees_equal(chunk(s0, 5), core.run_chunk(world, s0, p, 5), "restart")
    assert [g.steps for g in eager_graphs] == [12 + 9 + 5]


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_graphed_chunk_matches_the_jax_bench_loop(eager_graphs, dtype, atol):
    lanes, steps = 3, 30
    wd = flagship_world()
    with jax.enable_x64(dtype == np.float64):
        jworld = j_make_world_spec(wd["waypoints_list"], wd["building_list"],
                                   wd["map_size"], dtype=dtype)
        jp = JEnvParams(num_drones=wd["drone_num"])
        s0 = j_reset(jworld, jp, dtype=dtype)
        jstate = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (lanes,) + x.shape).copy(), s0)

        def one_step(st, _):          # bench.py:44-72
            st, out = j_step(jworld, st, j_controller(st, jworld), jp)
            st = j_reset_where(jworld, st, out.done | out.finish)
            return st, st
        traj = jax.jit(jax.vmap(lambda s: jax.lax.scan(one_step, s, None,
                                                       length=steps)[1]))(jstate)
        traj = jax.tree_util.tree_map(np.asarray, traj)
    world = core.world_spec(wd, "cpu", torch.from_numpy(np.zeros(1, dtype)).dtype)
    p = EnvParams(num_drones=wd["drone_num"])
    chunk = core.make_chunk(world, p)
    state = reset(world, p, lead=(lanes,))
    for t in range(steps):
        state = chunk(state, 1)
        for name, a, b in zip(state._fields, state, traj):
            a, b = a.numpy(), b[:, t]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"step {t} {name}")
            else:
                close(a, b, atol, f"step {t} {name}")


def test_graphed_policy_chunk_equals_rollout_chunk(eager_graphs):
    from rvo3d_tpu_torch.bench import detail

    wd = flagship_world()
    world = core.world_spec(wd, "cpu")
    p = EnvParams(num_drones=wd["drone_num"])
    ac = ActorCritic(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(0),
                     device="cpu")
    s0 = reset(world, p, lead=(3,))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    chunk = detail.make_policy_chunk(ac, world, p)
    got = chunk(chunk(s0, 6, g1), 5, g1)
    want = detail.rollout_chunk(ac, world, detail.rollout_chunk(ac, world, s0, p, 6, g2),
                                p, 5, g2)
    assert_trees_equal(got, want, "state")
    assert torch.equal(g1.get_state(), g2.get_state())
    assert [g.steps for g in eager_graphs] == [6 + 5]


# ---- the eval chunk ----

@pytest.mark.parametrize("dtype,mode,noise", [(torch.float32, "direct", False),
                                              (torch.float64, "increment", True)],
                         ids=["float32-direct", "float64-increment-noise"])
def test_graphed_eval_chunk_equals_eval_chunk(eager_graphs, dtype, mode, noise):
    wd = load_world("world16_dense")
    world = wd.spec(dtype=dtype, device="cpu")
    p = EnvParams(num_drones=wd.drone_num, noise=noise)
    ac = ActorCritic(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(0),
                     device="cpu")
    kw = dict(max_ep_len=6, std_factor=1.0, action_mode=mode)
    c0 = init_eval_carry(world, p, 3)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    chunk = make_eval_chunk(ac, world, p, chunk=8, **kw)
    c1, r1 = chunk(c0, g1)
    c1, r1b = chunk(c1, g1)
    c2, r2 = eval_chunk(ac, world, p, c0, g2, 8, **kw)
    c2, r2b = eval_chunk(ac, world, p, c2, g2, 8, **kw)
    assert_trees_equal(c1, c2, "carry")
    assert_trees_equal(r1, r2, "records")
    assert_trees_equal(r1b, r2b, "records, second chunk")
    assert torch.equal(g1.get_state(), g2.get_state())
    assert r1.ended.any() and r1.ep_len.dtype == torch.int32
    assert [g.steps for g in eager_graphs] == [16]


@pytest.mark.parametrize("mode", ["direct", "increment"])
def test_graphed_eval_chunk_matches_the_jax_evaluator_f64(eager_graphs, mode):
    lanes, chunk_len, max_ep_len = 4, 12, 7
    wd = load_world("gen_demo")
    n = wd.drone_num
    jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
    # std clamps to 1e-4 (log_std -20) and mu sits far from every 0.01 tie:
    # both packages fly the same rounded actions whatever their draws
    jac, params, ac = policies(constant=TIE_FREE_MU)
    with jax.enable_x64(True):
        jspec, tspec = specs(wd, np.float64)
        chunk_fn = jax.jit(j_make_eval_chunk(jac, jspec, jp, max_ep_len, 1.0, 1e-3,
                                             chunk_len, mode))
        s0 = j_reset(jspec, jp, dtype=jnp.float64)
        state = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (lanes,) + x.shape).copy(), s0)
        out, state = jax.vmap(functools.partial(j_observe, jspec, p=jp))(state)
        jc = JEvalCarry(env_state=state, obs=(out.obs_self, out.obs_nbr, out.obs_mask),
                        ep_len=jnp.zeros((lanes,), jnp.int32),
                        speed_sum=jnp.zeros((lanes,)), ret0=jnp.zeros((lanes,)),
                        rng=jax.random.PRNGKey(0))
        chunk = make_eval_chunk(ac, tspec, tp, max_ep_len=max_ep_len, std_factor=1e-3,
                                chunk=chunk_len, action_mode=mode)
        tc, gen = init_eval_carry(tspec, tp, lanes), torch.Generator().manual_seed(0)
        ended = 0
        for _ in range(2):
            jc, jrec = chunk_fn(params, jc)
            tc, trec = chunk(tc, gen)
            for name in ("ended", "success", "all_info", "ep_len"):
                np.testing.assert_array_equal(getattr(trec, name).numpy(),
                                              np.asarray(getattr(jrec, name)), name)
            for name in ("speed", "ret0"):
                close(getattr(trec, name), getattr(jrec, name), 1e-12, name)
            for name, a, b in zip(tc.env_state._fields, tc.env_state, jc.env_state):
                close(a, b, 1e-12, name)
            ended += int(trec.ended.sum())
    assert ended >= lanes


# ---- the rollout ----

@pytest.mark.parametrize("dtype,mode,noise", [(torch.float32, "direct", False),
                                              (torch.float64, "increment", True)],
                         ids=["float32-direct", "float64-increment-noise"])
def test_graphed_rollout_equals_rollout_epoch(eager_graphs, dtype, mode, noise):
    wd = load_world("gen_demo")
    spec = wd.spec(dtype=dtype, device="cpu")
    p = EnvParams(num_drones=wd.drone_num, noise=noise)
    cfg = TrainConfig(steps_per_epoch=10, num_envs=3, max_ep_len=4, action_mode=mode)
    ac = ActorCritic(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(0),
                     device="cpu")
    runs = []
    for graphed in (True, False):
        carry = init_rollout_carry(spec, p, 3, torch.Generator().manual_seed(2))
        roll = (make_rollout(ac, spec, p, cfg) if graphed
                else functools.partial(rollout_epoch, ac, spec, p, cfg))
        batches = []
        for _ in range(2):
            carry, batch = roll(carry)
            batches.append([x.clone() for x in batch])
        runs.append((carry, batches))
    (c1, b1), (c2, b2) = runs
    assert_trees_equal(c1._replace(generator=None), c2._replace(generator=None), "carry")
    for epoch, (x, y) in enumerate(zip(b1, b2)):
        assert_trees_equal(tuple(x), tuple(y), f"batch {epoch}")
    assert torch.equal(c1.generator.get_state(), c2.generator.get_state())
    cuts = torch.stack([b[7] for b in b1])
    assert cuts[:, :-1].any() and cuts[:, -1].all()       # terminal and epoch-end cuts
    assert c1.stats.count.sum() > 0
    assert [g.steps for g in eager_graphs] == [20]


@pytest.mark.parametrize("mode,max_ep_len", [("direct", 5), ("increment", 7)])
def test_graphed_rollout_matches_jax_f64(eager_graphs, mode, max_ep_len):
    e, t_len = 4, 12
    wd = load_world("gen_demo")
    n = wd.drone_num
    jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
    kw = dict(steps_per_epoch=t_len, max_ep_len=max_ep_len, num_envs=e, action_mode=mode)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jac, params, ac = policies(constant=TIE_FREE_MU)
    with jax.enable_x64(True):
        jspec, tspec = specs(wd, np.float64)
        jcarry = jax.jit(lambda k: j_init(jspec, jp, e, k, dtype=jnp.float64))(
            jax.random.PRNGKey(1))
        jcarry = jcarry._replace(stats=type(jcarry.stats)(
            *[x.astype(jnp.float64) for x in jcarry.stats]))
        jrun = jax.jit(lambda c: j_rollout(jac, jspec, jp, jcfg, params, c))
        roll = make_rollout(ac, tspec, tp, tcfg)
        tcarry = init_rollout_carry(tspec, tp, e, torch.Generator().manual_seed(1))
        for _ in range(2):
            jcarry, jb = jrun(jcarry)
            tcarry, tb = roll(tcarry)
            for name in ("obs_self", "obs_nbr", "rew", "val"):
                close(getattr(tb, name), getattr(jb, name), 1e-12, name)
            for name in ("obs_mask", "act", "cut"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)), name)
            for name, a, b in zip(tcarry.env_state._fields, tcarry.env_state,
                                  jcarry.env_state):
                close(a, b, 1e-12, name)
            np.testing.assert_array_equal(tcarry.ep_len.numpy(), np.asarray(jcarry.ep_len))
            for name in ("count", "finish_count", "collision_count", "len_sum"):
                np.testing.assert_array_equal(getattr(tcarry.stats, name).numpy(),
                                              np.asarray(getattr(jcarry.stats, name)))
            for name in ("ret_sum", "ret_min", "ret_max"):
                close(getattr(tcarry.stats, name), getattr(jcarry.stats, name), 1e-12)
    assert tcarry.stats.collision_count.sum() > 0


# ---- the served act ----

@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stochastic"])
def test_graphed_act_equals_the_eager_forward(eager_graphs, servers,  # noqa: F811
                                              deterministic):
    _, tsrv = servers
    srv = PolicyServer(tsrv.ac, nm=10, std_factor=0.5, deterministic=deterministic)
    rng = np.random.default_rng(5)
    for b, k in ((1, 0), (6, 3), (6, 10), (64, 4)):   # a shape again, with new inputs
        obs = rand_obs(rng, b, k)
        inputs = [torch.as_tensor(obs[0]), torch.as_tensor(obs[1]),
                  torch.as_tensor(obs[2])]
        if not deterministic:
            inputs.append(torch.randn(b, 3, generator=torch.Generator().manual_seed(b + k)))
        got = srv._graphed(inputs).clone()
        assert torch.equal(got, srv.policy(*inputs)), (b, k)
        if not deterministic:
            want = srv.act(*obs, generator=torch.Generator().manual_seed(b + k))
            np.testing.assert_array_equal(got.numpy(), want)
    assert len(srv._graphs) == 3


@pytest.mark.parametrize("b,k", [(1, 0), (64, 10)])
def test_graphed_act_matches_jax(eager_graphs, servers, b, k):  # noqa: F811
    jsrv, tsrv = servers
    obs = rand_obs(np.random.default_rng(b + k), b, k)
    got = tsrv._graphed([torch.as_tensor(x) for x in obs])
    np.testing.assert_allclose(got.numpy(), jsrv.act(*map(jnp.asarray, obs)), atol=1e-5)


def test_server_keeps_at_most_max_graphs(eager_graphs, servers):  # noqa: F811
    _, tsrv = servers
    srv = PolicyServer(tsrv.ac, nm=10)
    rng = np.random.default_rng(7)
    sizes = list(range(1, serving.MAX_GRAPHS + 3)) + [1]   # 1 comes back after eviction
    for b in sizes:
        obs = rand_obs(rng, b, 2)
        got = srv.act(*obs)
        np.testing.assert_array_equal(got, srv.policy(*map(torch.as_tensor, obs)).numpy())
    assert len(srv._graphs) == serving.MAX_GRAPHS
    kept = [key[0][0] for key in srv._graphs]               # batch sizes, oldest first
    assert kept == sizes[-serving.MAX_GRAPHS:]
    assert len(eager_graphs) == len(sizes)                  # 1 was captured anew
