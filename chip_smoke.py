#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rvo3d_tpu_torch) on one CUDA card.

Run from the repo root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from csrc/ with nvcc, holds it
against its plain torch version at the serving path's shapes (one
direction each way, and both biGRU directions fused in one launch), times
it at B = 2048, 4096 and 65536 beside the plain scan and cuDNN, runs the
serving path closed-loop (evaluate of a biGRU-256 policy with random
weights from a fixed seed on worlds_data/world16_dense, 256 lanes x 16
drones), serves PolicyServer.act / act_flat batches, and checks that the
path went through the kernel. It then scores the committed product policy
(rvo3d_tpu_torch/assets/w16_r4_e30.pt, the w16_r4 run's epoch 30) on
world16_dense (`product_eval`: success >= 0.85 and mean EpLen within 0.3
of 30.91 over >= 256 episodes at the evaluator's 1e-3 std factor),
fine-tunes it for 2 epochs of Trainer.run_epoch at the run's full width
(`train`: 128 lanes x 16 drones, T = 300, biGRU-256, batched update,
minibatch 16384, 20 pi / 50 v iterations; one line per epoch), and holds
the pi- and v-loss gradients of 16384 of its rows, as they are and with
random neighbour masks, kernel forward on the card against the plain path
on the CPU (`train_grad_kernel_vs_plain`).

Then the multi-world slice: world32_mix and its route-reversed variant in
alternate lanes (64 lanes x 32 drones, float64) stepped on the card
against the CPU and each lane against its own world's single-world run
(`multi_world_env_card_vs_cpu`); the committed w32_m3s product
(rvo3d_tpu_torch/assets/w32_m3s_e5.pt) scored det on both populations
(`w32_product_eval`); and the w32_m3s recipe through the port's own CLI
in-process (`bc_ppo_recipe`: BC on the RVO expert with 3 DAgger rounds,
then PPO for 5 epochs (the run's 10 cut), 64 lanes x 32 drones,
biGRU-256, batch 4096, minibatch 16384; one `bc_round` line per fit, one
`ppo_epoch` line per epoch, the kernel held to its plain version at the
rows the path gave it, and the gate:
det success >= 0.8 on both populations at the best persisted epoch).
Then the LSTM and bfloat16 policies, data-parallel lanes, the curriculum,
reference-policy import and the profiler: `lstm_policy` (an LSTM-256 policy
with (256, 256) heads: its forward at B = 4096 on the card against the CPU,
one Trainer epoch at w16_r4's width with T cut to 64 and 5 pi / 5 v
iterations, evaluate at 256 lanes; it launches no masked GRU), `bf16_serve`
(the w16_r4 product with compute_dtype bfloat16: act p50 at B = 1, 64 and
4096 beside the float32 serve, its forward within 0.05 / 0.2 of float32's,
det success over 256 episodes), `data_parallel_epoch` (this script started
twice more, `--dp-worker`, as two gloo ranks on this card running
`cli train --mesh_data 2` from the product's params at 128 lanes, T = 64,
5 pi / 5 v iterations, against the same epoch in this process: metrics at
rtol 1e-3, final params within 1e-5, rank-0 artifacts once),
`curriculum` (`cli train --curriculum 1.2:1,0.4:rest`, 3 epochs, 16
lanes, T = 32, full width), `reference_import` (a reference-layout
biGRU-256 state dict from the seed, card against CPU, then
`cli eval --torch_checkpoint`) and `profile_rollout_step`
(utils/profiler.trace over 5 graphed rollout steps at w16_r4's width: the
15 CUDA ops with the most device time, launches per step, the device's
idle share, the masked-GRU kernel among them; the trace goes to
chiprun_out/profile_rollout_step/; the same 5 eager steps' idle share
beside it).
Then world generation, the oracle parity check, rendering and tensor
parallelism: `worldgen_parity` (`cli worldgen` of a 16-drone world at
world16_dense's map size, seed 0, then `cli parity --x64 --device cuda`,
200 steps: train mode on it, gen_demo, world16_dense and world32_mix, eval
and noise modes on world16_dense; any [FAIL] fails the phase),
`render_record` (record_trajectory of the w16_r4 product on world16_dense,
100 steps through the CLI's policy controller with draws from a CPU
generator, on the card against the CPU: the first step where they part,
if any, must follow a 2-decimal rounding tie of an action; no frames are
drawn where matplotlib is absent, and the line says so) and
`tensor_parallel_epoch` (this script started twice more, `--tp-worker`, as
two gloo ranks on this card running `cli train --mesh_model 2` on
`data_parallel_epoch`'s config, held against its one-process epoch at the
same tolerances).
Then the bench command and the JAX side's throughput scripts, each through
its entry point in rvo3d_tpu_torch/bench/ (the JSON each writes under
runs_torch/bench/ goes into the phase's line): `bench_env` (`cli bench`
in this process at bench.py's size, 16384 lanes x 100 steps x 3 repeats of
the flagship world: its line, with finite positive rates and bench.py's
keys plus `device`; the spread between the lanes of the last timed
chunk's final state, reported; the timed loop at 4 lanes x 100 steps in
float64 on the card against the CPU, 1e-12 and exact flags),
`bench_ladder` (rungs 4 and 5 at full size; lane 1 of the rung-5 lane
world, the flipped population, in float64 on the card against the CPU
over 60 steps), `bench_detail` (the env sweep at 2048-16384 lanes, the
biGRU-256 rollout at 2048 lanes x 30 steps, the flagship PPO epoch at 32
lanes x 300 steps with the per-agent update; `cuts` lists any cut),
`bench_serving` (PolicyServer.act at B = 1, 256, 4096 and 32768) and
`bench_gru` (one kernel direction against the plain scan and cuDNN at
B = 32768 and 131072, each beside its bound; max |kernel - plain| within
1e-4 at both).
Then the JAX side's last entry points, through their port: `entry_forward`
(entry()'s flagship biGRU-256 forward at B = 256 with every neighbour slot
on, card against CPU, the kernel timed at those rows beside its bound and
cuDNN), `dryrun_multichip` (dryrun_multichip(4, full_size=True): the
flagship epoch, 256 lanes x 8 drones, T = 100, over a 2 x 2 mesh of gloo
ranks on this card, held against the same epoch unsharded: the metrics at
1e-3 unless the rollouts part, the rollouts equal up to a 0.01 rounding
tie, the params equal to the one-process update on the ranks' batch
within 1e-5; the line says what held), `expert_diag`
(expert_eval on world16_dense and world32_mix; expert_noise_sweep's
sweep_world at the JAX plan's margins on world32_mix, its reversal and
world16_dense, 100 lanes x 150 steps; world16_dense with slowdown, its
first 4 noise streams at every margin, on the card against the CPU with
identical per-lane outcomes), `conflict_diag` (at its defaults, 16 envs x
400 steps, from a run directory holding the w32_m3s clone; its final
forward of 204,800 rows timed), `bc_diag` (bc_eval on world16_dense, BC
cut to 100 steps, then w3_diag --reuse of its clone) and
`bench_detail_train_split` (bench.detail's section 4 on gen_demo, T cut to
25 and 5 / 5 iterations); `cuts` lists each cut.
Then the step loops as CUDA graphs (utils/graphs.py), through which every
phase above runs its bench chunks, evaluations, rollouts and served
batches on the card (the tensor-parallel rollouts stay eager): `graphs`
holds each graphed loop against its eager body in this process, every
leaf bit for bit, and times both in turns: the flagship bench chunk at
bench.py's size (16384 x 100) in float64 and float32, and the step time
over 2048-16384 lanes; the eval chunk (the w16_r4 product, 128 lanes,
40 steps; timed at 128 and 256 lanes); three rollout epochs at w16_r4's
width with T cut to 64 (step ms; the idle shares come from
`profile_rollout_step`, which now traces 5 graphed steps and the same 5
eager ones); `PolicyServer.act` at B = 1, 64 and 4096, deterministic and
stochastic (p50 ms). Before those, each graphed loop that flies the policy
(the eval chunk at 128 and 256 lanes, the rollout at 128, act at B = 1, 64
and 4096) runs 3 steps in a loop of its own whose graph also copies the
kernel's inputs and output, and the last replay's output is held to the
plain version on its inputs (`kernel_at_replayed_launch`, atol 1e-4).
Then the learner's device programs: since then GAE, the PPO update and the
BC fit of every training phase above (`train`, `bc_ppo_recipe`, ...) run
as CUDA graph replays too (algo/ppo.PPOUpdate, algo/bc.fit; the
tensor-parallel update stays eager), and `learner_graphs` (stated at
30-60 s before it was added) holds them against their bodies called
eagerly in this process, every leaf bit for bit: the w16_r4 product's
update on one rollout batch at full width (128 x 16, T = 300, 20 pi / 50
v iterations, minibatch 16384; params, both Adams' states, the batch with
its GAE, the metrics), the same with target_kl set so that the KL stop
fires midway, and 200 BC fit steps at B = 4096 on a world32_mix demo set;
it prints ms per update iteration and per BC step, graphed and eager, the
eager ones split into the kernel forward, the rest of the forward, the
backward, the clip and Adam, and the device's idle share over 5 of each.
Each of these phases that launches the masked GRU keeps the kernel's
inputs at its first launch with each row count and holds the kernel to its
plain version on them (`kernel_at_path_rows`, atol 1e-4; a graphed loop's
first step runs eagerly, and its launch is the one kept); `bf16_serve` also
holds its bfloat16 forward on the card to the CPU's, within 1e-4 plus two
bfloat16 steps at the output's largest value.
The env step's all-pairs VO runs on the card as the hand-written kernel of
rvo3d_tpu_torch/ops/vo_pairs.py (csrc/vo_pairs.cu) in every phase that
steps the env there: `build` builds it beside the masked GRU; the
`env_card_vs_cpu_f64`, `evaluate`, `multi_world_env_card_vs_cpu` and
`bench_env` lines give its launches (`vo_launches`), and each `train_epoch`
line its launches in the rollout; `vo_pairs_kernel` (right after
`env_card_vs_cpu_f64`) holds both of its modes to the plain PyTorch path
on the card at the main paths' shapes, float32 states after 10 steps of
the noisy waypoint controller: 1024 lanes x 32 drones of world32_mix (the
eval cell), 128 x 16 of world16_dense (the rollout) and 16384 x 8 of the
flagship world (`bench_env`), and the same lanes crowded within 0.8 m of
their centres, which must list neighbours; flags and the non-finite
pattern must be equal and values within 2 ulp (`vo_within`, the card
tests' limit). It times both beside the kernel's bound (`vo_bound`).
The `kernels` line has a row for it, whose launches count the env phases
and each training epoch's rollout (`train_rollout`).
The env step's per-drone arithmetic runs on the card as the hand-written
passes of rvo3d_tpu_torch/ops/env_drones.py (csrc/env_drones.cu) around
those launches: `build` builds them too, the env phases' lines give their
launches (`env_drones_launches`), and `env_drones_kernel` (after
`vo_pairs_kernel`) holds step, observe and reset_where to the plain path
on the card with `vo_within` at the same three shapes over 10 steps of the
noisy waypoint controller, times each pass from a CUDA graph beside its
byte bound (`env_drones_bound`) and each call beside the plain path's; the
`kernels` line has its row.
Each phase prints one JSON line with its wall-clock seconds, and a `total`
line the script's; a failed phase exits non-zero. The last line is
{"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

SEED = 0
LANES = 256            # env lanes; x 16 drones = B 4096 policy rows
WORLD = "world16_dense"
F32_PEAK = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
# the card's fastest route for work held to f32 accuracy: 3xTF32 on the
# tensor cores, a third of the 495 TFLOP/s dense TF32 peak
TF32X3_PEAK = 495e12 / 3
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
ATOL = 1e-4            # f32 accuracy (3xTF32 in the kernel, TF32 off in the
                       # plain scan): summation order over 265 terms, 10 steps
TIMED_B = (2048, 4096, 16384, 65536)  # w16_r4's rollout (128 x 16), serving,
                                      # w16_r4's PPO minibatch, a large batch
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rvo3d_tpu_torch",
                      "assets")
PRODUCT_PARAMS = os.path.join(ASSETS, "w16_r4_e30.pt")   # PolicyServer.save format
PRODUCT_CONFIG = os.path.join(ASSETS, "w16_r4_config.json")
TRAIN_EPOCHS = 2
TRAIN_T = 300          # the run's steps_per_epoch; a cut would be printed
GRAD_ROWS = 16384      # the run's minibatch
GRAD_RTOL = 1e-3       # per parameter group: max |card - CPU| <= 1e-3 max |CPU|
                       # (f32 with TF32 off, the GRU forward at 3xTF32, ~3e-7),
                       # or no more than twice the card's plain path's distance:
                       # at B = 16384 the card's f32 pi-loss gradients alone can
                       # differ from the CPU's by more than that, with or without
                       # the kernel (tests/torch_grad_precision.py)
# The product policy under the evaluator's 1e-3 std factor: the JAX package
# reported success 100 % and EpLen 30.91 +- 0.29 over 100 episodes on the
# TPU (w16_r4's results.txt); the same evaluation of the JAX package on a
# CPU scores success 0.91-0.95 and EpLen 30.83-30.98 over 100 episodes
# (seeds 0-3). So the gate is success >= 0.85 over >= 256 episodes, and a
# mean EpLen within 0.3 of 30.91.
PRODUCT_EPISODES = 256
PRODUCT_MIN_SUCCESS = 0.85
PRODUCT_EPLEN, PRODUCT_EPLEN_TOL = 30.91, 0.3
# The w32_m3s product (runs/w32_m3s epoch 5) on both world32_mix
# populations, det (std factor 1e-3), 256 episodes each. The gate per
# population is set from the JAX package's own score off the TPU
# (tests/torch_eval_cpu.py --product w32_m3s [--reverse], seeds 0-3, 100
# episodes each): success 1.0 and EpLen 29.0 +- 0.0 on world32_mix, 1.0
# and 30.0 +- 0.0 on its reversal, for the JAX package and the port alike
# (the TPU run's epoch-5 line: 100 %, 29.0 and 30.0).
W32_PARAMS = os.path.join(ASSETS, "w32_m3s_e5.pt")
W32_CONFIG = os.path.join(ASSETS, "w32_m3s_config.json")
W32_POPULATIONS = ("world32_mix", "world32_mix:rev")
W32_EPISODES = 256
W32_GATE = {"world32_mix": {"min_success": 0.95, "ep_len": (29.0, 0.3)},
            "world32_mix:rev": {"min_success": 0.95, "ep_len": (30.0, 0.3)}}
MULTI_LANES, MULTI_STEPS = 64, 100
# The w32_m3s recipe (scripts/round5_tpu_queue3.sh:97-105) through the
# port's CLI at full width; its depth is cut only in PPO epochs, from 10
# to 5, to keep the script near half its time limit (a further cut would
# go, in this order, to eval episodes and DAgger rounds); `cuts` prints it
RECIPE_RUN_EPOCHS, RECIPE_EPOCHS = 10, 5
RECIPE_EVAL_EPISODES = 100
RECIPE_DAGGER = 3
RECIPE_MIN_SUCCESS = 0.8      # det, worst population, best persisted epoch
RECIPE_MIN_EPISODES = 64
# The LSTM epoch and the data-parallel epoch run w16_r4's training config at
# its width (128 lanes x 16 drones, minibatch 16384) with T and the pi / v
# iterations cut (the run has T = 300, 20 pi and 50 v iterations)
CUT_T, CUT_ITERS = 64, 5
DP_RANKS = 2               # gloo ranks sharing this card, 64 lanes each
DP_TIMEOUT_S = 300
DP_KEYS = ("mean_step_reward", "pi_loss", "v_loss", "kl")
DP_METRIC_TOL = {"rtol": 1e-3, "atol": 1e-3}  # tests/test_sharding.py:111-114
DP_PARAM_TOL = 1e-5
BF16_GATE = {"mu": 0.05, "v": 0.2}           # tests/test_models.py:173-174
PROFILE_STEPS = 5
PARITY_STEPS = 200
RENDER_STEPS = 100
RENDER_POS_TOL = 1e-4      # card vs CPU float32 positions over 100 steps
REPO = os.path.dirname(os.path.abspath(__file__))
PROFILE_DIR = os.path.join(REPO, "chiprun_out", "profile_rollout_step")
# `cli bench` at the JAX bench.py's defaults (bench.py:128-130), and its
# line's keys (bench.py:140-148) beside the card's name
BENCH_SIZE = {"RVO3D_BENCH_ENVS": "16384", "RVO3D_BENCH_STEPS": "100",
              "RVO3D_BENCH_REPEATS": "3"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "repeats", "min", "median",
              "max", "device"}
F64_ATOL = 1e-12           # float64 env on the card against the CPU
# the phases of the JAX side's last entry points, through their port
DRYRUN_RANKS = 4           # a 2 x 2 (data, model) mesh of gloo ranks on this card
EXPERT_WORLDS = ("world16_dense", "world32_mix")
SWEEP_PLAN = (("world32_mix", False), ("world32_mix", True), ("world16_dense", False))
SWEEP_CHECK = ("world16_dense", True, 4)   # (world, slowdown, lanes a margin) card vs CPU
BC_DIAG_STEPS = (2000, 100)  # bc_eval's BC steps: the script's, and this run's
# section 4's depth: the script's, and this run's (its traced E256 epoch
# writes ~3 MB of trace a step)
SPLIT_CUTS = {"steps_per_epoch": (300, 25), "train_pi_iters": (20, 5),
              "train_v_iters": (50, 5)}


def recipe_argv(run_dir):
    return ["train", "--device", "cuda", "--world", "world32_mix",
            "--num_envs", "64", "--steps_per_epoch", "300", "--action_mode", "direct",
            "--log_std_init", "-2.3", "--target_kl", "0.01", "--train_pi_iters", "20",
            "--train_v_iters", "50", "--batched_update", "--minibatch", "16384",
            "--pi_lr", "1e-6", "--vf_lr", "5e-5", "--save_freq", "5",
            "--eval_every", "5", "--eval_episodes", str(RECIPE_EVAL_EPISODES), "--seed", "7",
            "--vf_no_encoder", "--quiet", "--multi_worlds", "world32_mix,world32_mix:rev",
            "--bc_steps", "2000", "--bc_expert", "rvo", "--bc_dagger", str(RECIPE_DAGGER),
            "--bc_noise", "0.1", "--bc_margin", "0.3", "--bc_slowdown",
            "--train_epoch", str(RECIPE_EPOCHS), "--run_dir", run_dir]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_phase(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn() or {}
    except Exception as e:  # a failed phase ends the run with a non-zero code
        emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}",
              "seconds": time.perf_counter() - t0})
        raise SystemExit(1) from e
    emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0, **out})
    return out


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def p50_ms(fn, iters=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def gru_bound(xs, ms, fwd, ndirs=2):
    """The least time of one launch on these inputs, of a biGRU (ndirs 2)
    or one direction: the products the data needs at the 3xTF32 peak (the
    input product at every active step, the hidden product at every active
    step after a row's first, where the carry is still h0 = 0), or the
    bytes read once (xs, mask, each direction's weights) and written once
    (each direction's [B, H] output)."""
    in_dim, hidden = xs.shape[-1], fwd[1].shape[0]
    active = float(ms.sum().item())
    rows_active = float((ms.sum(0) > 0).sum().item())
    flops = 2.0 * ndirs * (active * in_dim + (active - rows_active) * hidden) * 3 * hidden
    nbytes = 4.0 * (xs.numel() + ms.numel() + ndirs * sum(t.numel() for t in fwd)
                    + ndirs * xs.shape[1] * hidden)
    t_ops, t_bytes = flops / TF32X3_PEAK, nbytes / HBM_BYTES_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_f32_simt": max(flops / F32_PEAK, t_bytes) * 1e3}


# IEEE operations of one pair as csrc/vo_pairs.cu runs them (pair_vo: the
# sums of 3 with their zero-adds, asin, acos, sqrt, a division and nearbyint
# each one; comparisons and selects none); rows and the rank add no arithmetic
VO_FLOPS_PER_PAIR = 108


def vo_bound(states, actions, others=None, nm=0, buildings=None, building_mask=None):
    """The least time of one float32 launch of the VO pair kernel on these
    inputs: the larger of its operations (VO_FLOPS_PER_PAIR a pair, outside
    the tensor cores) and its bytes (each input read once, each output
    written once), for the observe mode when `nm` is given, else the reward
    mode."""
    if states.element_size() != 4:
        raise ValueError(f"vo_bound times float32 launches, got {states.dtype}")
    n, item = states.shape[-2], states.element_size()
    rows = states.numel() // 12
    m = n if others is None else others.shape[-2]
    read = states.nbytes + actions.nbytes + (0 if others is None else others.nbytes)
    if nm:
        read += sum(t.nbytes for t in (buildings, building_mask) if t is not None)
        written = rows * (nm * 9 * item + nm + 2 + item)
    else:
        written = rows * (1 + 2 * item)
    flops = rows * m * VO_FLOPS_PER_PAIR
    t_ops, t_bytes = flops / F32_PEAK, (read + written) / HBM_BYTES_S
    return {"flops": flops, "bytes": read + written, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def env_drones_bound(rows, item, act_item, nm, slots, parity=True):
    """The least time of each env pass (ops/env_drones.py) at `rows` rows
    of states of `item` bytes and actions of `act_item`: each input byte
    read once and each output byte written once at 3.35 TB/s, the world's
    leaves (a few KB, read by every lane) left out, no noise or progress
    term. `slots`: the obs_nbr slots the VO pass listed, whose values post
    reads and writes. Returns {pass: {"bytes", "bound_ms"}}."""
    t, a = item, act_item
    state = 11 * t + 4 + 3                   # pos, vel, yaw .. max_dev; wp; flags
    rounded = 12 * t if parity else 0        # obs_self
    nbr = 2 * slots * 9 * t if parity else 0
    per_row = {
        "pre": 6 * t + 4 + 12 * t,
        "mid": state + 3 * a + 4 * t + 1 + t + (state - 1) + 12 * t + rounded + 2 * t,
        "post": 3 * t + 1 + 2 * t + nm + t + 1,
        "obs": 6 * t + 4 + t + 12 * t + rounded + t + 3 * t,
        "post_obs": nm + t + 1,
        "reset": 1 + 2 * (state + 3 * t),
    }
    out = {}
    for name, b in per_row.items():
        total = rows * b + (nbr if name in ("post", "post_obs") else 0)
        out[name] = {"bytes": total, "bound_ms": total / HBM_BYTES_S * 1e3}
    return out


def graphed_ms(fn, iters=50):
    """ms of one call of fn replayed from a CUDA graph (so the host's
    launch time is left out), after an eager warm-up on a side stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def vo_within(got, want, what):
    """Raise unless the kernel's outputs `got` equal the plain path's `want`:
    flags and the non-finite pattern exactly, float32 values to 2 ulp of the
    larger value (an ulp each side, tests/test_torch_cuda.py's limit for the
    CUDA math library's asin and acos of two toolkits). Returns the largest
    |difference| of the finite values."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not b.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: output {i} (flags) differs")
            continue
        if b.dtype != torch.float32:
            raise ValueError(f"vo_within holds float32 outputs, got {b.dtype}")
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(a), test(b)):
                raise AssertionError(f"{what}: output {i}'s non-finite pattern differs")
        fin = torch.isfinite(b)
        a, b = a[fin], b[fin]
        if not b.numel():
            continue
        big = torch.maximum(a.abs(), b.abs())
        ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
        diff = (a - b).abs()
        if not bool((diff <= 2 * ulp).all()):
            raise AssertionError(f"{what}: output {i} differs by up to "
                                 f"{float(diff.max())}, beyond 2 ulp")
        err = max(err, float(diff.max()))
    return err


def encoder_view(obs_nbr, obs_mask):
    """The biGRU's inputs as the encoder builds them: a row with no valid
    slot activates its last (zero) slot; [S, B, IN] and [S, B] views."""
    import torch

    nm = obs_mask.shape[-1]
    last = torch.zeros(nm, dtype=torch.bool, device=obs_mask.device)
    last[-1] = True
    mask = torch.where(obs_mask.any(-1, keepdim=True), obs_mask, last)
    return (obs_nbr.reshape(-1, nm, obs_nbr.shape[-1]).float().transpose(0, 1),
            mask.reshape(-1, nm).float().t())


@contextlib.contextmanager
def kernel_inputs_kept(mg, keep, replayed=None):
    """While open, the masked-GRU kernel's inputs at its first launch with
    each row count B go into keep[B]: clones, with the launch's strides, of
    the operands the path gave the kernel (bfloat16-rounded ones included).
    The launches themselves are unchanged. A launch being captured into a
    CUDA graph is not kept there (its clone would be a node of the graph):
    a graphed loop's first step runs eagerly (utils/graphs.py), and its
    launches are the ones kept. With `replayed`, the first captured launch
    with each B puts into replayed[B] clones of its inputs and of its
    output made inside the graph, as its nodes: after each replay they
    hold that replay's launch (kernel_at_replayed)."""
    import torch

    real = mg.launch

    def clones(xs, mask, weights, reverse):
        return (xs.detach().clone(), mask.detach().clone(),
                [tuple(w.detach().clone() for w in ws) for ws in weights], bool(reverse))

    def launch(xs, mask, weights, reverse=False):
        b = int(xs.shape[1])
        capturing = torch.cuda.is_current_stream_capturing()
        if b not in keep and not capturing:
            keep[b] = clones(xs, mask, weights, reverse)
        out = real(xs, mask, weights, reverse)
        if capturing and replayed is not None and b not in replayed:
            replayed[b] = clones(xs, mask, weights, reverse) + (out.detach().clone(),)
        return out
    mg.launch = launch
    try:
        yield keep
    finally:
        mg.launch = real


def kernel_at_replayed(mg, replayed):
    """A replayed launch's own output (kernel_inputs_kept's `replayed`,
    read after the graph's last replay) against the plain version on that
    launch's inputs; raises above ATOL or when nothing was captured."""
    import torch

    out = {}
    for b, (xs, ms, weights, reverse, got) in sorted(replayed.items()):
        with torch.no_grad():
            if len(weights) == 2:
                ref = mg.masked_bigru_scan_plain(xs, ms, *weights)
            else:
                ref = mg.masked_gru_scan_plain(xs, ms, *weights[0], reverse=reverse)
        out[f"B{b}"] = {"max_abs_err": (got - ref).abs().max().item(),
                        "active_slots_per_row": float(ms.sum() / ms.shape[1]),
                        "directions": len(weights)}
    bad = {k: r["max_abs_err"] for k, r in out.items() if not r["max_abs_err"] <= ATOL}
    if not out or bad:
        raise AssertionError(f"replayed launch: none captured, or max |kernel - plain| "
                             f"above {ATOL}: {bad}")
    return out


def kernel_at_kept_rows(mg, keep, want=()):
    """The kernel against its plain version (launches not counted) on each
    kept launch's inputs, on the card; raises above ATOL, or when a row
    count in `want` was never launched."""
    import torch

    out = {}
    for b, (xs, ms, weights, reverse) in sorted(keep.items()):
        xs, ms = xs.to("cuda"), ms.to("cuda")
        weights = [tuple(w.to("cuda") for w in ws) for ws in weights]
        l0 = mg.launches
        with torch.no_grad():
            if len(weights) == 2:
                got = mg.masked_bigru_scan_cuda(xs, ms, *weights)
                ref = mg.masked_bigru_scan_plain(xs, ms, *weights)
            else:
                got = mg.masked_gru_scan_cuda(xs, ms, *weights[0], reverse=reverse)
                ref = mg.masked_gru_scan_plain(xs, ms, *weights[0], reverse=reverse)
        mg.launches = l0
        out[f"B{b}"] = {"max_abs_err": (got - ref).abs().max().item(),
                        "active_slots_per_row": float(ms.sum() / ms.shape[1]),
                        "directions": len(weights)}
    missing = [b for b in want if b not in keep]
    bad = {k: r["max_abs_err"] for k, r in out.items() if not r["max_abs_err"] <= ATOL}
    if missing or bad:
        raise AssertionError(f"kernel at the path's rows: no launch at B = {missing}, "
                             f"max |kernel - plain| above {ATOL}: {bad}")
    return out


def time_kept_launch(mg, kept, iters):
    """One kept biGRU launch's inputs timed on the card: the kernel, its
    plain version and cuDNN's unmasked bidirectional nn.GRU on the same
    rows (launches made here are not counted), beside gru_bound."""
    import torch

    xs, ms, weights, _ = kept
    xs, ms = xs.to("cuda"), ms.to("cuda")
    fwd, bwd = [tuple(w.to("cuda") for w in ws) for ws in weights]
    l0 = mg.launches
    with torch.no_grad():
        row = {"B": int(xs.shape[1]),
               "active_slots_per_row": float(ms.sum() / ms.shape[1]),
               "kernel_bigru_ms": cuda_ms(lambda: mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd),
                                          iters),
               "plain_bigru_ms": cuda_ms(lambda: mg.masked_bigru_scan_plain(xs, ms, fwd, bwd),
                                         max(3, iters // 3))}
        gru = torch.nn.GRU(xs.shape[-1], fwd[1].shape[0], bidirectional=True).to("cuda")
        dense = xs.contiguous()
        row["cudnn_bigru_unmasked_ms"] = cuda_ms(lambda: gru(dense), iters)
    mg.launches = l0
    row.update(gru_bound(xs, ms, fwd))
    row["share_of_bound"] = row["bound_ms"] / row["kernel_bigru_ms"]
    return row


def bf16_steps(ref):
    """The spacing of bfloat16 values at |ref| (2^-7 of the binade's
    floor): one rounding step of a bfloat16 value of that size."""
    import torch

    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)


def state_diff(a, b):
    """Two DroneStates: (max |a - b| over the float leaves, the names of
    the integer and flag leaves that differ)."""
    import torch

    worst, differ = 0.0, []
    for name, x, y in zip(a._fields, a, b):
        x, y = x.cpu(), y.cpu()
        if not x.is_floating_point():
            if not torch.equal(x, y):
                differ.append(name)
        elif x.numel():
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst, differ


def lane_spread(state):
    """How far any lane of a DroneState is from lane 0: max |x - x[0]| over
    the float leaves, and the count of integer and flag entries that
    differ."""
    worst, differ = 0.0, 0
    for x in state:
        if not x.numel():
            continue
        if x.is_floating_point():
            worst = max(worst, (x - x[:1]).abs().max().item())
        else:
            differ += int((x != x[:1]).sum().item())
    return {"max_abs": worst, "integer_and_flag_entries": differ}


def device_us(e):
    """A profiler event's own device time, in us."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def cuda_ops(prof):
    """The profile's device ops with device time, the most first; the
    device spans of record_function ranges (an optimizer's step) are not
    ops and would count their kernels twice."""
    import torch

    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
           and not getattr(e, "is_user_annotation", False)]
    return sorted(ops, key=device_us, reverse=True)


def tree_diff(a, b, path=""):
    """Two trees of NamedTuples/tuples of tensors on one device: (max |a - b|
    over the float leaves, the paths of the leaves that are not equal bit
    for bit, dtypes included)."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return math.inf, [path]
        worst = 0.0
        if a.is_floating_point() and a.numel():   # inf - inf (equal) counts 0
            worst = float(torch.nan_to_num((a.double() - b.double()).abs(), nan=0.0).max())
        return worst, [] if torch.equal(a, b) else [path]
    worst, differ = 0.0, []
    if isinstance(a, tuple):
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            w, d = tree_diff(x, y, f"{path}.{name}" if path else str(name))
            worst, differ = max(worst, w), differ + d
    return worst, differ


def quiet_main(main, argv):
    """main(argv) with what it prints kept: (exit code, printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def bench_results(name):
    """A bench script's JSON under runs_torch/bench/."""
    from rvo3d_tpu_torch.bench import core

    with open(os.path.join(core.OUT_DIR, name)) as f:
        return json.load(f)


def all_rates_ok(values):
    return bool(values) and all(math.isfinite(v) and v > 0 for v in values)


def dp_argv(run_dir, start_ckpt):
    """The data-parallel epoch's CLI flags: w16_r4's training config at its
    width from the product's params (fresh optimizers), T and the
    iterations cut, one epoch, saved and evaluated."""
    return ["train", "--device", "cuda", "--world", "world16_dense", "--num_envs", "128",
            "--steps_per_epoch", str(CUT_T), "--train_pi_iters", str(CUT_ITERS),
            "--train_v_iters", str(CUT_ITERS), "--pi_lr", "1e-6", "--vf_lr", "5e-5",
            "--target_kl", "0.01", "--log_std_init", "-2.3", "--batched_update",
            "--minibatch", "16384", "--action_mode", "direct", "--seed", "7",
            "--train_epoch", "0", "--save_freq", "1", "--eval_episodes", "16",
            "--resume", start_ckpt, "--resume_params_only", "--quiet",
            "--run_dir", run_dir]


def cli_epoch_recorded(argv):
    """cli.main(argv) with its training epoch recorded: the (gathered)
    rollout batch the update saw, the metrics, seconds, lanes and masked-GRU
    launches of the epoch, and the launches of the whole command."""
    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.algo import trainer as trainer_mod
    from rvo3d_tpu_torch.ops import masked_gru as mg

    real = trainer_mod.Trainer.run_epoch
    seen = {}

    def run_epoch(self):
        def hook(name, data):
            if name == "gae":
                seen["batch"] = {k: v.detach().cpu() for k, v in data._asdict().items()}
        self.phase_hook = hook
        l0 = mg.launches
        m = real(self)
        seen.update(metrics=m, epoch_time_s=m["epoch_time_s"],
                    epoch_launches=mg.launches - l0, lanes=int(self.carry.ep_len.shape[0]))
        return m
    trainer_mod.Trainer.run_epoch = run_epoch
    l0 = mg.launches
    try:
        seen["rc"] = cli.main(argv)
    finally:
        trainer_mod.Trainer.run_epoch = real
    seen["launches"] = mg.launches - l0
    return seen


def dp_worker(out_dir, tag="dp") -> int:
    """One rank of `data_parallel_epoch` (tag "dp": --mesh_data 2) or of
    `tensor_parallel_epoch` (tag "tp": --mesh_model 2), started with the
    RVO3D_* variables: the CLI epoch over the mesh, recorded to
    <out_dir>/<tag>_rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from rvo3d_tpu_torch.ops import masked_gru as mg
    from rvo3d_tpu_torch.parallel import distributed_init_from_env

    if not distributed_init_from_env("cuda"):
        raise SystemExit("--dp-worker/--tp-worker needs the RVO3D_* variables")
    mesh_flags = {"dp": ["--mesh_data", str(DP_RANKS)],
                  "tp": ["--mesh_model", str(DP_RANKS)]}[tag]
    keep = {}
    with kernel_inputs_kept(mg, keep):
        seen = cli_epoch_recorded(dp_argv(os.path.join(out_dir, tag),
                                          os.path.join(out_dir, "start", "ckpt"))
                                  + mesh_flags)
    seen["kernel_inputs"] = {b: (xs.cpu(), ms.cpu(), [tuple(w.cpu() for w in ws)
                                                      for ws in weights], rev)
                             for b, (xs, ms, weights, rev) in keep.items()}
    seen["backend"] = dist.get_backend()
    torch.save(seen, os.path.join(out_dir, f"{tag}_rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if seen["rc"] == 0 else 1


def start_ranks(flag, tmp):
    """This script `flag tmp` (--dp-worker or --tp-worker) in DP_RANKS
    processes joined over a local port; their logs, once all exited 0."""
    from rvo3d_tpu_torch.parallel.multihost import start_ranks as start

    return start([os.path.abspath(__file__), flag, tmp], DP_RANKS, DP_TIMEOUT_S)


def reference_state_dict(seed, hidden=256, heads=(256, 256)):
    """A biGRU policy's state dict in the reference's naming and layouts
    (nn.GRU [3H, in], nn.Linear [out, in]; torch's default init bounds),
    drawn from `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def u(fan, *shape):
        return (2 * torch.rand(shape, generator=g) - 1) * fan ** -0.5

    rnn, sd = "pi.rnn_reader.rnn_net", {}
    for sfx in ("", "_reverse"):
        sd[f"{rnn}.weight_ih_l0{sfx}"] = u(hidden, 3 * hidden, 9)
        sd[f"{rnn}.weight_hh_l0{sfx}"] = u(hidden, 3 * hidden, hidden)
        sd[f"{rnn}.bias_ih_l0{sfx}"] = u(hidden, 3 * hidden)
        sd[f"{rnn}.bias_hh_l0{sfx}"] = u(hidden, 3 * hidden)
    sd["pi.rnn_reader.ln.weight"] = torch.ones(12 + hidden)
    sd["pi.rnn_reader.ln.bias"] = torch.zeros(12 + hidden)
    for prefix, out in (("pi.net_out", 3), ("v.v_net", 1)):
        dims = [12 + hidden, *heads, out]
        for idx, (a, b) in zip((0, 2, 4), zip(dims, dims[1:])):
            sd[f"{prefix}.{idx}.weight"] = u(a, b, a)
            sd[f"{prefix}.{idx}.bias"] = u(a, b)
    sd["pi.log_std"] = torch.full((3,), -1.0)
    return sd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.tp_worker:
        return dp_worker(args.tp_worker, "tp")
    import numpy as np

    from rvo3d_tpu_torch.algo import ppo
    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.algo.trainer import Trainer, metrics_finite
    from rvo3d_tpu_torch.config import EnvParams, ModelConfig, from_dict
    from rvo3d_tpu_torch.env import DroneEnv, geometry as geo
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.models import encoder as encoder_mod
    from rvo3d_tpu_torch.ops import _build
    from rvo3d_tpu_torch.ops import env_drones as ed
    from rvo3d_tpu_torch.ops import masked_gru as mg
    from rvo3d_tpu_torch.ops import vo_pairs as vp
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
    from rvo3d_tpu_torch.worlds import load_world

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    run_phase("device", lambda: {"kind": kind, "count": torch.cuda.device_count(),
                                 "nvidia_smi": smi, "torch": torch.__version__,
                                 "cuda": torch.version.cuda})

    def build():
        out = {}
        for name in ("masked_gru", "vo_pairs", "env_drones"):
            _build.load(name)
            info = _build.BUILD_INFO[name]
            ptxas = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            out[name] = {"nvcc_seconds": info["seconds"], "ptxas": ptxas}
        return out
    run_phase("build", build)

    # the VO kernel's and the env passes' launches in each phase that steps
    # the env on the card
    vo_launches_by_phase, env_launches_by_phase = {}, {}

    def counted(name, fn):
        def run():
            v0, e0 = vp.launches, ed.launches
            out = fn()
            vo_launches_by_phase[name] = vp.launches - v0
            env_launches_by_phase[name] = ed.launches - e0
            if vo_launches_by_phase[name] == 0 or env_launches_by_phase[name] == 0:
                raise AssertionError(f"{name} never launched the VO pair kernel "
                                     "or the env passes")
            return {**out, "vo_launches": vo_launches_by_phase[name],
                    "env_drones_launches": env_launches_by_phase[name]}
        return run

    # ---- kernel vs plain at the serving path's shapes ----
    cfg = ModelConfig()
    hidden, s_len, in_dim = cfg.rnn_hidden_dim, 10, cfg.rnn_input_dim
    b_main = LANES * 16
    gen = torch.Generator().manual_seed(SEED)

    def gru_case(b, mask_kind="random"):
        nbr = torch.randn(b, s_len, in_dim, generator=gen)
        mask = (torch.rand(b, s_len, generator=gen) > 0.4).float()
        if mask_kind == "empty":
            mask.zero_()
        elif mask_kind == "last":     # a drone with no neighbour (the encoder's row)
            mask.zero_()
            mask[:, -1] = 1.0
        elif mask_kind == "suffix":   # the env's layout: valid slots at the end
            k = torch.randint(0, s_len + 1, (b, 1), generator=gen)
            mask = (torch.arange(s_len)[None, :] >= s_len - k).float()
        bound = hidden ** -0.5
        fwd, bwd = ([torch.empty(shape).uniform_(-bound, bound, generator=gen).to(dev)
                     for shape in ((in_dim, 3 * hidden), (hidden, 3 * hidden),
                                   (3 * hidden,), (3 * hidden,))] for _ in range(2))
        nbr, mask = nbr.to(dev), mask.to(dev)
        return nbr.transpose(0, 1), mask.t(), fwd, bwd   # the encoder's strided views

    kstats = {}

    def kernel_checks():
        errs = {}
        for label, b, kind, reverse in (("fwd", b_main, "random", False),
                                        ("bwd", b_main, "random", True),
                                        ("ragged_bwd", b_main - 7, "random", True),
                                        ("empty_mask", b_main, "empty", False),
                                        ("bigru", b_main, "random", None),
                                        ("bigru_suffix_ragged", b_main - 7, "suffix", None),
                                        ("bigru_b1", 1, "random", None)):
            xs, ms, fwd, bwd = gru_case(b, kind)
            if reverse is None:
                got = mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd)
                torch.cuda.synchronize()
                ref = mg.masked_bigru_scan_plain(xs, ms, fwd, bwd)
            else:
                got = mg.masked_gru_scan_cuda(xs, ms, *fwd, reverse=reverse)
                torch.cuda.synchronize()
                ref = mg.masked_gru_scan_plain(xs, ms, *fwd, reverse=reverse)
            err = (got - ref).abs().max().item()
            if not err <= ATOL:
                raise AssertionError(f"{label}: max |kernel - plain| = {err} > {ATOL}")
            errs[label] = err
        kstats["max_abs_err"] = max(errs.values())

        # the main path's launch: both directions of the biGRU, summed
        timed = {}
        for b in TIMED_B:
            xs, ms, fwd, bwd = gru_case(b)
            iters = 30 if b <= 4096 else 10 if b <= 16384 else 5
            row = {"kernel_bigru_ms": cuda_ms(
                       lambda: mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd), iters),
                   "kernel_one_direction_ms": cuda_ms(
                       lambda: mg.masked_gru_scan_cuda(xs, ms, *fwd), iters),
                   "plain_bigru_ms": cuda_ms(
                       lambda: mg.masked_bigru_scan_plain(xs, ms, fwd, bwd),
                       max(3, iters // 3))}
            gru = torch.nn.GRU(in_dim, hidden, bidirectional=True).to(dev)
            x_dense = xs.contiguous()
            with torch.no_grad():
                row["cudnn_bigru_unmasked_ms"] = cuda_ms(lambda: gru(x_dense), iters)
            row.update(gru_bound(xs, ms, fwd))
            row["share_of_bound"] = row["bound_ms"] / row["kernel_bigru_ms"]
            geo = mg.card_geometry(b, hidden, in_dim, 2)
            row["geometry"] = {"rows": geo.rows, "tiles": geo.tiles,
                               "clusters": geo.clusters, "cluster_ctas": mg.CLUSTER,
                               "smem_bytes": geo.smem_bytes}
            row["max_active_clusters"] = mg.max_active_clusters(geo.rows, geo.smem_bytes)
            timed[str(b)] = row
        main = timed[str(b_main)]
        kstats.update(ms=main["kernel_bigru_ms"], plain_ms=main["plain_bigru_ms"],
                      library_ms=main["cudnn_bigru_unmasked_ms"],
                      bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                      bound_ms_f32_simt=main["bound_ms_f32_simt"])
        return {"max_abs_err": errs, "atol": ATOL, "B": b_main, "H": hidden,
                "S": s_len, "bound_peak": "3xTF32 = 495/3 TFLOP/s", "timed": timed}
    run_phase("kernel_vs_plain", kernel_checks)

    # ---- the env on the card against the env on the CPU (which the tests
    # hold to the NumPy oracle), float64, same actions ----
    wd = load_world(WORLD)

    def env_check():
        p64 = EnvParams(num_drones=wd.drone_num)
        envs = [DroneEnv(wd.spec(dtype=torch.float64, device=d), p64, num_envs=8)
                for d in (dev, "cpu")]
        states = [e.reset()[0] for e in envs]
        rng = np.random.default_rng(SEED)
        worst, flagged, finished = 0.0, 0, 0
        for _ in range(40):
            noise = torch.from_numpy(0.2 * rng.standard_normal((8, wd.drone_num, 3)))
            act = geo.rnd(waypoint_controller(states[1], envs[1].world) + noise, 2)
            (sg, og), (sc, oc) = [e.step(st, act.to(e.world.device))
                                  for e, st in zip(envs, states)]
            for name in ("done", "info_arrive", "finish", "obs_mask"):
                if not torch.equal(getattr(og, name).cpu(), getattr(oc, name)):
                    raise AssertionError(f"{name} differs between card and CPU")
            for a, b in ((og.obs_self, oc.obs_self), (og.obs_nbr, oc.obs_nbr),
                         (og.reward, oc.reward), (sg.pos, sc.pos)):
                a = a.cpu()
                fin = torch.isfinite(b)
                if not torch.equal(fin, torch.isfinite(a)):
                    raise AssertionError("inf pattern differs between card and CPU")
                worst = max(worst, (a[fin] - b[fin]).abs().max().item())
            flagged += int(oc.obs_mask.sum())
            finished += int(oc.finish.sum())
            done = oc.done
            states = [envs[0].reset_where(sg, done.to(dev)),
                      envs[1].reset_where(sc, done)]
        if worst > 1e-9:
            raise AssertionError(f"card vs CPU max |diff| {worst} > 1e-9")
        return {"steps": 40, "lanes": 8, "max_abs_diff": worst, "atol": 1e-9,
                "neighbour_slots_seen": flagged, "finished_drone_steps": finished}
    run_phase("env_card_vs_cpu_f64", counted("env_card_vs_cpu_f64", env_check))

    # ---- the VO kernel against the plain path on the card, and timed ----
    vo_rows = {}

    def vo_pairs_kernel():
        from rvo3d_tpu_torch.bench import core as bench_core
        from rvo3d_tpu_torch.bench.flagship import flagship_world
        from rvo3d_tpu_torch.env import rvo
        from rvo3d_tpu_torch.env.env import drone_states_12

        shapes = (("eval_1024x32", load_world("world32_mix").spec(device=dev), 1024),
                  ("rollout_128x16", load_world(WORLD).spec(device=dev), 128),
                  ("bench_16384x8",
                   bench_core.world_spec(flagship_world(), dev, torch.float32), 16384))
        for label, w, lanes in shapes:
            p_w = EnvParams(num_drones=w.num_drones)
            env = DroneEnv(w, p_w, num_envs=lanes)
            state, _ = env.reset()
            g = torch.Generator(device=dev).manual_seed(SEED)
            for _ in range(10):
                noise = 0.5 * torch.randn(state.pos.shape, generator=g, device=dev)
                act = geo.rnd(waypoint_controller(state, w) + noise, 2)
                state, out = env.step(state, act)
                state = env.reset_where(state, out.done)
            s12, _ = drone_states_12(w, state, p_w)
            bld = (w.buildings, w.building_mask)
            # the same lanes crowded: each drone pulled to within 0.8 m of
            # its lane's centre and flying (and commanded) toward it, so
            # rows list neighbours and the top-nm selection runs at this
            # shape whatever the flown steps listed
            crowd = s12.clone()
            c = crowd[..., 0:3].mean(-2, keepdim=True)
            off = crowd[..., 0:3] - c
            reach = off.norm(dim=-1, keepdim=True).amax(-2, keepdim=True)
            crowd[..., 0:3] = c + off * (0.8 / reach.clamp_min(1e-3))
            crowd[..., 3:6] = geo.rnd(-0.5 * torch.sign(off), 2)
            crowd_act = crowd[..., 3:6].clone()
            row = {"lanes": lanes, "drones": w.num_drones}
            for kind, (x, a) in (("flown", (s12, act)), ("crowded", (crowd, crowd_act))):
                got = vp.observe(x, a, *bld, p_w)
                listed = int(got[1].sum())
                if kind == "crowded" and listed == 0:
                    raise AssertionError(f"{label}: the crowded lanes list no neighbour")
                row[f"listed_slots_{kind}"] = listed
                row[f"full_rows_{kind}"] = int(got[1].all(-1).sum())
                vo_within(got, rvo.vo_observe_plain(x, a, *bld, p_w),
                          f"{label} {kind} observe")
                vo_within(vp.reward_info(x, a, p_w), rvo.vo_reward_info_plain(x, a, p_w),
                          f"{label} {kind} reward")
            runs = {"reward": (lambda: vp.reward_info(s12, act, p_w),
                               lambda: rvo.vo_reward_info_plain(s12, act, p_w)),
                    "observe": (lambda: vp.observe(s12, act, *bld, p_w),
                                lambda: rvo.vo_observe_plain(s12, act, *bld, p_w))}
            for mode, (kernel, plain) in runs.items():
                err = vo_within(kernel(), plain(), f"{label} {mode}")
                b = vo_bound(s12, act, nm=p_w.neighbor_num if mode == "observe" else 0,
                             buildings=bld[0], building_mask=bld[1])
                row[mode] = {"ms": cuda_ms(kernel, 50), "plain_ms": cuda_ms(plain, 10),
                             "max_abs_err": err, **b}
            vo_rows[label] = row
        return {"shapes": vo_rows, "card": smi}
    run_phase("vo_pairs_kernel", vo_pairs_kernel)

    # ---- the env passes against the plain path on the card, and timed ----
    env_rows = {}

    def env_drones_kernel():
        from rvo3d_tpu_torch.bench import core as bench_core
        from rvo3d_tpu_torch.bench.flagship import flagship_world
        from rvo3d_tpu_torch.env import env as env_mod
        from rvo3d_tpu_torch.env import rvo

        def flat(tree):
            return tuple(x for part in tree for x in part)

        shapes = (("eval_1024x32", load_world("world32_mix").spec(device=dev), 1024),
                  ("rollout_128x16", load_world(WORLD).spec(device=dev), 128),
                  ("bench_16384x8",
                   bench_core.world_spec(flagship_world(), dev, torch.float32), 16384))
        for label, w, lanes in shapes:
            p_w = EnvParams(num_drones=w.num_drones)
            state = env_mod.reset(w, p_w, (lanes,))
            g = torch.Generator(device=dev).manual_seed(SEED)
            err, listed, resets = 0.0, 0, 0
            for t in range(10):
                noise = 0.5 * torch.randn(state.pos.shape, generator=g, device=dev)
                act = geo.rnd(waypoint_controller(state, w) + noise, 2)
                want = env_mod.step_plain(w, state, act, p_w)
                err = max(err, vo_within(flat(env_mod._step_passes(w, state, act, p_w, None)),
                                         flat(want), f"{label} step {t}"))
                state, out = want
                listed += int(out.obs_mask.sum())
                mask = out.done | out.finish
                resets += int(mask.sum())
                want = env_mod.reset_where_plain(w, state, mask)
                err = max(err, vo_within(env_mod._reset_where_passes(w, state, mask), want,
                                         f"{label} reset {t}"))
                state = want
            err = max(err, vo_within(flat(env_mod._observe_passes(w, state, p_w)),
                                     flat(env_mod.observe_plain(w, state, p_w)),
                                     f"{label} observe"))
            # each pass alone, and the three calls, on the last state
            act = geo.rnd(waypoint_controller(state, w), 2)
            s12 = ed.pre(w, state, p_w)
            info = rvo.vo_reward_info(s12, act, p_w)
            mid = ed.mid(w, state, s12, act, info.vo_flag, info.min_exp_time, p_w)
            post_state = state._replace(**mid.fields)
            vo = rvo.vo_observe(mid.states12, act, w.buildings, w.building_mask, p_w)
            obs = ed.obs(w, state, p_w)
            vo0 = rvo.vo_observe(obs[0], obs[3], w.buildings, w.building_mask, p_w)
            mask = state.arrive_flag | (torch.rand(state.yaw.shape, generator=g,
                                                   device=dev) < 0.05)
            passes = {
                "pre": lambda: ed.pre(w, state, p_w),
                "mid": lambda: ed.mid(w, state, s12, act, info.vo_flag, info.min_exp_time,
                                      p_w),
                "post": lambda: ed.post(w, post_state, vo.collision, mid, vo.obs_nbr,
                                        vo.obs_mask, p_w),
                "obs": lambda: ed.obs(w, state, p_w),
                "post_obs": lambda: ed.post_obs(w, state, vo0.obs_nbr, vo0.obs_mask, p_w),
                "reset": lambda: ed.reset(w, state, mask)}
            bound = env_drones_bound(state.yaw.numel(), 4, 4, p_w.neighbor_num,
                                     int(vo.obs_mask.sum()))
            row = {"lanes": lanes, "drones": w.num_drones, "max_abs_err": err,
                   "listed_slots": listed, "resets": resets, "passes": {}}
            for name, fn in passes.items():
                row["passes"][name] = {"ms": graphed_ms(fn), **bound[name]}
            calls = {"step": (lambda: env_mod.step(w, state, act, p_w),
                              lambda: env_mod.step_plain(w, state, act, p_w)),
                     "observe": (lambda: env_mod.observe(w, state, p_w),
                                 lambda: env_mod.observe_plain(w, state, p_w)),
                     "reset_where": (lambda: env_mod.reset_where(w, state, mask),
                                     lambda: env_mod.reset_where_plain(w, state, mask))}
            for name, (fused, plain) in calls.items():
                row[name] = {"ms": graphed_ms(fused), "plain_ms": graphed_ms(plain)}
            env_rows[label] = row
        return {"shapes": env_rows, "card": smi}
    run_phase("env_drones_kernel", env_drones_kernel)

    # ---- the main path: evaluate closed-loop, then serve ----
    world = wd.spec(device=dev)
    p = EnvParams(num_drones=wd.drone_num)
    ac = ActorCritic(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    mg.launches = 0

    def run_eval():
        m = evaluate(ac, world, p,
                     generator=torch.Generator(device=dev).manual_seed(SEED),
                     num_episodes=LANES, num_lanes=LANES, max_ep_len=150,
                     max_chunks=2, action_mode="direct")
        torch.cuda.synchronize()
        if m.get("truncated") or m["episodes"] < 100:
            raise AssertionError(f"evaluate ended {m['episodes']} episodes")
        if not all(np.isfinite(m[k]) for k in ("success_rate", "mean_speed",
                                              "mean_ep_len")):
            raise AssertionError(f"non-finite metrics {m}")
        if mg.launches == 0:
            raise AssertionError("evaluate never launched the masked GRU kernel")
        return {"world": WORLD, "lanes": LANES, "drones": wd.drone_num,
                "gru_launches": mg.launches, **m}
    run_phase("evaluate", counted("evaluate", run_eval))

    server = PolicyServer(ac, nm=p.neighbor_num)

    def serve():
        rng = np.random.default_rng(SEED)
        lat = {}
        for b in (1, 64, 4096):
            k = 4
            obs_self = rng.normal(size=(b, 12)).astype(np.float32)
            nbr = np.zeros((b, 10, 9), np.float32)
            mask = np.zeros((b, 10), bool)
            nbr[:, 10 - k:] = rng.normal(size=(b, k, 9))
            mask[:, 10 - k:] = rng.random((b, k)) > 0.3
            nbr[~mask] = 0.0   # act_flat reads all-zero blocks as padding
            flat = np.concatenate([obs_self, nbr[:, 10 - k:].reshape(b, -1)], 1)
            a = server.act(obs_self, nbr, mask)
            af = server.act_flat(flat)
            if a.shape != (b, 3) or not np.isfinite(a).all() or not np.isfinite(af).all():
                raise AssertionError(f"bad actions at batch {b}")
            if not np.allclose(a, af, atol=1e-6, rtol=0):
                raise AssertionError(f"act and act_flat disagree at batch {b}")
            lat[f"act_p50_ms_b{b}"] = p50_ms(lambda: server.act(obs_self, nbr, mask))
            lat[f"act_flat_p50_ms_b{b}"] = p50_ms(lambda: server.act_flat(flat))
        return lat
    run_phase("serve", serve)
    launches = mg.launches

    # ---- what the path computed is right: the kernel path against the plain
    # path (the same policy on the CPU) at B = 4096 on env observations. The
    # random policy leaves the drones still, so the env is flown by the
    # waypoint controller with noise, and every row that saw a neighbour in
    # 30 steps is kept ----
    def flown_observations():
        """B = 4096 env observations: every row that saw a neighbour in 30
        steps of the waypoint controller with noise, then the last step's."""
        env = DroneEnv(world, p, num_envs=LANES)
        g = torch.Generator(device=dev).manual_seed(SEED)
        state, out = env.reset()
        rows = []
        for _ in range(30):
            noise = 0.5 * torch.randn(state.pos.shape, generator=g, device=dev)
            state, out = env.step(state, geo.rnd(waypoint_controller(state, world) + noise, 2))
            state = env.reset_where(state, out.done)
            seen = out.obs_mask.any(-1)
            rows.append((out.obs_self[seen], out.obs_nbr[seen], out.obs_mask[seen]))
        flat = (out.obs_self.flatten(0, 1), out.obs_nbr.flatten(0, 1),
                out.obs_mask.flatten(0, 1))
        return [torch.cat([r[i] for r in rows] + [flat[i]])[:b_main] for i in range(3)]

    def encoder_check():
        obs = flown_observations()
        with torch.no_grad():
            ac_cpu = ActorCritic(cfg, device="cpu")
            ac_cpu.load_state_dict(ac.state_dict())
            mu, _, v = ac(*obs)
            mu_c, _, v_c = ac_cpu(*[o.cpu() for o in obs])
        err_mu = (mu.cpu() - mu_c).abs().max().item()
        err_v = (v.cpu() - v_c).abs().max().item()
        with_nbr = int(obs[2].any(-1).sum().item())
        if with_nbr == 0:
            raise AssertionError("no observation row with a neighbour")
        if not (err_mu <= ATOL and err_v <= ATOL):
            raise AssertionError(f"kernel path vs plain: mu {err_mu}, v {err_v}")
        return {"B": int(mu.shape[0]), "rows_with_neighbours": with_nbr,
                "max_abs_err_mu": err_mu, "max_abs_err_v": err_v, "atol": ATOL}
    run_phase("encoder_kernel_vs_plain", encoder_check)

    # ---- where an evaluate step's time goes, at 256 lanes x 16 drones ----
    def breakdown():
        env = DroneEnv(world, p, num_envs=LANES)
        state, out = env.reset()
        obs = (out.obs_self, out.obs_nbr, out.obs_mask)
        act = torch.zeros_like(state.vel)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            policy_ms = cuda_ms(lambda: ac.step(*obs, 1e-3, gen), 20)
            env_ms = cuda_ms(lambda: env.step(state, act), 20)
            observe_ms = cuda_ms(lambda: env.observe(state), 20)
        return {"policy_step_ms": policy_ms, "env_step_ms": env_ms,
                "env_observe_ms": observe_ms}
    run_phase("step_breakdown", breakdown)

    # ---- the training path, from the committed product policy (the w16_r4
    # run's epoch 30, with its config) ----
    with open(PRODUCT_CONFIG) as f:
        run_cfg = from_dict(json.load(f))
    product = torch.load(PRODUCT_PARAMS, map_location="cpu", weights_only=True)
    run_world = load_world(run_cfg.world).spec(device=dev)
    launches_by_phase = {"evaluate_and_serve": launches}

    def product_eval():
        server = PolicyServer.from_checkpoint(PRODUCT_PARAMS, device=dev)
        mg.launches = 0
        m = evaluate(server.ac, run_world, run_cfg.env,
                     generator=torch.Generator(device=dev).manual_seed(SEED),
                     num_episodes=PRODUCT_EPISODES, num_lanes=128, chunk_len=40,
                     max_chunks=8, std_factor=run_cfg.train.std_factor_eval,
                     action_mode=run_cfg.train.action_mode)
        torch.cuda.synchronize()
        n = mg.launches
        if (m.get("truncated") or m["episodes"] < PRODUCT_EPISODES
                or m["success_rate"] < PRODUCT_MIN_SUCCESS
                or abs(m["mean_ep_len"] - PRODUCT_EPLEN) > PRODUCT_EPLEN_TOL):
            raise AssertionError(f"the product policy scores {m}; the gate is success "
                                 f">= {PRODUCT_MIN_SUCCESS} over {PRODUCT_EPISODES} "
                                 f"episodes, EpLen {PRODUCT_EPLEN} +- {PRODUCT_EPLEN_TOL}")
        if n == 0:
            raise AssertionError("product_eval never launched the masked GRU kernel")
        launches_by_phase["product_eval"] = n
        return {"world": run_cfg.world, "lanes": 128, "drones": run_cfg.env.num_drones,
                "gru_launches": n, "min_success": PRODUCT_MIN_SUCCESS,
                "ep_len_gate": [PRODUCT_EPLEN, PRODUCT_EPLEN_TOL], **m}
    run_phase("product_eval", product_eval)

    trained = {}

    def train():
        cfg = dataclasses.replace(run_cfg, train=dataclasses.replace(
            run_cfg.train, steps_per_epoch=TRAIN_T))
        tr = cfg.train
        trainer = Trainer(cfg, run_world, device=dev)
        trainer.ac.load_state_dict(product["state_dict"])   # fresh optimizers
        marks, keep = [], {}

        def hook(name, data):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((ev, mg.launches, vp.launches, ed.launches))
            if name == "gae":
                active = data.obs_mask.sum(-1)
                keep["rows"], keep["multi"] = active.numel(), (active > 1).sum()
                keep["any"] = (active > 0).sum()
            elif name == "update":
                flat = ppo.AgentData(*[x.flatten(0, 2) for x in data])
                start = (flat.act.shape[0] - GRAD_ROWS) // 2
                keep["window"] = ppo.AgentData(
                    *[x[start:start + GRAD_ROWS].clone() for x in flat])
        trainer.phase_hook = hook
        lines = []
        mg.launches = 0
        for epoch in range(TRAIN_EPOCHS):
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            m = trainer.run_epoch()
            torch.cuda.synchronize()
            (e0, l0, v0, d0), (e1, l1, v1, d1), (e2, l2, _, _), (e3, l3, _, _) = marks
            line = {"phase": "train_epoch", "epoch": epoch,
                    "epoch_time_s": m["epoch_time_s"], "steps_per_sec": m["steps_per_sec"],
                    "rollout_ms": e0.elapsed_time(e1), "gae_ms": e1.elapsed_time(e2),
                    "update_ms": e2.elapsed_time(e3),
                    "gru_launches_rollout": l1 - l0, "gru_launches_update": l3 - l2,
                    "vo_launches_rollout": v1 - v0, "env_drones_launches_rollout": d1 - d0,
                    "pi_iters": m["pi_iters"], "kl": m["kl"], "pi_loss": m["pi_loss"],
                    "v_loss": m["v_loss"], "mean_step_reward": m["mean_step_reward"],
                    "episodes": sum(m["episodes"]),
                    "success_episodes": sum(m["success_episodes"]),
                    "collision_episodes": sum(m["collision_episodes"]),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "rollout_rows": keep["rows"],
                    "rollout_rows_with_neighbour": int(keep["any"]),
                    "rollout_rows_multi_slot": int(keep["multi"])}
            emit(line)
            lines.append(line)
            if not metrics_finite(m):
                raise AssertionError(f"epoch {epoch}: non-finite metrics")
            if line["gru_launches_rollout"] == 0 or line["gru_launches_update"] == 0:
                raise AssertionError(f"epoch {epoch}: the kernel was not launched "
                                     "in the rollout and in the update")
            if line["vo_launches_rollout"] == 0:
                raise AssertionError(f"epoch {epoch}: the rollout never launched "
                                     "the VO pair kernel")
            vo_launches_by_phase["train_rollout"] = (
                vo_launches_by_phase.get("train_rollout", 0) + line["vo_launches_rollout"])
            env_launches_by_phase["train_rollout"] = (
                env_launches_by_phase.get("train_rollout", 0)
                + line["env_drones_launches_rollout"])
        launches_by_phase["train"] = mg.launches
        trained.update(trainer=trainer, window=keep["window"])
        # where a rollout step's time goes, at the trainer's carry
        env = DroneEnv(run_world, cfg.env, num_envs=tr.num_envs)
        state, obs = trainer.carry.env_state, trainer.carry.obs
        act = torch.zeros_like(state.vel)
        none = torch.zeros(state.yaw.shape, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            step_ms = {"policy_step_ms": cuda_ms(lambda: trainer.ac.step(*obs, 1.0, gen), 20),
                       "env_step_ms": cuda_ms(lambda: env.step(state, act), 20),
                       "env_observe_ms": cuda_ms(lambda: env.observe(state), 20),
                       "reset_where_ms": cuda_ms(lambda: env.reset_where(state, none), 20)}
        return {"epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_T,
                "steps_per_epoch_cut": TRAIN_T != run_cfg.train.steps_per_epoch,
                "lanes": tr.num_envs, "drones": cfg.env.num_drones,
                "world": cfg.world, "hidden": cfg.model.rnn_hidden_dim,
                "minibatch": tr.minibatch, "batched_update": tr.batched_update,
                "train_pi_iters": tr.train_pi_iters, "train_v_iters": tr.train_v_iters,
                "gru_launches": launches_by_phase["train"],
                "epoch_time_s": [x["epoch_time_s"] for x in lines],
                "rollout_step_breakdown": step_ms}
    run_phase("train", train)

    # ---- the training path's gradients: kernel forward (plain backward) on
    # the card against the plain path on the CPU, on 16384 rollout rows ----
    def train_grad_check():
        """The 16384 rollout rows as they are, and the same rows with random
        neighbour features and masks (the product policy keeps VO
        neighbours out of its cone, so its rows hold almost none)."""
        trainer, rows = trained["trainer"], trained["window"]
        tr = trainer.cfg.train
        ac_card = trainer.ac
        ac_cpu = ActorCritic(trainer.cfg.model, device="cpu")
        ac_cpu.load_state_dict(ac_card.state_dict())
        g = torch.Generator().manual_seed(SEED)
        nm = rows.obs_mask.shape[-1]
        k = torch.randint(0, nm + 1, (GRAD_ROWS, 1), generator=g)
        rand_mask = torch.arange(nm)[None, :] >= nm - k          # the env's suffix layout
        rand_nbr = torch.randn(rows.obs_nbr.shape, generator=g) * rand_mask[..., None]
        cases = {"rollout_rows": rows,
                 "random_neighbours": rows._replace(obs_nbr=rand_nbr.to(dev),
                                                    obs_mask=rand_mask.to(dev))}

        def grads(model, batch):
            out = {}
            losses = {"pi": lambda: ppo.pi_loss_fn(model, batch, tr.clip_ratio,
                                                   tr.adv_norm, tr.ent_coef)[0],
                      "v": lambda: ppo.v_loss_fn(model, batch, tr.value_clip)}
            for name, loss in losses.items():
                model.zero_grad(set_to_none=True)
                loss().backward()
                out[name] = {n: q.grad.detach().cpu().clone()
                             for n, q in model.named_parameters() if q.grad is not None}
            model.zero_grad(set_to_none=True)
            return out
        def plain_on_card(batch):
            """The same gradients with the encoder's biGRU through the plain
            scans on the card: the yardstick of what the card's float32
            arithmetic alone moves."""
            real = encoder_mod.masked_bigru_scan
            encoder_mod.masked_bigru_scan = mg.masked_bigru_scan_plain
            try:
                return grads(ac_card, batch)
            finally:
                encoder_mod.masked_bigru_scan = real

        groups = ("encoder.fwd", "encoder.bwd", "encoder.ln", "actor", "critic", "log_std")
        report, failed = {}, []
        for case, batch in cases.items():
            before = mg.launches
            g_card = grads(ac_card, batch)
            torch.cuda.synchronize()
            if mg.launches - before != 2:
                raise AssertionError(f"{case}: {mg.launches - before} kernel launches "
                                     "for two losses")
            g_plain = plain_on_card(batch)
            if mg.launches - before != 2:
                raise AssertionError(f"{case}: the plain path launched the kernel")
            g_cpu = grads(ac_cpu, ppo.AgentData(*[x.cpu() for x in batch]))
            with torch.no_grad():   # the encoder's forward error on these rows
                feat = ac_card.encoder(batch.obs_self, batch.obs_nbr, batch.obs_mask)
                feat_cpu = ac_cpu.encoder(*[x.cpu() for x in batch[:3]])
            report[case] = {"rows_multi_slot": int((batch.obs_mask.sum(-1) > 1).sum()),
                            "encoder_max_abs_err": (feat.cpu() - feat_cpu).abs().max().item()}
            for loss, ref in g_cpu.items():
                if set(g_card[loss]) != set(ref) or set(g_plain[loss]) != set(ref):
                    raise AssertionError(f"{case}/{loss}: other parameters got gradients")
                for group in groups:
                    names = [n for n in ref if n.startswith(group)]
                    if not names:
                        continue

                    def flat(gr):
                        return torch.cat([gr[n].flatten() for n in names])
                    r = flat(ref)
                    scale = r.abs().max().item()
                    err = (flat(g_card[loss]) - r).abs().max().item()
                    err_plain = (flat(g_plain[loss]) - r).abs().max().item()
                    rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
                    rel_plain = err_plain / scale if scale > 0 else 0.0
                    report[case][f"{loss}/{group}"] = {
                        "max_abs_err": err, "max_abs_grad": scale, "rel_err": rel,
                        "card_plain_rel_err": rel_plain}
                    if not rel <= max(GRAD_RTOL, 2 * rel_plain):
                        failed.append(f"{case}/{loss}/{group}")
        # the kernel at the rollout rows' masks (the encoder's view of them)
        enc = ac_card.encoder
        mask = rows.obs_mask
        last = torch.zeros(nm, dtype=torch.bool, device=dev)
        last[-1] = True
        mask = torch.where(mask.any(-1, keepdim=True), mask, last)
        xs = rows.obs_nbr.to(torch.float32).transpose(0, 1)
        ms = mask.to(torch.float32).t()
        with torch.no_grad():
            fwd, bwd = enc.fwd.weights(), enc.bwd.weights()
            timing = {"kernel_bigru_ms": cuda_ms(
                          lambda: mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd), 20),
                      "plain_bigru_ms": cuda_ms(
                          lambda: mg.masked_bigru_scan_plain(xs, ms, fwd, bwd), 5)}
            gru = torch.nn.GRU(xs.shape[-1], enc.hidden_dim, bidirectional=True).to(dev)
            x_dense = xs.contiguous()
            timing["cudnn_bigru_unmasked_ms"] = cuda_ms(lambda: gru(x_dense), 20)
        timing.update(gru_bound(xs, ms, fwd))
        timing["active_slots_per_row"] = float(ms.sum() / ms.shape[1])

        # where an update iteration's time goes (kernel forward, plain backward)
        def fwd_bwd(loss):
            ac_card.zero_grad(set_to_none=True)
            loss().backward()
        pi_loss = lambda: ppo.pi_loss_fn(ac_card, rows, tr.clip_ratio, tr.adv_norm,
                                         tr.ent_coef)[0]
        v_loss = lambda: ppo.v_loss_fn(ac_card, rows, tr.value_clip)
        timing["update_iteration_ms"] = {
            "pi_loss_forward": cuda_ms(pi_loss, 10),
            "pi_loss_forward_backward": cuda_ms(lambda: fwd_bwd(pi_loss), 10),
            "v_loss_forward_backward": cuda_ms(lambda: fwd_bwd(v_loss), 10)}
        ac_card.zero_grad(set_to_none=True)
        if failed:
            raise AssertionError(f"gradients past rel {GRAD_RTOL}: {failed}: {report}")
        return {"rows": GRAD_ROWS, "rel_tol": GRAD_RTOL, "cases": report,
                "timed_at_rollout_rows": timing}
    run_phase("train_grad_kernel_vs_plain", train_grad_check)

    # ---- multi-world lanes: world32_mix and its route-reversed variant in
    # alternate lanes, float64, on the card against the CPU, and each lane
    # against the single-world run of its own world (CPU) ----
    from rvo3d_tpu_torch.worlds.multi import MultiWorldEnv, reverse_routes

    wd32 = load_world("world32_mix")

    def pop_spec(pop, device, dtype=torch.float32):
        spec = wd32.spec(dtype=dtype, device=device)
        return reverse_routes(spec) if pop.endswith(":rev") else spec

    def multi_env_check():
        p64 = EnvParams(num_drones=wd32.drone_num)
        idx = torch.arange(MULTI_LANES) % len(W32_POPULATIONS)
        envs = [MultiWorldEnv([pop_spec(k, d, torch.float64) for k in W32_POPULATIONS],
                              idx, p64) for d in (dev, "cpu")]
        singles = [DroneEnv(pop_spec(k, "cpu", torch.float64), p64,
                            num_envs=int((idx == i).sum()))
                   for i, k in enumerate(W32_POPULATIONS)]
        states = [e.reset_batch()[0] for e in envs]
        s_states = [e.reset()[0] for e in singles]
        rng = np.random.default_rng(SEED)
        worst = {"card_vs_cpu": 0.0, "lane_vs_single": 0.0}
        seen = {"collisions": 0, "finished": 0, "neighbour_slots": 0}

        def compare(key, a_out, b_out, sel=slice(None)):
            for name in ("done", "info_arrive", "finish", "obs_mask"):
                a, b = getattr(a_out, name).cpu()[sel], getattr(b_out, name).cpu()
                if not torch.equal(a, b):
                    raise AssertionError(f"{key}: {name} differs")
            for name in ("obs_self", "obs_nbr", "reward"):
                a, b = getattr(a_out, name).cpu()[sel], getattr(b_out, name).cpu()
                fin = torch.isfinite(b)
                if not torch.equal(fin, torch.isfinite(a)):
                    raise AssertionError(f"{key}: {name} inf pattern differs")
                worst[key] = max(worst[key], (a[fin] - b[fin]).abs().max().item())

        for _ in range(MULTI_STEPS):
            lw = envs[1].lane_worlds
            noise = torch.from_numpy(
                0.3 * rng.standard_normal((MULTI_LANES, wd32.drone_num, 3)))
            act = geo.rnd(waypoint_controller(states[1], lw) + noise, 2)
            (sg, og), (sc, oc) = [e.step_batch(st, act.to(e.lane_worlds.device))
                                  for e, st in zip(envs, states)]
            compare("card_vs_cpu", og, oc)
            worst["card_vs_cpu"] = max(worst["card_vs_cpu"],
                                       (sg.pos.cpu() - sc.pos).abs().max().item())
            need = oc.done | oc.finish
            sg = envs[0].reset_where_batch(sg, need.to(dev))
            sc = envs[1].reset_where_batch(sc, need)
            (rg, sg), (rc, sc) = envs[0].observe_batch(sg), envs[1].observe_batch(sc)
            compare("card_vs_cpu", rg, rc)
            for i, env in enumerate(singles):
                lanes = idx == i
                st, o = env.step(s_states[i], act[lanes])
                compare("lane_vs_single", oc, o, lanes)
                st = env.reset_where(st, need[lanes])
                r, st = env.observe(st)
                compare("lane_vs_single", rc, r, lanes)
                s_states[i] = st
            states = [sg, sc]
            seen["collisions"] += int(oc.done.sum())
            seen["finished"] += int(oc.finish.sum())
            seen["neighbour_slots"] += int(oc.obs_mask.sum())
        for key, err in worst.items():
            if not err <= 1e-12:
                raise AssertionError(f"{key}: max |diff| {err} > 1e-12")
        return {"worlds": list(W32_POPULATIONS), "lanes": MULTI_LANES,
                "drones": wd32.drone_num, "steps": MULTI_STEPS, "dtype": "float64",
                "max_abs_diff": worst, "atol": 1e-12, **seen, "card": smi}
    run_phase("multi_world_env_card_vs_cpu",
              counted("multi_world_env_card_vs_cpu", multi_env_check))

    # ---- the committed w32_m3s product on both world32_mix populations ----
    with open(W32_CONFIG) as f:
        w32_cfg = from_dict(json.load(f))

    def w32_product_eval():
        server = PolicyServer.from_checkpoint(W32_PARAMS, device=dev)
        out, failed = {}, []
        mg.launches = 0
        for pop in W32_POPULATIONS:
            t0 = time.perf_counter()
            m = evaluate(server.ac, pop_spec(pop, dev), w32_cfg.env,
                         generator=torch.Generator(device=dev).manual_seed(SEED),
                         num_episodes=W32_EPISODES, num_lanes=128, chunk_len=40,
                         max_chunks=8, std_factor=w32_cfg.train.std_factor_eval,
                         action_mode=w32_cfg.train.action_mode)
            torch.cuda.synchronize()
            gate = W32_GATE[pop]
            (eplen, tol) = gate["ep_len"]
            if (m.get("truncated") or m["episodes"] < W32_EPISODES
                    or m["success_rate"] < gate["min_success"]
                    or abs(m["mean_ep_len"] - eplen) > tol):
                failed.append(pop)
            out[pop] = {**m, "seconds": time.perf_counter() - t0, "gate": gate}
        n = mg.launches
        launches_by_phase["w32_product_eval"] = n
        if n == 0:
            raise AssertionError("w32_product_eval never launched the masked GRU kernel")
        if failed:
            raise AssertionError(f"the w32_m3s product misses its gate on {failed}: {out}")
        return {"lanes": 128, "drones": wd32.drone_num, "gru_launches": n,
                "populations": out, "card": smi}
    run_phase("w32_product_eval", w32_product_eval)

    # ---- the w32_m3s recipe through the port's CLI: BC on the RVO expert
    # with DAgger, then PPO, both populations, full width ----
    def bc_ppo_recipe():
        import tempfile

        from rvo3d_tpu_torch import cli
        from rvo3d_tpu_torch.algo import bc, evaluator, trainer as trainer_mod
        from rvo3d_tpu_torch.env import rvo_policy

        # the expert alone at the demos' width (32 lanes x 32 drones)
        p32 = dataclasses.replace(w32_cfg.env, noise=False)
        lw32 = pop_spec(W32_POPULATIONS[0], dev)
        st32 = DroneEnv(lw32, p32, num_envs=32).reset()[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rvo_policy.rvo_controller(st32, lw32, p32, margin=0.3, slowdown=True)
        torch.cuda.synchronize()
        expert_peak = torch.cuda.max_memory_allocated() - base
        expert_ms = cuda_ms(lambda: rvo_policy.rvo_controller(st32, lw32, p32, margin=0.3,
                                                              slowdown=True), 5, warmup=1)
        del st32, lw32

        launches = {"demos_dagger": 0, "fit": 0, "rollout": 0, "update": 0, "eval": 0}
        rounds, epochs, evals = [], [], []
        seen = {}     # the policy and rows the path fed the kernel, kept for the checks
        cur = {"collect_s": 0.0, "demo_steps": 0, "expert_events": [],
               "launches_demos": 0}
        real = {"collect": bc.collect_demos, "fit": bc.fit,
                "expert": rvo_policy.rvo_controller, "run_epoch": trainer_mod.Trainer.run_epoch,
                "evaluate": evaluator.evaluate}

        def expert(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real["expert"](*a, **k)
            e1.record()
            cur["expert_events"].append((e0, e1))
            return out

        def collect(*a, **k):
            behave = k.get("behavior_fn")
            if behave is not None and "dagger_obs" not in seen:
                calls = [0]

                def keep(obs_self, obs_nbr, obs_mask):
                    # the first DAgger rollout's own rows, halfway through it
                    calls[0] += 1
                    if calls[0] == a[3] // 2:
                        seen["dagger_obs"] = (obs_nbr.clone(), obs_mask.clone())
                    return behave(obs_self, obs_nbr, obs_mask)
                k["behavior_fn"] = keep
            l0 = mg.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["collect"](*a, **k)
            torch.cuda.synchronize()
            cur["collect_s"] += time.perf_counter() - t0
            cur["demo_steps"] += a[3]
            cur["launches_demos"] += mg.launches - l0
            return out

        def fit(*a, **k):
            seen["ac"], seen["bc_data"], seen["bc_rows"] = a[0], a[1], a[2]
            l0 = mg.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = real["fit"](*a, **k)
            torch.cuda.synchronize()
            fit_s, steps = time.perf_counter() - t0, a[3]
            ex = [e0.elapsed_time(e1) for e0, e1 in cur["expert_events"]]
            line = {"phase": "bc_round", "round": len(rounds),
                    "collect_s": cur["collect_s"], "demo_steps": cur["demo_steps"],
                    "expert_ms_per_step": sum(ex) / max(len(ex), 1),
                    "collect_ms_per_step": 1e3 * cur["collect_s"] / max(cur["demo_steps"], 1),
                    "fit_s": fit_s, "fit_steps": steps,
                    "fit_ms_per_step": 1e3 * fit_s / max(steps, 1), "batch": a[4],
                    "rows": a[2], "loss": loss,
                    "gru_launches_demos": cur["launches_demos"],
                    "gru_launches_fit": mg.launches - l0, "card": smi}
            emit(line)
            rounds.append(line)
            launches["demos_dagger"] += cur["launches_demos"]
            launches["fit"] += mg.launches - l0
            cur.update(collect_s=0.0, demo_steps=0, expert_events=[], launches_demos=0)
            return loss

        def run_epoch(self):
            marks = []

            def hook(name, data):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((ev, mg.launches))
                if name == "gae":
                    active = data.obs_mask.sum(-1)
                    rows.update(rows=active.numel(), any=(active > 0).sum(),
                                multi=(active > 1).sum())
                    seen.setdefault("rollout_obs", (data.obs_nbr[-1].clone(),
                                                    data.obs_mask[-1].clone()))
            rows = {}
            self.phase_hook = hook
            m = real["run_epoch"](self)
            torch.cuda.synchronize()
            (e0, l0), (e1, l1), (e2, l2), (e3, l3) = marks
            line = {"phase": "ppo_epoch", "epoch": len(epochs),
                    "epoch_time_s": m["epoch_time_s"], "steps_per_sec": m["steps_per_sec"],
                    "rollout_ms": e0.elapsed_time(e1), "gae_ms": e1.elapsed_time(e2),
                    "update_ms": e2.elapsed_time(e3),
                    "gru_launches_rollout": l1 - l0, "gru_launches_update": l3 - l2,
                    "pi_iters": m["pi_iters"], "kl": m["kl"], "pi_loss": m["pi_loss"],
                    "v_loss": m["v_loss"], "mean_step_reward": m["mean_step_reward"],
                    "episodes": sum(m["episodes"]),
                    "success_episodes": sum(m["success_episodes"]),
                    "collision_episodes": sum(m["collision_episodes"]),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "rollout_rows": rows["rows"],
                    "rollout_rows_with_neighbour": int(rows["any"]),
                    "rollout_rows_multi_slot": int(rows["multi"]), "card": smi}
            emit(line)
            epochs.append(line)
            launches["rollout"] += l1 - l0
            launches["update"] += l3 - l2
            return m

        def evaluate_counted(*a, **k):
            l0 = mg.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = real["evaluate"](*a, **k)
            torch.cuda.synchronize()
            evals.append({**m, "seconds": time.perf_counter() - t0,
                          "gru_launches": mg.launches - l0})
            launches["eval"] += mg.launches - l0
            return m

        with tempfile.TemporaryDirectory() as tmp:
            run_dir = os.path.join(tmp, "w32_m3s")
            argv = recipe_argv(run_dir)
            bc.collect_demos, bc.fit = collect, fit
            rvo_policy.rvo_controller = expert
            trainer_mod.Trainer.run_epoch = run_epoch
            evaluator.evaluate = evaluate_counted
            torch.cuda.reset_peak_memory_stats()
            mg.launches = 0
            t0 = time.perf_counter()
            try:
                rc = cli.main(argv)
            finally:
                bc.collect_demos, bc.fit = real["collect"], real["fit"]
                rvo_policy.rvo_controller = real["expert"]
                trainer_mod.Trainer.run_epoch = real["run_epoch"]
                evaluator.evaluate = real["evaluate"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            total = mg.launches
            with open(os.path.join(run_dir, "results.txt")) as f:
                results = [ln.rstrip("\n") for ln in f]
            with open(os.path.join(run_dir, "best_checkpoint.json")) as f:
                best = json.load(f)
            with open(os.path.join(run_dir, "train.jsonl")) as f:
                train_lines = [json.loads(ln) for ln in f if ln.strip()]
        emit({"phase": "recipe_results", "results": results, "best_checkpoint": best,
              "card": smi})
        launches_by_phase["bc_ppo_recipe"] = total

        # the kernel at the rows this path gave it, against its plain
        # version (not counted): 4096 rows drawn from the final BC set as
        # the fit draws its batch, the first DAgger rollout's own B = 1024
        # (32 lanes x 32 drones, its middle step) and the PPO rollout's
        # B = 2048 (64 x 32, epoch 0's last step)
        enc = seen["ac"].encoder
        g = torch.Generator(device=dev).manual_seed(SEED)
        pick = torch.randperm(seen["bc_rows"], generator=g, device=dev)
        cases = {"bc_fit_4096": [x[pick[:4096]] for x in seen["bc_data"][1:3]],
                 "dagger_1024": list(seen["dagger_obs"]),
                 "ppo_rollout_2048": list(seen["rollout_obs"])}
        at_rows = {}
        with torch.no_grad():
            fwd, bwd = enc.fwd.weights(), enc.bwd.weights()
            gru = torch.nn.GRU(fwd[0].shape[0], enc.hidden_dim, bidirectional=True).to(dev)
            for label, (nbr, mask) in cases.items():
                xs, ms = encoder_view(nbr, mask)
                l0 = mg.launches
                err = (mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd)
                       - mg.masked_bigru_scan_plain(xs, ms, fwd, bwd)).abs().max().item()
                x_dense = xs.contiguous()
                row = {"B": int(xs.shape[1]), "max_abs_err": err,
                       "active_slots_per_row": float(ms.sum() / ms.shape[1]),
                       "kernel_bigru_ms": cuda_ms(
                           lambda: mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd), 20),
                       "plain_bigru_ms": cuda_ms(
                           lambda: mg.masked_bigru_scan_plain(xs, ms, fwd, bwd), 5),
                       "cudnn_bigru_unmasked_ms": cuda_ms(lambda: gru(x_dense), 20),
                       **gru_bound(xs, ms, fwd)}
                mg.launches = l0
                at_rows[label] = row
                if not err <= ATOL:
                    raise AssertionError(f"{label}: max |kernel - plain| {err} > {ATOL}")
        del seen

        problems = []
        if rc != 0:
            problems.append(f"cli exit code {rc}")
        finite = [r["loss"] for r in rounds] + [
            x for ln in epochs for k in ("pi_loss", "v_loss", "kl") for x in ln[k]] + [
            ln["mean_step_reward"] for ln in epochs] + [
            e[k] for e in evals for k in ("success_rate", "mean_ep_len", "mean_speed")]
        if not all(np.isfinite(finite)):
            problems.append("non-finite metrics")
        for part, n in launches.items():
            if n == 0:
                problems.append(f"no kernel launch in {part}")
        if sum(launches.values()) != total:
            problems.append(f"{total} launches in the run, {sum(launches.values())} "
                            "in its sub-phases")
        if len(rounds) != RECIPE_DAGGER + 1 or len(epochs) != RECIPE_EPOCHS + 1:
            problems.append(f"{len(rounds)} BC rounds, {len(epochs)} PPO epochs")
        # the best persisted epoch's det score, worst population (evaluate
        # calls and results.txt lines come in the same order)
        best_evals = [e for e, r in zip(evals, results)
                      if r.startswith(f"epoch {best['epoch']} [")]
        if (best["epoch"] is None or len(best_evals) != len(W32_POPULATIONS)
                or best["min_success_rate"] < RECIPE_MIN_SUCCESS
                or min(e["episodes"] for e in best_evals) < RECIPE_MIN_EPISODES):
            problems.append(f"best persisted checkpoint {best}: the gate is det "
                            f"success >= {RECIPE_MIN_SUCCESS} on every population "
                            f"over >= {RECIPE_MIN_EPISODES} episodes")
        summary = {"argv": argv, "cuts": {"train_epoch": [RECIPE_RUN_EPOCHS, RECIPE_EPOCHS]},
                   "wall_s": wall,
                   "bc_s": sum(r["collect_s"] + r["fit_s"] for r in rounds),
                   "ppo_s": sum(ln["epoch_time_s"] for ln in epochs),
                   "eval_s": sum(e["seconds"] for e in evals),
                   "gru_launches": launches, "max_memory_allocated": peak,
                   "kernel_at_path_rows": at_rows, "atol": ATOL,
                   "expert_alone": {"lanes": 32, "drones": wd32.drone_num,
                                    "candidates": 729, "ms": expert_ms,
                                    "peak_bytes": expert_peak},
                   "best_checkpoint": best, "results": results,
                   "train_jsonl_keys": sorted(train_lines[0]) if train_lines else [],
                   "card": smi}
        if problems:
            raise AssertionError(f"{problems}: {summary}")
        return summary
    run_phase("bc_ppo_recipe", bc_ppo_recipe)

    # ---- the LSTM and bfloat16 policies, data-parallel lanes, the
    # curriculum, reference-policy import, the profiler ----
    import tempfile

    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.utils.torch_import import load_reference_policy

    def lstm_policy():
        """LSTM-256 with (256, 256) heads: the forward at B = 4096 on the card
        against the CPU, one Trainer epoch at w16_r4's width (T and the
        iterations cut), evaluate at 256 lanes. No masked-GRU launch."""
        cfg_l = dataclasses.replace(
            run_cfg, model=dataclasses.replace(run_cfg.model, rnn_mode="LSTM"),
            train=dataclasses.replace(run_cfg.train, steps_per_epoch=CUT_T,
                                      train_pi_iters=CUT_ITERS, train_v_iters=CUT_ITERS))
        mg.launches = 0
        trainer = Trainer(cfg_l, run_world, device=dev)
        ac_l = trainer.ac
        ac_cpu = ActorCritic(cfg_l.model, device="cpu")
        ac_cpu.load_state_dict(ac_l.state_dict())
        obs = flown_observations()
        with torch.no_grad():
            (mu, _, v), (mu_c, _, v_c) = ac_l(*obs), ac_cpu(*[o.cpu() for o in obs])
        err = {"mu": (mu.cpu() - mu_c).abs().max().item(),
               "v": (v.cpu() - v_c).abs().max().item()}
        torch.cuda.reset_peak_memory_stats()
        m = trainer.run_epoch()
        peak = torch.cuda.max_memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            step_ms = cuda_ms(lambda: ac_l.step(*trainer.carry.obs, 1.0, gen), 20)
        t0 = time.perf_counter()
        ev = evaluate(ac_l, world, p, generator=torch.Generator(device=dev).manual_seed(SEED),
                      num_episodes=LANES, num_lanes=LANES, max_ep_len=150, max_chunks=2,
                      action_mode="direct")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches_by_phase["lstm_policy"] = mg.launches
        if not (err["mu"] <= ATOL and err["v"] <= ATOL):
            raise AssertionError(f"LSTM card vs CPU: {err} > {ATOL}")
        if not metrics_finite(m) or not np.isfinite(ev["success_rate"]):
            raise AssertionError(f"non-finite LSTM metrics {m} {ev}")
        if mg.launches:
            raise AssertionError(f"the LSTM path launched the masked GRU {mg.launches} times")
        tr = cfg_l.train
        return {"model": "LSTM-256, heads (256, 256)", "forward_B": int(mu.shape[0]),
                "max_abs_err": err, "atol": ATOL, "lanes": tr.num_envs,
                "drones": cfg_l.env.num_drones, "minibatch": tr.minibatch,
                "cuts": {"steps_per_epoch": [run_cfg.train.steps_per_epoch, CUT_T],
                         "train_pi_iters": [run_cfg.train.train_pi_iters, CUT_ITERS],
                         "train_v_iters": [run_cfg.train.train_v_iters, CUT_ITERS]},
                "epoch_time_s": m["epoch_time_s"], "steps_per_sec": m["steps_per_sec"],
                "pi_loss": m["pi_loss"], "v_loss": m["v_loss"], "kl": m["kl"],
                "step_ms_B2048": step_ms, "max_memory_allocated": peak,
                "evaluate": {"lanes": LANES, "seconds": eval_s, **ev},
                "gru_launches": mg.launches, "card": smi}
    run_phase("lstm_policy", lstm_policy)

    def bf16_serve():
        """The w16_r4 product with compute_dtype bfloat16 beside its float32
        serve: act p50, the forward's distance, det success (not gated)."""
        f32 = PolicyServer.from_checkpoint(PRODUCT_PARAMS, device=dev)
        cfg16 = dataclasses.replace(f32.ac.cfg, compute_dtype="bfloat16")
        ac16 = ActorCritic(cfg16, device=dev)
        ac16.load_state_dict(product["state_dict"])
        s16 = PolicyServer(ac16, nm=f32.nm)
        ac16_cpu = ActorCritic(cfg16, device="cpu")
        ac16_cpu.load_state_dict(product["state_dict"])
        keep = {"f32": {}, "bf16": {}, "det_eval_bf16": {}}
        mg.launches = 0
        obs = flown_observations()
        with torch.no_grad():
            with kernel_inputs_kept(mg, keep["f32"]):
                mu32, _, v32 = f32.ac(*obs)
            with kernel_inputs_kept(mg, keep["bf16"]):
                mu16, _, v16 = ac16(*obs)
        with torch.no_grad():
            mu16_c, _, v16_c = ac16_cpu(*[o.cpu() for o in obs])
        diff = {"mu": (mu16 - mu32).abs().max().item(), "v": (v16 - v32).abs().max().item()}
        # the card's bfloat16 forward against the CPU's (the plain scan on
        # the same bfloat16-rounded operands): the bfloat16 layers round on
        # both devices after float32 sums taken in different orders, so a
        # value may land one bfloat16 step away, and the step carries on,
        # absolute, to the outputs; the gate is 1e-4 plus two bfloat16 steps
        # at the output's largest |value| (an output near 0 can take a whole
        # step of a larger intermediate)
        card_cpu = {}
        for name, got, ref in (("mu", mu16.cpu(), mu16_c), ("v", v16.cpu(), v16_c)):
            d = (got - ref).abs()
            step = bf16_steps(ref.abs().max()).item()
            card_cpu[name] = {"max_abs": d.max().item(), "bf16_step_at_max": step,
                              "share_above_1e-4": (d > ATOL).float().mean().item()}
            if not d.max().item() <= ATOL + 2 * step:
                raise AssertionError(f"bf16 card vs CPU {name}: {card_cpu[name]}")
        rng = np.random.default_rng(SEED)
        lat = {}
        for b in (1, 64, 4096):
            o = (rng.normal(size=(b, 12)).astype(np.float32),
                 rng.normal(size=(b, 10, 9)).astype(np.float32), rng.random((b, 10)) > 0.6)
            for name, srv in (("f32", f32), ("bf16", s16)):
                with kernel_inputs_kept(mg, keep[name]):    # a first call, kept
                    srv.act(*o)
            lat[f"b{b}"] = {name: p50_ms(lambda: srv.act(*o))
                            for name, srv in (("f32", f32), ("bf16", s16),
                                              ("f32_again", f32), ("bf16_again", s16))}
        serve_launches = mg.launches
        t0 = time.perf_counter()
        with kernel_inputs_kept(mg, keep["det_eval_bf16"]):
            ev = evaluate(ac16, run_world, run_cfg.env,
                          generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_episodes=PRODUCT_EPISODES, num_lanes=128, chunk_len=40,
                          max_chunks=8, std_factor=run_cfg.train.std_factor_eval,
                          action_mode=run_cfg.train.action_mode)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches_by_phase["bf16_serve"] = mg.launches
        # the kernel at this path's rows: the first launch at each B of each
        # policy's forward and serve, and of the bfloat16 evaluation
        at_rows = {k: kernel_at_kept_rows(mg, kept, want=(128 * 16,) if k == "det_eval_bf16"
                                          else (1, 64, 4096))
                   for k, kept in keep.items()}
        if not (diff["mu"] <= BF16_GATE["mu"] and diff["v"] <= BF16_GATE["v"]):
            raise AssertionError(f"bf16 vs f32 forward {diff}; the gate is {BF16_GATE}")
        if mg.launches == 0:
            raise AssertionError("bf16_serve never launched the masked GRU kernel")
        return {"forward_B": int(mu32.shape[0]), "max_abs_diff_vs_f32": diff,
                "gate": BF16_GATE, "bf16_card_vs_cpu": card_cpu,
                "bf16_card_vs_cpu_gate": "max |d| <= 1e-4 + 2 bfloat16 steps at max |cpu|",
                "kernel_at_path_rows": at_rows, "atol": ATOL, "act_p50_ms": lat,
                "det_eval": {"seconds": eval_s, **ev},
                "gru_launches": {"forward_and_serve": serve_launches,
                                 "det_eval": mg.launches - serve_launches},
                "card": smi}
    run_phase("bf16_serve", bf16_serve)

    def write_start(tmp):
        """<tmp>/start/ckpt: the product's params with fresh optimizers, the
        start of the data- and tensor-parallel epochs."""
        from rvo3d_tpu_torch.algo.ppo import PPOState, make_optimizers
        from rvo3d_tpu_torch.utils.checkpoint import save_checkpoint

        start = os.path.join(tmp, "start", "ckpt")
        ac_s = ActorCritic(run_cfg.model, device=dev)
        ac_s.load_state_dict(product["state_dict"])
        save_checkpoint(start, 0, PPOState(ac_s, *make_optimizers(run_cfg.train, ac_s)),
                        run_cfg)
        return start, ac_s

    dp_one = {}    # the one-process epoch, which tensor_parallel_epoch reuses

    def data_parallel_epoch():
        """One epoch through `cli train --mesh_data 2` in two gloo ranks on
        this card (64 lanes each) against the same epoch in one process."""
        with tempfile.TemporaryDirectory() as tmp:
            start, ac_p = write_start(tmp)
            logs = start_ranks("--dp-worker", tmp)
            ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"), weights_only=False)
                     for r in range(DP_RANKS)]
            mg.launches = 0
            keep_one = {}
            with kernel_inputs_kept(mg, keep_one):
                one = cli_epoch_recorded(dp_argv(os.path.join(tmp, "one"), start))
            one_launches = mg.launches
            run_dp, run_one = os.path.join(tmp, "dp"), os.path.join(tmp, "one")
            params = [torch.load(os.path.join(r, "ckpt", "0", "state.pt"),
                                 weights_only=False)["params"] for r in (run_dp, run_one)]
            dp_one.update(one=one, params=params[1], launches=one_launches)
            with open(os.path.join(run_dp, "train.jsonl")) as f:
                jsonl = [ln for ln in f if ln.strip()]
            with open(os.path.join(run_dp, "results.txt")) as f:
                results = f.read().splitlines()
            ckpts = sorted(os.listdir(os.path.join(run_dp, "ckpt")))
        problems = []
        rollout = {}
        for r, got in enumerate(ranks):
            worst = {}
            for k, ref in one["batch"].items():
                a = got["batch"][k]
                if ref.is_floating_point():
                    worst[k] = (a.double() - ref.double()).abs().max().item()
                elif not torch.equal(a, ref):
                    problems.append(f"rank {r}: rollout {k} differs")
            rollout[f"rank{r}"] = worst
            for k in ("mean_step_reward", "pi_loss", "v_loss", "kl"):
                if not np.allclose(got["metrics"][k], one["metrics"][k], **DP_METRIC_TOL):
                    problems.append(f"rank {r}: {k} {got['metrics'][k]} vs "
                                    f"{one['metrics'][k]}")
        # where a rank's rollout differs: the policy's forward on one rank's
        # rows alone against the same rows inside the full batch (the first
        # step's observations, the product's weights)
        obs0 = [one["batch"][k][0].to(dev) for k in ("obs_self", "obs_nbr", "obs_mask")]
        half = obs0[0].shape[0] // DP_RANKS
        with torch.no_grad():
            full = ac_p(*obs0)
            part = ac_p(*[o[:half] for o in obs0])
        split = {name: (a[:half] - b).abs().max().item()
                 for name, a, b in (("mu", full[0], part[0]), ("v", full[2], part[2]))}
        param_err = max((params[0][k].double() - v.double()).abs().max().item()
                        for k, v in params[1].items())
        if param_err > DP_PARAM_TOL:
            problems.append(f"final params differ by {param_err} > {DP_PARAM_TOL}")
        if len(jsonl) != 1 or len(results) != 1 or ckpts != ["0", "config.json"]:
            problems.append(f"rank-0 artifacts: {len(jsonl)} train.jsonl lines, "
                            f"{len(results)} results lines, ckpt {ckpts}")
        if sum("run dir:" in log for log in logs) != 1:
            problems.append("'run dir:' printed by other than one rank")
        launches = {"one_process": one_launches,
                    **{f"rank{r}": got["launches"] for r, got in enumerate(ranks)},
                    "epoch_only": {"one_process": one["epoch_launches"],
                                   **{f"rank{r}": g["epoch_launches"]
                                      for r, g in enumerate(ranks)}}}
        launches_by_phase["data_parallel_epoch"] = one_launches + sum(
            g["launches"] for g in ranks)
        # the kernel at the rows each process gave it: a rank's rollout
        # rows (64 lanes x 16 drones), the update's and the evaluation's
        lanes_rows = run_cfg.train.num_envs * run_cfg.env.num_drones
        at_rows = {"one_process": kernel_at_kept_rows(mg, keep_one, want=(lanes_rows,)),
                   **{f"rank{r}": kernel_at_kept_rows(mg, g["kernel_inputs"],
                                                      want=(lanes_rows // DP_RANKS,))
                      for r, g in enumerate(ranks)}}
        summary = {"ranks": DP_RANKS, "backend": ranks[0]["backend"],
                   "lanes": run_cfg.train.num_envs, "lanes_per_rank": ranks[0]["lanes"],
                   "drones": run_cfg.env.num_drones,
                   "cuts": {"steps_per_epoch": [run_cfg.train.steps_per_epoch, CUT_T],
                            "train_pi_iters": [run_cfg.train.train_pi_iters, CUT_ITERS],
                            "train_v_iters": [run_cfg.train.train_v_iters, CUT_ITERS]},
                   "epoch_time_s": {"one_process": one["epoch_time_s"],
                                    **{f"rank{r}": g["epoch_time_s"]
                                       for r, g in enumerate(ranks)}},
                   "rollout_max_abs_diff": rollout,
                   "policy_rows_alone_vs_in_full_batch": split,
                   "final_params_max_abs_diff": param_err,
                   "param_tol": DP_PARAM_TOL, "metric_tol": DP_METRIC_TOL,
                   "metrics": {"one_process": {k: one["metrics"][k] for k in DP_KEYS},
                               **{f"rank{r}": {k: g["metrics"][k] for k in DP_KEYS}
                                  for r, g in enumerate(ranks)}},
                   "gru_launches": launches, "kernel_at_path_rows": at_rows, "atol": ATOL,
                   "results": results, "card": smi}
        if problems:
            raise AssertionError(f"{problems}: {summary}")
        return summary
    run_phase("data_parallel_epoch", data_parallel_epoch)

    def curriculum():
        """cli train --curriculum 1.2:1,0.4:rest over 3 epochs at full width."""
        import re

        num = r"-?[\d.]+(?:e-?\d+)?"
        line_re = re.compile(rf"^(?:epoch (\d+) \(stage thr=({num})\):|stage thr=({num}) "
                             rf"done \(epoch (\d+)\): eval@({num})) success {num}% "
                             rf"EpLen {num}±{num}$")
        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "run")
            argv = ["train", "--device", "cuda", "--world", WORLD, "--num_envs", "16",
                    "--steps_per_epoch", "32", "--train_epoch", "3",
                    "--curriculum", "1.2:1,0.4:rest", "--batched_update",
                    "--action_mode", "direct", "--eval_episodes", "16", "--quiet",
                    "--run_dir", run]
            mg.launches = 0
            keep = {}
            t0 = time.perf_counter()
            with kernel_inputs_kept(mg, keep):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(run, "train.jsonl")) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            with open(os.path.join(run, "results.txt")) as f:
                results = f.read().splitlines()
            ckpts = sorted(d for d in os.listdir(os.path.join(run, "ckpt")) if d.isdigit())
        launches_by_phase["curriculum"] = mg.launches
        # the kernel at the run's rows: the rollout's (16 lanes x 16
        # drones), the update's and the evaluations'
        at_rows = kernel_at_kept_rows(mg, keep, want=(16 * 16,))
        stages = [(ln["epoch"], ln["goal_threshold"]) for ln in lines]
        parsed = [[g for g in line_re.match(r).groups() if g is not None]
                  if line_re.match(r) else None for r in results]
        want = [["0", "1.2"], ["1.2", "1", "0.4"], ["1.2", "1", "1.2"], ["1", "0.4"],
                ["2", "0.4"], ["0.4", "3", "0.4"]]
        out = {"argv": argv, "wall_s": wall, "stages": stages, "results": results,
               "checkpoints": ckpts, "epoch_time_s": [ln["epoch_time_s"] for ln in lines],
               "gru_launches": mg.launches, "kernel_at_path_rows": at_rows, "atol": ATOL,
               "card": smi}
        if (rc != 0 or stages != [(0, 1.2), (1, 0.4), (2, 0.4)] or parsed != want
                or ckpts != ["0", "1", "2"] or mg.launches == 0):
            raise AssertionError(f"curriculum run: {out}")
        return out
    run_phase("curriculum", curriculum)

    def reference_import():
        """A reference-layout biGRU-256 state dict from a seed, imported:
        card against CPU, then `cli eval --torch_checkpoint`."""
        import re

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "policy.pt")
            torch.save({"model_state": reference_state_dict(SEED)}, path)
            sd = load_reference_policy(path)
            ac_r = ActorCritic(ModelConfig(), device=dev)
            ac_r.load_state_dict(sd)
            ac_cpu = ActorCritic(ModelConfig(), device="cpu")
            ac_cpu.load_state_dict(sd)
            obs = flown_observations()
            mg.launches = 0
            keep = {}
            with torch.no_grad(), kernel_inputs_kept(mg, keep):
                (mu, _, v), (mu_c, _, v_c) = ac_r(*obs), ac_cpu(*[o.cpu() for o in obs])
            err = {"mu": (mu.cpu() - mu_c).abs().max().item(),
                   "v": (v.cpu() - v_c).abs().max().item()}
            res = os.path.join(tmp, "results.txt")
            with kernel_inputs_kept(mg, keep):
                rc = cli.main(["eval", "--device", "cuda", "--world", WORLD,
                               "--torch_checkpoint", path, "--rnn_mode", "biGRU",
                               "--episodes", "32", "--lanes", "32", "--results_file", res])
            with open(res) as f:
                lines = f.read().splitlines()
        launches_by_phase["reference_import"] = mg.launches
        # the forward's rows and the evaluation's (32 lanes x 16 drones)
        at_rows = kernel_at_kept_rows(mg, keep, want=(b_main, 32 * 16))
        num = r"-?[\d.]+(?:e-?\d+)?"
        line_re = re.compile(rf"^world={WORLD} success_rate={num}% EpLen={num}±{num} "
                             rf"speed={num}±{num} ret0=(?:{num}|inf|-inf|nan) "
                             rf"\((\d+) episodes(?:, TRUNCATED)?\)$")
        out = {"forward_B": int(mu.shape[0]), "max_abs_err": err, "atol": ATOL,
               "eval_lines": lines, "gru_launches": mg.launches,
               "kernel_at_path_rows": at_rows, "card": smi}
        if not (err["mu"] <= ATOL and err["v"] <= ATOL):
            raise AssertionError(f"imported policy card vs CPU: {out}")
        if rc != 0 or len(lines) != 1 or not line_re.match(lines[0]) or mg.launches == 0:
            raise AssertionError(f"eval --torch_checkpoint: {out}")
        return out
    run_phase("reference_import", reference_import)

    def profile_rollout_step():
        """torch.profiler over 5 rollout steps at w16_r4's width with the
        product's weights, replayed as the trainer's CUDA graph: the 15
        CUDA ops with the most device time and the device's idle share;
        the same 5 steps of the eager loop beside it (idle share only, no
        trace written)."""
        from rvo3d_tpu_torch.algo.rollout import make_rollout, rollout_epoch
        from rvo3d_tpu_torch.utils.profiler import trace

        cfg_p = dataclasses.replace(run_cfg, train=dataclasses.replace(
            run_cfg.train, steps_per_epoch=PROFILE_STEPS))
        trainer = Trainer(cfg_p, run_world, device=dev)
        trainer.ac.load_state_dict(product["state_dict"])
        roll = make_rollout(trainer.ac, run_world, cfg_p.env, cfg_p.train)
        keep = {}
        with kernel_inputs_kept(mg, keep):   # warm-up and capture; the steps' rows
            carry, _ = roll(trainer.carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = roll(carry)
        torch.cuda.synchronize()
        plain_wall_ms = 1e3 * (time.perf_counter() - t0)     # the same steps unprofiled
        mg.launches = 0
        t0 = time.perf_counter()
        with trace(PROFILE_DIR) as prof:
            carry, _ = roll(carry)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = launches_by_phase["profile_rollout_step"] = mg.launches
        at_rows = kernel_at_kept_rows(
            mg, keep, want=(cfg_p.train.num_envs * cfg_p.env.num_drones,))

        ops = cuda_ops(prof)
        busy_ms = sum(device_us(e) for e in ops) / 1e3
        # the eager loop over the same steps, for its idle share
        rollout_epoch(trainer.ac, run_world, cfg_p.env, cfg_p.train, carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout_epoch(trainer.ac, run_world, cfg_p.env, cfg_p.train, carry)
        torch.cuda.synchronize()
        eager_wall_ms = 1e3 * (time.perf_counter() - t0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as ep:
            rollout_epoch(trainer.ac, run_world, cfg_p.env, cfg_p.train, carry)
            torch.cuda.synchronize()
        eager_ops = cuda_ops(ep)
        eager_busy_ms = sum(device_us(e) for e in eager_ops) / 1e3
        top = [{"name": e.key, "device_ms": device_us(e) / 1e3,
                "launches_per_step": e.count / PROFILE_STEPS} for e in ops[:15]]
        gru = [e.key for e in ops if "masked_gru" in e.key]
        out = {"steps": PROFILE_STEPS, "lanes": cfg_p.train.num_envs,
               "drones": cfg_p.env.num_drones, "path": "CUDA graph replays",
               "wall_ms_profiled": wall_ms,
               "wall_ms_unprofiled": plain_wall_ms, "device_busy_ms": busy_ms,
               "device_idle_share": 1.0 - busy_ms / plain_wall_ms,
               "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
               "cuda_ops": len(ops),
               "launches_per_step": sum(e.count for e in ops) / PROFILE_STEPS,
               "eager": {"wall_ms_unprofiled": eager_wall_ms,
                         "device_busy_ms": eager_busy_ms,
                         "device_idle_share": 1.0 - eager_busy_ms / eager_wall_ms,
                         "launches_per_step": sum(e.count for e in eager_ops)
                         / PROFILE_STEPS},
               "top15_by_device_time": top, "masked_gru_in_trace": gru,
               "gru_launches": launches, "kernel_at_path_rows": at_rows, "atol": ATOL,
               "trace": os.path.relpath(os.path.join(PROFILE_DIR, "trace.json"), REPO),
               "card": smi}
        if not gru or launches != PROFILE_STEPS:
            raise AssertionError(f"the masked GRU kernel is not in the trace: {out}")
        return out
    profiled = run_phase("profile_rollout_step", profile_rollout_step)

    # ---- the four step loops as CUDA graphs (utils/graphs.py) against their
    # eager bodies on the card, at the main path's sizes: every leaf equal
    # bit for bit; times in turns (graphed, eager, eager, graphed) ----
    def graphs_phase():
        from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry, make_eval_chunk
        from rvo3d_tpu_torch.algo.rollout import make_rollout, rollout_epoch
        from rvo3d_tpu_torch.bench import core as bcore
        from rvo3d_tpu_torch.bench.flagship import flagship_world
        from rvo3d_tpu_torch.env.env import reset

        mg.launches = 0
        problems, out = [], {"card": smi}

        def held(name, graphed, eager):
            err, differ = tree_diff(graphed, eager)
            if err != 0.0 or differ:
                problems.append(f"{name}: max |graph - eager| {err}, differing {differ}")
            return {"max_abs_diff": err, "differing_leaves": differ}

        def in_turns(fns, timer):
            got = {k: [] for k in fns}
            for k in list(fns) + list(fns)[::-1]:
                got[k].append(timer(fns[k]))
            return got

        # a replayed launch held to plain: each graphed loop that flies the
        # policy, 3 steps (warm-up, capture and replay, replay) at the path's
        # row counts, in loops of its own (the copies of the kernel's inputs
        # and output are nodes of their graphs, not of the timed ones)
        srv = PolicyServer.from_checkpoint(PRODUCT_PARAMS, device=dev)
        ekw = dict(max_ep_len=150, std_factor=run_cfg.train.std_factor_eval,
                   action_mode=run_cfg.train.action_mode)
        cfg_r = dataclasses.replace(run_cfg, train=dataclasses.replace(
            run_cfg.train, steps_per_epoch=CUT_T))
        trainer = Trainer(cfg_r, run_world, device=dev)
        trainer.ac.load_state_dict(product["state_dict"])
        rng = np.random.default_rng(SEED)

        def gen():
            return torch.Generator(device=dev).manual_seed(SEED)

        def served(b):
            one = PolicyServer(srv.ac)
            obs = (rng.normal(size=(b, 12)).astype(np.float32),
                   rng.normal(size=(b, 10, 9)).astype(np.float32), rng.random((b, 10)) > 0.5)
            return lambda: [one.act(*obs) for _ in range(3)]
        three = dataclasses.replace(cfg_r.train, steps_per_epoch=3)
        replay_runs = {
            f"eval_lanes{e}": (lambda e=e: make_eval_chunk(
                srv.ac, run_world, run_cfg.env, chunk=3, **ekw)(
                    init_eval_carry(run_world, run_cfg.env, e), gen()))
            for e in (128, 256)}
        replay_runs["rollout_lanes128"] = lambda: make_rollout(
            trainer.ac, run_world, cfg_r.env, three)(trainer.snapshot()[3])
        replay_runs.update({f"act_b{b}": served(b) for b in (1, 64, 4096)})
        replayed = {}
        for name, run in replay_runs.items():
            rep = {}
            with kernel_inputs_kept(mg, {}, rep):
                run()
            torch.cuda.synchronize()
            replayed[name] = kernel_at_replayed(mg, rep)
        out["kernel_at_replayed_launch"] = replayed

        # the bench chunk: bench.py's size, float64 and float32
        wd8 = flagship_world()
        p8 = EnvParams(num_drones=wd8["drone_num"])
        lanes, steps = int(BENCH_SIZE["RVO3D_BENCH_ENVS"]), int(BENCH_SIZE["RVO3D_BENCH_STEPS"])
        bench = {}
        for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
            w = bcore.world_spec(wd8, dev, dt)
            s0 = reset(w, p8, lead=(lanes,))
            chunk = bcore.make_chunk(w, p8)
            bench[name] = held(f"bench chunk {name}", chunk(s0, steps),
                               bcore.run_chunk(w, s0, p8, steps))
        secs = in_turns({"graphed": lambda: chunk(s0, steps),
                         "eager": lambda: bcore.run_chunk(w, s0, p8, steps)},
                        lambda fn: bcore.best_seconds(fn, dev, 2))
        bench["env_steps_per_s"] = {k: [lanes * steps / x for x in v] for k, v in secs.items()}
        sweep = {}
        for e in (2048, 4096, 8192, 16384):
            se = reset(w, p8, lead=(e,))
            chunk = bcore.make_chunk(w, p8)
            t = in_turns({"graphed": lambda: chunk(se, 60),
                          "eager": lambda: bcore.run_chunk(w, se, p8, 60)},
                         lambda fn: bcore.best_seconds(fn, dev, 2))
            sweep[str(e)] = {k: [1e3 * x / 60 for x in v] for k, v in t.items()}
        bench["sweep_step_ms"] = sweep
        out["bench_chunk"] = bench

        # the eval chunk: the w16_r4 product at 128 lanes, chunk 40
        ev = {}
        for e in (128, 256):
            c0 = init_eval_carry(run_world, run_cfg.env, e)
            chunk_fn = make_eval_chunk(srv.ac, run_world, run_cfg.env, chunk=40, **ekw)
            g = chunk_fn(c0, gen())
            if e == 128:
                eg = eval_chunk(srv.ac, run_world, run_cfg.env, c0, gen(), 40, **ekw)
                ev["lanes128"] = held("eval chunk", g, eg)
                rec = g[1]
                ev["lanes128"]["records"] = {
                    "ended": int(rec.ended.sum()), "success": int(rec.success[rec.ended].sum()),
                    "ep_len_sum": int(rec.ep_len[rec.ended].sum())}
            t = in_turns({"graphed": lambda: chunk_fn(c0, gen()),
                          "eager": lambda: eval_chunk(srv.ac, run_world, run_cfg.env, c0,
                                                      gen(), 40, **ekw)},
                         lambda fn: bcore.best_seconds(fn, dev, 1))
            ev[f"env_steps_per_s_lanes{e}"] = {k: [e * 40 / x for x in v]
                                               for k, v in t.items()}
        out["eval_chunk"] = ev

        # the rollout: three epochs at w16_r4's width, T cut to CUT_T
        roll = make_rollout(trainer.ac, run_world, cfg_r.env, cfg_r.train)
        carries = [trainer.snapshot()[3], trainer.snapshot()[3]]
        ro, times = {}, {"graphed": [], "eager": []}
        for epoch in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gc, gb = roll(carries[0])
            gb = tuple(x.clone() for x in gb)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ec, eb = rollout_epoch(trainer.ac, run_world, cfg_r.env, cfg_r.train, carries[1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ro[f"epoch{epoch}"] = held(f"rollout epoch {epoch}",
                                       (gc._replace(generator=None), gb),
                                       (ec._replace(generator=None), tuple(eb)))
            if epoch:                       # epoch 0 warms up and captures
                times["graphed"].append(1e3 * (t1 - t0) / CUT_T)
                times["eager"].append(1e3 * (t2 - t1) / CUT_T)
            carries = [gc, ec]
        ro.update(lanes=cfg_r.train.num_envs, drones=cfg_r.env.num_drones, steps=CUT_T,
                  step_ms=times,
                  device_idle_share_graphed=profiled["device_idle_share"],
                  device_idle_share_eager=profiled["eager"]["device_idle_share"],
                  idle_share_source="profile_rollout_step (utils/profiler.trace, "
                                    f"{PROFILE_STEPS} steps)")
        out["rollout"] = ro

        # the served act: B = 1, 64, 4096, deterministic and stochastic
        act = {}
        for det in (True, False):
            srv.deterministic = det
            for b in (1, 64, 4096):
                obs = (rng.normal(size=(b, 12)).astype(np.float32),
                       rng.normal(size=(b, 10, 9)).astype(np.float32),
                       rng.random((b, 10)) > 0.5)

                def eager(seed=b):
                    x = [torch.as_tensor(o, device=dev) for o in obs]
                    eps = None if det else torch.randn(
                        b, 3, generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
                    return srv.policy(*x, eps).cpu().numpy()

                def graphed(seed=b):
                    return srv.act(*obs, generator=None if det else torch.Generator(
                        device=dev).manual_seed(seed))
                tag = f"{'det' if det else 'stochastic'}_b{b}"
                a_g, a_e = graphed(), eager()
                d = float(np.abs(a_g - a_e).max())
                if not np.array_equal(a_g, a_e):
                    problems.append(f"act {tag}: max |graph - eager| {d}")
                act[tag] = {"max_abs_diff": d, **{
                    f"{k}_p50_ms": v for k, v in in_turns(
                        {"graphed": graphed, "eager": eager},
                        lambda fn: p50_ms(fn, iters=30)).items()}}
        srv.deterministic = True
        out["act"] = act
        out["gru_launches"] = launches_by_phase["graphs"] = mg.launches
        if problems:
            raise AssertionError(f"{problems}: {out}")
        return out

    def graphs_held():
        """graphs_phase with the eager warm-up launches kept and the kernel
        held to plain at the path's rows: 2048 and 4096 (the eval chunk at
        128 and 256 lanes, the rollout at 128, 16 drones a lane), 1, 64 and
        4096 (the served batches)."""
        keep = {}
        with kernel_inputs_kept(mg, keep):
            out = graphs_phase()
        out["kernel_at_path_rows"] = kernel_at_kept_rows(mg, keep, want=(1, 64, 2048, 4096))
        out["atol"] = ATOL
        return out
    run_phase("graphs", graphs_held)

    # ---- the learner's device programs (algo/ppo.PPOUpdate, algo/bc.fit)
    # as CUDA graphs against their bodies called eagerly, at the main path's
    # sizes: every leaf equal bit for bit; times, splits and idle shares ----
    def learner_graphs():
        """The w16_r4 product's update on one rollout batch at full width
        (128 x 16, T = 300, 20 pi / 50 v iterations, minibatch 16384), GAE
        included, graphed against eager from the same start (params, both
        Adams' states, the batch with its adv and ret, the metrics); the
        same with target_kl set to 0.9 of the kl an eager update reaches
        after 10 iterations, so that the stop fires midway; 200 BC fit
        steps at B = 4096 on a world32_mix demo set (the RVO expert, 32
        lanes x 32 drones x 25 steps) from a biGRU-256 made from the seed,
        graphed against eager. Then ms per pi and v iteration and per BC
        step, graphed and eager, the eager iteration and step split into
        the kernel forward, the rest of the forward, the backward, the clip
        and Adam, and the device's idle share over 5 iterations or steps of
        each (utils/profiler.trace; the traces are not kept)."""
        import tempfile

        from rvo3d_tpu_torch.algo import bc as bc_mod
        from rvo3d_tpu_torch.algo.rollout import RolloutBatch, make_rollout
        from rvo3d_tpu_torch.utils import graphs as graphs_mod
        from rvo3d_tpu_torch.utils.profiler import trace

        problems, out = [], {"card": smi}
        tr = run_cfg.train
        mg.launches = 0
        trainer = Trainer(run_cfg, run_world, device=dev)
        trainer.ac.load_state_dict(product["state_dict"])
        _, rb = make_rollout(trainer.ac, run_world, run_cfg.env, tr)(trainer.carry)
        batch = RolloutBatch(*[x.clone() for x in rb])
        del trainer, rb
        launches = {"rollout": mg.launches}

        @contextlib.contextmanager
        def graphed_as(graphed):
            real = graphs_mod.on_card
            graphs_mod.on_card = lambda device: graphed
            try:
                yield
            finally:
                graphs_mod.on_card = real

        def update_run(cfg, graphed):
            """One update from the product's params with fresh Adams on
            `batch`, GAE included: (learner, metrics, seconds, launches)."""
            with graphed_as(graphed):
                ac = ActorCritic(run_cfg.model, device=dev)
                ac.load_state_dict(product["state_dict"])
                learner = ppo.PPOUpdate(ac, cfg, *ppo.make_optimizers(cfg, ac))
                torch.cuda.synchronize()
                l0, t0 = mg.launches, time.perf_counter()
                learner.prepare(batch)
                m = learner.update(torch.Generator().manual_seed(cfg.seed))
                torch.cuda.synchronize()
                return learner, m, time.perf_counter() - t0, mg.launches - l0

        def learner_tree(lr, m):
            adam = tuple(tuple(opt.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq"))
                         for opt in (lr.pi_opt, lr.vf_opt)
                         for grp in opt.param_groups for p in grp["params"]
                         if p in opt.state)
            return (tuple(lr.ac.state_dict().values()), adam, lr.data, m)

        def held(name, a, b):
            err, differ = tree_diff(a, b)
            if err != 0.0 or differ:
                problems.append(f"{name}: max |graph - eager| {err}, differing {differ[:5]}")
            return {"max_abs_diff": err, "differing_leaves": len(differ)}

        def summary(m):
            return {k: getattr(m, k).tolist() for k in ("pi_iters", "kl", "pi_loss", "v_loss")}

        # the update, as w16_r4 runs it, then with the stop midway
        probe = dataclasses.replace(tr, train_pi_iters=tr.train_pi_iters // 2,
                                    target_kl=1e9, train_v_iters=0)
        _, probed, _, launches["update_kl_probe"] = update_run(probe, False)
        kl_half = float(probed.kl[0])
        mid = dataclasses.replace(tr, target_kl=0.9 * kl_half)
        updates, learners = {}, {}
        for name, cfg in (("w16_r4", tr), ("stop_midway", mid)):
            g = update_run(cfg, True)
            e = update_run(cfg, False)
            updates[name] = {**held(f"update {name}", learner_tree(g[0], g[1]),
                                    learner_tree(e[0], e[1])),
                             "target_kl": cfg.target_kl, **summary(g[1]),
                             "seconds_graphed_with_capture": g[2], "seconds_eager": e[2],
                             "launches_graphed": g[3], "launches_eager": e[3]}
            launches[f"update_{name}"] = g[3] + e[3]
            iters = g[1].pi_iters.tolist()
            if name == "stop_midway" and not all(0 < i < cfg.train_pi_iters for i in iters):
                problems.append(f"the stop did not fire midway: pi_iters {iters}")
            learners[name] = (g[0], e[0])
        del learners["stop_midway"]
        g_l, e_l = learners["w16_r4"]
        l0 = mg.launches
        for _ in range(2):     # GAE's step is captured in the second call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g_l.prepare(batch)
            g_l.update(torch.Generator().manual_seed(tr.seed))
            torch.cuda.synchronize()
        updates["w16_r4"]["seconds_graphed_replays"] = time.perf_counter() - t0
        updates["w16_r4"]["batch_rows"] = int(batch.act[..., 0].numel())
        launches["update_w16_r4_replayed"] = mg.launches - l0
        out["update"] = updates

        # per iteration: graphed replays and eager bodies (counters reset:
        # the windows are read at the iteration index); the timing's
        # launches are not the path's
        l0 = mg.launches

        def reset(lr):
            for t in (lr.i_pi, lr.i_v, lr.stopped):
                t.zero_()

        def timed(lr, fn, iters):
            reset(lr)
            return cuda_ms(fn, iters, warmup=1)

        with tempfile.TemporaryDirectory() as tmp:
            def idle(lr, fn, name, n=5):
                """Device busy time and idle share of n calls of fn."""
                reset(lr)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
                reset(lr)
                with trace(os.path.join(tmp, name)) as prof:
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                ops = cuda_ops(prof)
                busy = sum(device_us(e) for e in ops) / 1e3
                return {"calls": n, "wall_ms": wall, "device_busy_ms": busy,
                        "device_idle_share": 1.0 - busy / wall,
                        "masked_gru_device_ms": sum(device_us(e) for e in ops
                                                    if "masked_gru" in e.key) / 1e3,
                        "kernels_per_call": sum(e.count for e in ops) / n}

            it = {"pi_graphed_ms": timed(g_l, g_l._pi_step, 10),
                  "v_graphed_ms": timed(g_l, g_l._v_step, 10),
                  "pi_eager_ms": timed(e_l, e_l._pi_body, 5),
                  "v_eager_ms": timed(e_l, e_l._v_body, 5)}
            reset(e_l)
            win = e_l._window(e_l.pi_off, e_l.i_pi)
            ac = e_l.ac
            pi_params = [p for grp in e_l.pi_opt.param_groups for p in grp["params"]]

            def pi_fwd():
                return ppo.pi_loss_fn(ac, win, tr.clip_ratio, tr.adv_norm, tr.ent_coef)[0]

            def pi_fwd_bwd():
                ac.zero_grad(set_to_none=True)
                pi_fwd().backward()
            xs, ms = encoder_view(win.obs_nbr, win.obs_mask)
            with torch.no_grad():
                fw, bw = ac.encoder.fwd.weights(), ac.encoder.bwd.weights()
                kernel = cuda_ms(lambda: mg.masked_bigru_scan_cuda(xs, ms, fw, bw), 10)
                fwd = cuda_ms(pi_fwd, 5)
            fwd_bwd = cuda_ms(pi_fwd_bwd, 5)
            clip = cuda_ms(lambda: ppo.clip_by_global_norm_(pi_params, tr.grad_clip_norm), 5)
            adam = cuda_ms(lambda: e_l.pi_opt.step(keep=e_l.stopped.logical_not()), 5)
            ac.zero_grad(set_to_none=True)
            it["pi_eager_split_ms"] = {
                "kernel_forward": kernel, "forward_rest": fwd - kernel,
                "backward": fwd_bwd - fwd, "clip": clip, "adam": adam,
                "iteration": it["pi_eager_ms"], "window_rows": int(xs.shape[1])}
            it["pi_graphed_profile"] = idle(g_l, g_l._pi_step, "pi_graphed")
            it["pi_eager_profile"] = idle(e_l, e_l._pi_body, "pi_eager")
            out["update_iteration"] = it
            del learners, g_l, e_l, win, xs, ms
            mg.launches = l0

            # the BC fit: 200 steps at B = 4096, graphed and eager
            p32 = dataclasses.replace(w32_cfg.env, noise=False)
            data = bc_mod.collect_demos(pop_spec(W32_POPULATIONS[0], dev), p32, 32, 25,
                                        torch.Generator(device=dev).manual_seed(SEED),
                                        expert="rvo", action_mode=w32_cfg.train.action_mode,
                                        explore_std=0.1, expert_margin=0.3,
                                        expert_slowdown=True)
            n = data[0].shape[0]
            launches["bc_demos"] = mg.launches - l0
            steps, rows, lr_bc = 200, 4096, 1e-3

            def bc_run(graphed, profile_dir=None):
                """200 fit steps from the seed's policy: (policy, loss, ms a
                step past step 20, launches, profile of the last 5 steps)."""
                with graphed_as(graphed), contextlib.ExitStack() as stack:
                    ac = ActorCritic(w32_cfg.model,
                                     generator=torch.Generator().manual_seed(SEED), device=dev)
                    gen = torch.Generator(device=dev).manual_seed(SEED)
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    prof = {}

                    def indices(s):     # fit's own draw, with marks
                        if s == 20:
                            ev[0].record()
                        if profile_dir and s == steps - 5:
                            torch.cuda.synchronize()
                            prof["t0"] = time.perf_counter()
                            prof["p"] = stack.enter_context(trace(profile_dir))
                        return torch.randint(0, n, (rows,), generator=gen, device=dev)
                    torch.cuda.synchronize()
                    l0 = mg.launches
                    loss = bc_mod.fit_steps(ac, data, n, steps, rows, lr_bc, None, 1.0,
                                            indices)
                    ev[1].record()
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - prof.get("t0", 0.0))
                return ac, loss, ev[0].elapsed_time(ev[1]) / (steps - 20), \
                    mg.launches - l0, prof.get("p"), wall

            bc_out, bc_acs = {}, {}
            for graphed in (True, False):
                tag = "graphed" if graphed else "eager"
                ac, loss, ms_step, nl, prof, wall = bc_run(graphed, os.path.join(tmp, tag))
                ops = cuda_ops(prof)
                busy = sum(device_us(e) for e in ops) / 1e3
                bc_acs[tag] = (ac, loss)
                bc_out[tag] = {"loss": float(loss), "ms_per_step": ms_step, "launches": nl,
                               "profile_last_5_steps": {
                                   "wall_ms_profiled": wall, "device_busy_ms": busy,
                                   "device_idle_share": 1.0 - busy / (5 * ms_step),
                                   "device_idle_share_profiled": 1.0 - busy / wall,
                                   "kernels_per_step": sum(e.count for e in ops) / 5}}
                launches[f"bc_fit_{tag}"] = nl
            bc_out.update(held("bc fit", (tuple(bc_acs["graphed"][0].state_dict().values()),
                                          bc_acs["graphed"][1]),
                               (tuple(bc_acs["eager"][0].state_dict().values()),
                                bc_acs["eager"][1])))
        # the eager BC step split at B = 4096
        l0 = mg.launches
        ac = bc_acs["eager"][0]
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        idx = torch.randint(0, n, (rows,), generator=gen, device=dev)
        opt = bc_mod.Adam([q for q in ac.parameters() if q.requires_grad], lr=lr_bc)

        def bc_fwd_bwd():
            opt.zero_grad(set_to_none=True)
            bc_mod.bc_loss(ac, data, idx).backward()
        xs, ms = encoder_view(data[1][idx], data[2][idx])
        with torch.no_grad():
            fw, bw = ac.encoder.fwd.weights(), ac.encoder.bwd.weights()
            kernel = cuda_ms(lambda: mg.masked_bigru_scan_cuda(xs, ms, fw, bw), 10)
            fwd = cuda_ms(lambda: bc_mod.bc_loss(ac, data, idx), 5)
        fwd_bwd = cuda_ms(bc_fwd_bwd, 5)
        adam = cuda_ms(opt.step, 5)
        bc_out["eager_split_ms"] = {"kernel_forward": kernel, "forward_rest": fwd - kernel,
                                    "backward": fwd_bwd - fwd, "adam": adam,
                                    "rows": rows, "set_rows": n}
        mg.launches = l0                       # the timing's launches are not the path's
        out["bc_fit"] = bc_out
        out["gru_launches"] = launches
        launches_by_phase["learner_graphs"] = mg.launches
        if problems:
            raise AssertionError(f"{problems}: {out}")
        return out
    run_phase("learner_graphs", learner_graphs)

    def worldgen_parity():
        """`cli worldgen` of a 16-drone world at world16_dense's map size,
        then `cli parity --x64 --device cuda` (the env on this card against
        the NumPy oracle, 200 steps): train mode on it, gen_demo,
        world16_dense and world32_mix; eval and noise modes on
        world16_dense. Any [FAIL] fails the phase."""
        import io
        import re

        line_re = re.compile(r"^\[(OK |FAIL)\] (\S+) \[(\S+)\]: (\d+) steps, (\d+) "
                             r"episode boundaries, max \|pos err\|=(\S+), max "
                             r"\|reward err\|=(\S+), flags (\w+)(.*) \((x64|f32)\)$")
        out, problems = {}, []
        mg.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["worldgen", "--name", "gen16", "--drones", "16",
                               "--map_size", "24", "24", "8", "--seed", "0", "--out", tmp])
            out["worldgen"] = buf.getvalue().strip()
            if rc != 0 or "16 drones" not in out["worldgen"]:
                problems.append(f"worldgen: rc {rc}, {out['worldgen']!r}")
            gen = os.path.join(tmp, "gen16")
            for mode, worlds, flags in (
                    ("train", [gen, "gen_demo", WORLD, "world32_mix"], []),
                    ("eval", [WORLD], ["--eval_mode"]),
                    ("noise", [WORLD], ["--noise"])):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["parity", "--x64", "--device", "cuda", "--steps",
                                   str(PARITY_STEPS), "--worlds", *worlds, *flags])
                lines = buf.getvalue().splitlines()
                rows = {}
                for ln in lines:
                    m = line_re.match(ln)
                    if m is None:
                        problems.append(f"{mode}: unparsed line {ln!r}")
                        continue
                    rows[os.path.basename(m.group(2))] = {
                        "ok": m.group(1) == "OK ", "max_pos_err": float(m.group(6)),
                        "max_reward_err": float(m.group(7)), "flags": m.group(8),
                        "episode_boundaries": int(m.group(5)), "note": m.group(9).strip()}
                out[mode] = {"seconds": time.perf_counter() - t0, "worlds": rows,
                             "lines": lines}
                if rc != 0 or len(rows) != len(worlds) or not all(
                        r["ok"] for r in rows.values()):
                    problems.append(f"parity {mode}: rc {rc}, {lines}")
        launches_by_phase["worldgen_parity"] = mg.launches   # no policy: 0
        out["tolerance"] = 1e-12
        out["gru_launches"] = mg.launches
        out["card"] = smi
        if problems:
            raise AssertionError(f"{problems}: {out}")
        return out
    run_phase("worldgen_parity", worldgen_parity)

    def render_record():
        """record_trajectory of the w16_r4 product on world16_dense through
        the CLI's policy controller (its training mapping, std factor 1e-3,
        draws from a CPU generator), on the card against the CPU."""
        from rvo3d_tpu_torch.render import ScenePlotter, record_trajectory

        env_p = dataclasses.replace(run_cfg.env, noise=False)
        records, actions = {}, {}
        keep = {}
        mg.launches = 0
        for d in (dev, torch.device("cpu")):
            ac_d = ActorCritic(run_cfg.model, device=d)
            ac_d.load_state_dict(product["state_dict"])
            env = DroneEnv(load_world(run_cfg.world).spec(device=d), env_p)
            ctrl = cli._policy_controller(ac_d, env_p, action_mode=run_cfg.train.action_mode,
                                          seed=SEED)
            acts = []

            def recorded(state, world, ctrl=ctrl, acts=acts):
                a = ctrl(state, world)
                acts.append(a.cpu())
                return a
            t0 = time.perf_counter()
            with kernel_inputs_kept(mg, keep) if d.type == "cuda" else contextlib.nullcontext():
                records[d.type] = record_trajectory(env, recorded, steps=RENDER_STEPS)
            records[d.type + "_seconds"] = time.perf_counter() - t0
            actions[d.type] = torch.stack(acts)
        launches_by_phase["render_record"] = mg.launches
        card, host = records["cuda"], records["cpu"]
        parted, worst = None, 0.0
        for t in range(RENDER_STEPS):
            pos_err = float(np.abs(card["pos"][t] - host["pos"][t]).max())
            flags = all(np.array_equal(card[k][t], host[k][t])
                        for k in ("done", "finish", "obs_mask"))
            if not flags or pos_err > RENDER_POS_TOL:
                parted = t
                break
            worst = max(worst, pos_err,
                        float(np.abs(card["reward"][t] - host["reward"][t]).max()))
        # where the two part, the first differing action must be a 2-decimal
        # rounding tie of the policy's sample (exactly 0.01 apart, ROADMAP C3)
        diff = (actions["cuda"] - actions["cpu"]).abs()
        first_act = next((t for t in range(RENDER_STEPS) if diff[t].max() > 0), None)
        tie = first_act is not None and bool(
            ((diff[first_act] == 0) | ((diff[first_act] - 0.01).abs() < 1e-5)).all())
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            frames = "not drawn: matplotlib is not installed on this machine"
        else:
            with tempfile.TemporaryDirectory() as tmp:
                wd_r = load_world(run_cfg.world)
                plotter = ScenePlotter(wd_r.map_size, wd_r.building_list, wd_r.waypoints_list)
                try:
                    frames = len(plotter.render_trajectory(card, tmp, every=50))
                finally:
                    plotter.close()
        at_rows = kernel_at_kept_rows(mg, keep, want=(run_cfg.env.num_drones,))
        out = {"world": run_cfg.world, "steps": RENDER_STEPS,
               "action_mode": run_cfg.train.action_mode,
               "record_seconds": {k: v for k, v in records.items()
                                  if k.endswith("_seconds")},
               "parted_at_step": parted, "first_action_difference_step": first_act,
               "first_action_difference_is_rounding_tie": tie,
               "max_abs_diff_before_parting": worst, "pos_tol": RENDER_POS_TOL,
               "collisions": int(card["done"].sum()), "finished": int(card["finish"][-1].sum()),
               "frames": frames, "gru_launches": mg.launches,
               "kernel_at_path_rows": at_rows, "atol": ATOL, "card": smi}
        if mg.launches == 0:
            raise AssertionError(f"the card record launched no masked GRU: {out}")
        if parted is not None and not (tie and first_act <= parted):
            raise AssertionError(f"card and CPU records part at step {parted}: {out}")
        return out
    run_phase("render_record", render_record)

    def tensor_parallel_epoch():
        """dp_argv's epoch through `cli train --mesh_model 2` in two gloo
        ranks on this card (each steps all 128 lanes and holds half of the
        sharded weights) against the one-process epoch of
        data_parallel_epoch: the metrics at DP_METRIC_TOL; the rollout equal
        up to its first differing action, which must be a 2-decimal
        rounding tie (the row-parallel sum of two partial products rounds
        differently from one product); the final params within
        DP_PARAM_TOL of the one-process update run here on the ranks' own
        rollout batch (entry.tie_rule, which dryrun_multichip shares)."""
        from rvo3d_tpu_torch import entry as entry_mod
        from rvo3d_tpu_torch.utils.checkpoint import load_config

        one = dp_one["one"]
        with tempfile.TemporaryDirectory() as tmp:
            write_start(tmp)
            logs = start_ranks("--tp-worker", tmp)
            ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False)
                     for r in range(DP_RANKS)]
            run_tp = os.path.join(tmp, "tp")
            params = torch.load(os.path.join(run_tp, "ckpt", "0", "state.pt"),
                                weights_only=False)["params"]
            cfg_tp = load_config(run_tp)
            with open(os.path.join(run_tp, "train.jsonl")) as f:
                jsonl = [ln for ln in f if ln.strip()]
            with open(os.path.join(run_tp, "results.txt")) as f:
                results = f.read().splitlines()
            ckpts = sorted(os.listdir(os.path.join(run_tp, "ckpt")))
        problems, rollout, first_diff = [], {}, {}
        for r, got in enumerate(ranks):
            b, ref = got["batch"], one["batch"]
            if any(not torch.equal(b[k], ranks[0]["batch"][k]) for k in b):
                problems.append(f"rank {r}: its rollout differs from rank 0's")
            first_diff[f"rank{r}"] = entry_mod.rollout_parting(b, ref)[0]
            rollout[f"rank{r}"] = {k: (b[k].double() - ref[k].double()).abs().max().item()
                                   for k in ref if ref[k].is_floating_point()}
            for k in DP_KEYS:
                if not np.allclose(got["metrics"][k], one["metrics"][k], **DP_METRIC_TOL):
                    problems.append(f"rank {r}: {k} {got['metrics'][k]} vs "
                                    f"{one['metrics'][k]}")
        # the rounding-tie rule on the ranks' (equal) batch: from the same
        # start as the ranks (the product's params), the one-process update
        try:
            held = entry_mod.tie_rule(ranks[0]["batch"], params, one["batch"],
                                      product["state_dict"], cfg_tp, dev)
        except AssertionError as e:
            problems.append(str(e))
            held = {"one_update": {"pi_iters": None},
                    "params_max_abs_diff_same_batch": None}
        one_update, param_err = held["one_update"], held["params_max_abs_diff_same_batch"]
        epoch_param_err = max((params[k].double() - v.double()).abs().max().item()
                              for k, v in dp_one["params"].items())
        if one_update["pi_iters"] != ranks[0]["metrics"]["pi_iters"]:
            problems.append(f"pi iterations {ranks[0]['metrics']['pi_iters']} against "
                            f"{one_update['pi_iters']} in one process")
        if len(jsonl) != 1 or len(results) != 1 or ckpts != ["0", "config.json"]:
            problems.append(f"rank-0 artifacts: {len(jsonl)} train.jsonl lines, "
                            f"{len(results)} results lines, ckpt {ckpts}")
        if sum("mesh: {'data': 1, 'model': 2}" in log for log in logs) != 1:
            problems.append("'mesh: ...' printed by other than one rank")
        launches_by_phase["tensor_parallel_epoch"] = sum(g["launches"] for g in ranks)
        lanes_rows = run_cfg.train.num_envs * run_cfg.env.num_drones
        at_rows = {f"rank{r}": kernel_at_kept_rows(mg, g["kernel_inputs"], want=(lanes_rows,))
                   for r, g in enumerate(ranks)}
        summary = {"ranks": DP_RANKS, "mesh": {"data": 1, "model": DP_RANKS},
                   "backend": ranks[0]["backend"], "lanes": run_cfg.train.num_envs,
                   "lanes_per_rank": ranks[0]["lanes"], "drones": run_cfg.env.num_drones,
                   "cuts": {"steps_per_epoch": [run_cfg.train.steps_per_epoch, CUT_T],
                            "train_pi_iters": [run_cfg.train.train_pi_iters, CUT_ITERS],
                            "train_v_iters": [run_cfg.train.train_v_iters, CUT_ITERS]},
                   "epoch_time_s": {"one_process": one["epoch_time_s"],
                                    **{f"rank{r}": g["epoch_time_s"]
                                       for r, g in enumerate(ranks)}},
                   "rollout_first_action_difference_step": first_diff,
                   "rollout_max_abs_diff": rollout,
                   "final_params_max_abs_diff_same_batch": param_err,
                   "final_params_max_abs_diff_one_process_epoch": epoch_param_err,
                   "param_tol": DP_PARAM_TOL, "metric_tol": DP_METRIC_TOL,
                   "metrics": {"one_process": {k: one["metrics"][k] for k in DP_KEYS},
                               **{f"rank{r}": {k: g["metrics"][k] for k in DP_KEYS}
                                  for r, g in enumerate(ranks)},
                               "one_process_update_on_rank_batch": one_update},
                   "gru_launches": {"one_process": dp_one["launches"],
                                    **{f"rank{r}": g["launches"]
                                       for r, g in enumerate(ranks)},
                                    "epoch_only": {f"rank{r}": g["epoch_launches"]
                                                   for r, g in enumerate(ranks)}},
                   "kernel_at_path_rows": at_rows, "atol": ATOL, "results": results,
                   "card": smi}
        if problems:
            raise AssertionError(f"{problems}: {summary}")
        return summary
    run_phase("tensor_parallel_epoch", tensor_parallel_epoch)

    # ---- the bench command and the JAX side's throughput scripts ----
    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.bench import core as bench_core
    from rvo3d_tpu_torch.bench import detail as bench_detail_mod
    from rvo3d_tpu_torch.bench import gru as bench_gru_mod
    from rvo3d_tpu_torch.bench import ladder as bench_ladder_mod
    from rvo3d_tpu_torch.bench import serving as bench_serving_mod
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.env.env import reset

    def bench_env():
        """`cli bench` in this process at bench.py's size: its line, the
        spread between the lanes of the last timed chunk's final state (all
        lanes fly one deterministic trajectory, so any spread is an op that
        mixes lanes; reported, not gated), and the timed loop in float64,
        graphed on the card, against the CPU's eager loop."""
        os.environ.update(BENCH_SIZE)
        finals, real = [], bench_core.make_chunk

        def make_chunk(*a):
            chunk = real(*a)

            def run(state, steps):
                finals.append(chunk(state, steps))
                return finals[-1]
            return run
        bench_core.make_chunk = make_chunk
        mg.launches = 0
        try:
            rc, lines = quiet_main(cli.main, ["bench", "--device", "cuda"])
        finally:
            bench_core.make_chunk = real
        launches_by_phase["bench_env"] = mg.launches
        print(lines[-1], flush=True)
        line = json.loads(lines[-1])
        wd = flagship_world()
        p8 = EnvParams(num_drones=wd["drone_num"])
        runs = []
        for d in (dev, "cpu"):     # the card's graphed chunk, the CPU's eager loop
            w = bench_core.world_spec(wd, d, torch.float64)
            runs.append(bench_core.make_chunk(w, p8)(reset(w, p8, lead=(4,)), 100))
        err, differ = state_diff(*runs)
        problems = []
        if rc != 0 or set(line) != BENCH_KEYS:
            problems.append(f"rc {rc}, keys {sorted(line)}")
        if not all_rates_ok([line[k] for k in ("value", "min", "median", "max",
                                                "vs_baseline")]):
            problems.append("a rate is not finite and positive")
        if err > F64_ATOL or differ:
            problems.append(f"float64 card vs CPU: {err} > {F64_ATOL} or {differ} differ")
        out = {"bench_line": line, "size": BENCH_SIZE, "timed_chunks": len(finals) - 1,
               "lane_spread_of_final_state": lane_spread(finals[-1]),
               "f64_card_vs_cpu": {"lanes": 4, "steps": 100, "max_abs_diff": err,
                                   "atol": F64_ATOL, "differing_flags": differ},
               "gru_launches": mg.launches, "card": smi}
        if problems:
            raise AssertionError(f"{problems}: {out}")
        return out
    run_phase("bench_env", counted("bench_env", bench_env))

    def bench_ladder():
        """Rungs 4 and 5 at full size, and lane 1 of the rung-5 world (the
        flipped population) in float64 on the card against the CPU."""
        mg.launches = 0
        rc, _ = quiet_main(bench_ladder_mod.main, ["--device", "cuda"])
        launches_by_phase["bench_ladder"] = mg.launches
        res = bench_results("ladder_bench.json")
        lane1 = []
        for d in (dev, "cpu"):
            lw = bench_ladder_mod.rung5_lane_worlds(2, d, torch.float64)
            p32 = EnvParams(num_drones=lw.num_drones)
            st = bench_core.run_chunk(lw, reset(lw, p32, (2,)), p32, bench_ladder_mod.STEPS)
            lane1.append(type(st)(*[x[1] for x in st]))
        err, differ = state_diff(*lane1)
        rates = [v for k, v in res.items() if k.endswith("_per_sec")]
        out = {"results": res, "lane1_f64_card_vs_cpu": {
                   "steps": bench_ladder_mod.STEPS, "max_abs_diff": err, "atol": F64_ATOL,
                   "differing_flags": differ},
               "gru_launches": mg.launches, "card": smi}
        if rc != 0 or len(rates) != 2 or not all_rates_ok(rates) or err > F64_ATOL or differ:
            raise AssertionError(f"bench_ladder: {out}")
        return out
    run_phase("bench_ladder", bench_ladder)

    def bench_detail():
        """Sections 1-3 of the detail bench, and the kernel held to its
        plain version at the rows the rollout and the PPO epoch gave it."""
        keep = {}
        mg.launches = 0
        with kernel_inputs_kept(mg, keep):
            rc, _ = quiet_main(bench_detail_mod.main, ["--device", "cuda"])
        launches_by_phase["bench_detail"] = mg.launches
        res = bench_results("bench_details.json")
        at_rows = kernel_at_kept_rows(mg, keep, want=(2048 * 8, 32 * 8))
        rates = [*res["env_only_steps_per_sec"].values(),
                 res["rollout_policy_steps_per_sec_kernel"], res["ppo_env_steps_per_sec"]]
        out = {"results": res, "kernel_at_path_rows": at_rows, "atol": ATOL, "cuts": {},
               "gru_launches": mg.launches, "card": smi}
        if rc != 0 or len(rates) != 6 or not all_rates_ok(rates):
            raise AssertionError(f"bench_detail: {out}")
        return out
    run_phase("bench_detail", bench_detail)

    def bench_serving():
        """PolicyServer.act at the serving bench's four batches, and the
        kernel held to its plain version at each batch's rows."""
        keep = {}
        mg.launches = 0
        with kernel_inputs_kept(mg, keep):
            rc, _ = quiet_main(bench_serving_mod.main, ["--device", "cuda"])
        launches_by_phase["bench_serving"] = mg.launches
        res = bench_results("serving_bench.json")
        at_rows = kernel_at_kept_rows(mg, keep, want=bench_serving_mod.BATCHES)
        rates = [r["actions_per_sec_kernel"] for r in res["batches"].values()]
        out = {"results": res, "kernel_at_path_rows": at_rows, "atol": ATOL, "cuts": {},
               "gru_launches": mg.launches, "card": smi}
        if rc != 0 or len(rates) != len(bench_serving_mod.BATCHES) or not all_rates_ok(rates):
            raise AssertionError(f"bench_serving: {out}")
        return out
    run_phase("bench_serving", bench_serving)

    gru_rows = {}

    def bench_gru():
        """The GRU microbench at E = 4096 and 16384 (B = 32768 and 131072,
        one direction), each row beside its bound; max |kernel - plain|
        within ATOL at both."""
        mg.launches = 0
        rc, _ = quiet_main(bench_gru_mod.main, ["--device", "cuda"])
        launches_by_phase["bench_gru"] = mg.launches
        res = bench_results("gru_bench.json")
        for e in bench_gru_mod.LANES:
            row = res["shapes"][f"E{e}"]
            xs, ms, w = bench_gru_mod.inputs(row["B"], dev)
            row.update(gru_bound(xs, ms, w, ndirs=1))
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            gru_rows[str(row["B"])] = row
        bad = {b: r["max_abs_err"] for b, r in gru_rows.items()
               if not r["max_abs_err"] <= ATOL}
        out = {"results": res, "atol": ATOL, "gru_launches": mg.launches, "card": smi}
        if rc != 0 or len(gru_rows) != 2 or bad:
            raise AssertionError(f"bench_gru: max |kernel - plain| {bad}: {out}")
        return out
    run_phase("bench_gru", bench_gru)

    # ---- the JAX side's last entry points: the graft entry and its
    # sharded dry run, the BC and expert diagnostics, bench_detail section 4 ----
    from rvo3d_tpu_torch import entry as entry_mod
    from rvo3d_tpu_torch.diag import bc_eval as bc_eval_mod
    from rvo3d_tpu_torch.diag import conflict_diag as conflict_mod
    from rvo3d_tpu_torch.diag import expert_eval as expert_eval_mod
    from rvo3d_tpu_torch.diag import expert_noise_sweep as sweep_mod
    from rvo3d_tpu_torch.diag import w3_diag as w3_mod
    gru_path_rows = {}

    def entry_forward():
        """entry()'s flagship forward at B = 256 with every slot on, card
        against CPU, the kernel against plain at those rows, timed."""
        module, example = entry_mod.entry("cuda")
        keep = {}
        mg.launches = 0
        with kernel_inputs_kept(mg, keep), torch.no_grad():
            got = module(*example)
        torch.cuda.synchronize()
        launches_by_phase["entry_forward"] = mg.launches
        ac_cpu = ActorCritic(ModelConfig(), device="cpu")
        ac_cpu.load_state_dict(module.state_dict())
        with torch.no_grad():
            ref = ac_cpu(*[x.cpu() for x in example])
        err = {k: (a.cpu() - b).abs().max().item()
               for k, a, b in zip(("mu", "std", "v"), got, ref)}
        at_rows = kernel_at_kept_rows(mg, keep, want=(entry_mod.B,))
        timed = time_kept_launch(mg, keep[entry_mod.B], 30)
        gru_path_rows["entry_B256_full_mask"] = timed
        out = {"B": entry_mod.B, "nm": entry_mod.NM, "card_vs_cpu_max_abs": err,
               "atol": ATOL, "kernel_at_path_rows": at_rows, "timed": timed,
               "gru_launches": launches_by_phase["entry_forward"], "card": smi}
        if not max(err.values()) <= ATOL or timed["active_slots_per_row"] != entry_mod.NM:
            raise AssertionError(f"entry_forward: {out}")
        return out
    run_phase("entry_forward", entry_forward)

    def dryrun_multichip():
        """dryrun_multichip(4, full_size=True): the flagship epoch over a
        2 x 2 mesh of gloo ranks on this card against the same epoch
        unsharded here; the kernel against plain at the rows this process
        launched it with (the ranks' own launches are counted)."""
        keep, buf = {}, io.StringIO()
        mg.launches = 0
        with kernel_inputs_kept(mg, keep), contextlib.redirect_stdout(buf):
            art = entry_mod.dryrun_multichip(DRYRUN_RANKS, full_size=True, device="cuda")
        here = mg.launches
        lines = buf.getvalue().splitlines()
        ranks = {k: v for k, v in art["launches"].items() if k.startswith("rank")}
        launches_by_phase["dryrun_multichip"] = here + sum(ranks.values())
        lanes_rows = art["shapes"]["num_envs"] * art["shapes"]["num_drones"]
        at_rows = kernel_at_kept_rows(mg, keep, want=(lanes_rows,))
        return {"lines": lines, "held": art["held"], "metrics": art["metrics"],
                "steps_per_sec": art["steps_per_sec"], "mesh": art["mesh"],
                "backend": art["backend"], "shapes": art["shapes"],
                "artifact": art["artifact"], "gru_launches": {"this_process": here, **ranks},
                "kernel_at_path_rows": at_rows, "atol": ATOL, "cuts": {}, "card": smi}
    run_phase("dryrun_multichip", dryrun_multichip)

    def expert_diag():
        """expert_eval on world16_dense and world32_mix; sweep_world with the
        plan's margins on world32_mix, its reversal and world16_dense; one
        (world, slowdown) pair's per-lane outcomes on the card against the
        CPU under the same draws (its first lanes at every margin)."""
        mg.launches = 0
        t0 = time.perf_counter()
        rc, eval_lines = quiet_main(expert_eval_mod.main,
                                    [*EXPERT_WORLDS, "--device", "cuda"])
        eval_s = time.perf_counter() - t0
        margins = {(w, rev): m for w, m, rev in sweep_mod.PLAN}
        rows, sweep_s = [], {}
        for wname, rev in SWEEP_PLAN:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                got = sweep_mod.sweep_world(wname, margins[(wname, rev)], reverse=rev,
                                            device="cuda")
            rows += got
            sweep_s[wname + (":rev" if rev else "")] = time.perf_counter() - t0
        # the check: per-lane flags, card against CPU, same margins and draws
        wname, slowdown, lanes = SWEEP_CHECK
        wd_c = load_world(wname)
        p_c = dataclasses.replace(EnvParams(num_drones=wd_c.drone_num), noise=True,
                                  control_std=0.06)
        ms = margins[(wname, False)]
        g = torch.Generator(device=dev).manual_seed(sweep_mod.NOISE_SEED)
        streams = torch.randn((sweep_mod.MAX_EP_LEN, sweep_mod.LANES, wd_c.drone_num, 3),
                              generator=g, device=dev)[:, :lanes].repeat(1, len(ms), 1, 1)
        flags = {}
        t0 = time.perf_counter()
        for d in (dev, "cpu"):
            lm = torch.tensor(ms, device=d).repeat_interleave(lanes)
            out = sweep_mod.noisy_episode(wd_c.spec(device=d), p_c, slowdown, lm,
                                          streams.to(d))
            flags[str(torch.device(d).type)] = [x.cpu() for x in out]
        check_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(flags["cuda"], flags["cpu"]))
        launches_by_phase["expert_diag"] = mg.launches
        out = {"expert_eval": eval_lines, "expert_eval_s": eval_s, "rows": rows,
               "sweep_s": sweep_s, "lanes": sweep_mod.LANES,
               "max_ep_len": sweep_mod.MAX_EP_LEN,
               "card_vs_cpu": {"world": wname, "slowdown": slowdown, "margins": ms,
                               "lanes_per_margin": lanes, "identical": same,
                               "successes": int(flags["cuda"][0].sum()),
                               "mean_ep_len": float(flags["cuda"][1].float().mean()),
                               "collisions": int(flags["cuda"][2].sum()),
                               "seconds": check_s},
               "gru_launches": mg.launches, "card": smi}
        want = sum(len(margins[k]) * 2 for k in SWEEP_PLAN)
        if rc != 0 or len(eval_lines) != 2 * len(EXPERT_WORLDS) or len(rows) != want \
                or not same:
            raise AssertionError(f"expert_diag: {out}")
        return out
    run_phase("expert_diag", expert_diag)

    def conflict_diag():
        """conflict_diag at its defaults (16 envs x 400 steps) on world32_mix
        from a run directory holding the committed w32_m3s clone; its final
        forward over all 204,800 rows timed beside its bound and cuDNN."""
        import tempfile

        keep = {}
        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "w32_m3s")
            os.makedirs(os.path.join(run, "ckpt", "5"))
            shutil.copy(W32_CONFIG, os.path.join(run, "config.json"))
            w32 = torch.load(W32_PARAMS, map_location="cpu", weights_only=True)
            torch.save({"epoch": 5, "params": w32["state_dict"]},
                       os.path.join(run, "ckpt", "5", "state.pt"))
            report_path = os.path.join(tmp, "report.json")
            mg.launches = 0
            with kernel_inputs_kept(mg, keep):
                rc, lines = quiet_main(conflict_mod.main, [
                    run, "world32_mix", "--out", report_path, "--device", "cuda"])
            with open(report_path) as f:
                report = json.load(f)
        launches_by_phase["conflict_diag"] = mg.launches
        rows = report["states"]
        at_rows = kernel_at_kept_rows(mg, keep, want=(rows, 16 * 32))
        timed = time_kept_launch(mg, keep[rows], 5)
        gru_path_rows[f"conflict_diag_B{rows}"] = timed
        out = {"report": report, "kernel_at_path_rows": at_rows, "atol": ATOL,
               "timed": timed, "gru_launches": launches_by_phase["conflict_diag"],
               "cuts": {}, "card": smi}
        finite = all(math.isfinite(v) for v in report["rms_err_cruise"])
        if rc != 0 or rows != 16 * 400 * 32 or not finite:
            raise AssertionError(f"conflict_diag: {out}")
        return out
    run_phase("conflict_diag", conflict_diag)

    def bc_diag():
        """bc_eval on world16_dense (BC steps cut), then w3_diag --reuse of
        its clone."""
        import tempfile

        keep = {}
        mg.launches = 0
        with tempfile.TemporaryDirectory() as tmp, kernel_inputs_kept(mg, keep):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                clone = bc_eval_mod.run("world16_dense", "rvo", BC_DIAG_STEPS[1],
                                        device="cuda")
            eval_s = time.perf_counter() - t0
            path = os.path.join(tmp, "world16_dense_bc_torch.pt")
            torch.save(clone.state_dict(), path)
            t0 = time.perf_counter()
            rc, w3_lines = quiet_main(w3_mod.main, ["world16_dense", path, "--reuse",
                                                    "--device", "cuda"])
            w3_s = time.perf_counter() - t0
        launches_by_phase["bc_diag"] = mg.launches
        at_rows = kernel_at_kept_rows(mg, keep, want=(16,))
        steps = [ln for ln in w3_lines if ln.startswith("t=")]
        out = {"bc_eval": buf.getvalue().splitlines(), "bc_eval_s": eval_s,
               "w3_diag_head": w3_lines[:2], "w3_diag_tail": w3_lines[-2:],
               "w3_diag_steps": len(steps), "w3_diag_s": w3_s,
               "kernel_at_path_rows": at_rows, "atol": ATOL,
               "gru_launches": launches_by_phase["bc_diag"],
               "cuts": {"bc_steps": list(BC_DIAG_STEPS)}, "card": smi}
        if rc != 0 or not w3_lines[0].startswith("reused params") or not steps \
                or len(out["bc_eval"]) != 4:
            raise AssertionError(f"bc_diag: {out}")
        return out
    run_phase("bc_diag", bc_diag)

    def bench_detail_train_split():
        """Section 4 of the detail bench on gen_demo (its depth cut)."""
        keep = {}
        mg.launches = 0
        with kernel_inputs_kept(mg, keep), contextlib.redirect_stdout(io.StringIO()):
            res = bench_detail_mod.train_split(
                "gen_demo", dev, **{k: v[1] for k, v in SPLIT_CUTS.items()})
        launches_by_phase["bench_detail_train_split"] = mg.launches
        at_rows = kernel_at_kept_rows(mg, keep, want=(256 * 4, 4096 * 4))
        rates = [r[k] for r in res.values() for k in ("env_steps_per_sec_full",
                                                      "env_steps_per_sec_rollout_only")]
        trace_file = os.path.join(bench_core.OUT_DIR, "profiles", "gen_demo_train_epoch",
                                  "trace.json")
        out = {"results": res, "kernel_at_path_rows": at_rows, "atol": ATOL,
               "cuts": {k: list(v) for k, v in SPLIT_CUTS.items()},
               "trace_bytes": os.path.getsize(trace_file),
               "gru_launches": launches_by_phase["bench_detail_train_split"], "card": smi}
        if len(res) != 2 or not all_rates_ok(rates):
            raise AssertionError(f"bench_detail_train_split: {out}")
        return out
    run_phase("bench_detail_train_split", bench_detail_train_split)
    launches = sum(launches_by_phase.values())

    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "card": smi})
    emit({"kernels": [{
        "name": "masked_gru", "route": "cuda",
        "source": "rvo3d_tpu_torch/csrc/masked_gru.cu",
        "replaces": "rvo3d_tpu/ops/pallas_gru.py:106",
        "launches": launches,
        "max_abs_err": max([kstats["max_abs_err"]]
                           + [r["max_abs_err"] for r in gru_rows.values()]),
        "ms": kstats["ms"], "plain_ms": kstats["plain_ms"],
        "bound_ms": kstats["bound_ms"], "bound_by": kstats["bound_by"],
        "library_ms": kstats["library_ms"],
        "bound_ms_f32_simt": kstats["bound_ms_f32_simt"],
        "launches_by_phase": launches_by_phase,
        "biGRU_at_path_rows": gru_path_rows,
        "one_direction_by_B": {b: {k: r[k] for k in ("kernel_ms", "plain_ms",
                                                     "cudnn_gru_unmasked_ms", "bound_ms",
                                                     "bound_by", "max_abs_err")}
                               for b, r in gru_rows.items()}}, {
        "name": "vo_pairs", "route": "cuda",
        "source": "rvo3d_tpu_torch/csrc/vo_pairs.cu",
        "replaces": None,   # no TPU kernel: the JAX package leaves the pairs to XLA
        "launches": sum(vo_launches_by_phase.values()),
        "launches_by_phase": vo_launches_by_phase,
        "max_abs_err": max(r[m]["max_abs_err"] for r in vo_rows.values()
                           for m in ("reward", "observe")),
        "by_shape": {k: {m: {x: r[m][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")}
                         for m in ("reward", "observe")} for k, r in vo_rows.items()}}, {
        "name": "env_drones", "route": "cuda",
        "source": "rvo3d_tpu_torch/csrc/env_drones.cu",
        "replaces": None,   # no TPU kernel: the JAX package leaves the env's ops to XLA
        "launches": sum(env_launches_by_phase.values()),
        "launches_by_phase": env_launches_by_phase,
        "max_abs_err": max(r["max_abs_err"] for r in env_rows.values()),
        "by_shape": {k: {"passes": {m: {x: v[x] for x in ("ms", "bound_ms")}
                                    for m, v in r["passes"].items()},
                         **{c: r[c] for c in ("step", "observe", "reset_where")}}
                     for k, r in env_rows.items()}}]})
    if launches == 0:
        print("chip_smoke: the main path launched no masked GRU kernel", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
