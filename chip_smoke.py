#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rvo3d_tpu_torch) on one CUDA card.

Run from the repo root, with no arguments:

    python3 chip_smoke.py

or, to also time an older one-block masked_gru.cu (the PR-4 source, e.g.
`git show 5a338a1:rvo3d_tpu_torch/csrc/masked_gru.cu > OLD.cu`) in turns
with this kernel at the timed batches:

    python3 chip_smoke.py --old-kernel OLD.cu

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
then PPO, 64 lanes x 32 drones, biGRU-256, batch 4096, minibatch 16384;
one `bc_round` line per fit, one `ppo_epoch` line per epoch, the kernel
held to its plain version at the rows the path gave it, and the gate:
det success >= 0.8 on both populations at the best persisted epoch).
Each phase prints one JSON line with its wall-clock seconds; a failed
phase exits non-zero. The last line is {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
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
# port's CLI at full width and depth: no cut (a cut would go, in this
# order, to PPO epochs, eval episodes, DAgger rounds, and be printed)
RECIPE_EPOCHS = 10
RECIPE_EVAL_EPISODES = 100
RECIPE_DAGGER = 3
RECIPE_MIN_SUCCESS = 0.8      # det, worst population, best persisted epoch
RECIPE_MIN_EPISODES = 64


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


def bigru_bound(xs, ms, fwd):
    """The least time of one biGRU launch on these inputs: the products of
    the active steps (both directions) at the 3xTF32 peak, or the bytes
    read once (xs, mask, both directions' weights) and written once."""
    in_dim, hidden = xs.shape[-1], fwd[1].shape[0]
    active = float(ms.sum().item())
    flops = 2 * 2.0 * active * (in_dim + hidden) * 3 * hidden
    nbytes = 4.0 * (xs.numel() + ms.numel() + 2 * sum(t.numel() for t in fwd)
                    + xs.shape[1] * hidden)
    t_ops, t_bytes = flops / TF32X3_PEAK, nbytes / HBM_BYTES_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_f32_simt": max(flops / F32_PEAK, t_bytes) * 1e3}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-kernel", help="an older one-block masked_gru.cu "
                    "(PR-4 interface) to time in turns with this kernel")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from rvo3d_tpu_torch.algo import ppo
    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.algo.trainer import Trainer, metrics_finite
    from rvo3d_tpu_torch.config import EnvParams, ModelConfig, from_dict
    from rvo3d_tpu_torch.env import DroneEnv, geometry as geo
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.models import encoder as encoder_mod
    from rvo3d_tpu_torch.ops import _build
    from rvo3d_tpu_torch.ops import masked_gru as mg
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
    from rvo3d_tpu_torch.worlds import load_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    run_phase("device", lambda: {"kind": kind, "count": torch.cuda.device_count(),
                                 "nvidia_smi": smi, "torch": torch.__version__,
                                 "cuda": torch.version.cuda})

    def build():
        mg.library()
        info = _build.BUILD_INFO["masked_gru"]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        return {"kernel": "masked_gru", "nvcc_seconds": info["seconds"],
                "ptxas": ptxas}
    run_phase("build", build)

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
            row.update(bigru_bound(xs, ms, fwd))
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

    def old_kernel_in_turns():
        so = os.path.join(_build.BUILD_DIR, "masked_gru_old.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                        args.old_kernel], check=True, capture_output=True)
        fn = ctypes.CDLL(so).masked_gru_forward
        c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [c, i64, i64, i64, c, i64, i64, c, c, c, c, c,
                       i32, i32, i32, i32, i32, c]
        fn.restype = ctypes.c_int

        def one(xs, ms, w, reverse):   # one direction per launch
            out = torch.empty(xs.shape[1], hidden, device=dev)
            err = fn(xs.data_ptr(), *xs.stride(), ms.data_ptr(), *ms.stride(),
                     *(t.data_ptr() for t in w), out.data_ptr(), s_len,
                     xs.shape[1], in_dim, hidden, reverse,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"old kernel: cudaError {err}")
            return out

        timed = {}
        for label, b, kind in [(str(b), b, "random") for b in TIMED_B] + [
                (f"{b_main}_last_slot", b_main, "last")]:
            xs, ms, fwd, bwd = gru_case(b, kind)
            runs = {"new": lambda: mg.masked_bigru_scan_cuda(xs, ms, fwd, bwd),
                    "old": lambda: one(xs, ms, fwd, 0) + one(xs, ms, bwd, 1)}
            ref = mg.masked_bigru_scan_plain(xs, ms, fwd, bwd)
            errs = {k: (f() - ref).abs().max().item() for k, f in runs.items()}
            if not max(errs.values()) <= ATOL:
                raise AssertionError(f"B={label}: max |kernel - plain| {errs} > {ATOL}")
            iters = 30 if b <= 4096 else 5
            times = {"new": [], "old": []}
            for k in ("new", "old", "old", "new"):
                times[k].append(cuda_ms(runs[k], iters))
            timed[label] = {"new_bigru_ms": times["new"], "old_bigru_ms": times["old"],
                            "max_abs_err": errs}
        return {"old_source": args.old_kernel, "timed": timed}
    if args.old_kernel:
        run_phase("old_kernel_in_turns", old_kernel_in_turns)

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
    run_phase("env_card_vs_cpu_f64", env_check)

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
    run_phase("evaluate", run_eval)

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
    def encoder_check():
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
        obs = [torch.cat([r[i] for r in rows] + [flat[i]])[:b_main] for i in range(3)]
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
            marks.append((ev, mg.launches))
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
            (e0, l0), (e1, l1), (e2, l2), (e3, l3) = marks
            line = {"phase": "train_epoch", "epoch": epoch,
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
        timing.update(bigru_bound(xs, ms, fwd))
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
    run_phase("multi_world_env_card_vs_cpu", multi_env_check)

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
                       **bigru_bound(xs, ms, fwd)}
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
        summary = {"argv": argv, "cuts": [], "wall_s": wall,
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
    launches = sum(launches_by_phase.values())

    emit({"kernels": [{
        "name": "masked_gru", "route": "cuda",
        "source": "rvo3d_tpu_torch/csrc/masked_gru.cu",
        "replaces": "rvo3d_tpu/ops/pallas_gru.py:106",
        "launches": launches, "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"], "plain_ms": kstats["plain_ms"],
        "bound_ms": kstats["bound_ms"], "bound_by": kstats["bound_by"],
        "library_ms": kstats["library_ms"],
        "bound_ms_f32_simt": kstats["bound_ms_f32_simt"],
        "launches_by_phase": launches_by_phase}]})
    if launches == 0:
        print("chip_smoke: the main path launched no masked GRU kernel", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
