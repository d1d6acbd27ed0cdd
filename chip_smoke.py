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
path went through the kernel. Each phase prints one JSON line with its
wall-clock seconds; a failed phase exits non-zero. The last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
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
TIMED_B = (2048, 4096, 65536)  # w16_r4's rollout (128 x 16), serving, a PPO batch


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

    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.config import EnvParams, ModelConfig
    from rvo3d_tpu_torch.env import DroneEnv, geometry as geo
    from rvo3d_tpu_torch.models import ActorCritic
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
            iters = 30 if b <= 4096 else 5
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
            active = float(ms.sum().item())
            flops = 2 * 2.0 * active * (in_dim + hidden) * 3 * hidden  # two directions
            nbytes = 4.0 * (xs.numel() + ms.numel() + 2 * sum(t.numel() for t in fwd)
                            + b * hidden)
            t_ops, t_bytes = flops / TF32X3_PEAK, nbytes / HBM_BYTES_S
            row.update(flops=flops, bytes=nbytes,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       bound_ms_f32_simt=max(flops / F32_PEAK, t_bytes) * 1e3)
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

    emit({"kernels": [{
        "name": "masked_gru", "route": "cuda",
        "source": "rvo3d_tpu_torch/csrc/masked_gru.cu",
        "replaces": "rvo3d_tpu/ops/pallas_gru.py:106",
        "launches": launches, "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"], "plain_ms": kstats["plain_ms"],
        "bound_ms": kstats["bound_ms"], "bound_by": kstats["bound_by"],
        "library_ms": kstats["library_ms"],
        "bound_ms_f32_simt": kstats["bound_ms_f32_simt"]}]})
    if launches == 0:
        print("chip_smoke: the main path launched no masked GRU kernel", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
