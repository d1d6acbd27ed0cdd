"""Command-line entry points of the port: train, eval, worldgen, render,
parity and bench (counterpart of rvo3d_tpu/cli.py).

    python -m rvo3d_tpu_torch.cli train --world world32_mix \\
        --multi_worlds world32_mix,world32_mix:rev --num_envs 64 ...
    python -m rvo3d_tpu_torch.cli eval --world world32_mix \\
        --checkpoint <run_dir> --ckpt_epoch 5 --reverse

    python -m rvo3d_tpu_torch.cli train --world world16_dense \
        --curriculum 1.2:80,0.8:80,0.4:rest ...
    python -m rvo3d_tpu_torch.cli eval --world world16_dense \
        --torch_checkpoint policy.pt --rnn_mode biGRU
    python -m rvo3d_tpu_torch.cli worldgen --name w16 --drones 16 \
        --map_size 24 24 8 --out worlds_data
    python -m rvo3d_tpu_torch.cli render --world world16_dense \
        --checkpoint <run_dir> --out render_out
    python -m rvo3d_tpu_torch.cli parity --x64 --device cuda
    python -m rvo3d_tpu_torch.cli bench --device cuda

A run directory gets the full config as JSON, train.jsonl, checkpoints
under ckpt/ (<epoch>/state.pt), results.txt (one line per evaluated
population, in the JAX CLI's format) and best_checkpoint.json. Both
commands, render, parity and bench run on `--device` (default cuda;
without a card they raise). `train` runs over a (data, model) mesh when
started as several processes with the RVO3D_* variables (parallel/multihost.py):
`--mesh_data D --mesh_model M` with D*M processes (data-parallel lanes,
tensor-parallel weights), or `--auto_mesh`; rank 0 alone writes the run
directory. `bench` prints bench.py's one-line throughput result for the
port (bench/core.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _eval_suffix(m: dict) -> str:
    """Marks a truncated eval (episode budget not reached) in results.txt."""
    if m.get("truncated"):
        return f" [TRUNCATED: {m['episodes']} episodes]"
    return ""


def _fresh_run_dir(root: str, tag: str) -> str:
    os.makedirs(root, exist_ok=True)
    i = 0
    while os.path.exists(os.path.join(root, f"{tag}_{i}")):
        i += 1
    path = os.path.join(root, f"{tag}_{i}")
    os.makedirs(path)
    return path


def _policy_controller(ac, env_p, action_mode="increment", acceler_vel=1.0,
                       std_factor=1e-3, seed=0, randn=None):
    """controller(state, world) -> absolute action for the render paths,
    with the training and evaluation mapping ('increment' = acceler*a + vel,
    post_train.py:72-74; 'direct' = the raw command). The sampling noise
    comes from `randn(shape)` (standard normals), by default a CPU generator
    seeded from `seed`, so a card and a CPU run draw the same numbers."""
    import torch

    from rvo3d_tpu_torch.env import geometry as geo
    from rvo3d_tpu_torch.env.env import observe

    if randn is None:
        gen = torch.Generator().manual_seed(seed)

        def randn(shape):
            return torch.randn(shape, generator=gen)

    def controller(state, world):
        out, _ = observe(world, state, env_p)
        eps = randn(tuple(out.obs_self.shape[:-1]) + (ac.act_dim,)).to(out.obs_self.device)
        ps = ac.step(out.obs_self, out.obs_nbr, out.obs_mask, std_factor, eps=eps)
        a = geo.rnd(ps.action, 2)
        if action_mode == "direct":
            return a
        return acceler_vel * a + state.vel

    return controller


def _dump_training_gif(ac, wd, cfg, media_dir: str, epoch: int, device,
                       steps: int = 60) -> str:
    """Record one episode of the current policy and write
    media_dir/epoch_{N}.gif (+ its frames under media_dir/epoch_{N}/)."""
    import dataclasses

    from rvo3d_tpu_torch.env import DroneEnv
    from rvo3d_tpu_torch.render import ScenePlotter, frames_to_gif, record_trajectory

    env_p = dataclasses.replace(cfg.env, noise=False)
    env = DroneEnv(wd.spec(device=device), env_p)
    controller = _policy_controller(ac, env_p, action_mode=cfg.train.action_mode)
    traj = record_trajectory(env, controller, steps=steps)
    frame_dir = os.path.join(media_dir, f"epoch_{epoch}")
    os.makedirs(frame_dir, exist_ok=True)
    plotter = ScenePlotter(wd.map_size, wd.building_list, wd.waypoints_list)
    try:
        frames = plotter.render_trajectory(traj, frame_dir, every=2)
        gif = frames_to_gif(frames, os.path.join(media_dir, f"epoch_{epoch}.gif"))
    finally:
        plotter.close()
    return gif


def _results_line(path: str, line: str) -> None:
    print(line)
    with open(path, "a") as f:
        f.write(line + "\n")


def _load_spec(token: str, device, dtype=None):
    """'name' or 'name:rev' (the route-reversed variant) as a WorldSpec."""
    import torch

    from rvo3d_tpu_torch.worlds import load_world
    from rvo3d_tpu_torch.worlds.multi import reverse_routes

    rev = token.endswith(":rev")
    spec = load_world(token[:-4] if rev else token).spec(
        dtype=dtype or torch.float32, device=device)
    return reverse_routes(spec) if rev else spec


def _build_cfg(args):
    from rvo3d_tpu_torch.config import (Config, EnvParams, MeshConfig, ModelConfig,
                                        TrainConfig)
    from rvo3d_tpu_torch.worlds import load_world

    wd = load_world(args.world)
    env = EnvParams(num_drones=wd.drone_num, neighbor_num=args.neighbors_num,
                    mov_p_dest=args.p_dest, mov_p_way=args.p_way,
                    mov_p_progress=args.p_progress,
                    safe_rewards=not args.unsafe_rewards, noise=args.train_noise,
                    control_std=args.train_control_std)
    model = ModelConfig(rnn_hidden_dim=args.rnn_hidden_dim, rnn_mode=args.rnn_mode,
                        log_std_init=args.log_std_init, use_pallas_gru=args.pallas_gru)
    train = TrainConfig(
        pi_lr=args.pi_lr, vf_lr=args.vf_lr, train_epoch=args.train_epoch,
        steps_per_epoch=args.steps_per_epoch, max_ep_len=args.max_ep_len,
        gamma=args.gamma, lam=args.lam, clip_ratio=args.clip_ratio,
        train_pi_iters=args.train_pi_iters, train_v_iters=args.train_v_iters,
        target_kl=args.target_kl, max_update_num=args.max_update_num,
        seed=args.seed, save_freq=args.save_freq, num_envs=args.num_envs,
        adv_norm=args.adv_norm, ent_coef=args.ent_coef,
        action_mode=args.action_mode, fresh_logp=args.fresh_logp,
        value_clip=args.value_clip, batched_update=args.batched_update,
        minibatch=args.minibatch, vf_encoder=not args.vf_no_encoder,
        freeze_encoder=args.freeze_encoder)
    return Config(env=env, model=model, train=train,
                  mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
                  world=args.world), wd


def _mesh_from_args(cfg, args):
    """The (data, model) mesh the flags ask for (None for one process), as
    the JAX CLI decides it: --mesh_data D --mesh_model M (D*M = the world
    size; D defaults to world size / M), or --auto_mesh when several
    processes run."""
    import torch.distributed as dist

    from rvo3d_tpu_torch.parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.mesh.data * cfg.mesh.model > 1 or (args.auto_mesh and world > 1):
        data = cfg.mesh.data if cfg.mesh.data > 1 else world // cfg.mesh.model
        try:
            return make_mesh(data=data, model=cfg.mesh.model)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if world > 1:
        raise SystemExit(f"{world} processes joined, but neither --mesh_data {world} "
                         "nor --auto_mesh was given")
    return None


def _shared_run_dir(args, tag: str, mesh) -> str:
    """--run_dir, or a fresh runs_torch/<tag>_<i> that rank 0 picks."""
    run_dir = args.run_dir
    if run_dir is None and (mesh is None or mesh.rank == 0):
        run_dir = _fresh_run_dir("runs_torch", tag)
    if mesh is not None:
        import torch.distributed as dist

        box = [run_dir]
        dist.broadcast_object_list(box, src=0)
        run_dir = box[0]
    return run_dir


def cmd_train(args) -> int:
    import dataclasses

    import torch

    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.config import to_dict
    from rvo3d_tpu_torch.parallel import distributed_init_from_env, is_coordinator, replicate
    from rvo3d_tpu_torch.parallel.multihost import rank_device
    from rvo3d_tpu_torch.parallel.tensor_parallel import full_policy, shard_params_tp
    from rvo3d_tpu_torch.utils.checkpoint import (BestCheckpoint, restore_checkpoint,
                                                  save_checkpoint)
    from rvo3d_tpu_torch.utils.device import resolve_device
    from rvo3d_tpu_torch.utils.metrics import (JSONLLogger, plot_reward_curves,
                                               write_reward_csv)
    from rvo3d_tpu_torch.worlds.multi import stack_worlds, worlds_for_lanes

    dev = resolve_device(args.device)
    distributed_init_from_env(dev)
    dev = rank_device(dev)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    cfg, wd = _build_cfg(args)
    if args.bc_slowdown and args.bc_expert != "rvo":
        raise SystemExit("--bc_slowdown only affects the 'rvo' expert "
                         "(algo/bc.py collect_demos); pass --bc_expert rvo "
                         "or drop the flag")
    if args.bc_margin is not None and args.bc_expert != "rvo":
        raise SystemExit("--bc_margin only affects the 'rvo' expert; pass "
                         "--bc_expert rvo or drop the flag")
    if args.curriculum and args.multi_worlds:
        raise SystemExit("--curriculum and --multi_worlds are not combinable (the "
                         "curriculum path rebuilds the trainer per stage on the "
                         "single world)")
    mesh = _mesh_from_args(cfg, args)
    lead = is_coordinator()
    run_dir = _shared_run_dir(args, f"r{wd.drone_num}", mesh)
    if lead:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2)
        print(f"run dir: {run_dir}")
        if mesh is not None:
            print(f"mesh: {{'data': {mesh.data}, 'model': {mesh.model}}}")

    # multi-scenario training: lane e steps scenario e % K; every scenario
    # shares --world's drone count; 'name:rev' = route-reversed variant
    world = wd.spec(device=dev)
    lane_specs = None
    if args.multi_worlds:
        lane_specs = [(tok, _load_spec(tok, dev)) for tok in args.multi_worlds.split(",")]
        if any(sp.num_drones != wd.drone_num for _, sp in lane_specs):
            raise SystemExit("--multi_worlds requires every scenario to share "
                             f"--world's drone count ({wd.drone_num})")
        idx = torch.arange(cfg.train.num_envs) % len(lane_specs)
        lane_worlds = worlds_for_lanes(stack_worlds([sp for _, sp in lane_specs]), idx)
        if lead:
            print("multi-scenario lanes: "
                  + ", ".join(f"{tok} x{int((idx == i).sum())}"
                              for i, (tok, _) in enumerate(lane_specs)))
        trainer = Trainer(cfg, world, lane_worlds=lane_worlds, device=dev, mesh=mesh)
    else:
        trainer = Trainer(cfg, world, device=dev, mesh=mesh)

    resumed = False
    if args.resume:
        # '--resume auto' continues from this run dir's latest checkpoint
        # if one exists (a fresh start otherwise)
        resume_dir = (os.path.join(run_dir, "ckpt") if args.resume == "auto"
                      else args.resume)
        if args.resume != "auto" or os.path.isdir(resume_dir):
            try:
                _, start = restore_checkpoint(resume_dir, trainer.ppo_state,
                                              epoch=args.resume_epoch,
                                              params_only=args.resume_params_only)
                resumed = True
                if lead:
                    print(f"resumed from {resume_dir} @ epoch {start}"
                          + (" (params only, fresh optimizers)"
                             if args.resume_params_only else ""))
            except FileNotFoundError:
                if args.resume != "auto":
                    raise
                if lead:
                    print(f"resume auto: no steps in {resume_dir}; fresh start")
    if not resumed and args.bc_steps:
        from rvo3d_tpu_torch.algo.bc import bc_pretrain

        # every BC/DAgger round collects demos from every scenario into one
        # aggregate set and fits jointly
        bc_worlds = [sp for _, sp in lane_specs] if lane_specs else trainer.world
        bc_loss = bc_pretrain(
            trainer.ac, bc_worlds, cfg.env,
            torch.Generator(device=dev).manual_seed(cfg.train.seed + 1),
            num_envs=min(cfg.train.num_envs, 32), train_steps=args.bc_steps,
            expert=args.bc_expert, action_mode=cfg.train.action_mode,
            explore_std=args.bc_noise, expert_margin=args.bc_margin,
            dagger_rounds=args.bc_dagger, demo_steps=args.bc_demo_steps,
            conflict_weight=args.bc_conflict_weight,
            expert_slowdown=args.bc_slowdown, env_noise=args.bc_env_noise)
        scen = (", ".join(tok for tok, _ in lane_specs) if lane_specs
                else args.world)
        if lead:
            print(f"BC warm start [{scen}]: {args.bc_steps} steps "
                  f"(dagger={args.bc_dagger}, noise={args.bc_noise}, "
                  f"margin={args.bc_margin}, "
                  f"cw={args.bc_conflict_weight}), final loss {bc_loss:.4f}")
    if mesh is not None:   # every rank starts from rank 0's state, then
        for obj in trainer.ppo_state:      # keeps its model shard of it
            replicate(obj, mesh)
        shard_params_tp(trainer.ppo_state, mesh)

    logger = JSONLLogger(os.path.join(run_dir, "train.jsonl"), echo=not args.quiet) \
        if lead else None
    ckpt_dir = os.path.join(run_dir, "ckpt")
    results_path = os.path.join(run_dir, "results.txt")

    eval_kw = dict(num_episodes=args.eval_episodes, num_lanes=8,
                   std_factor=cfg.train.std_factor_eval, action_mode=cfg.train.action_mode)

    # goal-threshold curriculum, e.g. "--curriculum 1.2:80,0.8:80,0.4:rest":
    # a fresh Trainer (a fresh carry from the seed) per stage at that
    # stage's threshold, the PPO state carried over (under tensor
    # parallelism the new trainer is sharded first and takes this rank's
    # shards); evaluations at the stage's threshold, and at each stage's end
    # at {thr, final thr}. As on the non-curriculum path every rank
    # gathers the policy and the checkpoint, and rank 0 evaluates and writes.
    if args.curriculum:
        stages = []
        for part in args.curriculum.split(","):
            thr, eps = part.split(":")
            stages.append((float(thr), None if eps == "rest" else int(eps)))
        final_thr = stages[-1][0]
        done_epochs = 0
        for thr, eps in stages:
            budget = args.train_epoch - done_epochs
            remaining = budget if eps is None else min(eps, budget)
            if remaining <= 0:
                break
            cfg_stage = cfg.replace(env=dataclasses.replace(cfg.env, goal_threshold=thr))
            prev, trainer = trainer, Trainer(cfg_stage, world, device=dev, mesh=mesh)
            if mesh is not None:
                shard_params_tp(trainer.ppo_state, mesh)
            for dst, src in zip(trainer.ppo_state, prev.ppo_state):
                dst.load_state_dict(src.state_dict())
            del prev
            if lead:
                print(f"curriculum stage: goal_threshold={thr} for {remaining} epochs")

            def log_stage(m, base=done_epochs, thr=thr):
                m["epoch"] = base + m["epoch"]
                m["goal_threshold"] = thr
                logger.log(m)

            def eval_stage(e, s, base=done_epochs, tr=trainer, p_stage=cfg_stage.env):
                ac = full_policy(tr.ac)
                if not lead:
                    return
                m = evaluate(ac, tr.world, p_stage,
                             generator=torch.Generator(device=dev).manual_seed(base + e),
                             **eval_kw)
                _results_line(results_path,
                              f"epoch {base + e} (stage thr={p_stage.goal_threshold}):"
                              f" success {m['success_rate']:.2%} "
                              f"EpLen {m['mean_ep_len']}±{m['std_ep_len']}"
                              + _eval_suffix(m))

            def save_stage(e, s, base=done_epochs, c=cfg_stage):
                save_checkpoint(ckpt_dir, base + e, s, c)

            trainer.train(epochs=remaining - 1, log_fn=log_stage if lead else _quiet,
                          checkpoint_fn=save_stage, eval_fn=eval_stage)
            done_epochs += remaining
            ac = full_policy(trainer.ac)
            if not lead:
                continue
            for thr_eval in sorted({thr, final_thr}):
                p_eval = dataclasses.replace(cfg.env, goal_threshold=thr_eval)
                m = evaluate(ac, trainer.world, p_eval,
                             generator=torch.Generator(device=dev).manual_seed(done_epochs),
                             **eval_kw)
                _results_line(results_path,
                              f"stage thr={thr} done (epoch {done_epochs}): "
                              f"eval@{thr_eval} success {m['success_rate']:.2%} "
                              f"EpLen {m['mean_ep_len']}±{m['std_ep_len']}"
                              + _eval_suffix(m))
    else:
        # every persisted checkpoint is scored (plus the --eval_every
        # cadence); a multi-scenario run writes one results.txt line per
        # population. Every rank calls these three: under tensor
        # parallelism the shards are gathered (full_policy, save_checkpoint)
        # and rank 0 evaluates, renders and writes.
        best = BestCheckpoint(run_dir) if lead else None

        def eval_fn(epoch, state, saved=True):
            ac = full_policy(trainer.ac)
            if not lead:
                return
            targets = lane_specs or [(None, trainer.world)]
            min_success = 2.0
            for tok, sp in targets:
                m = evaluate(ac, sp, cfg.env,
                             generator=torch.Generator(device=dev).manual_seed(epoch),
                             **eval_kw)
                tag = f" [{tok}]" if tok is not None else ""
                _results_line(results_path,
                              f"epoch {epoch}{tag}: success {m['success_rate']:.2%} "
                              f"EpLen {m['mean_ep_len']}±{m['std_ep_len']} "
                              f"speed {m['mean_speed']}±{m['std_speed']}"
                              + _eval_suffix(m))
                min_success = min(min_success, m["success_rate"])
            best.update(epoch, min_success, saved)

        def save(epoch, state):
            save_checkpoint(ckpt_dir, epoch, state, cfg)

        def log_fn(m):
            if lead:
                logger.log(m)
            # --render_every K: every K epochs one episode of the current
            # policy is recorded and rendered to media/epoch_K.gif. As in
            # the JAX CLI this is best effort: a render failure (e.g. no
            # matplotlib) is printed and the run goes on.
            ep = m.get("epoch")
            if not (args.render_every and ep is not None and "halted" not in m
                    and ep % args.render_every == 0):
                return
            ac = full_policy(trainer.ac)
            if not lead:
                return
            try:
                gif = _dump_training_gif(ac, wd, cfg, os.path.join(run_dir, "media"),
                                         ep, dev)
                print(f"render_every: epoch {ep} -> {gif}")
            except Exception as exc:  # noqa: BLE001 - rendering is best-effort
                print(f"render_every: epoch {ep} render failed: {exc!r}")

        trainer.train(epochs=args.train_epoch, log_fn=log_fn, checkpoint_fn=save,
                      eval_fn=eval_fn, eval_every=args.eval_every)
    if lead:
        write_reward_csv(os.path.join(run_dir, "reward_curves.csv"), logger.read())
        plot_reward_curves(os.path.join(run_dir, "train.jsonl"),
                           os.path.join(run_dir, "reward_curves.png"))
    return 0


def _quiet(_metrics) -> None:
    """A non-coordinator rank's log function: rank 0 writes train.jsonl."""


def cmd_eval(args) -> int:
    import dataclasses

    import torch

    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.config import EnvParams
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils.device import resolve_device
    from rvo3d_tpu_torch.worlds import load_world

    if not (args.checkpoint or args.torch_checkpoint):
        raise SystemExit("eval needs --checkpoint (a run dir, its ckpt/, or a "
                         "PolicyServer.save file) or --torch_checkpoint (a "
                         "reference policy's state dict)")
    dev = resolve_device(args.device)
    wd = load_world(args.world)
    eval_spec = _load_spec(args.world + (":rev" if args.reverse else ""), dev)
    env_p = EnvParams(num_drones=wd.drone_num)
    if args.goal_threshold is not None:
        env_p = dataclasses.replace(env_p, goal_threshold=args.goal_threshold)
    if args.noise:
        env_p = dataclasses.replace(env_p, noise=True, control_std=args.control_std)

    if args.torch_checkpoint:
        from rvo3d_tpu_torch.config import ModelConfig
        from rvo3d_tpu_torch.models import ActorCritic
        from rvo3d_tpu_torch.utils.torch_import import load_reference_policy

        ac = ActorCritic(ModelConfig(rnn_mode=args.rnn_mode), device=dev)
        ac.load_state_dict(load_reference_policy(args.torch_checkpoint, args.rnn_mode))
    elif args.checkpoint.endswith(".pt"):
        ac = PolicyServer.from_checkpoint(args.checkpoint, device=dev).ac
    else:
        server = PolicyServer.from_torch(args.checkpoint, args.ckpt_epoch, device=dev)
        ac = server.ac
        args.action_mode = server.config.train.action_mode   # the training mapping
        print(f"evaluating epoch {server.epoch} (action_mode={args.action_mode})")

    m = evaluate(ac, eval_spec, env_p,
                 generator=torch.Generator(device=dev).manual_seed(args.seed),
                 num_episodes=args.episodes, num_lanes=args.lanes,
                 max_ep_len=args.max_ep_len, acceler_vel=args.acceler_vel,
                 std_factor=args.std_factor, action_mode=args.action_mode)
    noise_tag = f" noise=on(std={args.control_std})" if args.noise else ""
    if args.reverse:
        noise_tag = " routes=reversed" + noise_tag
    line = (f"world={args.world}{noise_tag} "
            f"success_rate={m['success_rate']:.2%} "
            f"EpLen={m['mean_ep_len']}±{m['std_ep_len']} "
            f"speed={m['mean_speed']}±{m['std_speed']} "
            f"ret0={m['mean_ret0']:.2f} ({m['episodes']} episodes"
            + (", TRUNCATED" if m.get("truncated") else "") + ")")
    print(line)
    if args.results_file:
        with open(args.results_file, "a") as f:
            f.write(line + "\n")
    return 0


def cmd_worldgen(args) -> int:
    from rvo3d_tpu_torch.worlds.gen import generate_world, native

    wd = generate_world(args.name, num_drones=args.drones,
                        map_size=tuple(args.map_size), seed=args.seed,
                        k_sigma=args.k_sigma, n_low=args.n_low)
    out = os.path.join(args.out, args.name)
    wd.save(out)
    planner = ("native" if native.native_available()
               else f"python ({native.UNAVAILABLE})")
    print(f"world '{args.name}' -> {out}: {wd.drone_num} drones, "
          f"{len(wd.building_list)} buildings, "
          f"routes {[len(w) for w in wd.waypoints_list]} waypoints, "
          f"planner {planner}")
    return 0


def cmd_render(args) -> int:
    from rvo3d_tpu_torch.config import EnvParams, ModelConfig
    from rvo3d_tpu_torch.env import DroneEnv
    from rvo3d_tpu_torch.render import (ScenePlotter, frames_to_gif, frames_to_mp4,
                                        record_trajectory)
    from rvo3d_tpu_torch.utils.device import resolve_device
    from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
    from rvo3d_tpu_torch.worlds import load_world

    dev = resolve_device(args.device)
    wd = load_world(args.world)
    env = DroneEnv(wd.spec(device=dev), EnvParams(num_drones=wd.drone_num))

    if args.torch_checkpoint or args.checkpoint:
        from rvo3d_tpu_torch.models import ActorCritic
        from rvo3d_tpu_torch.serving import PolicyServer

        action_mode = "increment"
        if args.torch_checkpoint:
            from rvo3d_tpu_torch.utils.torch_import import load_reference_policy

            ac = ActorCritic(ModelConfig(), device=dev)
            ac.load_state_dict(load_reference_policy(args.torch_checkpoint))
        elif args.checkpoint.endswith(".pt"):
            ac = PolicyServer.from_checkpoint(args.checkpoint, device=dev).ac
        else:
            server = PolicyServer.from_torch(args.checkpoint, args.ckpt_epoch, device=dev)
            print(f"rendering checkpoint epoch {server.epoch}")
            # a 'direct'-mode checkpoint flown through the increment mapping
            # flies garbage: match the training mapping
            ac, action_mode = server.ac, server.config.train.action_mode
        controller = _policy_controller(ac, env.params, action_mode=action_mode,
                                        acceler_vel=args.acceler_vel)
    else:
        controller = waypoint_controller

    traj = record_trajectory(env, controller, steps=args.steps)
    plotter = ScenePlotter(wd.map_size, wd.building_list, wd.waypoints_list)
    try:
        frames = plotter.render_trajectory(traj, args.out, every=args.every,
                                           draw_cones=args.cones)
    finally:
        plotter.close()
    gif = frames_to_gif(frames, os.path.join(args.out, "episode.gif"))
    mp4 = None if args.no_mp4 else frames_to_mp4(frames,
                                                 os.path.join(args.out, "episode.mp4"))
    print(f"{len(frames)} frames -> {args.out}"
          + (f", gif: {gif}" if gif else "")
          + (f", mp4: {mp4}" if mp4 else ""))
    return 0


def cmd_bench(args) -> int:
    from rvo3d_tpu_torch.bench import core

    return core.main(["--device", args.device])


def cmd_parity(args) -> int:
    from rvo3d_tpu_torch.parity import run_parity

    return run_parity(worlds=args.worlds, steps=args.steps, x64=args.x64,
                      seed=args.seed, env_train=not args.eval_mode,
                      noise=args.noise, device=args.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="rvo3d_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a policy")
    t.add_argument("--device", default="cuda")
    t.add_argument("--world", default="world_3")
    t.add_argument("--run_dir", default=None)
    t.add_argument("--resume", default=None,
                   help="checkpoint dir to resume ('auto': this run dir's)")
    t.add_argument("--resume_epoch", type=int, default=None,
                   help="checkpoint epoch to resume from (default: latest)")
    t.add_argument("--resume_params_only", action="store_true",
                   help="restore only the params and start fresh optimizers")
    t.add_argument("--num_envs", type=int, default=16)
    t.add_argument("--train_epoch", type=int, default=600)
    t.add_argument("--steps_per_epoch", type=int, default=300)
    t.add_argument("--max_ep_len", type=int, default=500)
    t.add_argument("--pi_lr", type=float, default=4e-6)
    t.add_argument("--vf_lr", type=float, default=5e-5)
    t.add_argument("--gamma", type=float, default=0.99)
    t.add_argument("--lam", type=float, default=0.97)
    t.add_argument("--clip_ratio", type=float, default=0.2)
    t.add_argument("--train_pi_iters", type=int, default=50)
    t.add_argument("--train_v_iters", type=int, default=50)
    t.add_argument("--target_kl", type=float, default=0.05)
    t.add_argument("--max_update_num", type=int, default=10)
    t.add_argument("--seed", type=int, default=7)
    t.add_argument("--save_freq", type=int, default=50)
    t.add_argument("--rnn_hidden_dim", type=int, default=256)
    t.add_argument("--rnn_mode", default="biGRU", choices=["GRU", "biGRU", "LSTM"])
    t.add_argument("--neighbors_num", type=int, default=10)
    t.add_argument("--p_dest", type=float, default=20.0)
    t.add_argument("--p_way", type=float, default=3.0)
    t.add_argument("--p_progress", type=float, default=0.0)
    t.add_argument("--log_std_init", type=float, default=-1.0)
    t.add_argument("--bc_steps", type=int, default=0,
                   help="behavior-cloning fit steps before PPO (0 = off)")
    t.add_argument("--bc_expert", default="waypoint", choices=["waypoint", "rvo"])
    t.add_argument("--bc_dagger", type=int, default=0,
                   help="DAgger rounds after the first BC fit")
    t.add_argument("--bc_noise", type=float, default=0.0,
                   help="DART exploration noise std on executed demo actions")
    t.add_argument("--bc_margin", type=float, default=None,
                   help="RVO expert safety-margin inflation for demos")
    t.add_argument("--bc_demo_steps", type=int, default=200)
    t.add_argument("--bc_env_noise", action="store_true",
                   help="the env's control noise on during demo collection")
    t.add_argument("--bc_slowdown", action="store_true",
                   help="RVO expert aims to land on the active waypoint")
    t.add_argument("--bc_conflict_weight", type=float, default=1.0,
                   help="weight of BC rows with a flagged VO neighbour")
    t.add_argument("--adv_norm", action="store_true")
    t.add_argument("--ent_coef", type=float, default=0.0)
    t.add_argument("--fresh_logp", action="store_true")
    t.add_argument("--value_clip", type=float, default=0.0)
    t.add_argument("--vf_no_encoder", action="store_true",
                   help="exclude the shared encoder from the vf optimizer")
    t.add_argument("--freeze_encoder", action="store_true",
                   help="exclude the encoder from both optimizers")
    t.add_argument("--render_every", type=int, default=0,
                   help="every K epochs, record one episode of the current policy "
                        "and write media/epoch_K.gif in the run dir (needs "
                        "matplotlib; a failed render is printed; 0 = off)")
    t.add_argument("--train_noise", action="store_true",
                   help="control noise in the training rollouts")
    t.add_argument("--train_control_std", type=float, default=0.06)
    t.add_argument("--multi_worlds", default=None,
                   help="comma list of worlds ('name:rev' = route-reversed) "
                        "sharing --world's drone count; lane e trains scenario "
                        "e %% K and eval reports each population")
    t.add_argument("--minibatch", type=int, default=0)
    t.add_argument("--batched_update", action="store_true")
    t.add_argument("--unsafe_rewards", action="store_true")
    t.add_argument("--action_mode", default="increment",
                   choices=["increment", "direct"])
    t.add_argument("--pallas_gru", action="store_true",
                   help="recorded in the config; on CUDA the masked GRU always "
                        "runs the hand-written kernel")
    t.add_argument("--force_sequential", action="store_true",
                   help="accepted for the JAX CLI's scripts: the port never "
                        "switches the sequential update to the batched one")
    t.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel ranks over the lanes (= the process count)")
    t.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel ranks over the MLP and recurrent weights "
                        "(the mesh has mesh_data x mesh_model processes)")
    t.add_argument("--auto_mesh", action="store_true",
                   help="a mesh over every process that joined")
    t.add_argument("--quiet", action="store_true")
    t.add_argument("--eval_every", type=int, default=0)
    t.add_argument("--curriculum", default=None,
                   help="goal-threshold schedule, e.g. '1.2:80,0.8:80,0.4:rest'")
    t.add_argument("--eval_episodes", type=int, default=40)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="evaluate a policy")
    e.add_argument("--device", default="cuda")
    e.add_argument("--world", default="world_3")
    e.add_argument("--checkpoint", default=None,
                   help="run dir with ckpt/, or a PolicyServer.save .pt file")
    e.add_argument("--torch_checkpoint", default=None,
                   help="a reference policy's state dict (utils/torch_import.py)")
    e.add_argument("--rnn_mode", default="biGRU", choices=["GRU", "biGRU", "LSTM"],
                   help="the --torch_checkpoint policy's encoder")
    e.add_argument("--episodes", type=int, default=100)
    e.add_argument("--lanes", type=int, default=16)
    e.add_argument("--max_ep_len", type=int, default=150)
    e.add_argument("--acceler_vel", type=float, default=1.0)
    e.add_argument("--std_factor", type=float, default=1e-3)
    e.add_argument("--goal_threshold", type=float, default=None)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--ckpt_epoch", type=int, default=None,
                   help="checkpoint epoch to load (default: latest)")
    e.add_argument("--noise", action="store_true")
    e.add_argument("--control_std", type=float, default=0.06)
    e.add_argument("--reverse", action="store_true",
                   help="evaluate on the route-reversed scenario variant")
    e.add_argument("--results_file", default=None)
    e.add_argument("--action_mode", default="increment",
                   choices=["increment", "direct"])
    e.set_defaults(fn=cmd_eval)

    w = sub.add_parser("worldgen", help="generate a world")
    w.add_argument("--name", required=True)
    w.add_argument("--drones", type=int, default=4)
    w.add_argument("--map_size", type=int, nargs=3, default=[12, 12, 6])
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--k_sigma", type=float, default=2.0)
    w.add_argument("--n_low", type=int, default=1)
    w.add_argument("--out", default="worlds_data")
    w.set_defaults(fn=cmd_worldgen)

    r = sub.add_parser("render", help="render an episode to frames + gif + mp4")
    r.add_argument("--device", default="cuda")
    r.add_argument("--world", default="world_3")
    r.add_argument("--checkpoint", default=None,
                   help="run dir with ckpt/, or a PolicyServer.save .pt file")
    r.add_argument("--torch_checkpoint", default=None,
                   help="a reference biGRU policy's state dict")
    r.add_argument("--ckpt_epoch", type=int, default=None,
                   help="checkpoint epoch to render (default: latest)")
    r.add_argument("--acceler_vel", type=float, default=1.0)
    r.add_argument("--steps", type=int, default=100)
    r.add_argument("--every", type=int, default=2)
    r.add_argument("--out", default="render_out")
    r.add_argument("--cones", action="store_true",
                   help="overlay the live VO cones decoded from the observations")
    r.add_argument("--no_mp4", action="store_true")
    r.set_defaults(fn=cmd_render)

    pa = sub.add_parser("parity", help="fixed-seed parity check vs the oracle")
    pa.add_argument("--device", default="cuda", help="where the env steps")
    pa.add_argument("--worlds", nargs="+",
                    default=["gen_demo", "world16_dense", "world32_mix"],
                    help="world names or paths; the default is the worlds in "
                         "worlds_data/ (the JAX CLI's default world_2..world_8 "
                         "live in the reference fixtures, not in this repo)")
    pa.add_argument("--steps", type=int, default=200)
    pa.add_argument("--seed", type=int, default=7)
    pa.add_argument("--x64", action="store_true",
                    help="float64 env, held to 1e-12")
    pa.add_argument("--eval_mode", action="store_true",
                    help="env_train=False: the eval-time exp_radius collision "
                         "branch (rvo_inter.py:139-150)")
    pa.add_argument("--noise", action="store_true",
                    help="the same control-noise samples in both implementations")
    pa.set_defaults(fn=cmd_parity)

    b = sub.add_parser("bench", help="run the benchmark")
    b.add_argument("--device", default="cuda")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
