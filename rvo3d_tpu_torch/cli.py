"""Command-line entry points of the port: train and eval
(counterpart of rvo3d_tpu/cli.py).

    python -m rvo3d_tpu_torch.cli train --world world32_mix \\
        --multi_worlds world32_mix,world32_mix:rev --num_envs 64 ...
    python -m rvo3d_tpu_torch.cli eval --world world32_mix \\
        --checkpoint <run_dir> --ckpt_epoch 5 --reverse

A run directory gets the full config as JSON, train.jsonl, checkpoints
under ckpt/ (<epoch>/state.pt), results.txt (one line per evaluated
population, in the JAX CLI's format) and best_checkpoint.json. Both
commands run on `--device` (default cuda; without a card they raise).
Flags and commands that are not ported yet raise, naming their ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# flag -> (its default, the ROADMAP item of the port that will bring it)
NOT_PORTED = {
    "curriculum": (None, "A15"), "render_every": (0, "A15"),
    "torch_checkpoint": (None, "A16"), "mesh_data": (1, "A16"),
    "mesh_model": (1, "A16"), "auto_mesh": (False, "A16"),
}
COMMANDS_NOT_PORTED = {"worldgen": "A15", "render": "A15", "parity": "A15",
                       "bench": "A17"}


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


def _refuse_unported(args) -> None:
    for flag, (default, item) in NOT_PORTED.items():
        if getattr(args, flag, default) != default:
            raise SystemExit(f"--{flag} is not ported to rvo3d_tpu_torch yet "
                             f"(ROADMAP {item})")


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
                        log_std_init=args.log_std_init)
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


def cmd_train(args) -> int:
    import torch

    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.config import to_dict
    from rvo3d_tpu_torch.utils.checkpoint import (BestCheckpoint, restore_checkpoint,
                                                  save_checkpoint)
    from rvo3d_tpu_torch.utils.device import resolve_device
    from rvo3d_tpu_torch.utils.metrics import (JSONLLogger, plot_reward_curves,
                                               write_reward_csv)
    from rvo3d_tpu_torch.worlds.multi import stack_worlds, worlds_for_lanes

    _refuse_unported(args)
    dev = resolve_device(args.device)
    cfg, wd = _build_cfg(args)
    if args.bc_slowdown and args.bc_expert != "rvo":
        raise SystemExit("--bc_slowdown only affects the 'rvo' expert "
                         "(algo/bc.py collect_demos); pass --bc_expert rvo "
                         "or drop the flag")
    if args.bc_margin is not None and args.bc_expert != "rvo":
        raise SystemExit("--bc_margin only affects the 'rvo' expert; pass "
                         "--bc_expert rvo or drop the flag")
    run_dir = args.run_dir or _fresh_run_dir("runs_torch", f"r{wd.drone_num}")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    print(f"run dir: {run_dir}")

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
        print("multi-scenario lanes: "
              + ", ".join(f"{tok} x{int((idx == i).sum())}"
                          for i, (tok, _) in enumerate(lane_specs)))
        trainer = Trainer(cfg, world, lane_worlds=lane_worlds, device=dev)
    else:
        trainer = Trainer(cfg, world, device=dev)

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
                print(f"resumed from {resume_dir} @ epoch {start}"
                      + (" (params only, fresh optimizers)"
                         if args.resume_params_only else ""))
            except FileNotFoundError:
                if args.resume != "auto":
                    raise
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
        print(f"BC warm start [{scen}]: {args.bc_steps} steps "
              f"(dagger={args.bc_dagger}, noise={args.bc_noise}, "
              f"margin={args.bc_margin}, "
              f"cw={args.bc_conflict_weight}), final loss {bc_loss:.4f}")

    logger = JSONLLogger(os.path.join(run_dir, "train.jsonl"), echo=not args.quiet)
    ckpt_dir = os.path.join(run_dir, "ckpt")

    def save(epoch, state):
        save_checkpoint(ckpt_dir, epoch, state, cfg)

    # every persisted checkpoint is scored (plus the --eval_every cadence);
    # a multi-scenario run writes one results.txt line per population
    results_path = os.path.join(run_dir, "results.txt")
    best = BestCheckpoint(run_dir)

    def eval_fn(epoch, state, saved=True):
        targets = lane_specs or [(None, trainer.world)]
        min_success = 2.0
        for tok, sp in targets:
            m = evaluate(trainer.ac, sp, cfg.env,
                         generator=torch.Generator(device=dev).manual_seed(epoch),
                         num_episodes=args.eval_episodes, num_lanes=8,
                         std_factor=cfg.train.std_factor_eval,
                         action_mode=cfg.train.action_mode)
            tag = f" [{tok}]" if tok is not None else ""
            line = (f"epoch {epoch}{tag}: success {m['success_rate']:.2%} "
                    f"EpLen {m['mean_ep_len']}±{m['std_ep_len']} "
                    f"speed {m['mean_speed']}±{m['std_speed']}" + _eval_suffix(m))
            print(line)
            with open(results_path, "a") as f:
                f.write(line + "\n")
            min_success = min(min_success, m["success_rate"])
        best.update(epoch, min_success, saved)

    trainer.train(epochs=args.train_epoch, log_fn=logger.log, checkpoint_fn=save,
                  eval_fn=eval_fn, eval_every=args.eval_every)
    write_reward_csv(os.path.join(run_dir, "reward_curves.csv"), logger.read())
    plot_reward_curves(os.path.join(run_dir, "train.jsonl"),
                       os.path.join(run_dir, "reward_curves.png"))
    return 0


def cmd_eval(args) -> int:
    import dataclasses

    import torch

    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.config import EnvParams
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils.device import resolve_device
    from rvo3d_tpu_torch.worlds import load_world

    _refuse_unported(args)
    if not args.checkpoint:
        raise SystemExit("eval needs --checkpoint (a run dir, its ckpt/, or a "
                         "PolicyServer.save file)")
    dev = resolve_device(args.device)
    wd = load_world(args.world)
    eval_spec = _load_spec(args.world + (":rev" if args.reverse else ""), dev)
    env_p = EnvParams(num_drones=wd.drone_num)
    if args.goal_threshold is not None:
        env_p = dataclasses.replace(env_p, goal_threshold=args.goal_threshold)
    if args.noise:
        env_p = dataclasses.replace(env_p, noise=True, control_std=args.control_std)

    if args.checkpoint.endswith(".pt"):
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in COMMANDS_NOT_PORTED:
        raise SystemExit(f"'{argv[0]}' is not ported to rvo3d_tpu_torch yet "
                         f"(ROADMAP {COMMANDS_NOT_PORTED[argv[0]]}); the JAX "
                         "package's CLI has it")
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
    t.add_argument("--render_every", type=int, default=0, help="not ported (A15)")
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
    t.add_argument("--mesh_data", type=int, default=1, help="not ported (A16)")
    t.add_argument("--mesh_model", type=int, default=1, help="not ported (A16)")
    t.add_argument("--auto_mesh", action="store_true", help="not ported (A16)")
    t.add_argument("--quiet", action="store_true")
    t.add_argument("--eval_every", type=int, default=0)
    t.add_argument("--curriculum", default=None, help="not ported (A15)")
    t.add_argument("--eval_episodes", type=int, default=40)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="evaluate a policy")
    e.add_argument("--device", default="cuda")
    e.add_argument("--world", default="world_3")
    e.add_argument("--checkpoint", default=None,
                   help="run dir with ckpt/, or a PolicyServer.save .pt file")
    e.add_argument("--torch_checkpoint", default=None, help="not ported (A16)")
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

    for name, item in COMMANDS_NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported (ROADMAP {item})")

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
