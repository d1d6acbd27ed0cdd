"""Second witnesses for the PPO phase of the w32_m3s recipe (world32_mix
and its route-reversed variant, 64 lanes x 32 drones; scripts/
round5_tpu_queue3.sh:97-105), run through the port's CLI and, on the CPU
at a reduced lane count, through the JAX package's.

    # CPU, JAX package: the runs/w32_m3s epoch-5 state (params and both
    # Adam states) as a port checkpoint, OUT/tpu_e5/ckpt/5/state.pt
    JAX_PLATFORMS=cpu python tests/torch_ppo_witness.py tpu-state OUT

    # card, the port alone, at the recipe's width:
    #   from_tpu_e5  5 PPO epochs from that state (the TPU run's epochs 6-10)
    #   recipe       the recipe (BC + epochs 0-5) with a det eval after
    #                every epoch; its epoch-0 state goes to OUT/recipe_e0
    #                (skipped where OUT holds recipe_e0 already)
    python tests/torch_ppo_witness.py card OUT [--seeds 7 ...]

    # card, the port alone: 5 PPO epochs at 8 lanes (the JAX witness's
    # width) from OUT/<start> (recipe_e0 or tpu_e5)
    python tests/torch_ppo_witness.py card-reduced OUT [--start S] [--seeds 7 ...]

    # CPU, JAX package: the same from the same start, through the JAX CLI
    JAX_PLATFORMS=cpu python tests/torch_ppo_witness.py jax OUT [--start S] [--seeds 7 ...]

--seeds repeats a run once for each training seed (default 7, the
recipe's); a run of another seed than 7 is named with _s<seed>, and a
reduced run from tpu_e5 with _from_tpu_e5.

Every run evaluates det (std factor 1e-3) on both populations after every
epoch (results.txt lines, as the CLIs write them) and replays the first
episode of each eval lane with the port's env and the port eval's draws
(for the JAX run's checkpoints that is another draw than its own eval) to
name the first failure: the step, the drones whose collision flag rose,
and each one's nearest drone and its distance. Writes OUT/<run>/witness.json. Not
collected by pytest: minutes of card or CPU time.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUN_W32 = os.path.join(REPO, "runs", "w32_m3s")
POPULATIONS = ("world32_mix", "world32_mix:rev")
EPOCHS = 4          # --train_epoch: epochs 0..4, five PPO epochs
STARTS = {"recipe_e0": 0, "tpu_e5": 5}   # a reduced run's start: its epoch
LANES = 8           # a reduced run's lanes, 4 of each population
EVAL_LANES, MAX_EP_LEN = 8, 150   # the CLIs' evaluation during training


def recipe_flags(device, lanes=64, episodes=100, seed=7):
    return ["train", "--device", device, "--world", "world32_mix",
            "--num_envs", str(lanes), "--steps_per_epoch", "300",
            "--action_mode", "direct", "--log_std_init", "-2.3", "--target_kl", "0.01",
            "--train_pi_iters", "20", "--train_v_iters", "50", "--batched_update",
            "--minibatch", "16384", "--pi_lr", "1e-6", "--vf_lr", "5e-5",
            "--save_freq", "1", "--eval_every", "1", "--eval_episodes", str(episodes),
            "--seed", str(seed), "--vf_no_encoder", "--quiet",
            "--multi_worlds", ",".join(POPULATIONS)]


def bc_flags():
    return ["--bc_steps", "2000", "--bc_expert", "rvo", "--bc_dagger", "3",
            "--bc_noise", "0.1", "--bc_margin", "0.3", "--bc_slowdown"]


def first_failure(ac, token, device, seed, std_factor):
    """The first episode of each of the CLI eval's lanes for population
    `token`, replayed with its draws (a generator seeded with the epoch):
    how many lanes fail, and the earliest collision: its step, lane, the
    drones whose flag rose and each one's nearest drone and distance."""
    import torch

    from rvo3d_tpu_torch.cli import _load_spec
    from rvo3d_tpu_torch.config import EnvParams
    from rvo3d_tpu_torch.env import geometry as geo
    from rvo3d_tpu_torch.env.env import observe, reset, step

    spec = _load_spec(token, device)
    p = EnvParams(num_drones=spec.num_drones)
    gen = torch.Generator(device=device).manual_seed(seed)
    failed = torch.zeros(EVAL_LANES, dtype=torch.bool, device=device)
    over = torch.zeros_like(failed)
    first = None
    with torch.no_grad():
        state = reset(spec, p, (EVAL_LANES,))
        out, state = observe(spec, state, p)
        for t in range(1, MAX_EP_LEN + 1):
            a = ac.step(out.obs_self, out.obs_nbr, out.obs_mask, std_factor, gen).action
            state, out = step(spec, state, geo.rnd(a, 2, p.parity_rounding), p, None)
            hit = out.done.any(-1) & ~over
            if first is None and hit.any():
                lane = int(hit.nonzero()[0])
                pos = state.pos[lane].double()
                d = torch.cdist(pos, pos) + torch.eye(len(pos), device=device) * 1e9
                drones = out.done[lane].nonzero().flatten().tolist()
                first = {"step": t, "lane": lane, "drones": drones,
                         "nearest": [[i, int(d[i].argmin()), float(d[i].min())]
                                     for i in drones],
                         "finished": int(out.finish[lane].sum())}
            failed |= hit
            over |= hit | out.finish.all(-1)
            if over.all():
                break
    return {"population": token, "lanes": EVAL_LANES, "failed_lanes": int(failed.sum()),
            "unended_lanes": int((~over).sum()), "first_collision": first}


def port_failures(ckpt_dir, device):
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.utils.checkpoint import saved_epochs

    out = {}
    for e in saved_epochs(ckpt_dir):
        server = PolicyServer.from_torch(ckpt_dir, e, device=device)
        out[e] = [first_failure(server.ac, tok, device, e,
                                server.config.train.std_factor_eval)
                  for tok in POPULATIONS]
    return out


def port_run(name, argv, out, device, keep_epoch=None):
    from rvo3d_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, name)
        rc = cli.main(argv + ["--run_dir", run_dir])
        with open(os.path.join(run_dir, "results.txt")) as f:
            results = [ln.rstrip("\n") for ln in f]
        rec = {"run": name, "argv": argv, "rc": rc, "results": results,
               "first_failure": port_failures(os.path.join(run_dir, "ckpt"), device)}
        if keep_epoch is not None:
            dst = os.path.join(out, f"{name}_e{keep_epoch}")
            os.makedirs(os.path.join(dst, "ckpt", str(keep_epoch)), exist_ok=True)
            for rel in ("config.json", os.path.join("ckpt", "config.json"),
                        os.path.join("ckpt", str(keep_epoch), "state.pt")):
                shutil.copy(os.path.join(run_dir, rel), os.path.join(dst, rel))
    write(out, name, rec)
    return rec


def write(out, name, rec):
    os.makedirs(os.path.join(out, name), exist_ok=True)
    with open(os.path.join(out, name, "witness.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


def card_check():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the card runs need CUDA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def cmd_card(args):
    card_check()
    tpu = os.path.join(args.out, "tpu_e5", "ckpt")
    for seed in args.seeds:
        port_run("from_tpu_e5" + tag(seed), recipe_flags("cuda", seed=seed) + [
            "--resume", tpu, "--resume_epoch", "5", "--train_epoch", str(EPOCHS)],
            args.out, "cuda")
    if not os.path.isdir(os.path.join(args.out, "recipe_e0", "ckpt")):
        port_run("recipe", recipe_flags("cuda") + bc_flags() + ["--train_epoch", "5"],
                 args.out, "cuda", keep_epoch=0)


def cmd_card_reduced(args):
    card_check()
    for seed in args.seeds:
        port_run(reduced_name("reduced", args.start, seed),
                 recipe_flags("cuda", LANES, 64, seed) + [
                     "--resume", os.path.join(args.out, args.start, "ckpt"),
                     "--resume_epoch", str(STARTS[args.start]),
                     "--train_epoch", str(EPOCHS)], args.out, "cuda")


def reduced_name(prefix, start, seed):
    return prefix + ("" if start == "recipe_e0" else "_from_" + start) + tag(seed)


def tag(seed):
    return "" if seed == 7 else f"_s{seed}"


def jax_template(cfg):
    import jax
    import jax.numpy as jnp

    from rvo3d_tpu.algo.ppo import PPOState, make_optimizers
    from rvo3d_tpu.models import ActorCritic as JActorCritic

    jac = JActorCritic(cfg.model)
    params = jac.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                      jnp.zeros((1, cfg.env.neighbor_num, 9)),
                      jnp.zeros((1, cfg.env.neighbor_num), bool))
    pi_tx, vf_tx = make_optimizers(cfg.train, params)
    return PPOState(params=params, pi_opt=pi_tx.init(params), vf_opt=vf_tx.init(params))


def cmd_tpu_state(args):
    """runs/w32_m3s/ckpt/5, params and both Adam states, as a port checkpoint."""
    import jax
    import numpy as np

    from rvo3d_tpu.utils.checkpoint import load_config as j_load_config
    from rvo3d_tpu.utils.checkpoint import restore_checkpoint as j_restore
    from rvo3d_tpu_torch.algo.ppo import PPOState, make_optimizers
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.utils.checkpoint import load_config, save_checkpoint
    from rvo3d_tpu_torch.utils.convert import flax_to_state_dict, optax_adam_to_torch

    state, epoch = j_restore(os.path.join(RUN_W32, "ckpt"),
                             jax_template(j_load_config(RUN_W32)), epoch=5)
    state = jax.tree_util.tree_map(np.asarray, state)
    cfg = load_config(RUN_W32)
    ac = ActorCritic(cfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(state.params))
    pi_opt, vf_opt = make_optimizers(cfg.train, ac)
    optax_adam_to_torch(state.pi_opt, pi_opt, ac)
    optax_adam_to_torch(state.vf_opt, vf_opt, ac)
    path = save_checkpoint(os.path.join(args.out, "tpu_e5", "ckpt"), epoch,
                           PPOState(ac, pi_opt, vf_opt), cfg)
    print(path, "pi Adam step", float(next(iter(pi_opt.state.values()))["step"]))


def cmd_jax(args):
    """The JAX CLI's PPO from a start state (a port checkpoint)."""
    import jax
    import numpy as np

    from rvo3d_tpu.config import from_dict as j_from_dict
    from rvo3d_tpu_torch.algo.ppo import PPOState, make_optimizers
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.utils.checkpoint import load_config, restore_checkpoint
    from rvo3d_tpu_torch.utils.convert import state_dict_to_flax, torch_adam_to_optax

    src = os.path.join(args.out, args.start, "ckpt")
    cfg = load_config(src)
    ac = ActorCritic(cfg.model, device="cpu")
    pi_opt, vf_opt = make_optimizers(cfg.train, ac)
    restore_checkpoint(src, PPOState(ac, pi_opt, vf_opt), epoch=STARTS[args.start])
    with open(os.path.join(src, "config.json")) as f:
        jcfg = j_from_dict(json.load(f))
    tmpl = jax.tree_util.tree_map(np.asarray, jax_template(jcfg))
    jstate = tmpl._replace(params=state_dict_to_flax(ac.state_dict()),
                           pi_opt=torch_adam_to_optax(pi_opt, ac, tmpl.pi_opt),
                           vf_opt=torch_adam_to_optax(vf_opt, ac, tmpl.vf_opt))
    for seed in args.seeds:
        jax_run(args, seed, jstate, jcfg, ac, cfg)


def jax_run(args, seed, jstate, jcfg, ac, cfg):
    import jax
    import numpy as np

    from rvo3d_tpu import cli as j_cli
    from rvo3d_tpu.utils.checkpoint import restore_checkpoint as j_restore
    from rvo3d_tpu.utils.checkpoint import save_checkpoint as j_save
    from rvo3d_tpu_torch.utils.convert import flax_to_state_dict

    name = reduced_name("jax_reduced", args.start, seed)
    with tempfile.TemporaryDirectory() as tmp:
        start = os.path.join(tmp, "start")
        j_save(start, 0, jstate, jcfg)
        run_dir = os.path.join(tmp, name)
        argv = [a for a in recipe_flags("cpu", LANES, 64, seed)
                if a not in ("--device", "cpu")]
        argv += ["--resume", start, "--resume_epoch", "0", "--train_epoch", str(EPOCHS),
                 "--run_dir", run_dir]
        rc = j_cli.main(argv)
        with open(os.path.join(run_dir, "results.txt")) as f:
            results = [ln.rstrip("\n") for ln in f]
        failures = {}
        ckpt = os.path.join(run_dir, "ckpt")
        for e in sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()):
            got, _ = j_restore(ckpt, jstate, epoch=e, params_only=True)
            ac.load_state_dict(flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, got.params)))
            failures[e] = [first_failure(ac, tok, "cpu", e, cfg.train.std_factor_eval)
                           for tok in POPULATIONS]
    write(args.out, name, {"run": name, "argv": argv, "rc": rc,
                           "results": results, "first_failure": failures})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["tpu-state", "card", "card-reduced", "jax"])
    ap.add_argument("out")
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--start", choices=sorted(STARTS), default="recipe_e0")
    args = ap.parse_args()
    {"tpu-state": cmd_tpu_state, "card": cmd_card, "card-reduced": cmd_card_reduced,
     "jax": cmd_jax}[args.cmd](args)


if __name__ == "__main__":
    main()
