"""Score a committed product with both packages' evaluators on the CPU,
as the JAX CLI's `eval` does by default (16 lanes, 100 episodes, std
factor 1e-3, max_ep_len 150), over several seeds: the w16_r4 product
(runs/w16_r4 epoch 30) on world16_dense, or with --product w32_m3s the
w32_m3s product (runs/w32_m3s epoch 5) on world32_mix, with --reverse on
its route-reversed population. With --division-rounding the port's
float32 parity rounding divides by the scale instead of multiplying by
its reciprocal (its arithmetic before the fix of ROADMAP C5).

    JAX_PLATFORMS=cpu python tests/torch_eval_cpu.py [--seeds 0 1 2 3]
        [--product w16_r4|w32_m3s] [--reverse] [--lanes 16]
        [--episodes 100] [--division-rounding] [--skip-jax]

Prints one line per package and seed. Not collected by pytest: minutes
of CPU time.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--product", choices=["w16_r4", "w32_m3s"], default="w16_r4")
    ap.add_argument("--reverse", action="store_true")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--division-rounding", action="store_true")
    ap.add_argument("--skip-jax", action="store_true")
    args = ap.parse_args()

    import jax
    import torch

    from rvo3d_tpu.algo.evaluator import evaluate as j_evaluate
    from rvo3d_tpu.config import EnvParams as JEnvParams
    from rvo3d_tpu.worlds.loader import load_world_dir
    from rvo3d_tpu_torch.algo.evaluator import evaluate
    from rvo3d_tpu_torch.config import EnvParams
    from rvo3d_tpu_torch.env import geometry
    from rvo3d_tpu.worlds.multi import reverse_routes as j_reverse_routes
    from rvo3d_tpu_torch.worlds import load_world
    from rvo3d_tpu_torch.worlds.multi import reverse_routes
    from test_torch_product_asset import (RUN, RUN_W32, converted_product,
                                          restored_jax_product)

    run, epoch, world = ((RUN, 30, "world16_dense") if args.product == "w16_r4"
                         else (RUN_W32, 5, "world32_mix"))

    if args.division_rounding:
        def rnd(x, decimals, enabled=True):
            return torch.round(x, decimals=decimals) if enabled else x
        geometry.rnd = rnd
    kw = dict(num_episodes=args.episodes, num_lanes=args.lanes, action_mode="direct")
    wd = load_world(world)
    pop = f"{args.product} {world}" + (":rev" if args.reverse else "")
    if not args.skip_jax:
        jac, jparams = restored_jax_product(run, epoch)
        jspec = load_world_dir(wd.base_dir).spec()
        if args.reverse:
            jspec = j_reverse_routes(jspec)
        for seed in args.seeds:
            m = j_evaluate(jac, jparams, jspec, JEnvParams(num_drones=wd.drone_num),
                           jax.random.PRNGKey(seed), **kw)
            print("jax", pop, seed, m, flush=True)
    ac = converted_product(run, epoch).ac
    spec = wd.spec(device="cpu")
    if args.reverse:
        spec = reverse_routes(spec)
    tag = "port-division" if args.division_rounding else "port"
    for seed in args.seeds:
        m = evaluate(ac, spec, EnvParams(num_drones=wd.drone_num),
                     generator=torch.Generator().manual_seed(seed), **kw)
        print(tag, pop, seed, m, flush=True)


if __name__ == "__main__":
    main()
