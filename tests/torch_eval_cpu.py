"""Score the w16_r4 product (runs/w16_r4 epoch 30) with both packages'
evaluators on the CPU, as the JAX CLI's `eval` does by default (16 lanes,
100 episodes, std factor 1e-3, max_ep_len 150, world16_dense), over
several seeds; with --division-rounding the port's float32 parity
rounding divides by the scale instead of multiplying by its reciprocal
(its arithmetic before the fix of ROADMAP C5).

    JAX_PLATFORMS=cpu python tests/torch_eval_cpu.py [--seeds 0 1 2 3]
        [--lanes 16] [--episodes 100] [--division-rounding] [--skip-jax]

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
    from rvo3d_tpu_torch.worlds import load_world
    from test_torch_product_asset import converted_product, restored_jax_product

    if args.division_rounding:
        def rnd(x, decimals, enabled=True):
            return torch.round(x, decimals=decimals) if enabled else x
        geometry.rnd = rnd
    kw = dict(num_episodes=args.episodes, num_lanes=args.lanes, action_mode="direct")
    wd = load_world("world16_dense")
    if not args.skip_jax:
        jac, jparams = restored_jax_product()
        jspec = load_world_dir(wd.base_dir).spec()
        for seed in args.seeds:
            m = j_evaluate(jac, jparams, jspec, JEnvParams(num_drones=wd.drone_num),
                           jax.random.PRNGKey(seed), **kw)
            print("jax", seed, m, flush=True)
    ac = converted_product().ac
    spec = wd.spec(device="cpu")
    tag = "port-division" if args.division_rounding else "port"
    for seed in args.seeds:
        m = evaluate(ac, spec, EnvParams(num_drones=wd.drone_num),
                     generator=torch.Generator().manual_seed(seed), **kw)
        print(tag, seed, m, flush=True)


if __name__ == "__main__":
    main()
