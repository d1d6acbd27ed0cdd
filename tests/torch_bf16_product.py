"""The w16_r4 product's bfloat16 forward against its float32 forward, in the
JAX package and in the port, on the CPU: 4096 observation rows flown as
chip_smoke.py's `bf16_serve` flies them (256 lanes of world16_dense, 30
steps of the waypoint controller with noise; every row that saw a
neighbour, then the last step's). Prints one JSON line of max |d| pairs
(mu, v).

    JAX_PLATFORMS=cpu python tests/torch_bf16_product.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rvo3d_tpu.config import ModelConfig as JM  # noqa: E402
from rvo3d_tpu.models import ActorCritic as JAC  # noqa: E402
from rvo3d_tpu_torch.config import EnvParams, ModelConfig  # noqa: E402
from rvo3d_tpu_torch.env import DroneEnv, geometry as geo  # noqa: E402
from rvo3d_tpu_torch.models import ActorCritic  # noqa: E402
from rvo3d_tpu_torch.serving import PolicyServer  # noqa: E402
from rvo3d_tpu_torch.utils.convert import state_dict_to_flax  # noqa: E402
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller  # noqa: E402
from rvo3d_tpu_torch.worlds import load_world  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "rvo3d_tpu_torch", "assets", "w16_r4_e30.pt")


def main():
    srv = PolicyServer.from_checkpoint(ASSET, device="cpu")
    wd = load_world("world16_dense")
    world, p = wd.spec(device="cpu"), EnvParams(num_drones=16)
    env = DroneEnv(world, p, num_envs=256)
    g = torch.Generator().manual_seed(0)
    state, out = env.reset()
    rows = []
    for _ in range(30):
        noise = 0.5 * torch.randn(state.pos.shape, generator=g)
        state, out = env.step(state, geo.rnd(waypoint_controller(state, world) + noise, 2))
        state = env.reset_where(state, out.done)
        seen = out.obs_mask.any(-1)
        rows.append((out.obs_self[seen], out.obs_nbr[seen], out.obs_mask[seen]))
    flat = (out.obs_self.flatten(0, 1), out.obs_nbr.flatten(0, 1),
            out.obs_mask.flatten(0, 1))
    obs = [torch.cat([r[i] for r in rows] + [flat[i]])[:4096] for i in range(3)]
    cfg = srv.ac.cfg
    ac16 = ActorCritic(ModelConfig(**{**cfg.__dict__, "compute_dtype": "bfloat16"}),
                       device="cpu")
    ac16.load_state_dict(srv.ac.state_dict())
    with torch.no_grad():
        mu32, _, v32 = srv.ac(*obs)
        mu16, _, v16 = ac16(*obs)
    params = state_dict_to_flax(srv.ac.state_dict())
    kw = {k: v for k, v in cfg.__dict__.items() if k != "use_pallas_gru"}
    j32, j16 = JAC(JM(**kw)), JAC(JM(**{**kw, "compute_dtype": "bfloat16"}))
    o = [jnp.asarray(x.numpy()) for x in obs]
    jm32, _, jv32 = j32.apply(params, *o)
    jm16, _, jv16 = j16.apply(params, *o)

    def d(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    print(json.dumps({
        "port_bf16_vs_port_f32": [d(mu16, mu32), d(v16, v32)],
        "jax_bf16_vs_jax_f32": [d(jm16, jm32), d(jv16, jv32)],
        "port_bf16_vs_jax_bf16": [d(mu16, jm16), d(v16, jv16)],
        "port_f32_vs_jax_f32": [d(mu32, jm32), d(v32, jv32)],
        "v_range": [float(v32.min()), float(v32.max())],
        "rows_with_neighbour": int(obs[2].any(-1).sum())}))


if __name__ == "__main__":
    main()
