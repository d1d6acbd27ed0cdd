"""Typed configuration for the env, the policy and training.

The port's own copy of the JAX package's `EnvParams`, `ModelConfig`,
`TrainConfig`, `MeshConfig` and `Config` (rvo3d_tpu/config.py), field for
field, so a run directory's `config.json` written by either package loads
in both. The port's trainer (algo/trainer.py) reads TrainConfig; MeshConfig
is kept so that such files load (the port runs on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment parameters (defaults mirror the reference env:
    drone.py, ir_gym.py, rvo_inter.py, mdin.py)."""

    num_drones: int = 3
    neighbor_num: int = 10           # nm: max VO neighbour slots in the observation
    goal_threshold: float = 0.4
    radius: float = 0.2
    priority: float = 5.0
    dt: float = 1.0
    vel_max: float = 1.0             # per-axis max of the desired-velocity vector
    max_acc: float = 1.0
    max_angle_change: float = 90.0   # degrees
    acceler: float = 0.5             # abs_action = acceler*a_inc + cur_vel
    env_train: bool = True
    exp_radius: float = 0.2
    ctime_threshold: float = 2.0
    delta_t: float = 1.0
    drone_range: float = 10.0        # neighbour drone gate (10 m)
    building_range: float = 5.0      # building horizontal gate (5 m)
    building_z_slack: float = 2.0    # keep buildings with h > z - 2
    noise: bool = False              # Gaussian control noise on the position update
    control_std: float = 0.06
    rvo_p_base: float = -2.5
    rvo_p_urgent: float = -8.0
    mov_p_way: float = 3.0
    mov_p_dest: float = 20.0
    mov_p_exlen: float = -0.3
    mov_collision: float = -50.0
    mov_p_progress: float = 0.0      # potential-based progress shaping; 0 = off
    safe_rewards: bool = False       # False = parity: arrived drones get +inf rvo reward
    parity_rounding: bool = True     # the reference's decimal rounding of obs/rewards

    @property
    def rvo_state_dim(self) -> int:
        return 9

    @property
    def self_state_dim(self) -> int:
        return 12

    @property
    def obs_dim(self) -> int:
        return self.self_state_dim + self.rvo_state_dim * self.neighbor_num


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Policy network shape (defaults: the biGRU-256 flagship)."""

    state_dim: int = 12
    rnn_input_dim: int = 9
    rnn_hidden_dim: int = 256
    hidden_sizes_ac: Tuple[int, ...] = (256, 256)
    hidden_sizes_v: Tuple[int, ...] = (256, 256)
    rnn_mode: str = "biGRU"          # 'GRU' | 'biGRU' ('LSTM' is not ported yet)
    log_std_init: float = -1.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Read from config.json files only; the port decides nothing with it
    # (on CUDA the masked GRU always runs the hand-written kernel).
    use_pallas_gru: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """PPO hyperparameters (algo/rollout.py, algo/ppo.py, algo/trainer.py)."""

    pi_lr: float = 4e-6
    vf_lr: float = 5e-5
    train_epoch: int = 600
    steps_per_epoch: int = 300
    max_ep_len: int = 500
    gamma: float = 0.99
    lam: float = 0.97
    clip_ratio: float = 0.2
    train_pi_iters: int = 50
    train_v_iters: int = 50
    target_kl: float = 0.05
    max_update_num: int = 10
    grad_clip_norm: float = 2.0
    adv_norm: bool = False
    ent_coef: float = 0.0
    fresh_logp: bool = False
    value_clip: float = 0.0
    batched_update: bool = False
    minibatch: int = 0
    vf_encoder: bool = True
    freeze_encoder: bool = False
    action_mode: str = "increment"   # 'increment': abs = acceler*a + vel; 'direct': abs = a
    seed: int = 7
    save_freq: int = 50
    num_envs: int = 1
    std_factor_eval: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    env: EnvParams = dataclasses.field(default_factory=EnvParams)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    world: str = "world_3"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(d: dict) -> Config:
    return Config(
        env=EnvParams(**d.get("env", {})),
        model=ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d.get("model", {}).items()}),
        train=TrainConfig(**d.get("train", {})),
        mesh=MeshConfig(**d.get("mesh", {})),
        world=d.get("world", "world_3"),
    )
