from rvo3d_tpu_torch.env.env import (DroneEnv, drone_states_12, observe, reset,
                                     reset_where, step)
from rvo3d_tpu_torch.env.state import (DroneState, StepOutput, WorldSpec,
                                       init_drone_state, make_world_spec)

__all__ = ["DroneEnv", "DroneState", "StepOutput", "WorldSpec",
           "drone_states_12", "init_drone_state", "make_world_spec",
           "observe", "reset", "reset_where", "step"]
