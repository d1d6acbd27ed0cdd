from rvo3d_tpu_torch.render.plot import ScenePlotter, cones_from_obs, record_trajectory
from rvo3d_tpu_torch.render.gif import frames_to_gif, frames_to_mp4

__all__ = ["ScenePlotter", "record_trajectory", "frames_to_gif",
           "frames_to_mp4", "cones_from_obs"]
