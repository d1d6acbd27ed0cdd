from rvo3d_tpu_torch.models.actor_critic import ActorCritic, PolicyStep
from rvo3d_tpu_torch.models.encoder import GRUCore, NeighborEncoder

__all__ = ["ActorCritic", "PolicyStep", "GRUCore", "NeighborEncoder"]
