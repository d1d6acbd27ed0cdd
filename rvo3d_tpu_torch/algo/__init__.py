from rvo3d_tpu_torch.algo.evaluator import evaluate

__all__ = ["evaluate"]
