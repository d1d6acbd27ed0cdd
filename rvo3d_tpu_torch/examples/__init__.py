"""Runnable examples of the port (counterparts of the JAX side's
examples/): `python -m rvo3d_tpu_torch.examples.<name>`."""
