"""rvo3d_tpu_torch: the PyTorch / CUDA port of rvo3d_tpu for one NVIDIA H100.

Layout mirrors the JAX package (env/ models/ ops/ algo/ worlds/ utils/).
The port imports torch and numpy only; the JAX package is its reference,
held against it by tests/test_torch_*.py. Entry points default to
device='cuda'; pass device='cpu' to run on the CPU.
"""
