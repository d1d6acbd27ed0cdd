"""The BC and expert diagnostics (counterparts of the JAX side's
scripts/{expert_eval,expert_noise_sweep,conflict_diag,bc_eval,bc_trace,
w3_diag}.py), one module each, run as

    python -m rvo3d_tpu_torch.diag.<name> [the script's arguments] [--device cuda]

Each takes the JAX script's positional arguments and defaults (the
defaults name the reference's world_2/3/4/8; any world load_world
resolves can be given instead) and writes under runs_torch/bc_evals/.
"""
