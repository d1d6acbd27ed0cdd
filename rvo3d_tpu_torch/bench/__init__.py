"""Throughput benchmarks of the port on the card, the counterparts of the
JAX package's root bench.py and its scripts/*_bench.py:

    python -m rvo3d_tpu_torch.cli bench        core.py: env-steps/s, one JSON line
    python -m rvo3d_tpu_torch.bench.ladder     config-ladder rungs 4 and 5
    python -m rvo3d_tpu_torch.bench.detail     env sweep, policy rollout, PPO epoch
    python -m rvo3d_tpu_torch.bench.serving    PolicyServer.act latency by batch
    python -m rvo3d_tpu_torch.bench.gru        the masked-GRU kernel against plain

Each runs on `--device` (default cuda; without a card it raises) and
closes every timed window with torch.cuda.synchronize() on both sides.
The scripts write their JSON under runs_torch/bench/ at the repo root.
"""
