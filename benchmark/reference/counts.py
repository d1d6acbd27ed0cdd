"""The yardstick's operation and byte counts, and the card's peaks.

`gru_bound` is a frozen copy of chip_smoke.py's `gru_bound` (commit
9c4d68f085eba6da2a2a461640d8c4e22e7131e6, as restated in its PR 11 review
round), taking the [S, B] mask alone: the least time one launch of the
masked-GRU kernel needs on these inputs, the larger of its products at the
3xTF32 peak and its bytes at the HBM peak.

`policy_flops` counts the model FLOPs of the biGRU actor-critic: 2 per
multiply-add of the GRU's input product at every active slot, of its
hidden product at every active slot after a row's first (the carry is
still h0 = 0 there, as gru_bound counts), and of every dense layer; a
backward pass counts twice its forward. Element-wise work (gates,
LayerNorm, activations) is not counted.
"""

from __future__ import annotations

from typing import Sequence

import torch

# NVIDIA H100 SXM data sheet, dense rates
TF32_PEAK = 495e12
TF32X3_PEAK = TF32_PEAK / 3      # the kernel's 3xTF32 products
F32_PEAK = 67e12                 # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12


def slot_counts(mask: torch.Tensor):
    """(active slots, rows with an active slot) of an [S, B] mask."""
    m = mask.to(torch.float64)
    return float(m.sum()), float((m.sum(0) > 0).sum())


def gru_bound(mask: torch.Tensor, in_dim: int, hidden: int, ndirs: int = 2) -> dict:
    """The bound of one launch over `mask` [S, B] (the slots the kernel
    runs), IN = in_dim, H = hidden, one direction or both (a biGRU)."""
    s_len, b = mask.shape
    active, rows_active = slot_counts(mask)
    flops = 2.0 * ndirs * (active * in_dim + (active - rows_active) * hidden) * 3 * hidden
    weights = in_dim * 3 * hidden + hidden * 3 * hidden + 2 * 3 * hidden
    nbytes = 4.0 * (s_len * b * in_dim + s_len * b + ndirs * weights + ndirs * b * hidden)
    t_ops, t_bytes = flops / TF32X3_PEAK, nbytes / HBM_BYTES_S
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def mlp_flops(rows: float, dims: Sequence[int]) -> float:
    return 2.0 * rows * sum(a * b for a, b in zip(dims, dims[1:]))


def encoder_flops(mask: torch.Tensor, in_dim: int, hidden: int, ndirs: int = 2) -> float:
    """Forward FLOPs of the biGRU over `mask` [S, B] (the slots it runs)."""
    active, rows_active = slot_counts(mask)
    return 2.0 * ndirs * (active * in_dim + (active - rows_active) * hidden) * 3 * hidden


def policy_flops(mask: torch.Tensor, model: dict, heads: str = "actor",
                 backward: bool = False) -> float:
    """Model FLOPs of the encoder and the named heads ("actor", "critic",
    "both") on the rows of `mask` [S, B]; with `backward`, forward and
    backward (3x the forward)."""
    hidden, in_dim = model["rnn_hidden_dim"], model["rnn_input_dim"]
    feat = model["state_dim"] + hidden
    rows = mask.shape[1]
    total = encoder_flops(mask, in_dim, hidden)
    if heads in ("actor", "both"):
        total += mlp_flops(rows, [feat, *model["hidden_sizes_ac"], 3])
    if heads in ("critic", "both"):
        total += mlp_flops(rows, [feat, *model["hidden_sizes_v"], 1])
    return 3.0 * total if backward else total


def head_flops(rows: float, model: dict, head: str, backward: bool = False) -> float:
    """Dense FLOPs of one head alone on `rows` rows."""
    feat = model["state_dim"] + model["rnn_hidden_dim"]
    sizes = model["hidden_sizes_ac"] if head == "actor" else model["hidden_sizes_v"]
    total = mlp_flops(rows, [feat, *sizes, 3 if head == "actor" else 1])
    return 3.0 * total if backward else total
