"""Masked recurrent neighbour encoder (counterpart of
rvo3d_tpu/models/encoder.py).

The neighbour axis is a fixed [nm] with a validity mask; the GRU's carry
advances only on valid slots, which equals running torch's GRU over the
packed valid prefix. Valid slots sit at the end of the axis in ascending
urgency. With no valid slot, the last (zero-padded) slot is activated: the
reference feeds one all-zero row. The biGRU sums the two directions' final
hidden states; LayerNorm uses eps 1e-5.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rvo3d_tpu_torch.ops.masked_gru import masked_bigru_scan, masked_gru_scan


class GRUCore(nn.Module):
    """One direction of a torch-layout GRU, gate order (r, z, n). Weights
    are stored [in, 3H] / [H, 3H], the layout the CUDA kernel reads."""

    def __init__(self, input_dim: int, hidden_dim: int, reverse: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.reverse = reverse
        self.w_ih = nn.Parameter(torch.empty(input_dim, 3 * hidden_dim))
        self.w_hh = nn.Parameter(torch.empty(hidden_dim, 3 * hidden_dim))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden_dim))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_dim)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def weights(self):
        return self.w_ih, self.w_hh, self.b_ih, self.b_hh

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """xs [S, B, IN] (any strides), mask [S, B] float -> [B, H]."""
        return masked_gru_scan(xs, mask, *self.weights(), self.reverse)


class NeighborEncoder(nn.Module):
    """(self_state [..., 12], neighbours [..., nm, 9], mask [..., nm]) ->
    LayerNorm(concat(self_state, h_rnn)) [..., 12 + H]."""

    def __init__(self, state_dim: int = 12, input_dim: int = 9,
                 hidden_dim: int = 256, mode: str = "biGRU"):
        super().__init__()
        if mode not in ("GRU", "biGRU"):
            raise NotImplementedError(f"rnn mode {mode!r} is not ported (GRU, biGRU)")
        self.mode = mode
        self.hidden_dim = hidden_dim
        self.fwd = GRUCore(input_dim, hidden_dim)
        if mode == "biGRU":
            self.bwd = GRUCore(input_dim, hidden_dim, reverse=True)
        self.ln = nn.LayerNorm(state_dim + hidden_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fwd.reset_parameters(generator)
        if self.mode == "biGRU":
            self.bwd.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, self_state, neighbors, mask):
        nm = neighbors.shape[-2]
        lead = neighbors.shape[:-2]
        last = torch.zeros(nm, dtype=torch.bool, device=mask.device)
        last[-1] = True
        mask = torch.where(mask.any(-1, keepdim=True), mask, last)
        x = neighbors.reshape(-1, nm, neighbors.shape[-1])     # [B, nm, IN]
        xs = x.transpose(0, 1)                                  # [nm, B, IN] view
        ms = mask.reshape(-1, nm).to(x.dtype).transpose(0, 1)   # [nm, B] view
        if self.mode == "biGRU":   # both directions in one kernel launch
            hn = masked_bigru_scan(xs, ms, self.fwd.weights(), self.bwd.weights())
        else:
            hn = self.fwd(xs, ms)
        hn = hn.reshape(lead + (self.hidden_dim,))
        return self.ln(torch.cat([self_state.to(hn.dtype), hn], dim=-1))
