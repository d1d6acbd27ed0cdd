"""Masked recurrent neighbour encoder (counterpart of
rvo3d_tpu/models/encoder.py).

The neighbour axis is a fixed [nm] with a validity mask; the GRU's carry
advances only on valid slots, which equals running torch's GRU over the
packed valid prefix. Valid slots sit at the end of the axis in ascending
urgency. With no valid slot, the last (zero-padded) slot is activated: the
reference feeds one all-zero row. The biGRU sums the two directions' final
hidden states; the LSTM passes on h_n only; LayerNorm uses eps 1e-5.

Dtypes follow flax's param_dtype/compute_dtype rule: the recurrent weights
are stored in the parameter dtype, the inputs and weights are cast to the
compute dtype (float32 or bfloat16), and the LayerNorm's parameters stay
float32. The GRU directions then run through the masked-GRU scan in
float32 on those (possibly bfloat16-rounded) operands: the Pallas kernel's
own rule (bf16 operands, float32 accumulation and carry), on the card
through the CUDA kernel. The LSTM runs wholly in the compute dtype, its
carry included, as the JAX `lax.scan` does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rvo3d_tpu_torch.ops.masked_gru import masked_bigru_scan, masked_gru_scan
from rvo3d_tpu_torch.parallel.tensor_parallel import gather_from_model


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

    def weights(self, dtype: torch.dtype = torch.float32):
        """The four weights, whole (gathered over the model axis where
        tensor parallelism shards them), rounded to `dtype`, as float32
        (the scan's operand type); the parameters themselves when nothing
        gathers or rounds."""
        return tuple(gather_from_model(w).to(dtype).to(torch.float32)
                     for w in (self.w_ih, self.w_hh, self.b_ih, self.b_hh))

    def forward(self, xs: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """xs [S, B, IN] (any strides, float32 values of `dtype`), mask
        [S, B] float -> [B, H] float32."""
        return masked_gru_scan(xs, mask, *self.weights(dtype), self.reverse)


class LSTMCore(nn.Module):
    """One direction of a torch-layout LSTM, gate order (i, f, g, o),
    weights [in, 4H] / [H, 4H]. A plain loop over the S slots; the carry
    (h, c) moves only where the mask is set, and h_n is returned."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.w_ih = nn.Parameter(torch.empty(input_dim, 4 * hidden_dim))
        self.w_hh = nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim))
        self.b_ih = nn.Parameter(torch.empty(4 * hidden_dim))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden_dim))

    reset_parameters = GRUCore.reset_parameters

    def forward(self, xs: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """xs [S, B, IN], mask [S, B] float -> [B, H], all in `dtype`."""
        w_ih, w_hh, b_ih, b_hh = (gather_from_model(w).to(dtype) for w in
                                  (self.w_ih, self.w_hh, self.b_ih, self.b_hh))
        xs = xs.to(dtype)
        h = xs.new_zeros(xs.shape[1:-1] + (self.hidden_dim,))
        c = torch.zeros_like(h)
        for s in range(xs.shape[0]):
            g = xs[s] @ w_ih + b_ih + h @ w_hh + b_hh
            i, f, gg, o = g.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            keep = mask[s][..., None] > 0
            h, c = torch.where(keep, h_new, h), torch.where(keep, c_new, c)
        return h


class NeighborEncoder(nn.Module):
    """(self_state [..., 12], neighbours [..., nm, 9], mask [..., nm]) ->
    LayerNorm(concat(self_state, h_rnn)) [..., 12 + H]."""

    def __init__(self, state_dim: int = 12, input_dim: int = 9,
                 hidden_dim: int = 256, mode: str = "biGRU",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("GRU", "biGRU", "LSTM"):
            raise ValueError(f"unknown rnn mode {mode!r} (GRU, biGRU, LSTM)")
        self.mode = mode
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        self.fwd = (LSTMCore if mode == "LSTM" else GRUCore)(input_dim, hidden_dim)
        if mode == "biGRU":
            self.bwd = GRUCore(input_dim, hidden_dim, reverse=True)
        self.ln = nn.LayerNorm(state_dim + hidden_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fwd.reset_parameters(generator)
        if self.mode == "biGRU":
            self.bwd.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, self_state, neighbors, mask):
        """Features [..., 12 + H] in the compute dtype, whatever the
        observations' dtype."""
        cdt = self.compute_dtype
        self_state, neighbors = self_state.to(cdt), neighbors.to(cdt)
        if self.mode != "LSTM":        # the scan's operands: float32 values of cdt
            neighbors = neighbors.to(torch.float32)
        nm = neighbors.shape[-2]
        lead = neighbors.shape[:-2]
        # made on the device: a CUDA graph cannot hold a host-to-device copy
        last = torch.arange(nm, device=mask.device) == nm - 1
        mask = torch.where(mask.any(-1, keepdim=True), mask, last)
        x = neighbors.reshape(-1, nm, neighbors.shape[-1])     # [B, nm, IN]
        xs = x.transpose(0, 1)                                  # [nm, B, IN] view
        ms = mask.reshape(-1, nm).to(x.dtype).transpose(0, 1)   # [nm, B] view
        if self.mode == "biGRU":   # both directions in one kernel launch
            hn = masked_bigru_scan(xs, ms, self.fwd.weights(cdt), self.bwd.weights(cdt))
        else:
            hn = self.fwd(xs, ms, cdt)
        hn = hn.to(cdt).reshape(lead + (self.hidden_dim,))
        feat = torch.cat([self_state, hn], dim=-1)
        # float32 statistics and parameters over the compute-dtype features,
        # as flax's LayerNorm computes them; the result in the compute dtype
        return self.ln(feat.to(self.ln.weight.dtype)).to(cdt)
