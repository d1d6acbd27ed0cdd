"""Masked GRU scan over the neighbour axis: the hand-written CUDA kernel
(csrc/masked_gru.cu), its plain PyTorch version, and the autograd Function.

Counterpart of rvo3d_tpu/ops/pallas_gru.py (the Pallas TPU kernel
`_pallas_forward` -> `_kernel`, wrapped by the `masked_gru_scan` custom_vjp).

Shapes keep the JAX layout (B = flattened batch of agents, S = nm slots):
  xs    [S, B, IN]   any strides (the encoder passes a view of [B, nm, IN])
  mask  [S, B]       float 0/1 validity, any strides
  w_ih  [IN, 3H], w_hh [H, 3H], b_ih [3H], b_hh [3H]   torch gate order r, z, n
  out   [B, H]       the final hidden state; h0 = 0; the carry moves only
                     where mask > 0
`reverse=True` runs the slots from last to first (the biGRU's backward
direction) without copying xs.

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. The backward pass recomputes
through the plain scan, as the JAX custom_vjp does.
"""

from __future__ import annotations

import ctypes

import torch

from rvo3d_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (a run sets it to 0 to
# show that a path went through the kernel).
launches = 0

_C = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_C, _I64, _I64, _I64, _C, _I64, _I64, _C, _C, _C, _C, _C,
             _INT, _INT, _INT, _INT, _INT, _C]
MAX_HIDDEN = 256  # the kernel's one-thread-per-hidden-column limit


def masked_gru_scan_plain(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """The plain torch loop over S (semantics of gru_scan_reference)."""
    s_len = xs.shape[0]
    h = xs.new_zeros(xs.shape[1:-1] + (w_hh.shape[0],))
    for t in range(s_len):
        s = s_len - 1 - t if reverse else t
        gi = xs[s] @ w_ih + b_ih
        gh = h @ w_hh + b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        new = (1.0 - z) * n + z * h
        h = torch.where(mask[s][..., None] > 0, new, h)
    return h


def _check_cuda_args(xs, mask, w_ih, w_hh, b_ih, b_hh):
    if xs.dim() != 3:
        raise ValueError(f"xs must be [S, B, IN], got {tuple(xs.shape)}")
    s_len, b, in_dim = xs.shape
    hidden = w_hh.shape[0]
    expect = {"mask": (s_len, b), "w_ih": (in_dim, 3 * hidden),
              "w_hh": (hidden, 3 * hidden), "b_ih": (3 * hidden,),
              "b_hh": (3 * hidden,)}
    for name, t in zip(expect, (mask, w_ih, w_hh, b_ih, b_hh)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
    for name, t in zip(("xs", "mask", "w_ih", "w_hh", "b_ih", "b_hh"),
                       (xs, mask, w_ih, w_hh, b_ih, b_hh)):
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is {t.dtype}")
    for name, t in (("w_ih", w_ih), ("w_hh", w_hh), ("b_ih", b_ih), ("b_hh", b_hh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"the CUDA kernel takes 1 <= H <= {MAX_HIDDEN}, got H={hidden}")


def masked_gru_scan_cuda(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """Launch the CUDA kernel on the current stream; raises on a bad
    argument, a failed build or a failed launch."""
    global launches
    if not xs.is_cuda:
        raise ValueError("masked_gru_scan_cuda takes CUDA tensors")
    _check_cuda_args(xs, mask, w_ih, w_hh, b_ih, b_hh)
    lib = _build.load("masked_gru")
    fn = lib.masked_gru_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    s_len, b, in_dim = xs.shape
    hidden = w_hh.shape[0]
    out = torch.empty((b, hidden), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = fn(xs.data_ptr(), *xs.stride(), mask.data_ptr(), *mask.stride(),
                 w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
                 b_hh.data_ptr(), out.data_ptr(), s_len, b, in_dim, hidden,
                 int(bool(reverse)), stream)
    if err != 0:
        raise RuntimeError(f"masked_gru_forward launch failed: cudaError {err}")
    launches += 1
    return out


class MaskedGRUScan(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain scan on the CPU. Backward:
    recompute through the plain scan (the mask gets no gradient)."""

    @staticmethod
    def forward(ctx, xs, mask, w_ih, w_hh, b_ih, b_hh, reverse):
        ctx.save_for_backward(xs, mask, w_ih, w_hh, b_ih, b_hh)
        ctx.reverse = reverse
        if xs.is_cuda:
            return masked_gru_scan_cuda(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse)
        if xs.device.type == "cpu":
            return masked_gru_scan_plain(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse)
        raise ValueError(f"no masked GRU for device {xs.device}")

    @staticmethod
    def backward(ctx, grad_out):
        xs, mask, w_ih, w_hh, b_ih, b_hh = ctx.saved_tensors
        diff = [xs, None, w_ih, w_hh, b_ih, b_hh]
        need = [i for i, t in enumerate(diff)
                if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * 7
        if not need:
            return tuple(grads)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in need) if t is not None else mask
                      for i, t in enumerate(diff)]
            out = masked_gru_scan_plain(*leaves, reverse=ctx.reverse)
            got = torch.autograd.grad(out, [leaves[i] for i in need], grad_out)
        for i, g in zip(need, got):
            grads[i] = g
        return tuple(grads)


def masked_gru_scan(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """Final hidden state [B, H] of the masked GRU over xs [S, B, IN]."""
    return MaskedGRUScan.apply(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse)
