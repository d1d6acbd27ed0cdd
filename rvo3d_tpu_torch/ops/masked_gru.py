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
direction) without copying xs. `masked_bigru_scan` runs both directions of
a biGRU in one launch and returns the sum of their final states.

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. The backward pass on the CPU
recomputes through the plain scan, as the JAX custom_vjp does; on CUDA
tensors it launches the hand-written backward (ops/gru_grad.py), which
walks only the active slots.

The kernel's geometry (cluster split of the hidden units, row tiles,
shared-memory bytes, grid) is computed here by `launch_geometry` and
handed to the launcher, so the CPU tests reach it. The same library holds
the one-thread %globaltimer stamp of the graphed steps (`globaltimer_stamp`,
launched by utils/profiler.stamp), so a checkout builds one library.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from rvo3d_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (a run sets it to 0 to
# show that a path went through the kernel).
launches = 0

MAX_HIDDEN = 256     # the largest H the kernel takes
CLUSTER = 8          # CTAs per cluster; each owns Hp / 8 hidden units
WARPS = 12           # per CTA; each owns one (16-row tile, 8-unit group) item
MAX_SMEM = 232448    # shared memory one block may use on Hopper
# rows per tile, in order of preference; the first that fits in shared
# memory is taken (64-row tiles do not fit two carries at H=256; PERF.md)
ROW_CHOICES = (48, 32, 16)


@dataclass(frozen=True)
class LaunchGeometry:
    batch: int
    hidden: int
    in_dim: int
    ndirs: int
    hidden_pad: int    # H padded to a multiple of 8 * CLUSTER
    rows: int          # R, rows per tile
    tiles: int         # ceil(B / R)
    clusters: int      # clusters launched (persistent over the work items)
    smem_bytes: int

    @property
    def units(self) -> int:
        """Hidden units per CTA (U)."""
        return self.hidden_pad // CLUSTER

    def rows_of(self, tile: int) -> range:
        """Batch rows the tile writes."""
        return range(tile * self.rows, min((tile + 1) * self.rows, self.batch))

    def units_of(self, rank: int) -> range:
        """Hidden units CTA `rank` of a cluster writes."""
        return range(rank * self.units, min((rank + 1) * self.units, self.hidden))

    def work_of(self, cluster: int) -> List[Tuple[int, int]]:
        """(tile, direction) items cluster `cluster` runs, in the kernel's
        order: a contiguous share of the direction-major item list."""
        n = self.tiles * self.ndirs
        lo, hi = cluster * n // self.clusters, (cluster + 1) * n // self.clusters
        return [(w % self.tiles, w // self.tiles) for w in range(lo, hi)]


def smem_bytes(hidden_pad: int, in_dim: int, rows: int) -> int:
    """The kernel's dynamic shared memory: the transposed W_hh and W_ih
    slices [3U, Hp] and [3U, KX] (KX = IN padded to a multiple of 32), two
    carries [R, Hp], two bias slices, the step's x tile [R, INp + 4] (INp =
    IN padded to a multiple of 8) and mask, and a 64-bit word of step
    flags."""
    n3 = 3 * (hidden_pad // CLUSTER)
    in_pad = -(-in_dim // 8) * 8
    kx = -(-in_pad // 32) * 32
    floats = (n3 * (hidden_pad + kx) + 2 * rows * hidden_pad + 2 * n3
              + rows * (in_pad + 4) + rows)
    return 4 * floats + 8


def launch_geometry(batch: int, hidden: int, in_dim: int, ndirs: int = 1,
                    max_clusters: int = 16) -> LaunchGeometry:
    """The launch of the kernel for B = batch rows, H = hidden, IN = in_dim
    and 1 or 2 directions, on a card that holds `max_clusters` clusters at
    once: tiles of the first of ROW_CHOICES rows that fits. Raises
    ValueError for what the kernel does not take."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"the CUDA kernel takes 1 <= H <= {MAX_HIDDEN}, got H={hidden}")
    if in_dim < 1 or batch < 0 or ndirs not in (1, 2):
        raise ValueError(f"bad shape: B={batch}, IN={in_dim}, ndirs={ndirs}")
    if max_clusters < 1:
        raise ValueError(f"the card holds no cluster ({max_clusters})")
    hp = -(-hidden // (8 * CLUSTER)) * (8 * CLUSTER)
    groups = hp // CLUSTER // 8
    for r in ROW_CHOICES:
        if (r // 16) * groups <= WARPS and smem_bytes(hp, in_dim, r) <= MAX_SMEM:
            break
    else:
        raise ValueError(
            f"no tile of {ROW_CHOICES} rows fits in {MAX_SMEM} bytes of shared "
            f"memory at H={hidden}, IN={in_dim}")
    tiles = -(-batch // r)
    return LaunchGeometry(batch, hidden, in_dim, ndirs, hp, r, tiles,
                          min(tiles * ndirs, max_clusters), smem_bytes(hp, in_dim, r))


class _Params(ctypes.Structure):
    """struct GruParams in csrc/masked_gru.cu."""
    _P2 = ctypes.c_void_p * 2
    _fields_ = [("xs", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("w_ih", _P2), ("w_hh", _P2), ("b_ih", _P2), ("b_hh", _P2),
                ("out", ctypes.c_void_p)]
    _fields_ += [(n, ctypes.c_int64) for n in ("xs_s", "xs_b", "xs_i", "m_s", "m_b")]
    _fields_ += [(n, ctypes.c_int) for n in ("S", "B", "IN", "H", "Hp", "rows",
                                             "ndirs", "reverse", "ntiles")]


_forward = _build.launcher("masked_gru", "masked_gru_forward",
                           [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int])
_max_clusters = _build.launcher("masked_gru", "masked_gru_max_active_clusters",
                                [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                                stream=False, counted=False)


@functools.lru_cache(maxsize=None)
def max_active_clusters(rows: int, smem: int, device_index: int = 0) -> int:
    """Clusters of 8 CTAs (tiles of `rows` rows, `smem` bytes each) that the
    card holds at once (cudaOccupancyMaxActiveClusters)."""
    n = ctypes.c_int(0)
    _max_clusters(torch.device("cuda", device_index), rows, smem, ctypes.byref(n))
    if n.value < 1:
        raise RuntimeError(f"the card holds no cluster of {CLUSTER} CTAs with "
                           f"{smem} bytes of shared memory")
    return n.value


@functools.lru_cache(maxsize=256)
def card_geometry(batch, hidden, in_dim, ndirs=1, device_index=0) -> LaunchGeometry:
    """launch_geometry with the card's cluster occupancy (cached: the main
    path launches the same few shapes hundreds of times)."""
    geo = launch_geometry(batch, hidden, in_dim, ndirs, 1)
    mc = max_active_clusters(geo.rows, geo.smem_bytes, device_index)
    return launch_geometry(batch, hidden, in_dim, ndirs, mc)


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


def masked_bigru_scan_plain(xs, mask, fwd_weights, bwd_weights):
    """The sum of the forward and the reversed plain scans."""
    return (masked_gru_scan_plain(xs, mask, *fwd_weights)
            + masked_gru_scan_plain(xs, mask, *bwd_weights, reverse=True))


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


def launch(xs, mask, weights: Sequence[Sequence[torch.Tensor]], reverse=False):
    """Launch the kernel on the current stream for one direction
    (`weights` = [(w_ih, w_hh, b_ih, b_hh)], walked in reverse if
    `reverse`) or both (`weights` = [fwd, bwd], summed). Raises on a bad
    argument, a failed build or a failed launch."""
    if not xs.is_cuda:
        raise ValueError("the masked GRU kernel takes CUDA tensors")
    if len(weights) not in (1, 2):
        raise ValueError(f"one or two directions, got {len(weights)}")
    for w in weights:
        _check_cuda_args(xs, mask, *w)
    if len(weights) == 2 and weights[0][1].shape != weights[1][1].shape:
        raise ValueError("the two directions have different hidden sizes")
    s_len, b, in_dim = xs.shape
    hidden = weights[0][1].shape[0]
    ndirs = len(weights)
    # two directions are added into `out` with atomics, from zero
    out = (torch.zeros if ndirs == 2 else torch.empty)(
        (b, hidden), dtype=torch.float32, device=xs.device)
    if b == 0:
        return out
    dev = xs.device.index if xs.device.index is not None else torch.cuda.current_device()
    geo = card_geometry(b, hidden, in_dim, ndirs, dev)
    p = _Params()
    p.xs, p.mask, p.out = xs.data_ptr(), mask.data_ptr(), out.data_ptr()
    for d in range(2):
        w_ih, w_hh, b_ih, b_hh = weights[min(d, ndirs - 1)]
        p.w_ih[d], p.w_hh[d] = w_ih.data_ptr(), w_hh.data_ptr()
        p.b_ih[d], p.b_hh[d] = b_ih.data_ptr(), b_hh.data_ptr()
    p.xs_s, p.xs_b, p.xs_i = xs.stride()
    p.m_s, p.m_b = mask.stride()
    p.S, p.B, p.IN, p.H, p.Hp = s_len, b, in_dim, hidden, geo.hidden_pad
    p.rows, p.ndirs, p.ntiles = geo.rows, ndirs, geo.tiles
    p.reverse = int(bool(reverse))
    _forward(xs.device, ctypes.byref(p), geo.clusters, geo.smem_bytes)
    return out


def masked_gru_scan_cuda(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """One direction through the kernel."""
    return launch(xs, mask, [(w_ih, w_hh, b_ih, b_hh)], reverse)


def masked_bigru_scan_cuda(xs, mask, fwd_weights, bwd_weights):
    """Both directions through one launch of the kernel, summed."""
    return launch(xs, mask, [fwd_weights, bwd_weights])


class MaskedGRUScan(torch.autograd.Function):
    """One direction (4 weight tensors, `reverse` honoured) or a biGRU
    (8 weight tensors: forward then backward direction, summed). Forward:
    the kernel on CUDA, the plain scans on the CPU. Backward: the backward
    kernel on CUDA, a recompute through the plain scans on the CPU (the
    mask gets no gradient)."""

    @staticmethod
    def _sets(weights):
        """The weights as launch and backward take them: one or two sets."""
        return [weights[:4]] if len(weights) == 4 else [weights[:4], weights[4:]]

    @staticmethod
    def _plain(xs, mask, reverse, weights):
        if len(weights) == 8:
            return masked_bigru_scan_plain(xs, mask, weights[:4], weights[4:])
        return masked_gru_scan_plain(xs, mask, *weights, reverse=reverse)

    @staticmethod
    def forward(ctx, xs, mask, reverse, *weights):
        ctx.save_for_backward(xs, mask, *weights)
        ctx.reverse = reverse
        if xs.is_cuda:
            return launch(xs, mask, MaskedGRUScan._sets(weights), reverse)
        if xs.device.type == "cpu":
            return MaskedGRUScan._plain(xs, mask, reverse, weights)
        raise ValueError(f"no masked GRU for device {xs.device}")

    @staticmethod
    def backward(ctx, grad_out):
        xs, mask, *weights = ctx.saved_tensors
        diff = [xs, None, None, *weights]          # mask and reverse: no grad
        need = [i for i, t in enumerate(diff)
                if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * len(diff)
        if not need:
            return tuple(grads)
        if xs.is_cuda:
            from rvo3d_tpu_torch.ops import gru_grad   # it imports this module

            w_grads, d_xs = gru_grad.backward(xs, mask, MaskedGRUScan._sets(weights),
                                              grad_out, ctx.reverse, want_dx=0 in need)
            got = [d_xs, None, None, *(g for w in w_grads for g in w)]
            return tuple(got[i] if i in need else None for i in range(len(diff)))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in need) if t is not None else None
                      for i, t in enumerate(diff)]
            out = MaskedGRUScan._plain(leaves[0], mask, ctx.reverse, leaves[3:])
            got = torch.autograd.grad(out, [leaves[i] for i in need], grad_out)
        for i, g in zip(need, got):
            grads[i] = g
        return tuple(grads)


def masked_gru_scan(xs, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """Final hidden state [B, H] of the masked GRU over xs [S, B, IN]."""
    return MaskedGRUScan.apply(xs, mask, reverse, w_ih, w_hh, b_ih, b_hh)


def masked_bigru_scan(xs, mask, fwd_weights, bwd_weights):
    """Sum of the forward and reversed directions' final states [B, H];
    each of `fwd_weights`, `bwd_weights` is (w_ih, w_hh, b_ih, b_hh)."""
    return MaskedGRUScan.apply(xs, mask, False, *fwd_weights, *bwd_weights)
