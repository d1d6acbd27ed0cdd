"""The masked GRU scan's backward as one hand-written CUDA pass
(csrc/gru_grad.cu): its launch geometry, the ctypes binding and the entry
point `MaskedGRUScan.backward` (ops/masked_gru.py) takes for CUDA tensors.

  backward(xs, mask, weights, grad_out, reverse=False, want_dx=False)
      -> ([(d_w_ih, d_w_hh, d_b_ih, d_b_hh)] per direction, d_xs or None)

The arguments are those of ops/masked_gru.launch: xs [S, B, IN] and mask
[S, B] with any strides, one direction's (w_ih, w_hh, b_ih, b_hh) walked
in reverse if `reverse`, or a biGRU's two (the second in reverse), and
grad_out [B, H], the gradient of the final state (of the directions' sum).
The semantics are autograd's through masked_gru_scan_plain, which the CPU
keeps and the card tests hold the kernel to. The kernel replaces no TPU
kernel (see the note in its source).

One launcher call runs three kernels: W_hh's transpose, the walk over row
tiles (one block a share of the tiles; work only at active slots, W_hh
only after a row's first) and the fixed-order sum of the blocks'
partials. Every buffer is allocated here from the shapes, so a CUDA graph
captures the call. While the recorder is on (utils/profiler.py), each call
adds to the counters `gru_grad.launches`, `gru_grad.rows` (B) and
`gru_grad.slots` (S x B x directions: the dense slots a recompute through
the plain scan walks); a CUDA graph's replays add what its capture took.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.ops import masked_gru as mg
from rvo3d_tpu_torch.utils import profiler

launches = 0             # launcher calls since the last reset

ROWS = 32                # rows a tile
IN_PADS = (12, 16)       # the x row widths the kernel is built for
MAX_SLOTS = 64           # a step's active rows are bits of one word per slot
MAX_BLOCKS = 1024        # walk blocks the sum kernel lists


@dataclass(frozen=True)
class GradGeometry:
    batch: int
    hidden: int
    in_dim: int
    slots: int
    ndirs: int
    hidden_stride: int   # Hs: H padded to a multiple of 4
    in_pad: int          # IN padded to the first of IN_PADS that holds it
    tiles: int           # ceil(B / ROWS)
    blocks: int          # blocks of the walk kernel, each a contiguous share of the tiles
    smem_bytes: int

    def tiles_of(self, block: int) -> range:
        """The tiles block `block` walks, in its order."""
        return range(block * self.tiles // self.blocks,
                     (block + 1) * self.tiles // self.blocks)

    @property
    def carry_floats(self) -> int:
        """Scratch of the forward walk: [blocks, S, ROWS, 4, Hs]."""
        return self.blocks * self.slots * ROWS * 4 * self.hidden_stride

    @property
    def out_rows(self) -> int:
        """Rows of a direction's gradients [IN + 2 + H, 3H]: dW_ih, db_ih,
        db_hh, dW_hh."""
        return self.in_dim + 2 + self.hidden


def smem_bytes(hidden_stride: int, in_pad: int) -> int:
    """The walk kernel's dynamic shared memory: the tile's carry, the three
    gates' gradients, the r gate and the carry's gradient [ROWS, Hs] (six
    in all), the step's x [ROWS, in_pad], and two 32-bit row masks for each
    of MAX_SLOTS steps."""
    return 4 * (6 * ROWS * hidden_stride + ROWS * in_pad + 2 * MAX_SLOTS)


def launch_geometry(batch: int, hidden: int, in_dim: int, slots: int,
                    ndirs: int = 1, max_blocks: int = 132) -> GradGeometry:
    """The launch for B = batch rows, H = hidden, IN = in_dim, S = slots and
    1 or 2 directions on a card that holds `max_blocks` walk blocks at once.
    Raises ValueError for what the kernel does not take."""
    if not 1 <= hidden <= mg.MAX_HIDDEN:
        raise ValueError(f"the backward kernel takes 1 <= H <= {mg.MAX_HIDDEN}, "
                         f"got H={hidden}")
    if not 1 <= in_dim <= IN_PADS[-1]:
        raise ValueError(f"the backward kernel takes 1 <= IN <= {IN_PADS[-1]}, "
                         f"got IN={in_dim}")
    if not 0 <= slots <= MAX_SLOTS:
        raise ValueError(f"the backward kernel takes 0 <= S <= {MAX_SLOTS}, got S={slots}")
    if batch < 1 or ndirs not in (1, 2):
        raise ValueError(f"bad shape: B={batch}, ndirs={ndirs}")
    if max_blocks < 1:
        raise ValueError(f"the card holds no block of the walk kernel ({max_blocks})")
    hs = -(-hidden // 4) * 4
    in_pad = next(n for n in IN_PADS if in_dim <= n)
    tiles = -(-batch // ROWS)
    return GradGeometry(batch, hidden, in_dim, slots, ndirs, hs, in_pad, tiles,
                        min(tiles, max_blocks, MAX_BLOCKS), smem_bytes(hs, in_pad))


class _Params(ctypes.Structure):
    """struct GruGradParams in csrc/gru_grad.cu."""
    _P2 = ctypes.c_void_p * 2
    _fields_ = [("xs", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("grad_out", ctypes.c_void_p),
                ("w_ih", _P2), ("w_hh", _P2), ("b_ih", _P2), ("b_hh", _P2)]
    _fields_ += [(n, ctypes.c_void_p) for n in ("w_hh_t", "carry", "part", "part_hh_set",
                                                "dx_part", "d_out", "d_xs")]
    _fields_ += [(n, ctypes.c_int64) for n in ("xs_s", "xs_b", "xs_i", "m_s", "m_b")]
    _fields_ += [(n, ctypes.c_int) for n in ("S", "B", "IN", "H", "Hs", "ndirs", "reverse",
                                             "ntiles", "blocks")]


_launch = _build.launcher("gru_grad", "gru_grad_launch",
                          [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int])
_max_blocks = _build.launcher("gru_grad", "gru_grad_max_blocks",
                              [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                              stream=False, counted=False)


@functools.lru_cache(maxsize=None)
def max_active_blocks(in_pad: int, smem: int, device_index: int = 0) -> int:
    """Walk blocks (`in_pad`-float x rows, `smem` bytes each) that the card
    holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs)."""
    n = ctypes.c_int(0)
    _max_blocks(torch.device("cuda", device_index), in_pad, smem, ctypes.byref(n))
    if n.value < 1:
        raise RuntimeError(f"the card holds no walk block with {smem} bytes of shared memory")
    return n.value


@functools.lru_cache(maxsize=256)
def card_geometry(batch, hidden, in_dim, slots, ndirs=1, device_index=0) -> GradGeometry:
    """launch_geometry with the card's occupancy (cached: the update
    launches the same shape every iteration)."""
    geo = launch_geometry(batch, hidden, in_dim, slots, ndirs, 1)
    mb = max_active_blocks(geo.in_pad, geo.smem_bytes, device_index)
    return launch_geometry(batch, hidden, in_dim, slots, ndirs, mb)


def _note(geo: GradGeometry) -> None:
    """One call's shape added to the recorder's counters."""
    if not profiler.counting():
        return
    shape = {"launches": 1, "rows": geo.batch,
             "slots": geo.slots * geo.batch * geo.ndirs}
    for key, n in shape.items():
        profiler.count(f"gru_grad.{key}", n)


def backward(xs, mask, weights: Sequence[Sequence[torch.Tensor]], grad_out,
             reverse: bool = False, want_dx: bool = False
             ) -> Tuple[List[Tuple[torch.Tensor, ...]], Optional[torch.Tensor]]:
    """The weight gradients of each direction and, when `want_dx`, the xs
    gradient [S, B, IN] (summed over the directions), by the kernel on the
    current stream. Raises on a bad argument (on CPU tensors after every
    other check), a failed build or a failed launch."""
    if len(weights) not in (1, 2):
        raise ValueError(f"one or two directions, got {len(weights)}")
    for w in weights:
        mg._check_cuda_args(xs, mask, *w)
    if len(weights) == 2 and weights[0][1].shape != weights[1][1].shape:
        raise ValueError("the two directions have different hidden sizes")
    s_len, b, in_dim = xs.shape
    hidden = weights[0][1].shape[0]
    ndirs = len(weights)
    if tuple(grad_out.shape) != (b, hidden) or grad_out.device != xs.device:
        raise ValueError(f"grad_out must be {(b, hidden)} on {xs.device}, got "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    if grad_out.dtype != torch.float32:
        raise TypeError(f"the backward kernel takes float32; grad_out is {grad_out.dtype}")
    launch_geometry(max(b, 1), hidden, in_dim, s_len, ndirs)     # what it takes
    if not xs.is_cuda:
        raise ValueError("the masked GRU backward kernel takes CUDA tensors")
    dev = xs.device
    alloc = torch.empty if b > 0 else torch.zeros    # the kernel writes every element
    d_out = alloc((ndirs, in_dim + 2 + hidden, 3 * hidden), dtype=torch.float32, device=dev)
    d_xs = alloc(xs.shape, dtype=torch.float32, device=dev) if want_dx else None
    if b > 0:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        geo = card_geometry(b, hidden, in_dim, s_len, ndirs, index)
        grad_out = grad_out.contiguous()

        def scratch(n, dtype=torch.float32):
            return torch.empty(n, dtype=dtype, device=dev)
        w_hh_t = scratch(ndirs * 3 * hidden * hidden)
        carry = scratch(geo.carry_floats)
        part = scratch(geo.blocks * ndirs * geo.out_rows * 3 * hidden)
        part_hh_set = scratch(geo.blocks * ndirs, torch.int32)
        dx_part = (scratch(ndirs * xs.numel()) if want_dx and ndirs == 2 else d_xs)
        p = _Params()
        p.xs, p.mask, p.grad_out = xs.data_ptr(), mask.data_ptr(), grad_out.data_ptr()
        for d in range(2):
            w_ih, w_hh, b_ih, b_hh = weights[min(d, ndirs - 1)]
            p.w_ih[d], p.w_hh[d] = w_ih.data_ptr(), w_hh.data_ptr()
            p.b_ih[d], p.b_hh[d] = b_ih.data_ptr(), b_hh.data_ptr()
        p.w_hh_t, p.carry, p.part = w_hh_t.data_ptr(), carry.data_ptr(), part.data_ptr()
        p.part_hh_set, p.d_out = part_hh_set.data_ptr(), d_out.data_ptr()
        p.dx_part = dx_part.data_ptr() if want_dx else None
        p.d_xs = d_xs.data_ptr() if want_dx else None
        p.xs_s, p.xs_b, p.xs_i = xs.stride()
        p.m_s, p.m_b = mask.stride()
        p.S, p.B, p.IN, p.H, p.Hs = s_len, b, in_dim, hidden, geo.hidden_stride
        p.ndirs, p.reverse = ndirs, int(bool(reverse))
        p.ntiles, p.blocks = geo.tiles, geo.blocks
        _launch(dev, ctypes.byref(p), geo.in_pad, geo.smem_bytes)
        _note(geo)
    grads = [(d_out[d, :in_dim], d_out[d, in_dim + 2:], d_out[d, in_dim],
              d_out[d, in_dim + 1]) for d in range(ndirs)]
    return grads, d_xs
