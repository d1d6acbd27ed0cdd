"""The masked GRU scan's hand-written backward (rvo3d_tpu_torch/ops/gru_grad.py,
csrc/gru_grad.cu) and the autograd Function that takes it.

On the CPU: the ctypes parameters follow the C struct field by field; the
launch geometry splits the row tiles among the blocks once each, pads H and
IN, sizes the scratch and refuses what the kernel does not take; the
wrapper's checks raise on bad arguments and, last, on CPU tensors;
`MaskedGRUScan` on CPU tensors keeps the plain recompute (autograd through
masked_gru_scan_plain, bit for bit) and never reaches the kernel; a call's
counters. The kernel's walk shares each step among the threads of a block
(shared memory and barriers), so it is not built for the host.

On a card (marked gpu; skips without one): the gradients of all four
weights of each direction, and of xs when asked, through the kernel against
autograd through the plain scan on the card, each tensor within 1e-3 of its
largest reference gradient (the card tests' gradient limit), for one
direction each way and the biGRU; suffix masks with k = 0..S active slots,
the env's suffix masks with k uniform, random masks with empty rows, one
active slot a row with x = 0 there (the encoder's activated empty slot);
H in {8, 96, 101, 256} (101: the tails of every product), IN = 9, xs and
mask as the encoder's strided views; the PPO minibatch (B = 16384) at its
rollout rows and its random-neighbour rows; one launch a backward and
never the plain recompute; a call captured in a CUDA graph and replayed,
and two calls, giving the same bits. This
file imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gru_grad.py
"""

import ctypes
import os
import re

import pytest
import torch

from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.ops import gru_grad as gg
from rvo3d_tpu_torch.ops import masked_gru as mg
from rvo3d_tpu_torch.utils import profiler

S, IN = 10, 9


def _weights(h, in_dim, ndirs, g, device="cpu"):
    bound = 1.0 / h ** 0.5
    return [tuple(torch.empty(shape).uniform_(-bound, bound, generator=g).to(device)
                  for shape in ((in_dim, 3 * h), (h, 3 * h), (3 * h,), (3 * h,)))
            for _ in range(ndirs)]


def _mask(kind, b, g, s_len=S):
    """[B, S] float masks: `suffix<k>` (every row's last k slots), `suffix`
    (k uniform in 0..S a row, the env's layout), `random` (60 % on, a
    third of the rows emptied), `one_slot` (the last slot alone)."""
    if kind.startswith("suffix") and kind != "suffix":
        k = torch.full((b, 1), int(kind[6:]))
    elif kind == "suffix":
        k = torch.randint(0, s_len + 1, (b, 1), generator=g)
    elif kind == "random":
        m = (torch.rand(b, s_len, generator=g) > 0.4).float()
        m[torch.rand(b, generator=g) < 1 / 3] = 0.0
        return m
    elif kind == "one_slot":
        k = torch.ones(b, 1, dtype=torch.long)
    else:
        raise ValueError(kind)
    return (torch.arange(s_len)[None, :] >= s_len - k).float()


# ---- the CPU: the binding, the geometry, the checks, the dispatch ----

def test_ctypes_parameters_follow_the_c_struct():
    with open(os.path.join(_build.CSRC_DIR, "gru_grad.cu")) as f:
        body = re.search(r"struct GruGradParams \{(.*?)\};", f.read(), re.S).group(1)
    kinds = {"int64_t": "i64", "int": "i32"}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        if "*" in decl:
            name = decl.split("*")[-1].strip()
            fields.append((name.split("[")[0], "ptr2" if name.endswith("[2]") else "ptr"))
            continue
        ctype, names = decl.split(None, 1)
        fields += [(n.strip(), kinds[ctype]) for n in names.split(",")]
    ctype_kind = {ctypes.c_void_p: "ptr", ctypes.c_void_p * 2: "ptr2",
                  ctypes.c_int64: "i64", ctypes.c_int: "i32"}
    assert [(n, ctype_kind[t]) for n, t in gg._Params._fields_] == fields


@pytest.mark.parametrize("batch,blocks", [(1, 132), (31, 132), (33, 132), (4096, 132),
                                          (16384, 132), (16384, 7), (65536, 264),
                                          (204800, 2048)])
def test_geometry_walks_every_tile_once(batch, blocks):
    geo = gg.launch_geometry(batch, 256, IN, S, 2, blocks)
    assert geo.tiles == -(-batch // gg.ROWS)
    assert geo.blocks == min(geo.tiles, blocks, gg.MAX_BLOCKS)
    walked = [t for b in range(geo.blocks) for t in geo.tiles_of(b)]
    assert walked == list(range(geo.tiles))
    assert all(len(geo.tiles_of(b)) >= 1 for b in range(geo.blocks))


@pytest.mark.parametrize("hidden,in_dim,hs,in_pad", [(8, 9, 8, 12), (96, 9, 96, 12),
                                                     (101, 3, 104, 12), (256, 9, 256, 12),
                                                     (256, 13, 256, 16), (256, 16, 256, 16),
                                                     (1, 1, 4, 12)])
def test_geometry_pads_and_sizes_the_scratch(hidden, in_dim, hs, in_pad):
    geo = gg.launch_geometry(16384, hidden, in_dim, S, 2, 132)
    assert (geo.hidden_stride, geo.in_pad) == (hs, in_pad)
    assert geo.smem_bytes == 4 * (6 * gg.ROWS * hs + gg.ROWS * in_pad + 2 * gg.MAX_SLOTS)
    assert geo.smem_bytes <= mg.MAX_SMEM      # any H <= 256 fits
    assert geo.carry_floats == 132 * S * gg.ROWS * 4 * hs
    assert geo.out_rows == in_dim + 2 + hidden


def test_geometry_of_the_ppo_minibatch():
    """The update's shape on an H100 (132 blocks of one per SM): 512 tiles,
    ~3.9 a block, 194 KB of shared memory a block."""
    geo = gg.launch_geometry(16384, 256, 9, 10, 2, 132)
    assert (geo.tiles, geo.blocks, geo.smem_bytes) == (512, 132, 198656)
    assert {len(geo.tiles_of(b)) for b in range(geo.blocks)} == {3, 4}


@pytest.mark.parametrize("args,match", [((16, 0, 9, S), "H"), ((16, 257, 9, S), "H"),
                                        ((16, 8, 0, S), "IN"), ((16, 8, 17, S), "IN"),
                                        ((16, 8, 9, 65), "S"), ((0, 8, 9, S), "B"),
                                        ((16, 8, 9, S, 3), "ndirs"),
                                        ((16, 8, 9, S, 1, 0), "no block")])
def test_geometry_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        gg.launch_geometry(*args)


def _cpu_args(b=40, h=8, ndirs=2):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, S, IN, generator=g)
    mask = _mask("suffix", b, g)
    return x.transpose(0, 1), mask.t(), _weights(h, IN, ndirs, g), torch.randn(b, h,
                                                                              generator=g)


def test_backward_refuses_cpu_tensors_after_every_other_check():
    xs, ms, w, up = _cpu_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gg.backward(xs, ms, w, up)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gg.backward(xs, ms, w[:1], up, reverse=True, want_dx=True)


@pytest.mark.parametrize("case", ["three_dirs", "xs_rank", "mask_shape", "w_hh_shape",
                                  "hidden_mismatch", "f64_weight", "strided_weight",
                                  "grad_shape", "grad_dtype", "wide_in", "long_s", "wide_h"])
def test_backward_refuses_what_it_does_not_take(case):
    xs, ms, w, up = _cpu_args()
    err = ValueError
    if case == "three_dirs":
        w = w + w[:1]
    elif case == "xs_rank":
        xs = xs[0]
    elif case == "mask_shape":
        ms = ms[:-1]
    elif case == "w_hh_shape":
        w[0] = (w[0][0], w[0][1][:-1], w[0][2], w[0][3])
    elif case == "hidden_mismatch":
        w[1] = _weights(16, IN, 1, torch.Generator().manual_seed(1))[0]
    elif case == "f64_weight":
        w[0] = (w[0][0].double(),) + w[0][1:]
        err = TypeError
    elif case == "strided_weight":
        w[0] = (w[0][0], w[0][1].t().contiguous().t()) + w[0][2:]
    elif case == "grad_shape":
        up = up[:, :-1]
    elif case == "grad_dtype":
        up = up.double()
        err = TypeError
    elif case == "wide_in":
        xs = torch.zeros(S, xs.shape[1], 17)
        w = [(torch.zeros(17, 24),) + ws[1:] for ws in w]
    elif case == "long_s":
        xs, ms = torch.zeros(65, xs.shape[1], IN), torch.zeros(65, xs.shape[1])
    elif case == "wide_h":
        h = 257
        w = _weights(h, IN, 2, torch.Generator().manual_seed(2))
        up = torch.zeros(xs.shape[1], h)
    with pytest.raises(err) as info:
        gg.backward(xs, ms, w, up)
    assert "CUDA tensors" not in str(info.value)


@pytest.mark.parametrize("ndirs,reverse", [(1, False), (1, True), (2, False)])
def test_cpu_tensors_keep_the_plain_recompute(ndirs, reverse, monkeypatch):
    """MaskedGRUScan.backward on the CPU is autograd through the plain scan,
    bit for bit, with the xs gradient; the kernel's wrapper is never called."""
    def refuse(*a, **k):
        raise AssertionError("the CPU reached the backward kernel")
    monkeypatch.setattr(gg, "backward", refuse)
    xs, ms, w, up = _cpu_args(ndirs=ndirs)
    before = gg.launches

    def run(scan):
        leaves = [xs.detach().clone().requires_grad_()] + [
            t.detach().clone().requires_grad_() for ws in w for t in ws]
        ws = [tuple(leaves[1 + 4 * d: 5 + 4 * d]) for d in range(ndirs)]
        out = scan(leaves[0], ms, ws)
        (out * up).sum().backward()
        return [t.grad for t in leaves]

    if ndirs == 2:
        got = run(lambda x, m, ws: mg.masked_bigru_scan(x, m, *ws))
        ref = run(lambda x, m, ws: mg.masked_bigru_scan_plain(x, m, *ws))
    else:
        got = run(lambda x, m, ws: mg.masked_gru_scan(x, m, *ws[0], reverse=reverse))
        ref = run(lambda x, m, ws: mg.masked_gru_scan_plain(x, m, *ws[0], reverse=reverse))
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert gg.launches == before


def test_a_call_counts_its_shape_while_the_recorder_is_on():
    geo = gg.launch_geometry(16384, 256, IN, S, 2, 132)
    profiler.clear()
    try:
        gg._note(geo)      # off: nothing
        assert profiler.recorded().counters == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            gg._note(geo)
            gg._note(geo)
        c = profiler.recorded().counters
    finally:
        profiler.clear()
    assert c == {"gru_grad.launches": 2, "gru_grad.rows": 2 * 16384,
                 "gru_grad.slots": 2 * S * 16384 * 2}


def test_no_device_symbol_names_the_forward_kernel():
    """gru_roofline.train times the ops whose names hold "masked_gru": the
    backward's kernels, its parameters and its launchers must not."""
    with open(os.path.join(_build.CSRC_DIR, "gru_grad.cu")) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    assert "masked_gru" not in src


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(cuda, b, h, kind, ndirs, seed=0, zero_x_last=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, S, IN, generator=g)
    mask = _mask(kind, b, g)
    if zero_x_last:
        x[:, -1] = 0.0
    w = _weights(h, IN, ndirs, g, cuda)
    up = torch.randn(b, h, generator=g).to(cuda)
    return x.to(cuda), mask.to(cuda), w, up


def _grads(x, mask, w, up, reverse, kernel, want_dx=True):
    """Gradients of (out * up).sum() w.r.t. x and every weight, with xs and
    the mask as the encoder's strided views, through MaskedGRUScan (kernel)
    or autograd through the plain scans."""
    xl = x.detach().clone().requires_grad_(want_dx)
    wl = [tuple(t.detach().clone().requires_grad_() for t in ws) for ws in w]
    xs, ms = xl.transpose(0, 1), mask.t()
    if len(w) == 2:
        scan = mg.masked_bigru_scan if kernel else mg.masked_bigru_scan_plain
        out = scan(xs, ms, wl[0], wl[1])
    else:
        scan = mg.masked_gru_scan if kernel else mg.masked_gru_scan_plain
        out = scan(xs, ms, *wl[0], reverse=reverse)
    (out * up).sum().backward()
    return ([xl.grad] if want_dx else []) + [t.grad for ws in wl for t in ws]


def _assert_close(got, ref, what):
    for i, (a, r) in enumerate(zip(got, ref)):
        err = (a - r).abs().max().item()
        assert err <= 1e-3 * r.abs().max().item(), (what, i, err, r.abs().max().item())


DIRS = {"forward": (1, False), "reverse": (1, True), "bigru": (2, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("dirs", list(DIRS))
@pytest.mark.parametrize("kind", [f"suffix{k}" for k in range(S + 1)]
                         + ["suffix", "random", "one_slot"])
def test_kernel_grads_equal_plain_autograd(cuda, dirs, kind, monkeypatch):
    ndirs, reverse = DIRS[dirs]
    x, mask, w, up = _case(cuda, 1000, 256, kind, ndirs)
    ref = _grads(x, mask, w, up, reverse, kernel=False)

    def refuse(*a, **k):
        raise AssertionError("the card took the plain recompute")
    monkeypatch.setattr(mg.MaskedGRUScan, "_plain", staticmethod(refuse))
    before = gg.launches
    got = _grads(x, mask, w, up, reverse, kernel=True)
    torch.cuda.synchronize()
    assert gg.launches == before + 1
    _assert_close(got, ref, (dirs, kind))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [8, 96, 101, 256])
@pytest.mark.parametrize("dirs", list(DIRS))
@pytest.mark.parametrize("kind", ["suffix", "random", "one_slot_zero_x"])
def test_kernel_grads_over_widths(cuda, h, dirs, kind):
    ndirs, reverse = DIRS[dirs]
    zero_x = kind == "one_slot_zero_x"
    x, mask, w, up = _case(cuda, 777, h, "one_slot" if zero_x else kind, ndirs, seed=h,
                           zero_x_last=zero_x)
    _assert_close(_grads(x, mask, w, up, reverse, kernel=True),
                  _grads(x, mask, w, up, reverse, kernel=False), (h, dirs, kind))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rollout_rows", "random_neighbours"])
def test_kernel_grads_at_the_ppo_minibatch(cuda, kind):
    """B = 16384, biGRU-256: the rollout rows (one active slot, x = 0 there)
    and random neighbours (k uniform in 0..10, the env's suffix layout);
    the update asks for no xs gradient."""
    rollout = kind == "rollout_rows"
    x, mask, w, up = _case(cuda, 16384, 256, "one_slot" if rollout else "suffix", 2,
                           seed=7, zero_x_last=rollout)
    got = _grads(x, mask, w, up, False, kernel=True, want_dx=False)
    _assert_close(got, _grads(x, mask, w, up, False, kernel=False, want_dx=False), kind)
    if rollout:   # no row continues: no W_hh gradient
        assert all(not g.any() for g in (got[1], got[5]))


def _direct(x, mask, w, up, want_dx=True):
    grads, d_xs = gg.backward(x.transpose(0, 1), mask.t(), w, up, want_dx=want_dx)
    return [t.clone() for ws in grads for t in ws] + ([d_xs.clone()] if want_dx else [])


@pytest.mark.gpu
def test_two_calls_give_the_same_bits(cuda):
    x, mask, w, up = _case(cuda, 4096, 256, "random", 2, seed=3)
    first, second = _direct(x, mask, w, up), _direct(x, mask, w, up)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["suffix", "one_slot"])
def test_a_captured_call_replays_the_eager_bits(cuda, kind):
    x, mask, w, up = _case(cuda, 4096, 256, kind, 2, seed=5)
    eager = _direct(x, mask, w, up, want_dx=False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _direct(x, mask, w, up, want_dx=False)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = gg.launches
    with torch.cuda.graph(graph):
        grads, _ = gg.backward(x.transpose(0, 1), mask.t(), w, up)
    assert gg.launches == before + 1
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    captured = [t for ws in grads for t in ws]
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
