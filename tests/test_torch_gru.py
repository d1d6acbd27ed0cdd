"""The port's masked GRU (rvo3d_tpu_torch/ops/masked_gru.py) against the
JAX package's: the plain torch scan against gru_scan_reference and against
the Pallas kernel run in interpret mode, and the autograd Function's
gradients against autograd through the plain scan. The CUDA kernel itself
is held against the plain scan on a card by tests/test_torch_cuda.py.
f32, atol 1e-5: summation order over IN + H = 41 terms and 10 steps."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rvo3d_tpu.ops.pallas_gru as pg
from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.ops import masked_gru as mg

S, B, IN, H = 10, 64, 9, 32
ATOL = 1e-5


def make_data(b=B, hidden=H, seed=0, empty=False):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((S, b, IN)).astype(np.float32)
    mask = (rng.random((S, b)) > 0.4).astype(np.float32)
    if empty:
        mask[:] = 0.0
    w_ih = (rng.standard_normal((IN, 3 * hidden)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 3 * hidden)) * 0.1).astype(np.float32)
    b_ih = (rng.standard_normal(3 * hidden) * 0.1).astype(np.float32)
    b_hh = (rng.standard_normal(3 * hidden) * 0.1).astype(np.float32)
    return xs, mask, w_ih, w_hh, b_ih, b_hh


def to_torch(data, device="cpu"):
    return [torch.tensor(a, device=device) for a in data]


@pytest.mark.parametrize("b", [B, 61])
def test_plain_matches_jax_reference(b):
    data = make_data(b)
    ref = np.asarray(pg.gru_scan_reference(*map(jnp.asarray, data)))
    out = mg.masked_gru_scan_plain(*to_torch(data)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("b", [B, 61])
def test_plain_matches_pallas_interpret(b, monkeypatch):
    data = make_data(b, seed=1)
    monkeypatch.setattr(pg, "_INTERPRET", True)
    monkeypatch.setattr(pg, "TILE_B", 48)  # ragged last tile in the Pallas grid
    ref = np.asarray(pg._pallas_forward(*map(jnp.asarray, data)))
    out = mg.masked_gru_scan_plain(*to_torch(data)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_reverse_equals_flipped_sequence():
    data = make_data(seed=2)
    xs, mask, *w = data
    ref = np.asarray(pg.gru_scan_reference(
        jnp.asarray(xs[::-1].copy()), jnp.asarray(mask[::-1].copy()),
        *map(jnp.asarray, w)))
    out = mg.masked_gru_scan(*to_torch(data), reverse=True).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_strided_view_matches_contiguous():
    """The encoder passes xs as a [S, B, IN] view of [B, S, IN]."""
    data = to_torch(make_data(seed=3))
    xs, mask = data[0], data[1]
    xs_view = xs.transpose(0, 1).contiguous().transpose(0, 1)
    mask_view = mask.t().contiguous().t()
    assert not xs_view.is_contiguous()
    got = mg.masked_gru_scan(xs_view, mask_view, *data[2:])
    torch.testing.assert_close(got, mg.masked_gru_scan_plain(*data), rtol=0, atol=0)


def test_empty_mask_keeps_zero_state():
    out = mg.masked_gru_scan(*to_torch(make_data(empty=True)))
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_function_grads_match_autograd(reverse):
    data = to_torch(make_data(seed=4))

    def grads(fn):
        leaves = [t.clone().requires_grad_(i != 1) for i, t in enumerate(data)]
        loss = (fn(*leaves, reverse=reverse) ** 2).sum()
        diff = [t for i, t in enumerate(leaves) if i != 1]
        return torch.autograd.grad(loss, diff)

    for g1, g2 in zip(grads(mg.masked_gru_scan), grads(mg.masked_gru_scan_plain)):
        torch.testing.assert_close(g1, g2, rtol=0, atol=ATOL)


def bigru_data(b=B, seed=6):
    xs, mask, *fwd = make_data(b, seed=seed)
    bwd = make_data(b, seed=seed + 100)[2:]
    return xs, mask, fwd, bwd


@pytest.mark.parametrize("b", [B, 61])
def test_bigru_plain_matches_jax_reference(b):
    xs, mask, fwd, bwd = bigru_data(b)
    j = lambda a: jnp.asarray(np.ascontiguousarray(a))
    ref = (np.asarray(pg.gru_scan_reference(j(xs), j(mask), *map(j, fwd)))
           + np.asarray(pg.gru_scan_reference(j(xs[::-1]), j(mask[::-1]), *map(j, bwd))))
    t = lambda a: [torch.tensor(x) for x in a]
    out = mg.masked_bigru_scan_plain(torch.tensor(xs), torch.tensor(mask), t(fwd), t(bwd))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    got = mg.masked_bigru_scan(torch.tensor(xs), torch.tensor(mask), t(fwd), t(bwd))
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_bigru_plain_matches_pallas_interpret(monkeypatch):
    xs, mask, fwd, bwd = bigru_data(61, seed=7)
    monkeypatch.setattr(pg, "_INTERPRET", True)
    monkeypatch.setattr(pg, "TILE_B", 48)
    j = lambda a: jnp.asarray(np.ascontiguousarray(a))
    ref = (np.asarray(pg._pallas_forward(j(xs), j(mask), *map(j, fwd)))
           + np.asarray(pg._pallas_forward(j(xs[::-1]), j(mask[::-1]), *map(j, bwd))))
    t = lambda a: [torch.tensor(x) for x in a]
    out = mg.masked_bigru_scan_plain(torch.tensor(xs), torch.tensor(mask), t(fwd), t(bwd))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_bigru_function_grads_match_autograd():
    xs, mask, fwd, bwd = bigru_data(seed=8)
    base = [torch.tensor(a) for a in (xs, *fwd, *bwd)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(leaves[0], torch.tensor(mask), leaves[1:5], leaves[5:])
        return torch.autograd.grad((out ** 2).sum(), leaves)

    for g1, g2 in zip(grads(mg.masked_bigru_scan), grads(mg.masked_bigru_scan_plain)):
        torch.testing.assert_close(g1, g2, rtol=0, atol=ATOL)


def test_function_grads_match_jax_custom_vjp():
    import jax

    data = make_data(seed=5)
    xs, mask, w_ih, w_hh, b_ih, b_hh = data

    def loss_jax(w_ih, w_hh, xs):
        return jnp.sum(pg.masked_gru_scan(xs, jnp.asarray(mask), w_ih, w_hh,
                                          jnp.asarray(b_ih), jnp.asarray(b_hh)) ** 2)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(w_ih), jnp.asarray(w_hh), jnp.asarray(xs))
    t = to_torch(data)
    for i in (0, 2, 3):
        t[i].requires_grad_(True)
    loss = (mg.masked_gru_scan(*t) ** 2).sum()
    got = torch.autograd.grad(loss, (t[2], t[3], t[0]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    data = to_torch(make_data())
    with pytest.raises(ValueError, match="CUDA tensors"):
        mg.masked_gru_scan_cuda(*data)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mg.masked_bigru_scan_cuda(data[0], data[1], data[2:], data[2:])
    xs, mask, w_ih, w_hh, b_ih, b_hh = data
    with pytest.raises(TypeError, match="float32"):
        mg._check_cuda_args(xs.double(), mask, w_ih, w_hh, b_ih, b_hh)
    with pytest.raises(ValueError, match="mask must be"):
        mg._check_cuda_args(xs, mask[:, :-1], w_ih, w_hh, b_ih, b_hh)
    with pytest.raises(ValueError, match="contiguous"):
        mg._check_cuda_args(xs, mask, w_ih, w_hh.t().contiguous().t(), b_ih, b_hh)
    big = to_torch(make_data(hidden=mg.MAX_HIDDEN + 8))
    with pytest.raises(ValueError, match="H <="):
        mg._check_cuda_args(*big)
    mg._check_cuda_args(*data)  # accepted as is


def test_build_names_library_by_source_hash():
    path = _build.library_path("masked_gru")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("masked_gru")
