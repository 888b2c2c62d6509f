"""Port parity for K1's gradient: ``GraphFlashAttention`` on the CPU (the
plain forward with its lse, and the plain backward twin that follows the
kernels' algorithm) against ``jax.vjp`` of the JAX package's
``graph_flash_attention`` (the Pallas kernel in interpret mode, whose
gradient differentiates ``sparse_graph_attention``); the plain backward
against PyTorch's autograd through the plain forward; the host-side
inverse index; the inputs the K1 and K3 kernels refuse; and K3's
zero-padding of a head_dim the kernels do not take.

Tolerances. f32: the same algebra in another summation order — 1e-5 of
each tensor's max |value| against JAX (measured worst 3.5e-7), 2e-6
against autograd. bf16: the port reads bf16 and sums in f32, JAX
differentiates a scan that rounds scores and p to bf16, so the port in
bf16 is held to the f32 reference row by row, as chip_smoke.py holds
the kernel (6e-2 of each row's norm, floored at 1e-3 of the tensor's
rms row norm). K3's padded head_dim is exact up to f32 rounding — 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops.flash_attention import (
    graph_flash_attention as jax_graph_flash_attention,
)
from dragonfly2_tpu_torch.models.graph_transformer import (
    PAD_ID,
    build_inverse_index,
)
from dragonfly2_tpu_torch.ops.flash_attention import (
    MAX_SLOTS,
    ROW_WIDTHS,
    GraphFlashAttention,
    check_flash_inputs,
    check_graph_flash_inputs,
    chunked_attention,
    graph_backward_scratch,
    graph_flash_attention,
    graph_flash_attention_backward_plain,
    graph_flash_attention_plain,
    kernel_head_dim,
    pad_head_dim,
)

JAX_F32_TOL = 1e-5
AUTOGRAD_TOL = 2e-6
ROW_TOL = 6e-2
ROW_FLOOR = 1e-3
PAD_TOL = 1e-6


def _case(n, kw, heads, d, seed):
    """q, k, v, dout [n, heads, d] and deduped neighbor lists with a self
    slot, ragged PAD_ID tails, a row with no valid slot (row 3), and ids
    outside [0, n) that are not PAD_ID (row 5: n + 1000 and -5)."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((n, heads, d)).astype(np.float32)
                     for _ in range(4))
    nbr = np.full((n, kw), PAD_ID, dtype=np.int32)
    val = np.zeros((n, kw), dtype=np.float32)
    for r in range(n):
        deg = int(rng.integers(1, kw + 1))
        others = rng.choice(np.delete(np.arange(n), r), deg - 1,
                            replace=False)
        nbr[r, :deg] = np.r_[r, others]
        val[r, :deg] = -rng.random(deg)
    nbr[3] = PAD_ID
    nbr[5, -2:] = (n + 1000, -5)
    return q, k, v, dout, nbr, val


def _jax_grads(q, k, v, dout, nbr, val, block):
    out, vjp = jax.vjp(
        lambda q, k, v, val: jax_graph_flash_attention(
            q, k, v, nbr, val, block, block, True), q, k, v, val)
    return [np.array(x, np.float32) for x in (out, *vjp(dout))]


def _port_grads(q, k, v, dout, nbr, val, block, dtype=torch.float32,
                inv=None):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_()
              for x in (q, k, v)]
    leaves.append(torch.from_numpy(val).requires_grad_())
    out = graph_flash_attention(*leaves[:3], torch.from_numpy(nbr),
                                leaves[3], block, inv=inv)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(dout).to(dtype))
    return [x.float().numpy() for x in (out.detach(), *grads)]


def _row_errors(got, ref):
    """Each [rows, ...] tensor's worst row |got − ref| / max(|ref row|,
    ROW_FLOOR · rms row norm)."""
    errs = []
    for a, b in zip(got, ref):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        norm = np.linalg.norm(b, axis=1)
        floor = ROW_FLOOR * np.sqrt((norm ** 2).mean())
        errs.append(float((np.linalg.norm(a - b, axis=1)
                           / np.maximum(norm, floor)).max()))
    return errs


@pytest.mark.parametrize("n,kw,heads,d,block", [
    pytest.param(256, 16, 4, 8, 128, id="256x4x8-K16"),
    pytest.param(96, 5, 2, 16, 32, id="96x2x16-K5"),
])
def test_k1_grads_match_jax_vjp_f32(n, kw, heads, d, block):
    q, k, v, dout, nbr, val = _case(n, kw, heads, d, seed=n)
    ref = _jax_grads(q, k, v, dout, nbr, val, block)
    got = _port_grads(q, k, v, dout, nbr, val, block)
    # Row 3 lists nobody: its output is the constant 0, so its dq is 0.
    # The JAX gradient (autodiff of the masked scan) gives NaN there.
    np.testing.assert_array_equal(got[1][3], 0.0)
    got[1][3] = ref[1][3] = 0.0
    for name, a, b in zip(("out", "dq", "dk", "dv", "dval"), got, ref):
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        assert err <= JAX_F32_TOL * float(np.abs(b).max()), (name, err)
    np.testing.assert_array_equal(got[0][3], 0.0)   # no valid slot
    np.testing.assert_array_equal(got[4][3], 0.0)
    np.testing.assert_array_equal(got[4][5, -2:], 0.0)  # ids out of range


def test_k1_grads_bf16_near_jax_f32():
    q, k, v, dout, nbr, val = _case(256, 16, 4, 8, seed=11)
    # The f32 reference on the values bf16 holds.
    q, k, v, dout = (torch.from_numpy(x).bfloat16().float().numpy()
                     for x in (q, k, v, dout))
    ref = _jax_grads(q, k, v, dout, nbr, val, 128)
    got = _port_grads(q, k, v, dout, nbr, val, 128, torch.bfloat16)
    got[1][3] = ref[1][3] = 0.0      # JAX's NaN, see the f32 test
    errs = _row_errors(got[1:], ref[1:])
    assert max(errs) <= ROW_TOL, errs


@pytest.mark.parametrize("n,kw,block", [(64, 8, 16), (100, 12, 32),
                                        (48, 4, 64)])
def test_plain_backward_matches_autograd(n, kw, block):
    q, k, v, dout, nbr, val = _case(n, kw, 2, 8, seed=kw)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, val)]
    t_nbr, t_dout = torch.from_numpy(nbr), torch.from_numpy(dout)
    out = graph_flash_attention_plain(*leaves[:3], t_nbr, leaves[3], block)
    ref = torch.autograd.grad(out, leaves, t_dout)
    with torch.no_grad():
        _, lse = graph_flash_attention_plain(*leaves[:3], t_nbr, leaves[3],
                                             block, return_lse=True)
        got = graph_flash_attention_backward_plain(
            *leaves[:3], t_nbr, leaves[3], lse, t_dout,
            torch.from_numpy(build_inverse_index(nbr)))
    for name, a, b in zip(("dq", "dk", "dv", "dval"), got, ref):
        err = float((a.double() - b.double()).abs().max())
        assert err <= AUTOGRAD_TOL * float(b.abs().max()), (name, err)


def test_lse_is_the_row_log_sum_exp():
    q, k, v, _, nbr, val = _case(64, 8, 2, 8, seed=2)
    t = [torch.from_numpy(x) for x in (q, k, v, nbr, val)]
    _, lse = graph_flash_attention_plain(*t, 16, return_lse=True)
    valid = (nbr >= 0) & (nbr < 64)
    idx = np.where(valid, nbr, 0)
    s = np.einsum("nhd,nkhd->nhk", q, k[idx]) / np.sqrt(8) + val[:, None]
    s = np.where(valid[:, None], s, -np.inf)
    with np.errstate(divide="ignore"):
        ref = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.isneginf(lse.numpy()[3]).all()


def test_given_inverse_index_gives_the_same_gradients():
    q, k, v, dout, nbr, val = _case(64, 8, 2, 8, seed=3)
    built = _port_grads(q, k, v, dout, nbr, val, 16)
    given = _port_grads(q, k, v, dout, nbr, val, 16,
                        inv=torch.from_numpy(build_inverse_index(nbr)))
    for a, b in zip(built, given):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inverse_index_leaves_out_ids_out_of_range(seed):
    """Ids outside [0, n_rows) that are not PAD_ID (the op's masked
    slots) are left out as PAD_ID is; ``n_rows`` sets the key rows."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, 30, (30, 9)).astype(np.int32)
    nbr[rng.random((30, 9)) < 0.3] = PAD_ID
    nbr[4] = PAD_ID
    odd = nbr.copy()
    odd[7, :2] = (-3, 99)
    np.testing.assert_array_equal(
        build_inverse_index(odd),
        build_inverse_index(np.where((odd < 0) | (odd >= 30), PAD_ID, odd)))
    wide = build_inverse_index(nbr, 40)
    assert wide.shape[0] == 40 and (wide[30:] == -1).all()
    np.testing.assert_array_equal(wide[:30], build_inverse_index(nbr))


def test_function_without_inverse_index_on_cpu_builds_it():
    q, k, v, dout, nbr, val = _case(32, 4, 2, 8, seed=4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = GraphFlashAttention.apply(*leaves, torch.from_numpy(nbr),
                                    torch.from_numpy(val), None, 16)
    out.backward(torch.from_numpy(dout))
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in leaves)


def test_wrapper_on_cpu_counts_no_launch():
    q, k, v, dout, nbr, val = _case(32, 4, 2, 8, seed=5)
    before = (graph_flash_attention.launches,
              graph_flash_attention.backward_launches)
    _port_grads(q, k, v, dout, nbr, val, 16)
    assert (graph_flash_attention.launches,
            graph_flash_attention.backward_launches) == before


def test_wrapper_off_cpu_refuses_before_any_fallback():
    """A tensor that is not on the CPU launches the kernels or raises: on a
    device that is not CUDA it raises, under autograd too."""
    q, k, v, _, nbr, val = _case(32, 4, 2, 16, seed=6)
    t = [torch.from_numpy(x) for x in (q, k, v, nbr, val)]
    meta = [x.to("meta") for x in t]
    meta[0].requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        graph_flash_attention(*meta)


def _k1_inputs(n=8, heads=4, d=8, kw=4, dtype=torch.float32):
    q = torch.zeros(n, heads, d, dtype=dtype)
    return [q, q.clone(), q.clone(), torch.zeros(n, kw, dtype=torch.int32),
            torch.zeros(n, kw)]


def _strided(t):
    return t.transpose(0, 1).contiguous().transpose(0, 1)


# Each K1 refusal: (inputs changed from _k1_inputs, error).
K1_REFUSALS = {
    "heads-not-dividing-32": (dict(heads=3, d=32), ValueError),
    "row-width-16": (dict(heads=2, d=8), ValueError),
    "row-width-1024": (dict(heads=8, d=128), ValueError),
    "row-width-96": (dict(heads=4, d=24), ValueError),
    "k-past-512": (dict(kw=MAX_SLOTS + 1), ValueError),
    "fp16": (dict(dtype=torch.float16), TypeError),
}


@pytest.mark.parametrize("name", sorted(K1_REFUSALS))
def test_k1_refusals(name):
    kwargs, error = K1_REFUSALS[name]
    with pytest.raises(error):
        check_graph_flash_inputs(*_k1_inputs(**kwargs))


@pytest.mark.parametrize("case", ["nbr-int64", "val-f64", "mixed-dtype",
                                  "k-shape", "val-shape", "two-dim-q",
                                  "strided-q"])
def test_k1_input_refusals(case):
    q, k, v, nbr, val = _k1_inputs()
    if case == "nbr-int64":
        nbr = nbr.long()
    elif case == "val-f64":
        val = val.double()
    elif case == "mixed-dtype":
        k = k.bfloat16()
    elif case == "k-shape":
        k = k[:, :2]
    elif case == "val-shape":
        val = val[:, :3]
    elif case == "two-dim-q":
        q = q.reshape(8, 32)
    elif case == "strided-q":
        q = _strided(q)
    with pytest.raises((TypeError, ValueError)):
        check_graph_flash_inputs(q, k, v, nbr, val)


@pytest.mark.parametrize("width", ROW_WIDTHS)
@pytest.mark.parametrize("heads", [1, 4, 32])
def test_k1_takes_every_row_width(width, heads):
    check_graph_flash_inputs(*_k1_inputs(heads=heads, d=width // heads,
                                         kw=MAX_SLOTS))


# Each K3 refusal, past the zero-padding: (shape, dtype, error).
K3_REFUSALS = {
    "head-dim-256": ((8, 2, 256), torch.float32, ValueError),
    "head-dim-129": ((8, 2, 129), torch.bfloat16, ValueError),
    "head-dim-0": ((8, 2, 0), torch.float32, ValueError),
    "fp16": ((8, 2, 24), torch.float16, TypeError),
    "two-dims": ((8, 16), torch.float32, ValueError),
}


@pytest.mark.parametrize("name", sorted(K3_REFUSALS))
def test_k3_refusals(name):
    shape, dtype, error = K3_REFUSALS[name]
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        if x.dim() == 3:
            x = pad_head_dim(x, x, x)[0]
        check_flash_inputs(x, x, x)


@pytest.mark.parametrize("d,width", [(1, 4), (3, 4), (4, 4), (12, 16),
                                     (24, 32), (33, 64), (96, 128),
                                     (128, 128)])
def test_kernel_head_dim(d, width):
    assert kernel_head_dim(d) == width


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [3, 24, 96])
def test_padded_head_dim_equals_unpadded(d, causal):
    """Zero-padding q, k, v to the kernels' width and scaling by the true
    head_dim gives the unpadded attention and gradients, with zero padded
    columns: the computation the K3 wrapper runs on the card, here through
    the plain scan."""
    rng = np.random.default_rng(d)
    leaves = [torch.from_numpy(rng.standard_normal((70, 2, d)).astype(
        np.float32)).requires_grad_() for _ in range(3)]
    dout = torch.from_numpy(rng.standard_normal((70, 2, d)).astype(
        np.float32))
    ref_out = chunked_attention(*leaves, causal, block=32)
    ref = torch.autograd.grad(ref_out, leaves, dout)
    padded = pad_head_dim(*leaves)
    assert padded[0].shape[-1] == kernel_head_dim(d)
    out = chunked_attention(*padded, causal, block=32, scale=d ** -0.5)
    np.testing.assert_array_equal(out[..., d:].detach().numpy(), 0.0)
    out = out[..., :d]
    got = torch.autograd.grad(out, leaves, dout)
    torch.testing.assert_close(out, ref_out, rtol=PAD_TOL, atol=PAD_TOL)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=PAD_TOL, atol=PAD_TOL)


def test_k1_grad_dtype_and_shapes():
    q, k, v, dout, nbr, val = _case(40, 6, 2, 8, seed=7)
    got = _port_grads(q, k, v, dout, nbr, val, 16, torch.bfloat16)
    assert [x.shape for x in got] == [q.shape, q.shape, k.shape, v.shape,
                                      val.shape]


@pytest.mark.parametrize("n,heads", [(40, 2), (300, 8)])
def test_k1_backward_scratch_is_per_row_head(n, heads):
    """The backward's scratch is (lse, r, delta) a (row, head): f32
    [Nq, h, 4] and nothing else — nothing of size Nq·K (it is sized by q
    alone)."""
    q = torch.zeros(n, heads, 32 // heads * 4)
    scratch = graph_backward_scratch(q)
    assert [(tuple(t.shape), t.dtype) for t in scratch.values()] == [
        ((n, heads, 4), torch.float32)]
