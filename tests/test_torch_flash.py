"""Port parity for K3: the port's ``flash_attention`` on CPU tensors (the
plain ``chunked_attention`` scan, its backward through PyTorch's
autograd) against the JAX package's Pallas kernel in interpret mode —
the TPU kernel's own code path — and its custom VJP, on the cases of
tests/test_flash_attention.py; plus the plain scan against JAX's and the
wrapper's refusals. The CUDA kernels themselves run in
``chip_smoke.py`` on the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops.flash_attention import (
    chunked_attention as jax_chunked_attention,
)
from dragonfly2_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from dragonfly2_tpu_torch.ops import flash_attention
from dragonfly2_tpu_torch.ops.flash_attention import (
    EXP2_POLY_REL_ERR,
    FORWARD_TILING,
    HEAD_DIMS,
    LOG2E,
    NEG_INF,
    check_flash_inputs,
    chunked_attention,
    exp2_ftz,
    exp2_poly,
    flash_backward_plain,
    flash_forward_plain,
    forward_tiling,
    k3_route,
    poly_columns,
)

# The JAX tests' own tolerances: forward in f32 (the same algebra in
# another summation order), gradients, and bf16 against the f32 result.
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = 5e-2


def _qkv(t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, h, d)).astype(np.float32)
                 for _ in range(3))


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


# (T, causal, block_q, block_k): tests/test_flash_attention.py's cases.
# The blocks reach the JAX kernel only: the port takes none.
FWD_CASES = [
    pytest.param(128, False, 32, 32, id="full"),
    pytest.param(128, True, 32, 32, id="causal"),
    pytest.param(100, True, 32, 32, id="ragged-t"),
    pytest.param(128, False, 64, 32, id="asymmetric"),
    pytest.param(128, True, 128, 96, id="non-dividing-128-96"),
    pytest.param(128, True, 96, 128, id="non-dividing-96-128"),
    pytest.param(128, True, 48, 32, id="non-dividing-48-32"),
]


@pytest.mark.parametrize("t,causal,bq,bk", FWD_CASES)
def test_forward_matches_pallas_kernel(t, causal, bq, bk):
    q, k, v = _qkv(t, 2, 16, seed=t + bq + bk)
    ref = jax_flash_attention(q, k, v, causal, bq, bk, True)
    before = flash_attention.launches
    out = flash_attention(*_torch(q, k, v), causal)
    assert out.shape == (t, 2, 16) and out.dtype == torch.float32
    assert flash_attention.launches == before   # the CPU path launches nothing
    _close(out.numpy(), ref, FWD_TOL)


@pytest.mark.parametrize("t,causal,bq,bk", [
    pytest.param(64, True, 32, 32, id="causal"),
    pytest.param(100, False, 32, 32, id="ragged-full"),
    pytest.param(100, True, 48, 32, id="ragged-causal-non-dividing"),
])
def test_grads_match_custom_vjp(t, causal, bq, bk):
    q, k, v = _qkv(t, 2, 16, seed=3)
    ref = jax.grad(lambda q, k, v: (jax_flash_attention(
        q, k, v, causal, bq, bk, True) ** 2).sum(), argnums=(0, 1, 2))(
            q, k, v)
    leaves = _torch(q, k, v, grad=True)
    (flash_attention(*leaves, causal) ** 2).sum().backward()
    for got, want in zip(leaves, ref):
        _close(got.grad.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_near_f32(causal):
    q, k, v = _qkv(100, 2, 16, seed=5)
    ref = jax_flash_attention(q, k, v, causal, 32, 32, True)
    out = flash_attention(*(x.to(torch.bfloat16) for x in _torch(q, k, v)),
                          causal)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), ref, BF16_TOL)


@pytest.mark.parametrize("block", [16, 32, 100, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_matches_jax_forward_and_grads(block, causal):
    """Key blocks smaller than T, a ragged tail (88 = 5·16 + 8), and a
    block past T."""
    q, k, v = _qkv(88, 2, 4, seed=block)
    ref = jax_chunked_attention(q, k, v, causal, block)
    ref_grads = jax.grad(lambda q, k, v: (jax_chunked_attention(
        q, k, v, causal, block) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
    leaves = _torch(q, k, v, grad=True)
    out = chunked_attention(*leaves, causal, block)
    _close(out.detach().numpy(), ref, FWD_TOL)
    (out ** 2).sum().backward()
    for got, want in zip(leaves, ref_grads):
        _close(got.grad.numpy(), want, GRAD_TOL)


def test_chunked_bf16_matches_jax():
    q, k, v = _qkv(88, 2, 8, seed=9)
    ref = jax_chunked_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)), True, 32)
    out = chunked_attention(*(x.to(torch.bfloat16) for x in _torch(q, k, v)),
                            True, 32)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), np.asarray(ref, np.float32), BF16_TOL)


def test_chunked_counts_calls():
    q, k, v = _torch(*_qkv(16, 1, 4))
    before = chunked_attention.calls
    flash_attention(q, k, v)
    chunked_attention(q, k, v)
    assert chunked_attention.calls == before + 2


def test_chunked_backward_keeps_scores_out_of_memory():
    """Under autograd each key block is checkpointed: nothing autograd
    keeps is as large as one block's [h, T, block] scores, let alone the
    dense [h, T, T] ones."""
    t, h, d, block = 256, 2, 4, 32
    leaves = _torch(*_qkv(t, h, d), grad=True)
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = chunked_attention(*leaves, True, block)
    assert sizes and max(sizes) < h * t * block
    (out ** 2).sum().backward()
    assert all(x.grad is not None for x in leaves)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_takes_every_head_dim(d):
    q, k, v = (torch.zeros(5, 3, d, dtype=torch.bfloat16) for _ in range(3))
    check_flash_inputs(q, k, v)


@pytest.mark.parametrize("shape,dtype,error", [
    pytest.param((8, 2, 12), torch.float32, ValueError, id="head-dim-12"),
    pytest.param((8, 2, 256), torch.float32, ValueError, id="head-dim-256"),
    pytest.param((8, 16), torch.float32, ValueError, id="two-dims"),
    pytest.param((0, 2, 8), torch.float32, ValueError, id="empty-t"),
    pytest.param((8, 2, 8), torch.float16, TypeError, id="fp16"),
])
def test_kernel_input_refusals(shape, dtype, error):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        check_flash_inputs(q, q, q)


def test_kernel_refuses_mixed_and_strided_inputs():
    q = torch.zeros(8, 2, 8)
    with pytest.raises(TypeError):
        check_flash_inputs(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        check_flash_inputs(q, q[:, :, :4], q)
    strided = torch.zeros(2, 8, 8).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        check_flash_inputs(strided, strided, strided)
    shifted = torch.zeros(8 * 2 * 8 + 1)[1:].view(8, 2, 8)
    with pytest.raises(ValueError, match="aligned"):
        check_flash_inputs(shifted, shifted, shifted)


def test_off_cpu_never_falls_back_to_the_scan():
    """A tensor that is not on the CPU launches the kernel or raises: on a
    device that is not CUDA it raises, without running the scan."""
    q = torch.zeros(8, 2, 8, device="meta")
    before = chunked_attention.calls
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    assert chunked_attention.calls == before


@pytest.mark.parametrize("dtype,d,heads,route", [
    pytest.param(torch.bfloat16, 128, 4, "sm90", id="bf16-128"),
    pytest.param(torch.bfloat16, 64, 3, "sm90", id="bf16-64"),
    pytest.param(torch.bfloat16, 32, 8, "mma", id="bf16-32"),
    pytest.param(torch.bfloat16, 8, 8, "mma", id="bf16-8"),
    pytest.param(torch.bfloat16, 4, 3, "mma", id="bf16-4x3-24-byte-rows"),
    pytest.param(torch.float32, 128, 4, "fma", id="f32-128"),
    pytest.param(torch.float32, 8, 8, "fma", id="f32-8"),
])
def test_route_by_dtype_and_head_dim(dtype, d, heads, route):
    row_bytes = heads * d * torch.empty((), dtype=dtype).element_size()
    assert k3_route(dtype, d, row_bytes) == route


def test_route_never_gives_tma_a_stride_it_cannot_take():
    """TMA needs 16-byte global strides: a head_dim-64 row of 24 bytes
    (not a shape the wrapper takes, but the rule the route holds) and
    head_dim 4 with 3 heads (24-byte rows) stay off the sm90 route."""
    assert k3_route(torch.bfloat16, 64, 24) == "mma"
    assert all(k3_route(torch.bfloat16, 4, heads * 8) == "mma"
               for heads in range(1, 9))


def _jax_loss_grads(q, k, v, causal):
    return jax.grad(lambda q, k, v: (jax_chunked_attention(
        q, k, v, causal, 512) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("t", [1, 100, 300])
def test_tile_backward_matches_jax_gradient(t, d, causal):
    """The kernels' order written as plain tile loops (forward with lse;
    backward with P once, dS rounded where a product takes it, dQ added
    in ascending key-tile order) against JAX's gradient of
    chunked_attention for the loss sum(out²), in f32."""
    q, k, v = _qkv(t, 2, d, seed=t + d)
    ref_out = np.asarray(jax_chunked_attention(q, k, v, causal, 512))
    ref = _jax_loss_grads(q, k, v, causal)
    tq, tk, tv = _torch(q, k, v)
    out, lse = flash_forward_plain(tq, tk, tv, causal)
    _close(out.numpy(), ref_out, FWD_TOL)
    grads = flash_backward_plain(tq, tk, tv, out, 2 * out, lse, causal)
    for got, want in zip(grads, ref):
        _close(got.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tile_backward_bf16_near_f32(causal):
    """In bf16 (p and dS rounded as the kernels round them) the tile loops
    stay within the bf16 tolerance of JAX's f32 gradient, relative to its
    largest entry."""
    q, k, v = _qkv(100, 2, 8, seed=11)
    ref = _jax_loss_grads(q, k, v, causal)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    out, lse = flash_forward_plain(tq, tk, tv, causal)
    grads = flash_backward_plain(tq, tk, tv, out, 2 * out, lse, causal)
    for got, want in zip(grads, ref):
        want = np.asarray(want)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max(), err


# -- the bf16 forward kernel's exponential split ----------------------------


@pytest.mark.parametrize("lo,hi", [(-126, -100), (-100, -10), (-10, -1),
                                   (-1, 0), (-0.01, 0)])
def test_exp2_poly_relative_error(lo, hi):
    """The FP32-pipe exp2 against torch.exp2 in f64 over the range the
    kernel feeds it (scores minus the running max, so x <= 0): within
    the stated relative error, and never 0 at or above -126."""
    x = torch.linspace(lo, hi, 200_001, dtype=torch.float64).float()
    got = exp2_poly(x).double()
    err = (got / torch.exp2(x.double()) - 1).abs().max().item()
    assert err <= EXP2_POLY_REL_ERR, err
    assert (got > 0).all()


@pytest.mark.parametrize("lo,hi", [(-150, -126), (-127, -125),
                                   (-126.001, -125.999)])
def test_exp2_poly_and_ex2_agree_on_zeros(lo, hi):
    """Both exp2 forms give exactly 0 below -126 and nowhere else, so a
    pair is masked or flushed alike whichever form its position takes."""
    x = torch.linspace(lo, hi, 100_001, dtype=torch.float64).float()
    poly, ftz = exp2_poly(x), exp2_ftz(x)
    assert torch.equal(poly == 0, ftz == 0)
    assert torch.equal(poly == 0, x < -126)


@pytest.mark.parametrize("x", [-math.inf, NEG_INF, NEG_INF * LOG2E / 2,
                               -126.5, -1e30])
def test_exp2_poly_masked_scores_give_zero(x):
    """A masked score (-inf in the kernel, NEG_INF in the running max)
    and any argument below -126 give exactly 0 in both forms."""
    arg = torch.tensor([x], dtype=torch.float32)
    assert exp2_poly(arg).item() == 0.0 and exp2_ftz(arg).item() == 0.0


@pytest.mark.parametrize("tile,poly", [(128, 1), (128, 3), (64, 0),
                                       (64, 2)])
def test_poly_columns_are_a_tiles_last_blocks(tile, poly):
    cols = poly_columns(tile, poly)
    assert cols.shape == (tile,) and int(cols.sum()) == 8 * poly
    assert cols[tile - 8 * poly:].all() and not cols[:tile - 8 * poly].any()


def test_forward_tiling_covers_the_mma_route():
    """Every bf16 head_dim of the "mma" route has a tiling: a whole number
    of 16-key steps, and at most all of a tile's blocks on the
    polynomial; other widths fall back to 128-key tiles, no split."""
    for d in HEAD_DIMS:
        if k3_route(torch.bfloat16, d, 8 * d * 2) == "mma":
            tile, poly = FORWARD_TILING[d]
            assert tile % 16 == 0 and 0 <= poly <= tile // 8
    assert forward_tiling(128) == (128, 0)


# Any share exercises the twin's split in f32; the kernel's own share is
# held in bf16 below.
SPLIT_BLOCKS = 3


SPLIT_CASES = [pytest.param(t, d, causal, id=f"t{t}-d{d}-{name}")
               for d in (4, 8, 16, 32) for t in (1, 100, 300)
               for causal, name in ((False, "full"), (True, "causal"))]


def _jax_refs(q, k, v, causal):
    """JAX's Pallas forward in interpret mode and its chunked scan."""
    return (np.asarray(jax_flash_attention(q, k, v, causal, 128, 128, True)),
            np.asarray(jax_chunked_attention(q, k, v, causal, 512)))


@pytest.mark.parametrize("t,d,causal", SPLIT_CASES)
def test_split_forward_bf16_matches_jax(t, d, causal):
    """The bf16 forward's twin (the kernel's key tiles at this head_dim,
    the last blocks of 8 keys of each on the polynomial exp2 as the
    kernel splits them) against JAX's kernel and scan in f32 on the same
    values, within the bf16 tolerance."""
    q, k, v = _qkv(t, 2, d, seed=17 * t + d)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    out, lse = flash_forward_plain(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16 and lse.shape == (2, t)
    assert torch.isfinite(lse).all()
    for ref in _jax_refs(q, k, v, causal):
        _close(out.float().numpy(), ref, BF16_TOL)


@pytest.mark.parametrize("t,d,causal", SPLIT_CASES)
def test_split_forward_f32_within_poly_error(t, d, causal):
    """In f32 the split moves out only by the polynomial's error: each p
    is off by a factor within 1 ± EXP2_POLY_REL_ERR, so out = Σ p v / Σ p
    moves by at most about 2 · EXP2_POLY_REL_ERR · max |v|; without the
    split the twin holds JAX's f32 tolerance."""
    q, k, v = _qkv(t, 2, d, seed=17 * t + d)
    tq, tk, tv = _torch(q, k, v)
    split, _ = flash_forward_plain(tq, tk, tv, causal,
                                   poly_blocks=SPLIT_BLOCKS)
    plain, _ = flash_forward_plain(tq, tk, tv, causal, poly_blocks=0)
    bound = 2 * EXP2_POLY_REL_ERR * float(np.abs(v).max())
    for ref in _jax_refs(q, k, v, causal):
        _close(plain.numpy(), ref, FWD_TOL)
        assert np.abs(split.numpy() - ref).max() <= bound + FWD_TOL


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [4, 8, 32])
@pytest.mark.parametrize("t", [1, 100, 300])
def test_backward_takes_the_split_forwards_lse(t, d, causal):
    """The backward's twin (unchanged, exp only) fed the lse of the split
    forward still gives JAX's gradient of chunked_attention within
    test_tile_backward_matches_jax_gradient's tolerance, in f32."""
    q, k, v = _qkv(t, 2, d, seed=t + 3 * d)
    ref = _jax_loss_grads(q, k, v, causal)
    tq, tk, tv = _torch(q, k, v)
    out, lse = flash_forward_plain(tq, tk, tv, causal,
                                   poly_blocks=SPLIT_BLOCKS)
    grads = flash_backward_plain(tq, tk, tv, out, 2 * out, lse, causal)
    for got, want in zip(grads, ref):
        _close(got.numpy(), want, GRAD_TOL)
