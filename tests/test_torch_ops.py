"""Port parity: the plain PyTorch versions of the hand-written kernels
against the JAX package's Pallas kernels (interpret mode) and their XLA
references, on the cases of tests/test_flash_attention.py and
tests/test_table_gather.py. On CPU tensors the wrappers take the plain
path and never count a launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.graph_transformer import (
    _divisor_block,
    sparse_graph_attention,
)
from dragonfly2_tpu.models.graph_transformer import (
    neighbor_gather as jax_neighbor_gather,
)
from dragonfly2_tpu.ops.flash_attention import (
    graph_flash_attention as jax_graph_flash_attention,
)
from dragonfly2_tpu.ops.table_gather import neighbor_gather_pallas
from dragonfly2_tpu.ops.table_gather import table_gather as jax_table_gather
from dragonfly2_tpu.ops.table_gather import (
    table_scatter_add as jax_table_scatter_add,
)
from dragonfly2_tpu_torch.models.graph_transformer import (
    PAD_ID,
    build_inverse_index,
)
from dragonfly2_tpu_torch.ops.flash_attention import (
    graph_flash_attention,
    graph_flash_attention_plain,
)
from dragonfly2_tpu_torch.ops.table_gather import (
    inverse_index_csr,
    neighbor_gather,
    table_gather,
    table_gather_plain,
    table_scatter_add,
    table_scatter_add_plain,
)

# f32 on both sides: the same algebra in another summation order.
ATOL = RTOL = 2e-5
# Scatter-add and the gather's backward: f32 sums of the same terms in
# another order, then one rounding to the output dtype — 1e-6 in f32 and
# one bf16 ulp (2^-8 relative) of the largest entry in bf16. Measured on
# these cases: 0 in both dtypes, against the Pallas kernel in interpret
# mode and against the inverse-index VJP.
SCATTER_TOL = {"f32": 1e-6, "bf16": 2.0 ** -8}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _graph_case(n, k_width, h=2, d=16, seed=0):
    """Random neighbor lists with the build_neighbor_lists invariants:
    deduped (row, col), a self slot per row, PAD_ID padding."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((n, h, d)).astype(np.float32)
               for _ in range(3))
    nbr = np.full((n, k_width), PAD_ID, dtype=np.int32)
    val = np.zeros((n, k_width), dtype=np.float32)
    others = np.arange(n, dtype=np.int32)
    for r in range(n):
        deg = int(rng.integers(1, k_width))
        pool = np.delete(others, r)
        cols = np.concatenate([[r], rng.choice(
            pool, size=deg - 1, replace=False)]).astype(np.int32)
        nbr[r, :deg] = cols
        val[r, :deg] = -rng.random(deg).astype(np.float32)
        val[r, 0] = 0.0
    return q, k, v, nbr, val


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,kw,block", [(128, 8, 32), (96, 5, 32),
                                        (64, 16, 64), (100, 8, 32),
                                        (70, 4, 64)])
def test_graph_flash_plain_matches_jax(n, kw, block):
    q, k, v, nbr, val = _graph_case(n, kw, seed=n)
    kernel = jax_graph_flash_attention(q, k, v, nbr, val, block, block, True)
    scan = sparse_graph_attention(q, k, v, nbr, val, _divisor_block(n, 32))
    got = graph_flash_attention_plain(*_torch(q, k, v, nbr, val), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan),
                               rtol=RTOL, atol=ATOL)


def test_graph_flash_all_pad_row_is_zero():
    q, k, v, nbr, val = _graph_case(64, 4, seed=9)
    nbr[3, :] = PAD_ID
    ref = jax_graph_flash_attention(q, k, v, nbr, val, 32, 32, True)
    got = graph_flash_attention_plain(*_torch(q, k, v, nbr, val), 32)
    np.testing.assert_array_equal(got.numpy()[3], 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_graph_flash_wrapper_takes_plain_path_on_cpu():
    q, k, v, nbr, val = _torch(*_graph_case(96, 5, seed=4))
    before = graph_flash_attention.launches
    out = graph_flash_attention(q, k, v, nbr, val, 32)
    assert graph_flash_attention.launches == before == 0
    torch.testing.assert_close(
        out, graph_flash_attention_plain(q, k, v, nbr, val, 32),
        rtol=0, atol=0)


def test_graph_flash_wrapper_refuses_non_cpu_without_kernel():
    q, k, v, nbr, val = _torch(*_graph_case(16, 4, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        graph_flash_attention(q.to("meta"), k, v, nbr, val)


@pytest.mark.parametrize("m", [16, 48, 37, 3])
def test_table_gather_plain_matches_jax(m):
    rng = np.random.default_rng(3 + m)
    t = rng.standard_normal((50, 128)).astype(np.float32)
    idx = rng.integers(0, 50, m).astype(np.int32)
    ref = np.asarray(jax_table_gather(jnp.asarray(t), jnp.asarray(idx),
                                      interpret=True, block=16))
    got = table_gather_plain(*_torch(t, idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_table_gather_bf16_exact():
    rng = np.random.default_rng(11)
    t = rng.standard_normal((20, 256)).astype(np.float32)
    idx = rng.integers(0, 20, 33).astype(np.int32)
    ref = jax_table_gather(jnp.asarray(t, jnp.bfloat16), jnp.asarray(idx),
                           interpret=True, block=16)
    got = table_gather_plain(torch.from_numpy(t).bfloat16(),
                             torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_table_gather_wrapper_takes_plain_path_on_cpu():
    t = torch.randn(30, 64, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([0, 29, 5, 5, 12], dtype=torch.int32)
    out = table_gather(t, idx)
    assert table_gather.launches == 0
    assert torch.equal(out, t.index_select(0, idx.long()))


def test_table_gather_wrapper_refuses_non_cpu_without_kernel():
    with pytest.raises(ValueError, match="CUDA"):
        table_gather(torch.zeros(4, 8, device="meta"),
                     torch.zeros(2, dtype=torch.int32))


def _assert_scatter_close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = SCATTER_TOL[dtype] * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", [37, 64, 200])
def test_table_scatter_add_plain_matches_jax(dtype, m):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(m)
    n_rows = 30
    ct = rng.standard_normal((m, 128)).astype(np.float32)
    ct[::7] = 0.0                         # zero rows, as padding uses them
    idx = rng.integers(0, 12, m).astype(np.int32)
    idx[:5] = 3                           # a heavily duplicated row
    ref = jax_table_scatter_add(jnp.asarray(ct, jdt), jnp.asarray(idx),
                                n_rows, interpret=True, block=16)
    got = table_scatter_add_plain(torch.from_numpy(ct).to(tdt),
                                  torch.from_numpy(idx), n_rows)
    assert got.dtype == tdt and got.shape == (n_rows, 128)
    assert not got[12:].any()             # rows no index names stay zero
    _assert_scatter_close(got, ref, dtype)


def _neighbor_case(n=40, kw=6, width=128, seed=5):
    """A gather-mode case: neighbor lists with PAD_ID slots, their gather
    indices (pads → row 0), a table, and a cotangent that is zero on pad
    slots as the model's masked softmax makes it."""
    rng = np.random.default_rng(seed)
    nbr = _graph_case(n, kw, seed=seed)[3]
    pad = nbr >= n
    idx = np.where(pad, 0, nbr).astype(np.int32)
    table = rng.standard_normal((n, width)).astype(np.float32)
    ct = rng.standard_normal((n, kw, width)).astype(np.float32)
    ct[pad] = 0.0
    return nbr, idx, table, ct


def test_scatter_add_through_inverse_index_equals_idx_path():
    nbr, idx, _, ct = _neighbor_case()
    n, kw = idx.shape
    inv = torch.from_numpy(build_inverse_index(nbr))
    flat_ct = torch.from_numpy(ct.reshape(n * kw, -1))
    flat_idx = torch.from_numpy(idx.reshape(-1))
    by_inv = table_scatter_add(flat_ct, flat_idx, n, inv)
    by_idx = table_scatter_add(flat_ct, flat_idx, n)
    assert table_scatter_add.launches == 0
    torch.testing.assert_close(by_inv, by_idx, rtol=0, atol=0)
    torch.testing.assert_close(
        by_inv, table_scatter_add_plain(flat_ct, flat_idx, n, inv),
        rtol=0, atol=0)


def test_inverse_index_csr_is_the_inverse_index():
    rng = np.random.default_rng(2)
    n, kw = 25, 7
    nbr = rng.integers(0, 10, (n, kw)).astype(np.int32)  # no padding
    inv = build_inverse_index(nbr)
    pos, offsets = inverse_index_csr(torch.from_numpy(nbr.reshape(-1)), n)
    for j in range(n):
        row = pos[offsets[j]:offsets[j + 1]].numpy()
        np.testing.assert_array_equal(row, inv[j][inv[j] >= 0])
    assert int(offsets[-1]) == n * kw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_neighbor_gather_grads_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    nbr, idx, table, ct = _neighbor_case()
    n, kw, width = ct.shape
    heads = 2
    inv = build_inverse_index(nbr)
    table_j, ct_j = jnp.asarray(table, jdt), jnp.asarray(ct, jdt)
    out_p, vjp_p = jax.vjp(lambda t: neighbor_gather_pallas(
        t, jnp.asarray(idx), interpret=True, block=16), table_j)
    (grad_p,) = vjp_p(ct_j)
    _, vjp_i = jax.vjp(lambda t: jax_neighbor_gather(
        t, jnp.asarray(idx), jnp.asarray(inv)),
        table_j.reshape(n, heads, width // heads))
    (grad_i,) = vjp_i(ct_j.reshape(n, kw, heads, width // heads))
    for port_inv in (None, torch.from_numpy(inv)):
        t = torch.from_numpy(table).to(tdt).requires_grad_()
        out = neighbor_gather(t, torch.from_numpy(idx), port_inv)
        np.testing.assert_array_equal(out.detach().float().numpy(),
                                      np.asarray(out_p, np.float32))
        out.backward(torch.from_numpy(ct).to(tdt))
        assert t.grad.dtype == tdt
        _assert_scatter_close(t.grad, grad_p, dtype)
        _assert_scatter_close(t.grad, np.asarray(grad_i).reshape(n, width),
                              dtype)


def test_table_scatter_add_wrapper_refuses_non_cpu_without_kernel():
    with pytest.raises(ValueError, match="CUDA"):
        table_scatter_add(torch.zeros(4, 8, device="meta"),
                          torch.zeros(4, dtype=torch.int32), 3)
