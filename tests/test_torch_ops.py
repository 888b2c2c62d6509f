"""Port parity: the plain PyTorch versions of the hand-written kernels
against the JAX package's Pallas kernels (interpret mode) and their XLA
references, on the cases of tests/test_flash_attention.py and
tests/test_table_gather.py. On CPU tensors the wrappers take the plain
path and never count a launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.graph_transformer import (
    _divisor_block,
    sparse_graph_attention,
)
from dragonfly2_tpu.ops.flash_attention import (
    graph_flash_attention as jax_graph_flash_attention,
)
from dragonfly2_tpu.ops.table_gather import table_gather as jax_table_gather
from dragonfly2_tpu_torch.models.graph_transformer import PAD_ID
from dragonfly2_tpu_torch.ops.flash_attention import (
    graph_flash_attention,
    graph_flash_attention_plain,
)
from dragonfly2_tpu_torch.ops.table_gather import (
    table_gather,
    table_gather_plain,
)

# f32 on both sides: the same algebra in another summation order.
ATOL = RTOL = 2e-5


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
