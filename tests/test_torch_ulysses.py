"""Port parity for Ulysses sequence parallelism: the port's
``ulysses_attention`` on worlds of 1, 2 and 4 CPU ranks (gloo, one
process a rank, from tests/torch_dist_worker.py), each rank's output
shard put back together, against the JAX package's ``ulysses_attention``
on the 8-device CPU mesh — forward, gradients, the ragged chunked scan
and the errors. The exchange moves values without arithmetic, so the
outputs agree to f32 rounding of the local scan."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.parallel import ulysses_attention as jax_ulysses
from dragonfly2_tpu.parallel.mesh import mesh_context
from dragonfly2_tpu_torch.ops.flash_attention import chunked_attention
from dragonfly2_tpu_torch.parallel import group_size_rank, ulysses_attention
from tests.torch_dist_worker import spawn_worlds

FWD_TOL = 1e-5
# Gradients: the JAX flash tests' tolerance (tests/test_flash_attention.py).
GRAD_TOL = 1e-4
WORLDS = (1, 2, 4)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


# name: (shape [T, H, D], seed, causal, chunk, gradients too)
CASES = {
    "full": ((64, 8, 4), 0, False, 1024, False),
    "causal": ((64, 8, 4), 1, True, 1024, False),
    "ragged-chunk": ((88, 8, 4), 4, True, 16, False),
    "grad": ((32, 8, 4), 3, True, 1024, True),
}


def _case(name):
    shape, seed, causal, chunk, grad = CASES[name]
    q, k, v = _qkv(shape, seed)
    return dict(q=q, k=k, v=v, causal=causal, chunk=chunk, grad=grad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks at once; world 2 and 4 also try heads that do
    not divide the group (3 and 6)."""
    worlds = {w: {name: _case(name) for name in CASES} for w in WORLDS}
    for world, heads in ((2, 3), (4, 6)):
        q, k, v = _qkv((16, heads, 4), 7)
        worlds[world]["indivisible"] = dict(q=q, k=k, v=v, causal=False,
                                            expect_error=True)
    return spawn_worlds(worlds, str(tmp_path_factory.mktemp("ulysses")))


@pytest.fixture(scope="module")
def jax_refs():
    mesh = data_parallel_mesh().mesh
    refs = {}
    for name, (_, _, causal, chunk, grad) in CASES.items():
        case = _case(name)
        args = (case["q"], case["k"], case["v"])
        refs[name] = {"out": np.asarray(jax.jit(lambda *a: jax_ulysses(
            *a, mesh=mesh, causal=causal, chunk=chunk))(*args))}
        if grad:
            with mesh_context(mesh):
                grads = jax.jit(jax.grad(lambda q, k, v: (jax_ulysses(
                    q, k, v, mesh=mesh, causal=causal, chunk=chunk) ** 2
                ).sum(), argnums=(0, 1, 2)))(*args)
            refs[name].update(zip(("dq", "dk", "dv"),
                                  (np.asarray(g) for g in grads)))
    return refs


@pytest.mark.parametrize("name", ["full", "causal", "ragged-chunk"])
@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_jax_mesh(runs, jax_refs, world, name):
    shards = runs[world][name]["out"]
    assert len(shards) == world
    assert all(s.shape == (CASES[name][0][0] // world, 8, 4) for s in shards)
    np.testing.assert_allclose(np.concatenate(shards), jax_refs[name]["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_grads_match_jax_mesh(runs, jax_refs, world):
    for key in ("out", "dq", "dk", "dv"):
        tol = FWD_TOL if key == "out" else GRAD_TOL
        np.testing.assert_allclose(np.concatenate(runs[world]["grad"][key]),
                                   jax_refs["grad"][key], rtol=tol, atol=tol)


@pytest.mark.parametrize("world", [2, 4])
def test_rejects_indivisible_heads(runs, world):
    for message in runs[world]["indivisible"]["error"]:
        assert "divisible" in str(message)


def test_world_of_one_is_the_local_scan():
    """No process group: no exchange, the scan over key blocks of chunk."""
    assert group_size_rank() == (1, 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv((40, 4, 8), 11))
    before = chunked_attention.calls
    out = ulysses_attention(q, k, v, causal=True, chunk=16)
    assert chunked_attention.calls == before + 1
    torch.testing.assert_close(out, chunked_attention(q, k, v, True, 16),
                               rtol=0, atol=0)


def test_off_cpu_never_runs_the_scan():
    """Tensors that are not on the CPU go to the kernel, which launches
    or raises: on a device that is not CUDA it raises, and the scan never
    runs."""
    q = torch.zeros(16, 4, 8, device="meta")
    before = chunked_attention.calls
    with pytest.raises(ValueError, match="CUDA"):
        ulysses_attention(q, q, q, causal=True)
    assert chunked_attention.calls == before


def test_rejects_non_3d_input():
    q = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="head_dim"):
        ulysses_attention(q, q, q)
