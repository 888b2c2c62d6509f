"""Port parity for ring attention: the port's ``ring_attention`` on worlds
of 1, 2 and 4 CPU ranks (gloo, one process a rank, from
tests/torch_parallel_worker.py), each rank's output shard put back
together, against the JAX package's ``ring_attention`` on a CPU mesh of
as many devices — the cases of tests/test_ring_attention.py: full,
causal, padded, batched, bf16 and the gradients. Both compute the same
algebra block by block; the outputs agree to f32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dragonfly2_tpu.parallel.mesh import mesh_context
from dragonfly2_tpu.parallel.ring_attention import (
    ring_attention as jax_ring_attention,
)
from dragonfly2_tpu_torch.parallel import EXCHANGES, ring_attention
from tests.torch_dist_worker import spawn_worlds

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# tests/test_ring_attention.py::test_bf16_path's limit against f32.
BF16_TOL = 5e-2
WORLDS = (1, 2, 4)
T = 64


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


# name: (shape, seed, causal, padded, grad, bf16)
CASES = {
    "full": ((T, 2, 8), 0, False, False, False, False),
    "causal": ((T, 2, 8), 1, True, False, False, False),
    "padding": ((T, 2, 8), 2, False, True, False, False),
    "batched": ((3, T, 2, 8), 3, True, False, False, False),
    "grad": ((32, 2, 8), 4, True, False, True, False),
    "bf16": ((T, 2, 8), 6, False, False, False, True),
}


def _case(name):
    shape, seed, causal, padded, grad, bf16 = CASES[name]
    q, k, v = _qkv(shape, seed)
    case = dict(call="run_ring_attention", module="torch_parallel_worker",
                q=q, k=k, v=v, causal=causal, grad=grad, bf16=bf16)
    if padded:
        case["valid"] = np.arange(shape[-3]) < 50
    return case


def dense_reference(q, k, v, causal=False, kv_valid=None):
    """tests/test_ring_attention.py's dense reference, in numpy f64."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    batched = q.ndim == 4
    s = np.einsum("bnhd,bmhd->bhnm" if batched else "nhd,mhd->hnm", q, k)
    s /= np.sqrt(q.shape[-1])
    t = q.shape[-3]
    mask = np.tril(np.ones((t, t), bool)) if causal else np.ones((t, t), bool)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    s = np.where(mask, s, -1e9)
    p = np.exp(s - s.max(-1, keepdims=True)) * mask
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhnm,bmhd->bnhd" if batched else "hnm,mhd->nhd", p, v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks at once, each running every case; world 2 and 4
    also try an input of the wrong rank."""
    worlds = {w: {name: _case(name) for name in CASES} for w in WORLDS}
    for world in (2, 4):
        worlds[world]["bad_ndim"] = dict(
            call="run_ring_attention", module="torch_parallel_worker",
            q=np.zeros((16, 32), np.float32), expect_error=True)
    return spawn_worlds(worlds, str(tmp_path_factory.mktemp("ring")),
                        timeout_s=120.0)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's ring_attention on a mesh of each world's size, every case."""
    refs = {}
    for world in WORLDS:
        mesh = _mesh(world)
        for name, (_, _, causal, _, grad, bf16) in CASES.items():
            case = _case(name)
            args = [jnp.asarray(case[n], jnp.bfloat16 if bf16 else None)
                    for n in ("q", "k", "v")]
            valid = (jnp.asarray(case["valid"]) if "valid" in case
                     else None)

            def fn(q, k, v, causal=causal, valid=valid):
                return jax_ring_attention(q, k, v, mesh=mesh, causal=causal,
                                          kv_valid=valid)

            ref = {"out": np.asarray(jax.jit(fn)(*args), np.float32)}
            if grad:
                with mesh_context(mesh):
                    grads = jax.jit(jax.grad(
                        lambda q, k, v: (fn(q, k, v) ** 2).sum(),
                        argnums=(0, 1, 2)))(*args)
                ref.update(zip(("dq", "dk", "dv"),
                               (np.asarray(g) for g in grads)))
            refs[world, name] = ref
    return refs


def _whole(shards, batched):
    return np.concatenate(shards, axis=1 if batched else 0)


@pytest.mark.parametrize("name", ["full", "causal", "padding", "batched"])
@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_jax_mesh(runs, jax_refs, world, name):
    shape, _, causal, padded, _, _ = CASES[name]
    batched = len(shape) == 4
    shards = runs[world][name]["out"]
    assert len(shards) == world
    assert all(s.shape[-3] == shape[-3] // world for s in shards)
    out = _whole(shards, batched)
    np.testing.assert_allclose(out, jax_refs[world, name]["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    case = _case(name)
    np.testing.assert_allclose(
        out, dense_reference(case["q"], case["k"], case["v"], causal,
                             case.get("valid")), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_grads_match_jax_mesh(runs, jax_refs, world):
    got, ref = runs[world]["grad"], jax_refs[world, "grad"]
    for key in ("out", "dq", "dk", "dv"):
        tol = FWD_TOL if key == "out" else GRAD_TOL
        np.testing.assert_allclose(np.concatenate(got[key]), ref[key],
                                   rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_path(runs, jax_refs, world):
    got = runs[world]["bf16"]
    assert all(str(d) == "torch.bfloat16" for d in got["dtype"])
    out = np.concatenate(got["out"])
    case = _case("bf16")
    np.testing.assert_allclose(out, jax_refs[world, "bf16"]["out"],
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(
        out, dense_reference(case["q"], case["k"], case["v"]),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_rejects_bad_rank_input(runs, world):
    for message in runs[world]["bad_ndim"]["error"]:
        assert "expected [T,h,d]" in str(message)


def test_world_of_one_makes_no_exchange():
    """No process group: one step over the rank's own block, no hop."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((40, 2, 8), 11))
    EXCHANGES.reset()
    out = ring_attention(q, k, v, causal=True)
    assert EXCHANGES.read()["ring_shift"] == 0
    np.testing.assert_allclose(
        out.numpy(), dense_reference(q.numpy(), k.numpy(), v.numpy(), True),
        rtol=FWD_TOL, atol=FWD_TOL)
