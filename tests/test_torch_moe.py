"""Port parity for expert parallelism: the port's ``moe_apply`` on worlds
of 1, 2 and 4 CPU ranks (gloo, one process a rank and an expert, from
tests/torch_parallel_worker.py), each rank's token shard put back
together, against the JAX package's ``moe_apply`` on an ``expert`` mesh
of as many devices — the cases of tests/test_moe.py: ample capacity
(against a dense reference too), capacity drops, the gradients of the
experts and the gates, and the shape errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.parallel.mesh import mesh_context
from dragonfly2_tpu.parallel.moe import moe_apply as jax_moe
from dragonfly2_tpu_torch.parallel import (
    EXCHANGES,
    moe_apply,
    stack_stage_params,
)
from tests.torch_dist_worker import spawn_worlds

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
WORLDS = (1, 2, 4)


def jax_expert(params, x):
    return jnp.tanh(x @ params["w"]) + params["b"]


def make_experts(n, d, seed=0):
    """tests/test_moe.py's experts."""
    rng = np.random.default_rng(seed)
    return stack_stage_params([
        {"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
         "b": rng.standard_normal(d).astype(np.float32) * 0.1}
        for _ in range(n)])


def dense_reference(params, x, gates):
    probs = np.exp(gates - gates.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argmax(gates, axis=-1)
    out = np.zeros_like(x, dtype=np.float64)
    for t, e in enumerate(idx):
        out[t] = (np.tanh(x[t] @ params["w"][e]) + params["b"][e]) \
            * probs[t, e]
    return out


def _cases(world):
    """name → (experts, x, gates, capacity factor, gradients)."""
    rng = np.random.default_rng(1)
    ample = (make_experts(world, 16), rng.standard_normal(
        (64, 16)).astype(np.float32), rng.standard_normal(
        (64, world)).astype(np.float32), 8.0, False)
    # Every token wants the last expert, capacity ceil(t / E) a rank.
    gates = np.full((64, world), -10.0, np.float32)
    gates[:, world - 1] = 10.0
    drops = (make_experts(world, 8), np.ones((64, 8), np.float32), gates,
             1.0, False)
    rng = np.random.default_rng(2)
    grad = (make_experts(world, 8, seed=3), rng.standard_normal(
        (32, 8)).astype(np.float32), rng.standard_normal(
        (32, world)).astype(np.float32), 8.0, True)
    # Every gate tied: jnp.argmax takes the first index, expert 0.
    ties = (make_experts(world, 8, seed=4), rng.standard_normal(
        (32, 8)).astype(np.float32), np.zeros((32, world), np.float32), 8.0,
        False)
    return {"ample": ample, "drops": drops, "grad": grad, "ties": ties}


def _rank_case(params, x, gates, factor, grad, **extra):
    return dict(call="run_moe", module="torch_parallel_worker",
                w=params["w"], b=params["b"], x=x, gates=gates,
                capacity_factor=factor, grad=grad, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    worlds = {}
    for world in WORLDS:
        cases = {name: _rank_case(*args)
                 for name, args in _cases(world).items()}
        experts = make_experts(world, 8)
        cases["bad_x"] = _rank_case(
            experts, np.zeros((2, 16, 8), np.float32),
            np.zeros((2, world), np.float32), 1.25, False, expect_error=True)
        cases["bad_gates"] = _rank_case(
            experts, np.zeros((16, 8), np.float32),
            np.zeros((16, world + 1), np.float32), 1.25, False,
            expect_error=True)
        cases["bad_experts"] = _rank_case(
            make_experts(2 * world, 8), np.zeros((16, 8), np.float32),
            np.zeros((16, world), np.float32), 1.25, False,
            expect_error=True)
        worlds[world] = cases
    return spawn_worlds(worlds, str(tmp_path_factory.mktemp("moe")),
                        timeout_s=120.0)


@pytest.fixture(scope="module")
def jax_refs():
    refs = {}
    for world in WORLDS:
        mesh = jax.make_mesh((world,), ("expert",),
                             devices=jax.devices()[:world])
        for name, (params, x, gates, factor, grad) in _cases(world).items():
            def run(p, x, g, factor=factor):
                return jax_moe(jax_expert, p, x, g, mesh=mesh,
                               capacity_factor=factor)

            ref = {"out": np.asarray(jax.jit(run)(params, x, gates))}
            if grad:
                with mesh_context(mesh):
                    gp, gg = jax.jit(jax.grad(
                        lambda p, g: (run(p, x, g) ** 2).sum(),
                        argnums=(0, 1)))(params, gates)
                ref.update(dw=np.asarray(gp["w"]), db=np.asarray(gp["b"]),
                           dgates=np.asarray(gg))
            refs[world, name] = ref
    return refs


@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax_and_dense_reference(runs, jax_refs, world):
    """Ample capacity: nothing drops, so routed equals dense."""
    out = np.concatenate(runs[world]["ample"]["out"])
    np.testing.assert_allclose(out, jax_refs[world, "ample"]["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    params, x, gates, _, _ = _cases(world)["ample"]
    np.testing.assert_allclose(out, dense_reference(params, x, gates),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_capacity_drops_excess_tokens(runs, jax_refs, world):
    """Every token gated to one expert: each rank keeps its first
    ceil(t / E) tokens and zeroes the rest, as JAX does."""
    shards = runs[world]["drops"]["out"]
    t_loc = 64 // world
    capacity = -(-t_loc // world)
    for rows in shards:
        nonzero = np.abs(rows).sum(axis=1) > 0
        assert nonzero.sum() == capacity, nonzero
        assert nonzero[:capacity].all()
    np.testing.assert_allclose(np.concatenate(shards),
                               jax_refs[world, "drops"]["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_grads_flow_to_experts_and_gates(runs, jax_refs, world):
    got, ref = runs[world]["grad"], jax_refs[world, "grad"]
    np.testing.assert_allclose(np.concatenate(got["out"]), ref["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    for key in ("dw", "db"):
        np.testing.assert_allclose(np.stack(got[key]), ref[key],
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)
    dgates = np.concatenate(got["dgates"])
    np.testing.assert_allclose(dgates, ref["dgates"], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    # The straight-through combine gives the gate a real gradient (with
    # one expert its softmax is 1 whatever the logit).
    assert (np.abs(dgates).sum() > 0) == (world > 1)


@pytest.mark.parametrize("world", WORLDS)
def test_rejects_bad_shapes(runs, world):
    cases = runs[world]
    assert all("flatten batch" in str(e) for e in cases["bad_x"]["error"])
    assert all("gate_logits" in str(e)
               for e in cases["bad_gates"]["error"])
    assert all("experts" in str(e) for e in cases["bad_experts"]["error"])


@pytest.mark.parametrize("world", WORLDS)
def test_tied_gates_take_the_first_expert(runs, jax_refs, world):
    """``argmax`` over tied logits picks expert 0, as ``jnp.argmax``."""
    params, x, gates, _, _ = _cases(world)["ties"]
    out = np.concatenate(runs[world]["ties"]["out"])
    np.testing.assert_allclose(out, jax_refs[world, "ties"]["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(
        out, (np.tanh(x @ params["w"][0]) + params["b"][0]) / world,
        rtol=FWD_TOL, atol=FWD_TOL)


def test_world_of_one_makes_no_exchange():
    """Without a process group the exchanges are the identity."""
    params = {k: torch.from_numpy(v) for k, v in make_experts(1, 4).items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 4)).astype(np.float32))
    EXCHANGES.reset()
    out = moe_apply(lambda p, x: torch.tanh(x @ p["w"]) + p["b"], params, x,
                    torch.zeros(6, 1), capacity_factor=1.0)
    assert EXCHANGES.read()["all_to_all"] == 0
    np.testing.assert_allclose(
        out.numpy(), dense_reference({k: v.numpy() for k, v in params.items()},
                                     x.numpy(), np.zeros((6, 1), np.float32)),
        rtol=FWD_TOL, atol=FWD_TOL)
