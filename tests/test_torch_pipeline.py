"""Port parity for pipeline parallelism: the port's ``pipeline_apply`` on
worlds of 1, 2 and 4 CPU ranks (gloo, one process a rank and a stage,
from tests/torch_parallel_worker.py) against the JAX package's
``pipeline_apply`` on a ``stage`` mesh of as many devices and against
the stages run one after another — the cases of tests/test_pipeline.py:
the default schedule, more microbatches than stages, the gradients of
every stage's parameters (each held by its own rank) and of the input,
and the errors: ragged microbatches, a stage count that is not the
world's, zero microbatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.parallel.mesh import mesh_context
from dragonfly2_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from dragonfly2_tpu_torch.parallel import (
    EXCHANGES,
    pipeline_apply,
    stack_stage_params,
)
from tests.torch_dist_worker import spawn_worlds

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
WORLDS = (1, 2, 4)


def make_params(n_stages, d, seed=0):
    """tests/test_pipeline.py's stages."""
    rng = np.random.default_rng(seed)
    return stack_stage_params([
        {"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
         "b": rng.standard_normal(d).astype(np.float32) * 0.1}
        for _ in range(n_stages)])


def jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def sequential(stacked, x):
    for s in range(stacked["w"].shape[0]):
        x = jax_stage(jax.tree.map(lambda p: p[s], stacked), x)
    return x


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cases(world):
    """name → (params, x, microbatches, y for the gradient case)."""
    return {
        "default": (make_params(world, 16), _x((32, 16), 1), None, None),
        "more_microbatches": (make_params(world, 8), _x((48, 8), 2), 16,
                              None),
        "grad": (make_params(world, 8, seed=3), _x((16, 8), 4), None,
                 _x((16, 8), 5)),
    }


def _rank_case(params, x, micro, y, **extra):
    case = dict(call="run_pipeline", module="torch_parallel_worker",
                w=params["w"], b=params["b"], x=x, **extra)
    if micro is not None:
        case["microbatches"] = micro
    if y is not None:
        case["y"] = y
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    worlds = {}
    for world in WORLDS:
        cases = {name: _rank_case(*args)
                 for name, args in _cases(world).items()}
        bad = make_params(world, 8)
        cases["ragged"] = _rank_case(bad, np.zeros((30, 8), np.float32), 4,
                                     None, expect_error=True)
        cases["stage_mismatch"] = _rank_case(
            make_params(2 * world, 8), np.zeros((16, 8), np.float32), None,
            None, expect_error=True)
        cases["zero_microbatches"] = _rank_case(
            bad, np.zeros((16, 8), np.float32), 0, None, expect_error=True)
        worlds[world] = cases
    return spawn_worlds(worlds, str(tmp_path_factory.mktemp("pipeline")),
                        timeout_s=120.0)


@pytest.fixture(scope="module")
def jax_refs():
    refs = {}
    for world in WORLDS:
        mesh = jax.make_mesh((world,), ("stage",),
                             devices=jax.devices()[:world])
        for name, (params, x, micro, y) in _cases(world).items():
            def run(p, x, micro=micro):
                return jax_pipeline(jax_stage, p, x, mesh=mesh,
                                    microbatches=micro)

            ref = {"out": np.asarray(jax.jit(run)(params, x)),
                   "seq": np.asarray(sequential(params, x))}
            if y is not None:
                def pipe_loss(p, x):
                    return ((run(p, x) - y) ** 2).mean()

                def seq_loss(p, x):
                    return ((sequential(p, x) - y) ** 2).mean()

                with mesh_context(mesh):
                    g_pipe = jax.jit(jax.grad(pipe_loss, argnums=(0, 1)))(
                        params, x)
                g_seq = jax.grad(seq_loss, argnums=(0, 1))(params, x)
                for tag, (gp, gx) in (("", g_pipe), ("seq_", g_seq)):
                    ref.update({f"{tag}dw": np.asarray(gp["w"]),
                                f"{tag}db": np.asarray(gp["b"]),
                                f"{tag}dx": np.asarray(gx)})
            refs[world, name] = ref
    return refs


@pytest.mark.parametrize("name", ["default", "more_microbatches"])
@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax_and_sequential(runs, jax_refs, world, name):
    """Every rank returns the whole output, equal to JAX's pipeline and to
    the stages run one after another."""
    ref = jax_refs[world, name]
    for out in runs[world][name]["out"]:
        np.testing.assert_allclose(out, ref["out"], rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(out, ref["seq"], rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_grads_match_jax_and_sequential(runs, jax_refs, world):
    """Rank s holds stage s's gradient (the all-reduce's backward is the
    identity, so not S times it); every rank holds x's."""
    got, ref = runs[world]["grad"], jax_refs[world, "grad"]
    for key in ("dw", "db"):
        stacked = np.stack(got[key])
        for tag in ("", "seq_"):
            np.testing.assert_allclose(stacked, ref[tag + key],
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=tag + key)
    for dx in got["dx"]:
        for tag in ("", "seq_"):
            np.testing.assert_allclose(dx, ref[tag + "dx"], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=tag + "dx")


@pytest.mark.parametrize("world", WORLDS)
def test_rejects_bad_schedules(runs, world):
    """The JAX package's three refusals, word for word where they name a
    count."""
    cases = runs[world]
    assert all("microbatch" in str(e) for e in cases["ragged"]["error"])
    assert all(f"{2 * world} stages" in str(e)
               for e in cases["stage_mismatch"]["error"])
    assert all(">= 1" in str(e)
               for e in cases["zero_microbatches"]["error"])


def test_world_of_one_makes_no_exchange():
    """No process group: one stage, the microbatches in turn, no hop and
    no all-reduce — the stage applied to the whole batch."""
    params = {k: torch.from_numpy(v) for k, v in make_params(1, 8).items()}
    x = torch.from_numpy(_x((12, 8), 7))
    EXCHANGES.reset()
    out = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         params, x, microbatches=3)
    assert EXCHANGES.read() == dict.fromkeys(EXCHANGES.read(), 0)
    np.testing.assert_allclose(
        out.numpy(), np.tanh(x.numpy() @ params["w"][0].numpy()
                             + params["b"][0].numpy()),
        rtol=FWD_TOL, atol=FWD_TOL)
