"""The port's fleet entry points (``parallel/multihost.py``) in real
processes on the CPU: two fleets of two ranks over ``tcp://localhost``,
one joined by ``init_multihost()`` from the JAX package's ``DF2_*``
environment names, one by ``maybe_init_multihost`` from arguments (the
counterpart of ``cmd/common.py``'s, which joins when a coordinator is
given). Each rank checks ``sync`` and ``agree``; the environment fleet
also runs the dryrun twin of ``__graft_entry__.dryrun_multichip``
(``parallel/dryrun.py``), which raises unless the ranks end bit-equal.
"""

import multiprocessing as mp
import os
import socket
import time

import numpy as np
import pytest

import torch_dp_worker as worker
from dragonfly2_tpu_torch.parallel import multihost
from torch_dist_worker import run_once

WORLD = 2
MODES = ("env", "args")
TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(out_dir):
    ctx = mp.get_context("spawn")
    procs = []
    for mode in MODES:
        address = f"localhost:{_free_port()}"
        for rank in range(WORLD):
            proc = ctx.Process(target=worker.multihost_rank,
                               args=(rank, WORLD, address, mode, out_dir))
            proc.start()
            procs.append((mode, rank, proc))
    deadline = time.monotonic() + TIMEOUT_S
    for *_, proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for *_, proc in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(5)
    failed = {}
    for mode, rank, proc in procs:
        if proc.exitcode != 0:
            err = os.path.join(out_dir, f"{mode}{rank}.err")
            failed[(mode, rank)] = (open(err).read() if os.path.exists(err)
                                    else f"exit code {proc.exitcode}")
    assert not failed, failed


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """``{mode: [rank 0's npz, rank 1's]}``, spawned once a test run."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent / f"multihost-{run}"
            if run else tmp_path_factory.mktemp("multihost"))
    run_once(str(root), lambda: _spawn(str(root)))
    return {mode: [dict(np.load(root / f"{mode}{rank}.npz"))
                   for rank in range(WORLD)] for mode in MODES}


def test_init_multihost_from_the_environment(fleets):
    """``DF2_COORDINATOR_ADDRESS`` / ``DF2_NUM_PROCESSES`` /
    ``DF2_PROCESS_ID`` start the default group; gloo and the CPU on a
    machine without a card."""
    for rank, got in enumerate(fleets["env"]):
        assert int(got["process_id"]) == rank
        assert int(got["num_processes"]) == WORLD
        assert str(got["backend"]) == "gloo"
        assert str(got["device"]) == "cpu"


def test_maybe_init_multihost_joins_from_arguments(fleets):
    """With a coordinator argument it joins and returns the default
    group."""
    for rank, got in enumerate(fleets["args"]):
        assert int(got["process_id"]) == rank
        assert int(got["num_processes"]) == WORLD
        assert bool(got["is_world"])


@pytest.mark.parametrize("mode", MODES)
def test_sync_and_agree(fleets, mode):
    """``agree`` all-gathers each rank's value in rank order, on every
    rank."""
    for got in fleets[mode]:
        np.testing.assert_array_equal(got["agree_int"], [1, 11])
        np.testing.assert_array_equal(got["agree_vec"],
                                      [[0, 0], [1, -1]])


def test_dryrun_twin_at_world_two(fleets):
    """One tiny data-parallel epoch of GraphSAGE, the MLP and the
    GraphTransformer (gather, blocks and ring), and one tensor-parallel
    epoch of the GraphTransformer on a 1 × 2 grid, whose rank must hold
    fewer parameter bytes than the replicated model: the ranks agreed on
    their digests (the dryrun raises otherwise, or on the bytes) and
    report the same losses; ring attention, the pipeline and the experts
    report the same finite global losses."""
    first, second = fleets["env"]
    names = sorted(k for k in first if k.startswith("loss/"))
    assert names == ["loss/gat_blocks", "loss/gat_gather", "loss/gat_ring",
                     "loss/gat_tp", "loss/graphsage", "loss/mlp",
                     "loss/moe", "loss/pipeline", "loss/ring_attention"]
    for name in names:
        assert np.isfinite(first[name]) and first[name] == second[name]


def test_maybe_init_multihost_is_none_without_a_coordinator(monkeypatch):
    for name in ("DF2_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.maybe_init_multihost() is None


def test_init_multihost_needs_the_three_values(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        for prefix in ("DF2_", "JAX_"):
            monkeypatch.delenv(prefix + name, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.init_multihost(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="outside"):
        multihost.init_multihost("localhost:1", 2, 2)


def test_sync_and_agree_alone():
    """Without a process group: no barrier, and ``agree`` is ``[value]``."""
    multihost.sync()
    np.testing.assert_array_equal(multihost.agree(np.int64(7)), [7])
