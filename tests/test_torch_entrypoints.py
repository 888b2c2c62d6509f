"""The port's two serving entry points as processes:
``python -m dragonfly2_tpu_torch.cmd.inference`` and
``python -m dragonfly2_tpu_torch.cmd.trainer`` with ``--device cpu`` —
an announcer in this process uploads datasets to the trainer over the
wire, the trainer trains and registers the models in the shared
registry, the sidecar's watcher installs the new MLP, and its scores over
the wire equal a direct load of the same registry row here, bit for bit.
Without ``--device`` on a machine with no card, each command refuses to
start, naming ``DeviceFault``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.cmd.scheduler import TrainerClient
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference.sidecar import (
    InferenceClient,
    ModelReadyRequest,
    _scorer_from_artifact,
)
from dragonfly2_tpu_torch.manager import (
    Database,
    FilesystemObjectStore,
    ManagerService,
)
from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM
from dragonfly2_tpu_torch.scheduler.announcer import Announcer
from dragonfly2_tpu_torch.scheduler.storage import Storage, StorageConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_TIMEOUT_S = 120.0
# Training in the child takes about 10 s alone on the CPU; the tier-1
# run's other workers share the host.
LOAD_TIMEOUT_S = 240.0


def _env() -> dict:
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


class Child:
    """A command in a child process, its first stdout line read under a
    watchdog, stderr kept in a file for the failure message."""

    def __init__(self, module: str, args: list, tmp, expect: str):
        self.err_path = os.path.join(tmp, f"{module.rsplit('.', 1)[1]}.err")
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", module, *args], cwd=REPO,
                stdout=subprocess.PIPE, stderr=err, text=True, env=_env())
        watchdog = threading.Timer(START_TIMEOUT_S, self.proc.kill)
        watchdog.start()
        line = self.proc.stdout.readline()
        watchdog.cancel()
        if not line.startswith(expect):
            self.stop()
            raise AssertionError(f"{module} did not start: {line!r}\n"
                                 f"{self.stderr()}")
        self.target = line.rstrip().rsplit(" ", 1)[1]

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()
        finally:
            self.proc.stdout.close()


def _scheduler_storage(root) -> Storage:
    """A scheduler's datasets: 24 hosts' downloads and probes."""
    storage = Storage(str(root), StorageConfig(max_size=200_000))
    cluster = SyntheticCluster(n_hosts=24, seed=3)
    for rec in cluster.downloads(300):
        storage.create_download(rec)
    for rec in cluster.topology(600):
        storage.create_network_topology(rec)
    return storage


def _wait(what: str, predicate, timeout_s: float, children):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        for child in children:
            if child.proc.poll() is not None:
                raise AssertionError(f"a child died while waiting for "
                                     f"{what}:\n{child.stderr()}")
        value = predicate()
        if value:
            return value
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}:\n" + "\n".join(
        c.stderr() for c in children))


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """Both commands started, the announcer's upload trained and
    registered, the sidecar serving the registry's MLP: (the upload's
    response, the active registry row, the sidecar's client)."""
    tmp = tmp_path_factory.mktemp("entrypoints")
    db, objects = str(tmp / "manager.db"), str(tmp / "objects")
    children = []
    try:
        children.append(Child(
            "dragonfly2_tpu_torch.cmd.inference",
            ["--manager-db", db, "--object-store-dir", objects, "--host",
             "127.0.0.1", "--port", "0", "--reload-interval", "1",
             "--device", "cpu"], tmp, "inference sidecar serving on "))
        children.append(Child(
            "dragonfly2_tpu_torch.cmd.trainer",
            ["--manager-db", db, "--object-store-dir", objects,
             "--data-dir", str(tmp / "trainer"), "--host", "127.0.0.1",
             "--port", "0", "--device", "cpu"], tmp, "trainer serving on "))
        inference, trainer = children
        announcer = Announcer(
            host_id="sched-1", ip="127.0.0.1", hostname="sched-1",
            port=8002, storage=_scheduler_storage(tmp / "scheduler"),
            trainer_client=TrainerClient(trainer.target))
        response = announcer.train()
        registry = ManagerService(Database(db),
                                  FilesystemObjectStore(objects),
                                  device="cpu")
        active = _wait("the trainer's MLP in the registry",
                       lambda: registry.get_active_model("mlp"),
                       LOAD_TIMEOUT_S, children)
        client = InferenceClient(inference.target, timeout=30)
        _wait("the sidecar's install of the registry's MLP",
              lambda: client._client.ModelReady(
                  ModelReadyRequest("mlp"), timeout=30).version
              == active.version, LOAD_TIMEOUT_S, children)
        yield response, active, client
        client.close()
    finally:
        codes = [child.stop() for child in reversed(children)]
        assert codes == [0] * len(children), codes


def test_announcer_upload_accepted(loop):
    response = loop[0]
    assert response.host_id == "sched-1" and response.accepted_bytes > 0


def test_sidecar_serves_the_registry_version(loop):
    _, active, client = loop
    assert client.model_ready("mlp") and client.server_ready()
    assert client._client.ModelReady(ModelReadyRequest("mlp"),
                                     timeout=30).version == active.version


@pytest.mark.parametrize("rows", [1, 16, 64])
def test_scores_over_the_wire_equal_a_direct_load(loop, rows):
    _, active, client = loop
    inputs = np.random.default_rng(rows).uniform(
        0, 100, (rows, FEATURE_DIM)).astype(np.float32)
    got, version = client.model_infer_full("mlp", inputs)
    assert version == active.version
    direct = _scorer_from_artifact(active.artifact, device="cpu")
    np.testing.assert_array_equal(got, direct.score(inputs))


@pytest.mark.parametrize("module", ["inference", "trainer"])
def test_refuses_to_start_without_a_card(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would serve")
    args = ["--manager-db", str(tmp_path / "manager.db"), "--port", "0",
            "--object-store-dir", str(tmp_path / "objects")]
    if module == "trainer":
        args += ["--data-dir", str(tmp_path / "trainer")]
    out = subprocess.run(
        [sys.executable, "-m", f"dragonfly2_tpu_torch.cmd.{module}", *args],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "DeviceFault" in out.stderr
    assert "serving on" not in out.stdout


def test_multihost_flags_as_jax():
    """``cmd.common``'s multihost flags parse as JAX's, and without a
    coordinator the trainer takes the single-process path (no group)."""
    import argparse

    from dragonfly2_tpu.cmd import common as jax_common
    from dragonfly2_tpu_torch.cmd import common

    argv = ["--coordinator", "10.0.0.1:1234", "--num-processes", "4",
            "--process-id", "2"]
    parsed = []
    for module in (common, jax_common):
        parser = argparse.ArgumentParser()
        module.add_multihost_flags(parser)
        parsed.append((vars(parser.parse_args(argv)),
                       vars(parser.parse_args([]))))
    assert parsed[0] == parsed[1]
    env = {k: os.environ.pop(k) for k in ("DF2_COORDINATOR_ADDRESS",
                                         "JAX_COORDINATOR_ADDRESS")
           if k in os.environ}
    try:
        assert common.maybe_init_multihost(
            argparse.Namespace(**parsed[0][1])) is None
    finally:
        os.environ.update(env)


def test_profile_dir_writes_a_trace_a_cycle(tmp_path):
    """``--profile-dir``: each training cycle runs under
    ``torch.profiler`` and leaves one Chrome trace."""
    from dragonfly2_tpu_torch.cmd.trainer import ProfiledTraining

    class Stub:
        def train(self, ip, hostname, host_id, scheduler_id=0):
            torch.ones(64, 64) @ torch.ones(64, 64)
            return ("trained", host_id, scheduler_id)

    training = ProfiledTraining(Stub(), str(tmp_path / "traces"),
                                torch.device("cpu"))
    for cycle in range(2):
        assert training.train("1.1.1.1", "h", "host-1", 7) == (
            "trained", "host-1", 7)
    traces = sorted(os.listdir(tmp_path / "traces"))
    assert len(traces) == 2 and all(t.startswith("train-host-1-")
                                    for t in traces)
    with open(tmp_path / "traces" / traces[0]) as f:
        assert "traceEvents" in f.read()
