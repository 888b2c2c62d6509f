"""The model registry on S3: the port's ``ManagerService`` with the
validation gate on, and an ``InferenceService`` watching it, over
``S3ObjectStore`` against ``tests/fake_s3.py`` (every request's SigV4
verified), held against the JAX package's registry over its own S3 store
on the same script; and ``python -m dragonfly2_tpu_torch.cmd.manager
--object-store s3`` configured from its environment.

The script: an MLP v1 and v3 of seeded params and a NaN-poisoned v2
through the gate (each gate reads its candidate back from S3), the
watcher installing v3, a rollback of v3 after which the watcher rebuilds
v1 from S3. Held equal: the registry's states, the gate's verdicts, the
served version at each step, the objects in the bucket; ModelInfer
outputs within rtol = atol = BF16_TOL, the bf16 parity tolerance of
``tests/test_torch_evaluator.py`` (both packages serve the MLP in bf16,
and its outputs here are bandwidths of 4-30 MB/s). The gate's
correlation floor is lowered to -1: the params are seeded, not trained,
and the floor is a deployment knob; the NaN guard is not configurable
and still rejects v2.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu import manager as jax_manager
from dragonfly2_tpu.inference import modelguard as jax_guard
from dragonfly2_tpu.inference import sidecar as jax_sidecar
from dragonfly2_tpu.manager import objectstore as jax_store
from dragonfly2_tpu.manager import validation as jax_validation
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxStats
from dragonfly2_tpu_torch import manager as port_manager
from dragonfly2_tpu_torch.inference import modelguard as port_guard
from dragonfly2_tpu_torch.inference import sidecar as port_sidecar
from dragonfly2_tpu_torch.manager import objectstore as port_store
from dragonfly2_tpu_torch.manager import validation as port_validation
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM
from dragonfly2_tpu_torch.utils.servingstats import ServingStats
from tests.fake_s3 import FakeS3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 6e-2
HIDDEN = [32]


def mlp_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    widths = [FEATURE_DIM, *HIDDEN, 1]
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(
                np.float32),
            "bias": rng.normal(scale=0.1, size=(b,)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(widths, widths[1:]))}}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Artifact dirs of the same params in each package's format: good
    v1 and v3, and v1 NaN-poisoned."""
    from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
    from dragonfly2_tpu.train import checkpoint as jax_ckpt
    from dragonfly2_tpu_torch.models.mlp import Normalizer
    from dragonfly2_tpu_torch.train import checkpoint as port_ckpt

    base = tmp_path_factory.mktemp("registry-s3")
    mean = np.linspace(0, 10, FEATURE_DIM).astype(np.float32)
    std = np.linspace(1, 5, FEATURE_DIM).astype(np.float32)
    dirs = {"jax": {}, "port": {}}
    for tag, seed, poison in (("v1", 1, None), ("v3", 3, None),
                              ("nan", 1, "nan")):
        params = mlp_params(seed)
        for name, ckpt, norm, guard in (
                ("jax", jax_ckpt, JaxNormalizer, jax_guard),
                ("port", port_ckpt, Normalizer, port_guard)):
            tree = params if poison is None else guard.poison_params(
                params, poison)
            path = str(base / name / tag)
            ckpt.save_model(path, ckpt.mlp_tree(
                tree, norm(mean, std),
                norm(np.array([2.5], np.float32),
                     np.array([0.7], np.float32))),
                ckpt.ModelMetadata(model_id=f"s3-mlp-{tag}",
                                   model_type="mlp",
                                   config={"hidden": HIDDEN}))
            dirs[name][tag] = path
    return dirs


class Ctx:
    def abort(self, code, details):
        raise AssertionError(f"{code}: {details}")


PACKAGES = {
    "jax": dict(manager=jax_manager, store=jax_store, sidecar=jax_sidecar,
                validation=jax_validation, stats=JaxStats, device={}),
    "port": dict(manager=port_manager, store=port_store,
                 sidecar=port_sidecar, validation=port_validation,
                 stats=ServingStats, device={"device": "cpu"}),
}


def wait_for(predicate, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def registry_script(name: str, dirs: dict) -> dict:
    pkg = PACKAGES[name]
    features = np.random.default_rng(5).uniform(
        0, 50, (12, FEATURE_DIM)).astype(np.float32)
    with FakeS3(access_key="AK", secret_key="SK") as fake:
        stats = pkg["stats"]()
        manager = pkg["manager"].ManagerService(
            pkg["manager"].Database(),
            pkg["store"].S3ObjectStore(access_key="AK", secret_key="SK",
                                       endpoint_url=fake.endpoint),
            validation=pkg["validation"].ValidationConfig(
                min_rank_correlation=-1.0),
            serving_stats=stats, **pkg["device"])
        service = pkg["sidecar"].InferenceService(
            manager=manager, reload_interval=0.05, micro_batch=False,
            shadow_mode=False, serving_stats=stats, **pkg["device"])
        versions = []
        try:
            rows = []
            for tag in ("v1", "nan", "v3"):
                row = manager.create_model("s3-mlp", "mlp", "h", "1.1.1.1",
                                           "hn", {}, dirs[name][tag])
                versions.append(row.version)
                rows.append(row)
            verdicts = [(r.state, r.evaluation["validation"]["passed"])
                        for r in rows]

            def index(version):
                return versions.index(version) if version else None

            def infer():
                return np.asarray(service.ModelInfer(
                    pkg["sidecar"].ModelInferRequest(
                        model_name="mlp", inputs=features), Ctx()).outputs)

            service.serve_watcher()
            wait_for(lambda: service.serving_version("mlp") == versions[2])
            served = [index(service.serving_version("mlp"))]
            outputs = [infer()]
            restored = manager.quarantine_version(
                "mlp", versions[2], 0, reason="operator rollback")
            wait_for(lambda: service.serving_version("mlp") == versions[0])
            served.append(index(service.serving_version("mlp")))
            outputs.append(infer())
            states = sorted((index(r.version), r.state)
                            for r in manager.list_models())
            objects = {k: len(v) for k, v in fake.buckets["models"].items()
                       if k.endswith("model.tar")}
            assert len(objects) == 3
        finally:
            service.stop()
    return {"verdicts": verdicts, "served": served,
            "restored": index(restored.version), "states": states,
            "objects": len(objects), "outputs": outputs}


def test_registry_on_s3_matches_jax(artifacts):
    ref = registry_script("jax", artifacts)
    got = registry_script("port", artifacts)
    outputs = got.pop("outputs"), ref.pop("outputs")
    assert got == ref
    assert got["verdicts"] == [("active", True), ("quarantined", False),
                               ("active", True)]
    assert got["served"] == [2, 0] and got["restored"] == 0
    for g, r in zip(*outputs):
        assert g.shape == r.shape == (12,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=BF16_TOL, atol=BF16_TOL)


def test_cmd_manager_object_store_s3_from_environment(tmp_path):
    """``--object-store s3`` reads AWS_* from the environment: the
    manager creates its bucket on the endpoint with verified signatures,
    serves models listed from the shared database and stops on SIGTERM."""
    from dragonfly2_tpu_torch.manager import Database

    with FakeS3(access_key="env-ak", secret_key="env-sk") as fake:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(AWS_ACCESS_KEY_ID="env-ak",
                   AWS_SECRET_ACCESS_KEY="env-sk",
                   AWS_ENDPOINT_URL=fake.endpoint)
        db = str(tmp_path / "manager.db")
        proc = subprocess.Popen(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.manager",
             "--host", "127.0.0.1", "--port", "0", "--internal-port", "-1",
             "--db", db, "--object-store", "s3", "--no-auth",
             "--object-store-dir", str(tmp_path / "unused")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        watchdog = threading.Timer(60, proc.kill)
        watchdog.start()
        try:
            line = proc.stdout.readline()
            assert line.startswith("manager serving on 127.0.0.1:"), (
                line, proc.stderr.read() if proc.poll() is not None else "")
            port = int(line.split(":")[1].split()[0])
            assert "models" in fake.buckets
            # A trainer-side registry on the same database and store.
            trainer = port_manager.ManagerService(
                Database(db), port_store.new_object_store(
                    "s3", access_key="env-ak", secret_key="env-sk",
                    endpoint_url=fake.endpoint))
            art = tmp_path / "artifact"
            art.mkdir()
            (art / "model.bin").write_bytes(b"model-bytes")
            row = trainer.create_model("m", "gnn", "h", "1.1.1.1", "hn", {},
                                       str(art))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/api/v1/models",
                    timeout=10) as resp:
                listed = json.loads(resp.read())
            assert [m["version"] for m in listed] == [row.version]
            assert not os.path.exists(tmp_path / "unused")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=20) == 0
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
