"""The port stands alone: importing every ``dragonfly2_tpu_torch`` module
(and ``chip_smoke.py``) in a fresh interpreter loads no JAX-family
package and nothing of ``dragonfly2_tpu``."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grpc", "pyarrow",
             "pandas", "tensorstore", "ml_dtypes", "prometheus_client",
             "psutil", "dragonfly2_tpu")

_PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import dragonfly2_tpu_torch
# A name that is no identifier is no Python module: the native data
# plane's g++ build (native/df2native-<digest>.so) sits in the package.
names = [m.name for m in pkgutil.walk_packages(
    dragonfly2_tpu_torch.__path__, "dragonfly2_tpu_torch.")
    if m.name.rpartition(".")[2].isidentifier()]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_port_module_imports(probe):
    expected = {
        "dragonfly2_tpu_torch.device",
        "dragonfly2_tpu_torch.ops._build",
        "dragonfly2_tpu_torch.ops.table_gather",
        "dragonfly2_tpu_torch.ops.flash_attention",
        "dragonfly2_tpu_torch.data.synthetic",
        "dragonfly2_tpu_torch.data.features",
        "dragonfly2_tpu_torch.data.graph_sampler",
        "dragonfly2_tpu_torch.data.prefetch",
        "dragonfly2_tpu_torch.models.graphsage",
        "dragonfly2_tpu_torch.train.fused_sampling",
        "dragonfly2_tpu_torch.train.gnn_trainer",
        "dragonfly2_tpu_torch.train.schedule",
        "dragonfly2_tpu_torch.models.graph_transformer",
        "dragonfly2_tpu_torch.models.mlp",
        "dragonfly2_tpu_torch.train.checkpoint",
        "dragonfly2_tpu_torch.train.gat_trainer",
        "dragonfly2_tpu_torch.train.metrics",
        "dragonfly2_tpu_torch.train.split",
        "dragonfly2_tpu_torch.train.step_budget",
        "dragonfly2_tpu_torch.inference.scorer",
        "dragonfly2_tpu_torch.inference.sidecar",
        "dragonfly2_tpu_torch.parallel",
        "dragonfly2_tpu_torch.parallel.mesh",
        "dragonfly2_tpu_torch.parallel.ulysses",
        "dragonfly2_tpu_torch.data.pipeline",
        "dragonfly2_tpu_torch.inference.modelguard",
        "dragonfly2_tpu_torch.scheduler",
        "dragonfly2_tpu_torch.scheduler.controlstats",
        "dragonfly2_tpu_torch.scheduler.evaluator",
        "dragonfly2_tpu_torch.scheduler.evaluator.base",
        "dragonfly2_tpu_torch.scheduler.evaluator.scoring",
        "dragonfly2_tpu_torch.scheduler.replay",
        "dragonfly2_tpu_torch.scheduler.replaylog",
        "dragonfly2_tpu_torch.train.cost_trainer",
        "dragonfly2_tpu_torch.train.mlp_trainer",
        "dragonfly2_tpu_torch.utils",
        "dragonfly2_tpu_torch.utils.servingstats",
        "dragonfly2_tpu_torch.utils.percentile",
        "dragonfly2_tpu_torch.utils.faultplan",
        "dragonfly2_tpu_torch.utils.httpserver",
        "dragonfly2_tpu_torch.utils.debugmon",
        "dragonfly2_tpu_torch.inference.batcher",
        "dragonfly2_tpu_torch.inference.loadgen",
        "dragonfly2_tpu_torch.rpc",
        "dragonfly2_tpu_torch.rpc.health",
        "dragonfly2_tpu_torch.manager",
        "dragonfly2_tpu_torch.manager.database",
        "dragonfly2_tpu_torch.manager.objectstore",
        "dragonfly2_tpu_torch.manager.service",
        "dragonfly2_tpu_torch.manager.validation",
        "dragonfly2_tpu_torch.schema",
        "dragonfly2_tpu_torch.schema.records",
        "dragonfly2_tpu_torch.schema.io",
        "dragonfly2_tpu_torch.trainer",
        "dragonfly2_tpu_torch.trainer.storage",
        "dragonfly2_tpu_torch.trainer.training",
        "dragonfly2_tpu_torch.utils.digest",
        "dragonfly2_tpu_torch.utils.idgen",
        "dragonfly2_tpu_torch.utils.backoff",
        "dragonfly2_tpu_torch.scheduler.replaystore",
        "dragonfly2_tpu_torch.train.federated",
        "dragonfly2_tpu_torch.train.fedbench",
        "dragonfly2_tpu_torch.train.fedproc",
        "dragonfly2_tpu_torch.trainer.federation",
        "dragonfly2_tpu_torch.parallel.multihost",
        "dragonfly2_tpu_torch.parallel.dryrun",
        # slice 14: the P2P client, the in-process scheduler, the sink
        "dragonfly2_tpu_torch.version",
        "dragonfly2_tpu_torch.native",
        "dragonfly2_tpu_torch.client",
        "dragonfly2_tpu_torch.client.daemon",
        "dragonfly2_tpu_torch.client.dataplane",
        "dragonfly2_tpu_torch.client.download_async",
        "dragonfly2_tpu_torch.client.downloader",
        "dragonfly2_tpu_torch.client.hbm_sink",
        "dragonfly2_tpu_torch.client.metrics",
        "dragonfly2_tpu_torch.client.peer_task",
        "dragonfly2_tpu_torch.client.piece",
        "dragonfly2_tpu_torch.client.piece_reporter",
        "dragonfly2_tpu_torch.client.qos",
        "dragonfly2_tpu_torch.client.recovery",
        "dragonfly2_tpu_torch.client.source",
        "dragonfly2_tpu_torch.client.storage",
        "dragonfly2_tpu_torch.client.telemetry",
        "dragonfly2_tpu_torch.client.traffic_shaper",
        "dragonfly2_tpu_torch.client.upload",
        "dragonfly2_tpu_torch.client.upload_async",
        "dragonfly2_tpu_torch.scheduler.networktopology",
        "dragonfly2_tpu_torch.scheduler.networktopology.antientropy",
        "dragonfly2_tpu_torch.scheduler.networktopology.store",
        "dragonfly2_tpu_torch.scheduler.resource",
        "dragonfly2_tpu_torch.scheduler.resource.claims",
        "dragonfly2_tpu_torch.scheduler.resource.host",
        "dragonfly2_tpu_torch.scheduler.resource.managers",
        "dragonfly2_tpu_torch.scheduler.resource.peer",
        "dragonfly2_tpu_torch.scheduler.resource.piecestats",
        "dragonfly2_tpu_torch.scheduler.resource.resource",
        "dragonfly2_tpu_torch.scheduler.resource.task",
        "dragonfly2_tpu_torch.scheduler.scheduling",
        "dragonfly2_tpu_torch.scheduler.scheduling.core",
        "dragonfly2_tpu_torch.scheduler.service",
        "dragonfly2_tpu_torch.scheduler.storage",
        "dragonfly2_tpu_torch.scheduler.storage.storage",
        "dragonfly2_tpu_torch.utils.dag",
        "dragonfly2_tpu_torch.utils.dfpath",
        "dragonfly2_tpu_torch.utils.fsm",
        "dragonfly2_tpu_torch.utils.gc",
        "dragonfly2_tpu_torch.utils.geoplan",
        "dragonfly2_tpu_torch.utils.hosttypes",
        "dragonfly2_tpu_torch.utils.meminfo",
        "dragonfly2_tpu_torch.utils.obsstats",
        "dragonfly2_tpu_torch.utils.ratelimit",
        "dragonfly2_tpu_torch.utils.tracing",
    }
    assert expected <= set(probe["imported"])


@pytest.mark.parametrize("package", FORBIDDEN)
def test_no_forbidden_module_loaded(probe, package):
    # Match the top-level name exactly: "dragonfly2_tpu_torch" shares the
    # "dragonfly2_tpu" prefix but is not that package.
    hits = [m for m in probe["modules"] if m.split(".")[0] == package]
    assert hits == [], hits
