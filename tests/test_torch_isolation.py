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
        # slice 15: the layouts over one process-group axis
        "dragonfly2_tpu_torch.parallel.ring_attention",
        "dragonfly2_tpu_torch.parallel.pipeline",
        "dragonfly2_tpu_torch.parallel.moe",
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
        # slice 17: the replay engine, its bench helpers and the CLI
        "dragonfly2_tpu_torch.scheduler.replaybench",
        "dragonfly2_tpu_torch.cmd",
        "dragonfly2_tpu_torch.cmd.replaytool",
        # slice 18: the swarm driver beside the recorder
        "dragonfly2_tpu_torch.scheduler.loadbench",
        # slice 19: the ML loop's collection half
        "dragonfly2_tpu_torch.utils.netping",
        "dragonfly2_tpu_torch.client.networktopology",
        "dragonfly2_tpu_torch.scheduler.announcer",
        "dragonfly2_tpu_torch.trainer.service",
        "dragonfly2_tpu_torch.rpc.status",
        # slice 20: the manager as a service and the scheduler's link
        "dragonfly2_tpu_torch.utils.ttlcache",
        "dragonfly2_tpu_torch.utils.dynconfig",
        "dragonfly2_tpu_torch.utils.dflog",
        "dragonfly2_tpu_torch.manager.cache",
        "dragonfly2_tpu_torch.manager.searcher",
        "dragonfly2_tpu_torch.manager.oauth",
        "dragonfly2_tpu_torch.manager.auth",
        "dragonfly2_tpu_torch.manager.console",
        "dragonfly2_tpu_torch.manager.rest",
        "dragonfly2_tpu_torch.manager.client",
        "dragonfly2_tpu_torch.cmd.common",
        "dragonfly2_tpu_torch.cmd.manager",
        "dragonfly2_tpu_torch.cmd.scheduler",
        # slice 21: the poisoned-model rung, the chaos plane, and the
        # modules the data plane and tracing import
        "dragonfly2_tpu_torch.utils.tlsconf",
        "dragonfly2_tpu_torch.utils.otlp",
        "dragonfly2_tpu_torch.utils.reload",
        "dragonfly2_tpu_torch.client.uploadbench",
        "dragonfly2_tpu_torch.client.chaosbench",
        "dragonfly2_tpu_torch.client.qosbench",
        "dragonfly2_tpu_torch.inference.guardbench",
        # slice 22: the daemon's edge and the cloud object stores
        "dragonfly2_tpu_torch.utils.awssig",
        "dragonfly2_tpu_torch.utils.hmacsig",
        "dragonfly2_tpu_torch.utils.registryauth",
        "dragonfly2_tpu_torch.utils.certs",
        "dragonfly2_tpu_torch.client.source_signedhttp",
        "dragonfly2_tpu_torch.client.source_s3",
        "dragonfly2_tpu_torch.client.source_oss",
        "dragonfly2_tpu_torch.client.source_oras",
        "dragonfly2_tpu_torch.client.source_hdfs",
        "dragonfly2_tpu_torch.client.objectstorage_gateway",
        "dragonfly2_tpu_torch.client.proxy",
        "dragonfly2_tpu_torch.cmd.dfstore",
        # slice 23: the RPC transport and the two serving entry points
        "dragonfly2_tpu_torch.rpc.codec",
        "dragonfly2_tpu_torch.rpc.wire",
        "dragonfly2_tpu_torch.rpc.service",
        "dragonfly2_tpu_torch.rpc.client",
        "dragonfly2_tpu_torch.rpc.status",
        "dragonfly2_tpu_torch.cmd.inference",
        "dragonfly2_tpu_torch.cmd.trainer",
    }
    assert expected <= set(probe["imported"])


@pytest.mark.parametrize("package", FORBIDDEN)
def test_no_forbidden_module_loaded(probe, package):
    # Match the top-level name exactly: "dragonfly2_tpu_torch" shares the
    # "dragonfly2_tpu" prefix but is not that package.
    hits = [m for m in probe["modules"] if m.split(".")[0] == package]
    assert hits == [], hits


# Modules of the JAX package the port does not have yet, each with every
# line of the port that names it: none since the scheduler's and the
# daemon's RPC surfaces were ported. A line naming a module that does not
# exist fails the test below.
NOT_PORTED: dict = {}


def _module_file(name: str):
    path = os.path.join(REPO, *name.split("."))
    for candidate in (path + ".py", os.path.join(path, "__init__.py")):
        if os.path.isfile(candidate):
            return candidate
    return None


def _package_names(init_file: str) -> set:
    """The names a package's ``__init__.py`` binds."""
    import ast

    names = set()
    with open(init_file) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _port_module_references():
    """(module, "file:line") for every ``dragonfly2_tpu_torch`` module the
    port and ``chip_smoke.py`` import — at module level or inside a
    function — or start with ``python -m``."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dragonfly2_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in sorted(files):
        where = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            found = []
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif (isinstance(node, ast.ImportFrom) and node.level == 0
                  and node.module):
                found = [node.module]
                init = _module_file(node.module)
                if init is not None and init.endswith("__init__.py"):
                    bound = _package_names(init)
                    found += [f"{node.module}.{a.name}" for a in node.names
                              if a.name not in bound]
            elif isinstance(node, (ast.List, ast.Tuple)):
                items = node.elts
                found = [b.value for a, b in zip(items, items[1:])
                         if isinstance(a, ast.Constant) and a.value == "-m"
                         and isinstance(b, ast.Constant)
                         and isinstance(b.value, str)]
            for name in found:
                if name.split(".")[0] == "dragonfly2_tpu_torch":
                    yield name, f"{where}:{node.lineno}"


def test_every_imported_port_module_exists():
    missing = {}
    for name, where in _port_module_references():
        if _module_file(name) is None:
            missing.setdefault(name, set()).add(where)
    assert missing == NOT_PORTED
