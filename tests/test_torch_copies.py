"""The port's framework-neutral copies stay copies: each module below is
its ``dragonfly2_tpu`` original with only the package prefix changed
(``dragonfly2_tpu`` → ``dragonfly2_tpu_torch``), so a fix to the JAX
package shows up here as a difference to carry over.

The RPC surfaces in :data:`WIRE_COPIES` differ in one more way only:
where JAX's code imports ``grpc`` for its status codes and error, the
port's imports ``StatusCode`` and ``RpcError`` from ``rpc/status.py``.
The metrics modules in :data:`PROM_COPIES` likewise differ only where
JAX's import from ``prometheus_client`` (or its ``core``, ``exposition``
and ``parser`` modules): the port's import the same names from
``utils/prom.py``.

Modules whose port differs on purpose are not listed: the daemon's host
telemetry (``/proc`` instead of psutil), the device sink, the sharded
datasets (the port's parquet codec instead of pyarrow), and the earlier
slices' partial copies.
"""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PREFIX = re.compile(r"\bdragonfly2_tpu\b(?!_torch)")

COPIES = [
    "version.py",
    "utils/dag.py", "utils/dfpath.py", "utils/digest.py", "utils/faultplan.py",
    "utils/fsm.py", "utils/gc.py", "utils/geoplan.py", "utils/hosttypes.py",
    "utils/httpserver.py", "utils/idgen.py", "utils/meminfo.py",
    "utils/obsstats.py", "utils/ratelimit.py", "utils/tracing.py",
    "native/__init__.py", "native/pieceio.cpp",
    "client/__init__.py", "client/daemon.py", "client/dataplane.py",
    "client/download_async.py", "client/downloader.py", "client/peer_task.py",
    "client/piece.py", "client/piece_reporter.py", "client/qos.py",
    "client/recovery.py", "client/source.py", "client/storage.py",
    "client/traffic_shaper.py", "client/upload.py", "client/upload_async.py",
    "scheduler/controlstats.py", "scheduler/service.py",
    "scheduler/networktopology/__init__.py",
    "scheduler/networktopology/antientropy.py",
    "scheduler/networktopology/store.py",
    "scheduler/resource/__init__.py", "scheduler/resource/claims.py",
    "scheduler/resource/host.py", "scheduler/resource/managers.py",
    "scheduler/resource/peer.py", "scheduler/resource/piecestats.py",
    "scheduler/resource/resource.py", "scheduler/resource/task.py",
    "scheduler/scheduling/__init__.py", "scheduler/scheduling/core.py",
    "scheduler/storage/__init__.py",
    "scheduler/replaystore.py",
    "scheduler/replaylog.py", "scheduler/loadbench.py",
    "utils/netping.py", "client/networktopology.py",
    "scheduler/announcer.py",
    "utils/ttlcache.py", "utils/dynconfig.py", "utils/dflog.py",
    "manager/database.py", "manager/cache.py", "manager/searcher.py",
    "manager/oauth.py", "manager/auth.py", "manager/console/__init__.py",
    "manager/console/index.html", "manager/rest.py", "manager/client.py",
    "utils/tlsconf.py", "utils/otlp.py", "utils/reload.py",
    "client/uploadbench.py", "client/chaosbench.py", "client/qosbench.py",
    "utils/awssig.py", "utils/hmacsig.py", "manager/objectstore.py",
    "client/source_signedhttp.py", "client/source_s3.py",
    "client/source_oss.py", "utils/registryauth.py", "client/source_oras.py",
    "client/source_hdfs.py", "client/objectstorage_gateway.py",
    "cmd/dfstore.py", "utils/certs.py", "client/proxy.py",
    "rpc/codec.py",
    "scheduler/replica.py", "client/daemon_proc.py", "cmd/dfget.py",
    "cmd/dfcache.py", "cmd/dfdaemon.py",
    "manager/jobs.py", "manager/jobplane.py", "scheduler/jobworker.py",
    "scheduler/storage/storage.py", "tracetool.py", "cmd/tracetool.py",
    "utils/racecheck.py", "cmd/stress.py", "client/fanoutbench.py",
    "client/geobench.py", "scheduler/clusterbench.py",
]

WIRE_COPIES = ["scheduler/rpcserver.py", "client/rpcserver.py"]

PROM_COPIES = ["client/metrics.py", "scheduler/metrics.py",
               "trainer/metrics.py", "manager/metrics.py",
               "utils/metricsserver.py", "utils/prombridge.py",
               "client/obsbench.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copy_differs_only_in_the_package_prefix(path):
    with open(os.path.join(REPO, "dragonfly2_tpu", path)) as f:
        want = _PREFIX.sub("dragonfly2_tpu_torch", f.read())
    with open(os.path.join(REPO, "dragonfly2_tpu_torch", path)) as f:
        got = f.read()
    assert got == want, f"{path} differs from its JAX original"


def _status_swapped(text: str) -> str:
    """JAX's grpc status names as the port spells them."""
    text = re.sub(r"(?m)^(\s*)import grpc$",
                  r"\1from dragonfly2_tpu_torch.rpc.status import "
                  r"RpcError, StatusCode", text)
    return text.replace("grpc.StatusCode", "StatusCode").replace(
        "grpc.RpcError", "RpcError")


@pytest.mark.parametrize("path", WIRE_COPIES)
def test_wire_copy_differs_only_in_prefix_and_status_names(path):
    with open(os.path.join(REPO, "dragonfly2_tpu", path)) as f:
        text = f.read()
    assert "import grpc" in text
    want = _status_swapped(_PREFIX.sub("dragonfly2_tpu_torch", text))
    with open(os.path.join(REPO, "dragonfly2_tpu_torch", path)) as f:
        got = f.read()
    assert "import grpc" not in got and "grpc." not in got
    assert got == want, f"{path} differs from its JAX original"


def _prom_swapped(text: str) -> str:
    """JAX's prometheus_client imports as the port spells them."""
    return re.sub(
        r"(?m)^(\s*)from prometheus_client(\.core|\.exposition|\.parser)? "
        r"import", r"\1from dragonfly2_tpu_torch.utils.prom import", text)


@pytest.mark.parametrize("path", PROM_COPIES)
def test_prom_copy_differs_only_in_prefix_and_import_lines(path):
    with open(os.path.join(REPO, "dragonfly2_tpu", path)) as f:
        text = f.read()
    assert "from prometheus_client" in text
    want = _prom_swapped(_PREFIX.sub("dragonfly2_tpu_torch", text))
    with open(os.path.join(REPO, "dragonfly2_tpu_torch", path)) as f:
        got = f.read()
    assert "import prometheus_client" not in got
    assert "from prometheus_client" not in got
    assert got == want, f"{path} differs from its JAX original"
