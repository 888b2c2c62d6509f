"""The port's framework-neutral copies stay copies: each module below is
its ``dragonfly2_tpu`` original with only the package prefix changed
(``dragonfly2_tpu`` → ``dragonfly2_tpu_torch``), so a fix to the JAX
package shows up here as a difference to carry over.

Modules whose port differs on purpose are not listed: the scheduler's
dataset storage (no parquet export), the daemon's metrics (no
prometheus_client), its host telemetry (``/proc`` instead of psutil),
the device sink, and the earlier slices' partial copies.
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
]


@pytest.mark.parametrize("path", COPIES)
def test_copy_differs_only_in_the_package_prefix(path):
    with open(os.path.join(REPO, "dragonfly2_tpu", path)) as f:
        want = _PREFIX.sub("dragonfly2_tpu_torch", f.read())
    with open(os.path.join(REPO, "dragonfly2_tpu_torch", path)) as f:
        got = f.read()
    assert got == want, f"{path} differs from its JAX original"
