"""Repeat ``chip_smoke.py``'s registry-mirror pulls (the edge phase's part
(c)) and report, for each repetition, daemon A's piece-cost statistics
and the scheduler's bad-node verdict on it just before daemon B pulls,
the origin's content GETs around B's pull, and the scheduler's download
records (B's parents).

    N=14 python3 tests/mirror_pulls_repeat.py

Runs on the CPU or the card machine (nothing here uses a device). Prints
one JSON line a repetition and a last line with how often B went back to
the origin.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from dragonfly2_tpu_torch.client.proxy import (
        ProxyConfig,
        ProxyServer,
        RegistryMirror,
    )
    from dragonfly2_tpu_torch.utils.hosttypes import HostType

    runs, back_sourced = int(os.environ.get("N", 14)), 0
    path = "/v2/edge/llama/blobs/sha256:repeat"
    for i in range(runs):
        tmp = tempfile.mkdtemp(prefix="mirror-repeat-")
        root = os.path.join(tmp, "registry")
        os.makedirs(os.path.dirname(root + path))
        with open(root + path, "wb") as f:
            f.write(np.random.default_rng(i).bytes(smoke.EDGE_BLOB_BYTES))
        scheduler, start = smoke.fanout_mesh(os.path.join(tmp, "mesh"))
        daemons = [start(name, HostType.NORMAL)
                   for name in ("mirror-a", "mirror-b")]
        try:
            with smoke.OriginServer(root) as origin:
                remote = origin.url("").rstrip("/")
                proxies = [ProxyServer(d, ProxyConfig(
                    registry_mirror=RegistryMirror(remote=remote)))
                    for d in daemons]
                for proxy in proxies:
                    proxy.start()
                try:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{proxies[0].port}{path}").read()
                    verdict = smoke.parent_verdict(scheduler, "mirror-a",
                                                   remote + path)
                    before = origin.gets[path]
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{proxies[1].port}{path}").read()
                    gets = [before, origin.gets[path]]
                finally:
                    for proxy in proxies:
                        proxy.stop()
            records = [(r.host.hostname, r.state,
                        sorted(p.host.hostname for p in r.parents))
                       for r in scheduler.storage.list_download()]
            back_sourced += gets[1] != gets[0]
            print(json.dumps({"i": i, "origin_gets": gets,
                              "a_as_parent": verdict, "records": records}),
                  flush=True)
        finally:
            for d in daemons:
                d.stop()
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"runs": runs, "b_back_sourced": back_sourced}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
