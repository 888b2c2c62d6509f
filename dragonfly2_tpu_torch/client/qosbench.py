"""Multi-tenant QoS bench — the ``bench.py qos`` stage.

Proves the weighted-fair admission plane (docs/QOS.md) holds its two
promises on a REAL mixed-workload swarm before any operator trusts a
weights spec on one:

1. **Mixed-workload rung** (``run_qos_mixed_rung``): one throttled
   seed daemon (the shared contention point: ``upload_rate_bps`` +
   ``upload_max_streams``) serves an interactive tenant's small pulls,
   a bulk tenant's checkpoint-sized pull and a background preheat pull
   CONCURRENTLY, every task class-tagged end to end. Gates: the
   interactive per-task p99 stays within ``QOS_INTERACTIVE_P99_S``
   while the bulk tenant still drives ≥ ``QOS_BULK_FRACTION`` of the
   bulk-alone saturation throughput measured on the same swarm moments
   earlier (the single-class baseline rung).
2. **Flooding-tenant chaos rung** (``run_qos_flood_rung``): a
   background tenant floods a 2-slot seed with concurrent pulls far
   past the park-queue bound while an interactive tenant keeps
   issuing small pulls. Gates: interactive p99 holds its (looser)
   flood bound, the seed's 503 sheds land EXCLUSIVELY on the flooding
   class, and interactive is never shed.

Both rungs ride the in-process loopback swarm shape of
``obsbench._obs_rung_in`` — a real ``SchedulerService``, real daemons,
a real origin — with distinct blobs per tenant so every piece stream
crosses the seed's admission gate. ``check_qos_regression`` re-runs
the full stage against its ABSOLUTE bounds for the one-command
``bench.py qos --check-regression`` gate.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

#: Documented interactive per-task p99 bound in the mixed rung
#: (docs/QOS.md): small classed pulls through a contended seed must
#: stay interactive-fast. Generous vs the ~tens-of-ms expectation so a
#: noisy CI box cannot flake the gate.
QOS_INTERACTIVE_P99_S = 2.0
#: Interactive bound under a flooding tenant — looser (the floor
#: guarantees admission, not an idle link) but still interactive.
QOS_FLOOD_INTERACTIVE_P99_S = 3.0
#: Bulk must keep at least this fraction of its single-class
#: saturation throughput while sharing the seed with the other classes.
QOS_BULK_FRACTION = 0.70
#: The rungs' weights/floors spec — the docs/QOS.md example fleet.
QOS_WEIGHTS_SPEC = "interactive=8,bulk=3,background=1"
QOS_FLOORS_SPEC = "interactive=1"


def _md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def _delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """Per-key counter delta, dropping zero rows (QOS is process-wide,
    so every rung reads before/after deltas, never absolutes)."""
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


class _QosSwarm:
    """One throttled seed + per-tenant client daemons + an origin,
    against an in-process scheduler — the rungs' shared fixture."""

    def __init__(self, tmp: str, blobs: Dict[str, bytes], *,
                 seed_rate_bps: float, max_streams: int,
                 shed_limit: int = 512, clients: int = 3,
                 client_dl_max_streams: int = 0):
        from dragonfly2_tpu_torch.client.chaosbench import MultiBlobServer
        from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
        from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions
        from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
        from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
        from dragonfly2_tpu_torch.scheduler.scheduling.core import (
            Scheduling,
            SchedulingConfig,
        )
        from dragonfly2_tpu_torch.scheduler.service import SchedulerService

        self.service = SchedulerService(
            resource=Resource(),
            scheduling=Scheduling(
                BaseEvaluator(),
                SchedulingConfig(retry_interval=0.01,
                                 retry_back_to_source_limit=2)))
        options = PeerTaskOptions(native_data_plane=False, timeout=30.0,
                                  metadata_poll_interval=0.05)

        def cfg(name: str, **extra) -> "DaemonConfig":
            return DaemonConfig(
                storage_root=os.path.join(tmp, name), hostname=name,
                keep_storage=False, task_options=options,
                qos_class_weights=QOS_WEIGHTS_SPEC,
                qos_class_floors=QOS_FLOORS_SPEC,
                qos_shed_limit=shed_limit,
                **extra)

        # The seed is the contention point: throttled upload, a small
        # stream cap, the weighted-fair gate arbitrating who streams.
        self.seed = Daemon(self.service, cfg(
            "qos-seed", upload_rate_bps=seed_rate_bps,
            upload_max_streams=max_streams))
        self.clients = [
            Daemon(self.service, cfg(
                f"qos-c{i}", dl_max_streams=client_dl_max_streams))
            for i in range(clients)]
        self.daemons = [self.seed] + self.clients
        self.origin = MultiBlobServer(blobs)

    def __enter__(self) -> "_QosSwarm":
        for d in self.daemons:
            d.start()
        self.origin.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.origin.__exit__(*exc)
        for d in self.daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass

    def preheat(self, paths: List[str]) -> Optional[str]:
        """Seed downloads every blob back-to-source so the clients'
        classed pulls all resolve to the seed's replicas. Returns an
        error string on failure."""
        for path in paths:
            result = self.seed.download_file(self.origin.url(path))
            if not result.success:
                return f"seed preheat of {path}: {result.error}"
        return None


def _classed_pull(daemon, url: str, klass: str, tenant: str,
                  out: dict, key: str) -> None:
    t0 = time.perf_counter()
    try:
        result = daemon.download_file(url, traffic_class=klass,
                                      tenant=tenant)
        out[key] = {"ok": result.success, "error": result.error,
                    "bytes": result.content_length,
                    "seconds": time.perf_counter() - t0}
    except Exception as exc:  # noqa: BLE001 — reported, not fatal
        out[key] = {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                    "bytes": 0, "seconds": time.perf_counter() - t0}


def run_qos_mixed_rung(*, seed: int = 0,
                       bulk_bytes: int = 24 << 20,
                       background_bytes: int = 4 << 20,
                       interactive_bytes: int = 256 << 10,
                       interactive_pulls: int = 8,
                       piece_size: int = 256 << 10,
                       seed_rate_bps: float = 48 * (1 << 20),
                       max_streams: int = 4) -> dict:
    """Baseline (bulk alone) + mixed (all three classes concurrent)
    against ONE swarm; see the module docstring for the gates."""
    import numpy as np

    from dragonfly2_tpu_torch.client import peer_task as peer_task_mod
    from dragonfly2_tpu_torch.client import qos as qos_mod

    rng = np.random.default_rng(seed)
    blobs = {"/qos/bulk-alone": rng.bytes(bulk_bytes),
             "/qos/bulk-mixed": rng.bytes(bulk_bytes),
             "/qos/background": rng.bytes(background_bytes)}
    for i in range(interactive_pulls):
        blobs[f"/qos/interactive-{i}"] = rng.bytes(interactive_bytes)

    out: dict = {
        "bulk_bytes": bulk_bytes, "interactive_pulls": interactive_pulls,
        "interactive_bytes": interactive_bytes,
        "seed_rate_mb_per_s": round(seed_rate_bps / (1 << 20), 1),
        "max_streams": max_streams,
        "interactive_p99_bound_s": QOS_INTERACTIVE_P99_S,
        "bulk_fraction_bound": QOS_BULK_FRACTION,
        "failures": [], "verdict_pass": False,
    }
    tmp = tempfile.mkdtemp(prefix="df2-qos-")
    prev_piece_size = peer_task_mod.compute_piece_size
    try:
        peer_task_mod.compute_piece_size = lambda _len: piece_size
        with _QosSwarm(tmp, blobs, seed_rate_bps=seed_rate_bps,
                       max_streams=max_streams, clients=3) as swarm:
            err = swarm.preheat(sorted(blobs))
            if err:
                out["failures"].append(err)
                return out
            inter, bulk, backg = swarm.clients

            # -- baseline: bulk alone saturates the throttled seed ----
            runs: dict = {}
            _classed_pull(bulk, swarm.origin.url("/qos/bulk-alone"),
                          "bulk", "tenant-bulk", runs, "bulk_alone")
            alone = runs["bulk_alone"]
            if not alone["ok"]:
                out["failures"].append(
                    f"bulk-alone baseline: {alone['error']}")
                return out
            bulk_alone_mbps = (bulk_bytes / (1 << 20)) / alone["seconds"]
            out["bulk_alone_mb_per_s"] = round(bulk_alone_mbps, 1)
            out["bulk_alone_s"] = round(alone["seconds"], 3)

            # -- mixed: all three classes pull concurrently -----------
            before = qos_mod.QOS.snapshot()
            threads = [
                threading.Thread(
                    target=_classed_pull,
                    args=(bulk, swarm.origin.url("/qos/bulk-mixed"),
                          "bulk", "tenant-bulk", runs, "bulk_mixed"),
                    name="qos-bulk", daemon=True),
                threading.Thread(
                    target=_classed_pull,
                    args=(backg, swarm.origin.url("/qos/background"),
                          "background", "tenant-preheat", runs,
                          "background"),
                    name="qos-background", daemon=True),
            ]
            for t in threads:
                t.start()
            lat: List[float] = []
            for i in range(interactive_pulls):
                _classed_pull(inter,
                              swarm.origin.url(f"/qos/interactive-{i}"),
                              "interactive", "tenant-ui", runs, f"i{i}")
                pull = runs[f"i{i}"]
                if not pull["ok"]:
                    out["failures"].append(
                        f"interactive pull {i}: {pull['error']}")
                lat.append(pull["seconds"])
            for t in threads:
                t.join(timeout=60.0)
            after = qos_mod.QOS.snapshot()
    finally:
        peer_task_mod.compute_piece_size = prev_piece_size
        shutil.rmtree(tmp, ignore_errors=True)

    mixed = runs.get("bulk_mixed", {})
    if not mixed.get("ok"):
        out["failures"].append(
            f"bulk-mixed: {mixed.get('error', 'did not finish')}")
        return out
    if not runs.get("background", {}).get("ok"):
        out["failures"].append(
            f"background: {runs['background'].get('error')}")

    lat.sort()
    p99 = lat[-1] if lat else float("inf")
    bulk_mixed_mbps = (bulk_bytes / (1 << 20)) / mixed["seconds"]
    out["interactive_latencies_s"] = [round(v, 3) for v in lat]
    out["interactive_p99_s"] = round(p99, 3)
    out["bulk_mixed_mb_per_s"] = round(bulk_mixed_mbps, 1)
    out["bulk_mixed_s"] = round(mixed["seconds"], 3)
    out["bulk_fraction"] = round(
        bulk_mixed_mbps / max(bulk_alone_mbps, 1e-9), 3)
    out["upload_admitted_by_class"] = _delta(
        before["upload"]["admitted"], after["upload"]["admitted"])
    out["upload_parked_by_class"] = _delta(
        before["upload"]["parked"], after["upload"]["parked"])
    if p99 > QOS_INTERACTIVE_P99_S:
        out["failures"].append(
            f"interactive p99 {p99:.3f}s > bound "
            f"{QOS_INTERACTIVE_P99_S}s")
    if out["bulk_fraction"] < QOS_BULK_FRACTION:
        out["failures"].append(
            f"bulk kept only {out['bulk_fraction']:.0%} of its alone "
            f"throughput (bound {QOS_BULK_FRACTION:.0%})")
    if not out["upload_admitted_by_class"].get("interactive"):
        out["failures"].append(
            "no class-tagged interactive admissions at the seed's "
            "upload gate — the classed path was not exercised")
    out["verdict_pass"] = not out["failures"]
    return out


def run_qos_flood_rung(*, seed: int = 1,
                       flood_tasks: int = 8,
                       flood_bytes: int = 4 << 20,
                       interactive_pulls: int = 6,
                       interactive_bytes: int = 256 << 10,
                       piece_size: int = 256 << 10,
                       seed_rate_bps: float = 8 * (1 << 20),
                       max_streams: int = 2,
                       shed_limit: int = 4) -> dict:
    """Flooding-tenant chaos rung: background saturates a 2-slot seed
    far past the park bound; interactive must hold its bound, sheds
    must land only on the flooder.

    The seed throttle is much tighter than the mixed rung's: a piece
    body must dominate an op's client-side lifecycle (connect +
    metadata cadence) or the flooder's 30+ wanted streams never
    actually OVERLAP at the gate and the park bound is never hit."""
    import numpy as np

    from dragonfly2_tpu_torch.client import peer_task as peer_task_mod
    from dragonfly2_tpu_torch.client import qos as qos_mod

    rng = np.random.default_rng(seed)
    blobs: Dict[str, bytes] = {}
    for i in range(flood_tasks):
        blobs[f"/qos/flood-{i}"] = rng.bytes(flood_bytes)
    for i in range(interactive_pulls):
        blobs[f"/qos/fg-{i}"] = rng.bytes(interactive_bytes)

    out: dict = {
        "flood_tasks": flood_tasks, "flood_bytes": flood_bytes,
        "interactive_pulls": interactive_pulls,
        "max_streams": max_streams, "shed_limit": shed_limit,
        "interactive_p99_bound_s": QOS_FLOOD_INTERACTIVE_P99_S,
        "failures": [], "verdict_pass": False,
    }
    tmp = tempfile.mkdtemp(prefix="df2-qos-flood-")
    prev_piece_size = peer_task_mod.compute_piece_size
    try:
        peer_task_mod.compute_piece_size = lambda _len: piece_size
        with _QosSwarm(tmp, blobs, seed_rate_bps=seed_rate_bps,
                       max_streams=max_streams, shed_limit=shed_limit,
                       clients=2, client_dl_max_streams=32) as swarm:
            err = swarm.preheat(sorted(blobs))
            if err:
                out["failures"].append(err)
                return out
            inter, flooder = swarm.clients

            before = qos_mod.QOS.snapshot()
            runs: dict = {}
            threads = [
                threading.Thread(
                    target=_classed_pull,
                    args=(flooder, swarm.origin.url(f"/qos/flood-{i}"),
                          "background", "tenant-flood", runs, f"f{i}"),
                    name=f"qos-flood-{i}", daemon=True)
                for i in range(flood_tasks)
            ]
            for t in threads:
                t.start()
            lat: List[float] = []
            for i in range(interactive_pulls):
                _classed_pull(inter, swarm.origin.url(f"/qos/fg-{i}"),
                              "interactive", "tenant-ui", runs, f"i{i}")
                pull = runs[f"i{i}"]
                if not pull["ok"]:
                    out["failures"].append(
                        f"interactive pull {i}: {pull['error']}")
                lat.append(pull["seconds"])
            for t in threads:
                t.join(timeout=90.0)
            after = qos_mod.QOS.snapshot()
    finally:
        peer_task_mod.compute_piece_size = prev_piece_size
        shutil.rmtree(tmp, ignore_errors=True)

    lat.sort()
    p99 = lat[-1] if lat else float("inf")
    shed = _delta(before["upload"]["shed"], after["upload"]["shed"])
    out["interactive_latencies_s"] = [round(v, 3) for v in lat]
    out["interactive_p99_s"] = round(p99, 3)
    out["upload_shed_by_class"] = shed
    out["upload_admitted_by_class"] = _delta(
        before["upload"]["admitted"], after["upload"]["admitted"])
    out["flood_completed"] = sum(
        1 for i in range(flood_tasks) if runs.get(f"f{i}", {}).get("ok"))
    if p99 > QOS_FLOOD_INTERACTIVE_P99_S:
        out["failures"].append(
            f"interactive p99 under flood {p99:.3f}s > bound "
            f"{QOS_FLOOD_INTERACTIVE_P99_S}s")
    if not shed.get("background"):
        out["failures"].append(
            f"flood produced no background sheds at the seed "
            f"(shed={shed}) — the park bound was never hit")
    if shed.get("interactive"):
        out["failures"].append(
            f"{shed['interactive']} interactive requests were shed — "
            "sheds must land on the flooding class only")
    out["verdict_pass"] = not out["failures"]
    return out


# ----------------------------------------------------------------------
# Stage assembly + regression gate
# ----------------------------------------------------------------------


def run_qos_stage(*, seed: int = 0) -> dict:
    """Mixed rung + flood rung, one combined verdict."""
    mixed = run_qos_mixed_rung(seed=seed)
    flood = run_qos_flood_rung(seed=seed + 1)
    return {
        "mixed": mixed,
        "flood": flood,
        "verdict_pass": bool(mixed["verdict_pass"]
                             and flood["verdict_pass"]),
    }


def best_recorded_qos(state_dir: str) -> Optional[dict]:
    best = None
    for path in glob.glob(os.path.join(state_dir, "qos_run_*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if data.get("skipped") or not data.get("verdict_pass"):
            continue
        p99 = (data.get("mixed") or {}).get("interactive_p99_s")
        if p99 is None:
            continue
        if best is None or p99 < best["interactive_p99_s"]:
            best = {
                "file": os.path.basename(path),
                "interactive_p99_s": p99,
                "bulk_fraction": (data.get("mixed") or {}).get(
                    "bulk_fraction"),
                "flood_interactive_p99_s": (data.get("flood") or {}).get(
                    "interactive_p99_s"),
            }
    return best


def check_qos_regression(state_dir: str) -> Dict[str, object]:
    """``bench.py qos --check-regression``: a fresh full stage must hold
    its ABSOLUTE bounds — interactive p99 within bound in both rungs,
    bulk ≥ 70% of its alone throughput, sheds only on the flooder. The
    best record rides along for trend reading (the obs gate shape)."""
    fresh = run_qos_stage()
    failures: List[str] = list(fresh["mixed"]["failures"])
    failures += list(fresh["flood"]["failures"])
    return {
        "passed": not failures,
        "failures": failures,
        "fresh": {
            "mixed_interactive_p99_s": fresh["mixed"].get(
                "interactive_p99_s"),
            "bulk_fraction": fresh["mixed"].get("bulk_fraction"),
            "flood_interactive_p99_s": fresh["flood"].get(
                "interactive_p99_s"),
            "flood_shed_by_class": fresh["flood"].get(
                "upload_shed_by_class"),
        },
        "best_recorded": best_recorded_qos(state_dir),
    }
