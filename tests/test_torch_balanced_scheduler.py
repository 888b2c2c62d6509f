"""``BalancedSchedulerClient`` — the daemon's multi-scheduler client —
held to JAX's: each package's client is driven through the same script
with the same in-memory stub replicas (those of
``tests/test_scheduler_ha.py``), and the events the stubs and the
recovery counters record must be equal. Then the script's own checks run
on the port's record: failover with state replay, the size-scope fast
paths, healing by re-registration, the negative health cache, the
concurrent fan-out and the retired-client lifecycle. The hash ring is the
same in both packages, so every task lands on the same stub.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

PKGS = {"port": "dragonfly2_tpu_torch", "jax": "dragonfly2_tpu"}


def package(pkg: str) -> SimpleNamespace:
    """The names the scripts use, from package ``pkg``."""
    def m(name):
        return importlib.import_module(f"{PKGS[pkg]}.{name}")

    service = m("scheduler.service")
    return SimpleNamespace(
        Balanced=m("scheduler.rpcserver").BalancedSchedulerClient,
        RecoveryStats=m("client.recovery").RecoveryStats,
        Host=m("scheduler.resource.host").Host,
        SizeScope=m("scheduler.resource.task").SizeScope,
        ServiceError=service.ServiceError,
        PieceFinished=service.PieceFinished,
        RegisterPeerRequest=service.RegisterPeerRequest,
        RegisterPeerResponse=service.RegisterPeerResponse,
    )


def stub_class(p: SimpleNamespace):
    class StubSchedulerClient:
        """In-memory GrpcSchedulerClient shape with a kill switch."""

        def __init__(self, target: str):
            self.target = target
            self.dead = False
            self.know_hosts = True
            self.registered = []
            self.announced = []
            self.started = []
            self.b2s_started = []
            self.piece_batches = []
            self.finished = []
            self.close_calls = 0
            self.scope = p.SizeScope.NORMAL
            self.dropped = []

        def _check(self):
            if self.dead:
                raise p.ServiceError("Unavailable", f"{self.target} is dead")

        def announce_host(self, host):
            self._check()
            self.announced.append(host)
            self.know_hosts = True

        def leave_host(self, host_id):
            self._check()

        def register_peer(self, req, channel=None):
            self._check()
            if not self.know_hosts:
                raise p.ServiceError("NotFound",
                                     f"host {req.host_id} not announced")
            self.registered.append(req)
            return p.RegisterPeerResponse(size_scope=self.scope)

        def download_peer_started(self, peer_id):
            self._check()
            self.started.append(peer_id)

        def download_peer_back_to_source_started(self, peer_id):
            self._check()
            self.b2s_started.append(peer_id)

        def download_piece_finished(self, report):
            self._check()
            self.piece_batches.append([report])

        def download_pieces_finished(self, reports):
            self._check()
            self.piece_batches.append(list(reports))

        def download_piece_failed(self, peer_id, parent_id, piece_number):
            self._check()

        def download_peer_finished(self, peer_id, cost_seconds=0.0):
            self._check()
            self.finished.append(peer_id)

        def download_peer_back_to_source_finished(
                self, peer_id, content_length, total_piece_count,
                cost_seconds=0.0):
            self._check()

        def download_peer_failed(self, peer_id):
            self._check()

        def download_peer_back_to_source_failed(self, peer_id):
            self._check()

        def leave_peer(self, peer_id):
            self._check()

        def _drop_session(self, peer_id):
            self.dropped.append(peer_id)

        def close(self):
            self.close_calls += 1

    return StubSchedulerClient


class Script:
    """One package's balanced client over stub replicas."""

    def __init__(self, pkg: str, targets, factory=None, probe=None):
        self.p = package(pkg)
        self.Stub = stub_class(self.p)
        self.stubs = {}
        self.recovery = self.p.RecoveryStats()

        def make(target):
            self.stubs[target] = (self.Stub(target) if factory is None
                                  else factory(self, target))
            return self.stubs[target]

        self.balanced = self.p.Balanced(
            targets, client_factory=make,
            health_probe=probe or (lambda target: "SERVING"),
            recovery=self.recovery)

    def host(self, host_id: str = "h1"):
        return self.p.Host(id=host_id, hostname=host_id, ip="127.0.0.1",
                           port=1, download_port=1)

    def request(self, peer_id: str = "p1", task_id: str = "t1",
                host_id: str = "h1"):
        return self.p.RegisterPeerRequest(
            host_id=host_id, task_id=task_id, peer_id=peer_id,
            url="http://origin/blob")

    def piece(self, num: int):
        return self.p.PieceFinished(
            peer_id="p1", piece_number=num, parent_id="par",
            offset=num * 64, length=64, digest="md5:x")

    def owner_and_other(self, task_id: str):
        owner = self.balanced.ring.pick(task_id)
        return owner, ("b:1" if owner == "a:1" else "a:1")

    def events(self) -> dict:
        """What every stub and the recovery counters recorded."""
        snap = self.recovery.snapshot()
        return {
            "stubs": {t: {
                "registered": [r.peer_id for r in s.registered],
                "announced": [h.id for h in s.announced],
                "started": list(s.started),
                "b2s_started": list(s.b2s_started),
                "pieces": [[r.piece_number for r in b]
                           for b in s.piece_batches],
                "finished": list(s.finished),
                "close_calls": s.close_calls,
                "dropped": list(s.dropped),
            } for t, s in sorted(self.stubs.items())},
            "recovery": {k: v for k, v in snap.items()
                         if not k.endswith("_ms")},
            "peer_states": sorted(self.balanced._peer_states),
            "peer_owner": sorted(self.balanced._peer_owner),
        }


def _raises(fn, exc_type) -> str:
    try:
        fn()
    except exc_type as exc:
        return type(exc).__name__
    return ""


# -- the scripts ----------------------------------------------------------------


def failover_with_state_replay(s: Script) -> dict:
    s.balanced.register_peer(s.request(task_id="t-x"))
    s.balanced.download_peer_started("p1")
    s.balanced.download_pieces_finished([s.piece(0), s.piece(1)])
    owner, other = s.owner_and_other("t-x")
    s.stubs[owner].dead = True
    s.balanced.download_pieces_finished([s.piece(2)])
    return {"owner": owner, "other": other}


def empty_scope_drops_session(s: Script) -> dict:
    owner = s.balanced.ring.pick("t-empty")
    s.balanced._client_at(owner).scope = s.p.SizeScope.EMPTY
    resp = s.balanced.register_peer(s.request(task_id="t-empty"))
    return {"owner": owner, "scope": resp.size_scope.value}


def bare_tiny_keeps_session(s: Script) -> dict:
    owner = s.balanced.ring.pick("t-tiny")
    s.balanced._client_at(owner).scope = s.p.SizeScope.TINY
    resp = s.balanced.register_peer(s.request(task_id="t-tiny"))
    kept = "p1" in s.balanced._peer_states
    s.balanced.download_peer_started("p1")
    return {"owner": owner, "scope": resp.size_scope.value, "kept": kept}


def tiny_with_direct_piece_drops_session(s: Script) -> dict:
    owner = s.balanced.ring.pick("t-tiny")
    stub = s.balanced._client_at(owner)

    def register_with_payload(req, channel=None):
        stub.registered.append(req)
        return s.p.RegisterPeerResponse(size_scope=s.p.SizeScope.TINY,
                                        direct_piece=b"payload")

    stub.register_peer = register_with_payload
    resp = s.balanced.register_peer(s.request(task_id="t-tiny"))
    return {"owner": owner, "direct": resp.direct_piece}


def notfound_heals_by_reregistration(s: Script) -> dict:
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, _ = s.owner_and_other("t-x")
    stub = s.stubs[owner]
    original = stub.download_piece_finished
    calls = {"n": 0}

    def flaky(report):
        calls["n"] += 1
        if calls["n"] == 1:
            raise s.p.ServiceError("NotFound", "peer p1 not found")
        return original(report)

    stub.download_piece_finished = flaky
    s.balanced.download_piece_finished(s.piece(0))
    return {"owner": owner, "calls": calls["n"]}


def failover_reannounces_host(s: Script) -> dict:
    s.balanced.announce_host(s.host())
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, other = s.owner_and_other("t-x")
    s.stubs[other].know_hosts = False
    s.stubs[other].announced.clear()
    s.stubs[owner].dead = True
    s.balanced.download_peer_started("p1")
    return {"owner": owner, "other": other}


def no_replica_left_raises(s: Script) -> dict:
    s.balanced.register_peer(s.request(task_id="t-x"))
    s.stubs["a:1"].dead = True
    return {"raised": _raises(
        lambda: s.balanced.download_peer_started("p1"), s.p.ServiceError)}


def state_recorded_before_delivery(s: Script) -> dict:
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, _ = s.owner_and_other("t-x")
    seen = {}

    def capture_started(peer_id):
        with s.balanced._lock:
            seen["started"] = s.balanced._peer_states["p1"].started

    def capture_pieces(reports):
        with s.balanced._lock:
            seen["pieces"] = list(s.balanced._peer_states["p1"].pieces)

    s.stubs[owner].download_peer_started = capture_started
    s.stubs[owner].download_pieces_finished = capture_pieces
    s.balanced.download_peer_started("p1")
    s.balanced.download_pieces_finished([s.piece(0)])
    return {"seen": seen}


def finalize_during_rehome(s: Script) -> dict:
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, other = s.owner_and_other("t-x")
    s.stubs[owner].dead = True
    s.balanced._client_at(other)
    original = s.stubs[other].register_peer

    def register_then_finalized(req, channel=None):
        resp = original(req, channel)
        s.balanced._finalize("p1")
        return resp

    s.stubs[other].register_peer = register_then_finalized
    return {"raised": _raises(
        lambda: s.balanced.download_peer_started("p1"), s.p.ServiceError)}


def announce_raises_only_when_all_fail(s: Script) -> dict:
    s.balanced.announce_host(s.host())
    s.stubs["a:1"].dead = True
    s.balanced.announce_host(s.host())
    s.stubs["b:1"].dead = True
    return {"raised": _raises(lambda: s.balanced.announce_host(s.host()),
                              ConnectionError)}


def removal_rehomes_and_closes_retired_once(s: Script) -> dict:
    s.balanced.announce_host(s.host())
    s.balanced.register_peer(s.request(task_id="t-x"))
    s.balanced.download_peer_started("p1")
    s.balanced.download_pieces_finished([s.piece(0)])
    owner, other = s.owner_and_other("t-x")
    s.balanced.update_targets([other])
    closes_after_update = s.stubs[owner].close_calls
    s.balanced.download_peer_finished("p1")
    return {"owner": owner, "other": other,
            "closes_after_update": closes_after_update}


def unmovable_peer_keeps_retired_client(s: Script) -> dict:
    s.balanced.announce_host(s.host())
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, other = s.owner_and_other("t-x")
    s.stubs[other].dead = True
    s.balanced.update_targets([other])
    closes_after_update = s.stubs[owner].close_calls
    s.stubs[other].dead = False
    s.balanced.download_peer_finished("p1")
    return {"owner": owner, "other": other,
            "closes_after_update": closes_after_update}


def close_closes_retired_once(s: Script) -> dict:
    s.balanced.announce_host(s.host())
    s.balanced.register_peer(s.request(task_id="t-x"))
    owner, other = s.owner_and_other("t-x")
    s.stubs[other].dead = True
    s.balanced.update_targets([other])
    s.balanced.close()
    return {"owner": owner}


SCRIPTS = {f.__name__: f for f in (
    failover_with_state_replay, empty_scope_drops_session,
    bare_tiny_keeps_session, tiny_with_direct_piece_drops_session,
    notfound_heals_by_reregistration, failover_reannounces_host,
    no_replica_left_raises, state_recorded_before_delivery,
    finalize_during_rehome, announce_raises_only_when_all_fail,
    removal_rehomes_and_closes_retired_once,
    unmovable_peer_keeps_retired_client, close_closes_retired_once)}


def run_script(name: str, pkg: str) -> dict:
    targets = ["a:1"] if name == "no_replica_left_raises" else ["a:1", "b:1"]
    s = Script(pkg, targets)
    out = SCRIPTS[name](s)
    out["events"] = s.events()
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_records_the_events_jax_records(name):
    assert run_script(name, "port") == run_script(name, "jax")


def test_failover_replays_state_onto_the_survivor():
    out = run_script("failover_with_state_replay", "port")
    stubs, rec = out["events"]["stubs"], out["events"]["recovery"]
    neu = stubs[out["other"]]
    assert neu["registered"] == ["p1"] and neu["started"] == ["p1"]
    assert {n for batch in neu["pieces"] for n in batch} == {0, 1, 2}
    assert rec["scheduler_failovers"] == rec["scheduler_reregisters"] == 1
    assert rec["scheduler_failover_pieces_replayed"] == 3
    assert stubs[out["owner"]]["dropped"] == ["p1"]
    assert rec["reroute_samples"] == 1


@pytest.mark.parametrize("name,kept", [
    ("empty_scope_drops_session", False),
    ("bare_tiny_keeps_session", True),
    ("tiny_with_direct_piece_drops_session", False),
])
def test_size_scope_fast_paths(name, kept):
    out = run_script(name, "port")
    events = out["events"]
    assert ("p1" in events["peer_states"]) is kept
    assert ("p1" in events["peer_owner"]) is kept
    assert events["stubs"][out["owner"]]["dropped"] == ([] if kept
                                                        else ["p1"])
    if kept:
        assert events["stubs"][out["owner"]]["started"] == ["p1"]


def test_notfound_heals_and_host_is_taught():
    heal = run_script("notfound_heals_by_reregistration", "port")
    assert heal["events"]["recovery"]["scheduler_reregisters"] == 1
    taught = run_script("failover_reannounces_host", "port")
    other = taught["events"]["stubs"][taught["other"]]
    assert other["announced"] == ["h1"] and other["registered"] == ["p1"]


def test_terminal_failures_raise():
    assert run_script("no_replica_left_raises", "port")["raised"] == \
        "ServiceError"
    final = run_script("finalize_during_rehome", "port")
    assert final["raised"] == "ServiceError"
    assert "p1" not in final["events"]["peer_owner"]
    assert "p1" not in final["events"]["peer_states"]
    assert run_script("state_recorded_before_delivery", "port")["seen"] == \
        {"started": True, "pieces": [0]}
    assert run_script("announce_raises_only_when_all_fail",
                      "port")["raised"] == "ConnectionError"


def test_retired_client_lifecycle():
    moved = run_script("removal_rehomes_and_closes_retired_once", "port")
    stubs, rec = moved["events"]["stubs"], moved["events"]["recovery"]
    assert stubs[moved["other"]]["registered"] == ["p1"]
    assert stubs[moved["other"]]["finished"] == ["p1"]
    assert moved["closes_after_update"] == 1
    assert stubs[moved["owner"]]["close_calls"] == 1
    assert rec["scheduler_handoff_rehomed"] == 1
    assert rec["scheduler_failovers"] == 0

    stranded = run_script("unmovable_peer_keeps_retired_client", "port")
    stubs = stranded["events"]["stubs"]
    assert stranded["events"]["recovery"]["scheduler_handoff_stranded"] == 1
    assert stranded["closes_after_update"] == 0
    assert stubs[stranded["owner"]]["finished"] == ["p1"]
    assert stubs[stranded["owner"]]["close_calls"] == 1

    closed = run_script("close_closes_retired_once", "port")
    assert closed["events"]["stubs"][closed["owner"]]["close_calls"] == 1


# -- the health walk ------------------------------------------------------------


def _negative_cache(pkg: str) -> dict:
    probes = []

    def factory(script, target):
        stub = script.Stub(target)
        if target == "a:1":
            stub.dead = True

            def dial_timeout(req, channel=None):
                raise ConnectionError("dial a:1 timed out")

            stub.register_peer = dial_timeout
        return stub

    s = Script(pkg, ["a:1", "b:1"], factory=factory,
               probe=lambda t: probes.append(t) or "SERVING")
    s.balanced.NEGATIVE_HEALTH_TTL = 0.15
    task_id = next(f"t-{i}" for i in range(64)
                   if s.balanced.ring.pick(f"t-{i}") == "a:1")
    s.balanced.register_peer(s.request(task_id=task_id))
    serving_now = s.balanced._serving("a:1")
    cached, until = s.balanced._health_cache["a:1"]
    ttl_ok = until - time.monotonic() <= s.balanced.NEGATIVE_HEALTH_TTL + 0.01
    probes.clear()
    time.sleep(0.2)
    return {"task_id": task_id, "serving_now": serving_now,
            "cached": cached, "ttl_ok": ttl_ok,
            "serving_later": s.balanced._serving("a:1"),
            "probes_later": list(probes),
            "registered_at_b": [r.peer_id for r in s.stubs["b:1"].registered]}


def test_negative_cache_expires_as_jax():
    got = _negative_cache("port")
    assert got == _negative_cache("jax")
    assert got["serving_now"] is False and got["cached"] is False
    assert got["ttl_ok"] and got["serving_later"]
    assert got["probes_later"] == ["a:1"]
    assert got["registered_at_b"] == ["p1"]


def _probe_race(pkg: str) -> tuple:
    s = Script(pkg, ["a:1", "b:1"])

    def probe(target):
        s.balanced._note_unreachable(target)
        raise ConnectionError("probe raced the death")

    s.balanced._health_probe = probe
    serving = s.balanced._serving("a:1")
    cached, until = s.balanced._health_cache["a:1"]
    return serving, cached, (until - time.monotonic()
                             <= s.balanced.NEGATIVE_HEALTH_TTL + 0.01)


def test_probe_does_not_clobber_a_fresh_negative_verdict():
    assert _probe_race("port") == _probe_race("jax") == (False, False, True)


def test_serving_cache_is_guarded_under_churn():
    s = Script("port", ["a:1", "b:1", "c:1"])
    stop = threading.Event()
    errors = []

    def churn():
        flip = True
        while not stop.is_set():
            try:
                s.balanced.update_targets(["a:1", "b:1", "c:1"] if flip
                                          else ["a:1", "b:1"])
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
            flip = not flip

    def probe():
        while not stop.is_set():
            try:
                s.balanced._serving("c:1")
                s.balanced._note_unreachable("c:1")
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (churn, probe, probe)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(timeout=2)
    assert not errors


def _stalled_fan_out(pkg: str) -> tuple:
    def factory(script, target):
        stub = script.Stub(target)
        if target == "slow:1":
            real = stub.announce_host

            def slow_announce(host):
                time.sleep(0.3)
                return real(host)

            stub.announce_host = slow_announce
        return stub

    s = Script(pkg, ["slow:1", "b:1", "c:1"], factory=factory)
    begin = time.monotonic()
    s.balanced.announce_host(s.host())
    seconds = time.monotonic() - begin
    return seconds < 0.6, sorted(t for t, stub in s.stubs.items()
                                 if stub.announced)


def test_one_stalled_replica_does_not_serialize_the_fan_out():
    assert _stalled_fan_out("port") == _stalled_fan_out("jax") == (
        True, ["b:1", "c:1", "slow:1"])


def test_update_targets_is_the_dynconfig_hook():
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient

    balanced = BalancedSchedulerClient(["127.0.0.1:1"])
    balanced.update_targets(["127.0.0.1:1", "127.0.0.1:2"])
    assert balanced.ring.targets == {"127.0.0.1:1", "127.0.0.1:2"}
    balanced.update_targets(["127.0.0.1:2"])
    assert balanced.ring.targets == {"127.0.0.1:2"}
    balanced.close()
