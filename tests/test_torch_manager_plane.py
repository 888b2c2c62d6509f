"""The manager's cluster half: the same calls on two fresh sqlite
databases, one through ``dragonfly2_tpu``'s ``ManagerService`` and one
through ``dragonfly2_tpu_torch``'s, end in equal rows (timestamps
dropped; ids are sqlite's autoincrement in both) and equal answers:
cluster CRUD and upserts, keepalive and its expiry at a 0.2 s TTL,
``sweep_keepalive``'s count, ``list_schedulers`` by affinity,
``get_scheduler_cluster_config`` and the read-through cache, and the
searcher's ranking over a seeded table of IPs, IDCs, locations and
CIDRs."""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("dragonfly2_tpu", "dragonfly2_tpu_torch")
TTL = 0.2
VOLATILE = {"created_at", "updated_at", "last_keepalive", "expires_at"}
TABLES = ("scheduler_clusters", "schedulers", "seed_peer_clusters",
          "seed_peers", "applications", "configs")


def manager_of(pkg: str, tmp_path):
    m = importlib.import_module(f"{pkg}.manager")
    root = tmp_path / pkg
    root.mkdir(exist_ok=True)
    return m.ManagerService(m.Database(str(root / "manager.db")),
                            m.FilesystemObjectStore(str(root / "objects")),
                            keepalive_ttl=TTL)


def dump(db) -> dict:
    return {t: [{k: v for k, v in r.data.items() if k not in VOLATILE}
                for r in db.find(t)] for t in TABLES}


def both(script, tmp_path, *args):
    """``script(service, pkg, *args)`` on each package's service."""
    out = {}
    for pkg in PACKAGES:
        svc = manager_of(pkg, tmp_path)
        try:
            out[pkg] = script(svc, pkg, *args)
        finally:
            svc.db.close()
    return out["dragonfly2_tpu"], out["dragonfly2_tpu_torch"]


def error_of(pkg: str, fn) -> str:
    errors = importlib.import_module(f"{pkg}.manager.service")
    with pytest.raises(errors.ManagerError) as exc:
        fn()
    return str(exc.value)


def script_clusters(svc, pkg):
    a = svc.create_scheduler_cluster(
        "a", config={"filter_parent_limit": 4},
        client_config={"load_limit": 50},
        scopes={"idc": "idc-a", "cidrs": ["10.0.0.0/8"]}, is_default=True)
    b = svc.create_scheduler_cluster("b", scopes={"location": "cn|hz"})
    seeds = svc.create_seed_peer_cluster("seeds", {"load_limit": 300})
    first = svc.update_scheduler(hostname="s1", ip="10.0.0.1", port=8002,
                                 scheduler_cluster_id=a.id)
    again = svc.update_scheduler(hostname="s1", ip="10.0.0.1", port=9002,
                                 scheduler_cluster_id=a.id,
                                 features=["schedule", "preheat"])
    other = svc.update_scheduler(hostname="s1", ip="10.0.0.1", port=8002,
                                 scheduler_cluster_id=b.id)
    p1 = svc.update_seed_peer(hostname="seed", ip="10.0.1.1", port=65000,
                              download_port=65001,
                              seed_peer_cluster_id=seeds.id)
    p2 = svc.update_seed_peer(hostname="seed", ip="10.0.1.1", port=65100,
                              download_port=65101,
                              seed_peer_cluster_id=seeds.id, type="strong",
                              idc="idc-a", location="cn|hz")
    svc.create_application("app", url="http://x", bio="b",
                           priorities={"value": 3})
    svc.create_application("app2")
    svc.db.update("scheduler_clusters", b.id, name="b-renamed")
    c = svc.create_scheduler_cluster("c")
    svc.db.delete("scheduler_clusters", c.id)
    return {"ids": [first.id, again.id, other.id, p1.id, p2.id],
            "states": [first.state, again.state, p2.state],
            "clusters": [r.name for r in svc.list_scheduler_clusters()],
            "apps": [r.name for r in svc.list_applications()],
            "rows": dump(svc.db)}


def script_keepalive(svc, pkg):
    cluster = svc.create_scheduler_cluster("c", is_default=True)
    seeds = svc.create_seed_peer_cluster("seeds")
    for i in range(3):
        svc.update_scheduler(hostname=f"s{i}", ip=f"10.0.0.{i}", port=8002,
                             scheduler_cluster_id=cluster.id)
    svc.update_seed_peer(hostname="seed", ip="10.0.1.1", port=65000,
                         download_port=65001, seed_peer_cluster_id=seeds.id)
    before = [r.hostname for r in svc.list_schedulers(ip="10.9.9.9")]
    for i in range(2):
        svc.keepalive(source_type="scheduler", hostname=f"s{i}",
                      ip=f"10.0.0.{i}", cluster_id=cluster.id)
    svc.keepalive(source_type="seed_peer", hostname="seed", ip="10.0.1.1",
                  cluster_id=seeds.id)
    active = [r.hostname for r in svc.list_schedulers(ip="10.9.9.9")]
    peers = [r.hostname for r in svc.list_seed_peers()]
    peers_of = [r.hostname for r in svc.list_seed_peers(seeds.id)]
    swept_early = svc.sweep_keepalive()
    time.sleep(TTL + 0.1)
    svc.keepalive(source_type="scheduler", hostname="s1", ip="10.0.0.1",
                  cluster_id=cluster.id)
    swept = svc.sweep_keepalive()
    after = [r.hostname for r in svc.list_schedulers(ip="10.9.9.9")]
    unknown = error_of(pkg, lambda: svc.keepalive(
        source_type="scheduler", hostname="ghost", ip="0.0.0.0",
        cluster_id=cluster.id))
    return {"before": before, "active": active, "peers": peers,
            "peers_of": peers_of, "swept_early": swept_early,
            "swept": swept, "after": after, "unknown": unknown,
            "rows": dump(svc.db)}


def seeded_scopes(rng, n: int) -> list:
    idcs = ["idc-a", "idc-b", "idc-c", "idc-a|idc-d", ""]
    locations = ["cn|hz|a", "cn|hz|b", "cn|sh", "us|ca|sf", ""]
    out = []
    for i in range(n):
        cidrs = [f"10.{int(x)}.0.0/16" for x in
                 rng.choice(8, size=int(rng.integers(0, 3)), replace=False)]
        if rng.random() < 0.2:
            cidrs.append("not-a-cidr")
        out.append({"idc": idcs[int(rng.integers(len(idcs)))],
                    "location": locations[int(rng.integers(len(locations)))],
                    "cidrs": cidrs})
    return out


def seeded_queries(rng, n: int) -> list:
    idcs = ["idc-a", "IDC-B", "idc-d", "idc-x", ""]
    locations = ["cn|hz|a", "cn|hz", "cn|sh|x", "us", "eu|de", ""]
    out = []
    for _ in range(n):
        ip = (f"10.{int(rng.integers(0, 10))}.{int(rng.integers(256))}."
              f"{int(rng.integers(1, 255))}" if rng.random() < 0.8
              else "bad-ip")
        out.append({"ip": ip, "hostname": f"d{int(rng.integers(1000))}",
                    "conditions": {
                        "idc": idcs[int(rng.integers(len(idcs)))],
                        "location": locations[int(rng.integers(
                            len(locations)))]}})
    return out


def script_affinity(svc, pkg, seed):
    rng = np.random.default_rng(seed)
    ids = []
    for i, scopes in enumerate(seeded_scopes(rng, 6)):
        cluster = svc.create_scheduler_cluster(
            f"c{i}", scopes=scopes, is_default=(i == 5))
        ids.append(cluster.id)
        for j in range(2):
            svc.update_scheduler(hostname=f"c{i}-s{j}", ip=f"172.16.{i}.{j}",
                                 port=8002, scheduler_cluster_id=cluster.id)
            if i != 2:  # cluster c2 has no active scheduler
                svc.keepalive(source_type="scheduler",
                              hostname=f"c{i}-s{j}", ip=f"172.16.{i}.{j}",
                              cluster_id=cluster.id)
    picks = []
    for q in seeded_queries(rng, 200):
        rows = svc.list_schedulers(ip=q["ip"], hostname=q["hostname"],
                                   conditions=q["conditions"])
        picks.append(sorted(r.hostname for r in rows))
    return {"ids": ids, "picks": picks}


def script_config_cache(svc, pkg):
    cluster = svc.create_scheduler_cluster(
        "c", config={"candidate_parent_limit": 3}, is_default=True)
    svc.update_scheduler(hostname="s", ip="10.0.0.1", port=8002,
                         scheduler_cluster_id=cluster.id)
    first = svc.get_scheduler_cluster_config(cluster.id)
    svc.db.update("scheduler_clusters", cluster.id,
                  config={"candidate_parent_limit": 5,
                          "filter_parent_limit": 9})
    second = svc.get_scheduler_cluster_config(cluster.id)
    missing = error_of(pkg, lambda: svc.get_scheduler_cluster_config(99))
    empty = svc.list_schedulers(ip="1.2.3.4")
    misses = svc.cache.misses
    svc.list_schedulers(ip="1.2.3.4")
    counts = [svc.cache.misses - misses, svc.cache.hits]
    svc.keepalive(source_type="scheduler", hostname="s", ip="10.0.0.1",
                  cluster_id=cluster.id)
    fresh = [r.hostname for r in svc.list_schedulers(ip="1.2.3.4")]
    # A steady keepalive (no state flip) keeps the cached answer.
    svc.keepalive(source_type="scheduler", hostname="s", ip="10.0.0.1",
                  cluster_id=cluster.id)
    hits = svc.cache.hits
    svc.list_schedulers(ip="1.2.3.4")
    return {"configs": [first, second], "missing": missing,
            "empty": [r.hostname for r in empty], "counts": counts,
            "fresh": fresh, "steady_hit": svc.cache.hits - hits}


@pytest.mark.parametrize("script", [script_clusters, script_keepalive,
                                    script_config_cache],
                         ids=["clusters", "keepalive", "config_cache"])
def test_service_rows_match(script, tmp_path):
    want, got = both(script, tmp_path)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_schedulers_by_affinity_match(seed, tmp_path):
    want, got = both(script_affinity, tmp_path, seed)
    assert got == want
    # The table is not degenerate: several clusters win somewhere, and
    # some daemons find none active in their best cluster's stead.
    assert len({tuple(p) for p in got["picks"]}) >= 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_searcher_ranking_matches(seed):
    rng = np.random.default_rng(100 + seed)
    clusters = [SimpleNamespace(id=i, scopes=scopes, is_default=(i == 0))
                for i, scopes in enumerate(seeded_scopes(rng, 12))]
    queries = seeded_queries(rng, 300)
    ranked, scores = {}, {}
    for pkg in PACKAGES:
        s = importlib.import_module(f"{pkg}.manager.searcher")
        searcher = s.Searcher()
        ranked[pkg] = [[c.id for c in searcher.find_scheduler_clusters(
            clusters, q["ip"], q["hostname"], q["conditions"],
            has_active_schedulers=lambda c: c.id % 5 != 3)]
            for q in queries]
        scores[pkg] = [[searcher.evaluate(
            q["ip"], q["conditions"], s.Scopes.from_dict(c.scopes),
            c.is_default) for c in clusters] for q in queries]
    assert ranked["dragonfly2_tpu_torch"] == ranked["dragonfly2_tpu"]
    assert scores["dragonfly2_tpu_torch"] == scores["dragonfly2_tpu"]
    assert len({r[0] for r in ranked["dragonfly2_tpu_torch"]}) >= 3
