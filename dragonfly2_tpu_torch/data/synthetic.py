"""Synthetic P2P cluster — port of ``dragonfly2_tpu/data/synthetic.py``.

Hosts live in a ``region|zone|rack`` hierarchy with an IDC and a latent
upload bandwidth; probe RTT = base RTT by location distance × lognormal
noise, so topology is recoverable from probes (the GNNs' input), and a
piece's bandwidth from a parent = min(parent upload bandwidth, the link
bandwidth of the RTT class) × congestion noise, so parent quality is
predictable from pair features (the MLP's input).

Two output paths: the columnar one (:meth:`SyntheticCluster.
pair_example_columns`, :meth:`SyntheticCluster.probe_graph`) feeds the
trainers directly; the record one (:meth:`SyntheticCluster.downloads`,
:meth:`SyntheticCluster.topology`) gives ``schema`` records for the CSV
datasets the training orchestrator reads. The draws from ``self.rng``
happen in the same order as in the JAX package, so one seed gives
bit-identical graphs, pair examples and records in both packages; only
the ``peer_id_v2`` ids of downloads and their parents are random uuids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.schema import (
    MAX_DEST_HOSTS,
    DestHost,
    Download,
    Host,
    Network,
    NetworkTopology,
    Parent,
    Piece,
    Probes,
    SrcHost,
    Task,
)
from dragonfly2_tpu_torch.utils import idgen

PIECE_LENGTH = 4 << 20  # dfdaemon default piece size, 4 MiB

# Base RTT (ns) by location proximity class: same rack / same zone /
# same region / cross-region.
_BASE_RTT_NS = np.array([200_000, 1_000_000, 10_000_000, 60_000_000])
# Link bandwidth (bytes/s) implied by each proximity class.
_LINK_BW = np.array([10e9, 5e9, 1e9, 200e6]) / 8


@dataclass
class HostPool:
    """Latent per-host ground truth (index-aligned arrays)."""

    region: np.ndarray
    zone: np.ndarray
    rack: np.ndarray
    idc: np.ndarray
    is_seed: np.ndarray
    upload_bw: np.ndarray  # bytes/s
    upload_limit: np.ndarray

    def __len__(self) -> int:
        return len(self.region)

    def location(self, i: int) -> str:
        return f"r{self.region[i]}|z{self.zone[i]}|k{self.rack[i]}"

    def idc_name(self, i: int) -> str:
        return f"idc-{self.idc[i]}"

    def proximity(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """0=rack, 1=zone, 2=region, 3=cross-region for index arrays a,b."""
        same_region = self.region[a] == self.region[b]
        same_zone = same_region & (self.zone[a] == self.zone[b])
        same_rack = same_zone & (self.rack[a] == self.rack[b])
        return np.where(same_rack, 0,
                        np.where(same_zone, 1, np.where(same_region, 2, 3)))


class SyntheticCluster:
    def __init__(
        self,
        n_hosts: int = 200,
        n_regions: int = 4,
        zones_per_region: int = 4,
        racks_per_zone: int = 8,
        seed_fraction: float = 0.05,
        seed: int = 0,
    ):
        self.rng = np.random.default_rng(seed)
        region = self.rng.integers(0, n_regions, n_hosts)
        zone = self.rng.integers(0, zones_per_region, n_hosts)
        rack = self.rng.integers(0, racks_per_zone, n_hosts)
        is_seed = self.rng.random(n_hosts) < seed_fraction
        self.hosts = HostPool(
            region=region,
            zone=zone,
            rack=rack,
            # IDC correlates with (region, zone) — mirrors real deployments.
            idc=region * zones_per_region + zone,
            is_seed=is_seed,
            upload_bw=self.rng.lognormal(np.log(200e6), 0.8, n_hosts)
            * np.where(is_seed, 8.0, 1.0),
            upload_limit=np.where(is_seed, 300, 50),
        )

    def rtt_ns(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        prox = self.hosts.proximity(src, dst)
        noise = self.rng.lognormal(0.0, 0.25, size=len(prox))
        return (_BASE_RTT_NS[prox] * noise).astype(np.int64)

    def pair_bandwidth(self, parent: np.ndarray,
                       child: np.ndarray) -> np.ndarray:
        """Achieved piece bandwidth (bytes/s) child←parent."""
        prox = self.hosts.proximity(child, parent)
        congestion = self.rng.lognormal(0.0, 0.35, size=len(prox))
        return (np.minimum(self.hosts.upload_bw[parent], _LINK_BW[prox])
                * congestion)

    def pair_example_columns(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(features [n, FEATURE_DIM] float32, bandwidth MB/s [n] float32):
        (parent, child) scoring examples in the canonical feature layout
        (``scoring.FEATURE_NAMES``) — the MLP's training input."""
        h = self.hosts
        child = self.rng.integers(0, len(h), n)
        parent = self.rng.integers(0, len(h), n)
        total = self.rng.choice([0, 64, 256, 1024], size=n,
                                p=[0.1, 0.4, 0.35, 0.15])
        parent_done = np.where(
            total > 0, (total * self.rng.random(n)).astype(int),
            self.rng.integers(0, 64, n))
        child_done = (parent_done * self.rng.random(n) * 0.8).astype(int)
        uploads = self.rng.poisson(50, n).astype(float)
        # Failure rate anti-correlates with latent bandwidth (overloaded
        # hosts fail more) — gives upload stats predictive power.
        fail_rate = np.clip(
            0.3 - 0.25 * (np.log(h.upload_bw[parent]) - 17) / 5, 0.01, 0.6)
        failed = self.rng.binomial(uploads.astype(int), fail_rate
                                   ).astype(float)
        limit = h.upload_limit[parent].astype(float)
        busy = (limit * self.rng.random(n) ** 2).astype(int)
        prox = h.proximity(child, parent)
        features = np.stack(
            [
                parent_done.astype(float),
                child_done.astype(float),
                total.astype(float),
                uploads,
                failed,
                (limit - busy),
                limit,
                h.is_seed[parent].astype(float),
                (h.is_seed[parent] & (self.rng.random(n) < 0.9)
                 ).astype(float),
                (h.idc[parent] == h.idc[child]).astype(float),
                # scoring.location_matches on the "r|z|k" strings: the
                # same rack matches exactly (5), the same zone 2 leading
                # elements, the same region 1.
                np.select([prox == 0, prox == 1, prox == 2],
                          [5.0, 2.0, 1.0], 0.0),
            ],
            axis=1,
        ).astype(np.float32)
        bw = self.pair_bandwidth(parent, child)
        # Congestion discount when few free slots.
        bw = bw * np.clip((limit - busy) / limit, 0.2, 1.0)
        return features, (bw / 1e6).astype(np.float32)

    def probe_edge_columns(self, n: int) -> dict:
        """n probe edges as columns: src, dst (host indices), rtt_ns."""
        src = self.rng.integers(0, len(self.hosts), n)
        dst = self.rng.integers(0, len(self.hosts), n)
        mask = dst == src
        dst[mask] = (dst[mask] + 1) % len(self.hosts)
        return {"src": src, "dst": dst, "rtt_ns": self.rtt_ns(src, dst)}

    def probe_graph(self, n_edges: int) -> Graph:
        """A :class:`Graph` built directly from columnar probe edges."""
        cols = self.probe_edge_columns(n_edges)
        return Graph(
            node_ids=np.array([f"host-{i}" for i in range(len(self.hosts))]),
            node_features=self.node_feature_matrix(),
            edge_src=cols["src"].astype(np.int32),
            edge_dst=cols["dst"].astype(np.int32),
            edge_rtt_ns=cols["rtt_ns"],
        )

    def node_feature_matrix(self) -> np.ndarray:
        """Observable per-host features [n_hosts, 8]: type flag, upload
        limit, hashed idc/region/zone/rack buckets, degree placeholders.
        Latent bandwidth is excluded — the GNN infers host quality from
        graph structure."""
        h = self.hosts
        n = len(h)
        return np.stack(
            [
                h.is_seed.astype(float),
                h.upload_limit / 100.0,
                (h.idc % 16) / 16.0,
                (h.region % 16) / 16.0,
                (h.zone % 16) / 16.0,
                (h.rack % 16) / 16.0,
                np.zeros(n),
                np.ones(n),
            ],
            axis=1,
        ).astype(np.float32)

    # -- record-object path --------------------------------------------------

    def _host_record(self, i: int) -> Host:
        h = self.hosts
        return Host(
            id=idgen.host_id_v1(f"host-{i}", 8002),
            type="super" if h.is_seed[i] else "normal",
            hostname=f"host-{i}",
            ip=f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}",
            port=8002,
            download_port=8001,
            concurrent_upload_limit=int(h.upload_limit[i]),
            network=Network(idc=h.idc_name(i), location=h.location(i)),
        )

    def downloads(self, n: int, max_parents: int = 4) -> list[Download]:
        out = []
        for _ in range(n):
            child = int(self.rng.integers(0, len(self.hosts)))
            n_parents = int(self.rng.integers(1, max_parents + 1))
            parents_idx = self.rng.integers(0, len(self.hosts), n_parents)
            total_pieces = int(self.rng.choice([64, 256]))
            url = ("https://origin.example.com/obj-"
                   f"{self.rng.integers(0, 1 << 20)}")
            parents = []
            total_cost = 0
            for p in parents_idx:
                bw = float(self.pair_bandwidth(np.array([p]),
                                               np.array([child]))[0])
                n_pieces = int(self.rng.integers(1, 8))
                pieces = [
                    Piece(length=PIECE_LENGTH,
                          cost=int(PIECE_LENGTH / bw * 1e9))
                    for _ in range(n_pieces)
                ]
                total_cost += sum(q.cost for q in pieces)
                parents.append(
                    Parent(
                        id=idgen.peer_id_v2(),
                        state="Running",
                        finished_piece_count=int(
                            self.rng.integers(0, total_pieces)),
                        upload_piece_count=n_pieces,
                        host=self._host_record(int(p)),
                        pieces=pieces,
                    )
                )
            out.append(
                Download(
                    id=idgen.peer_id_v2(),
                    state="Succeeded",
                    cost=total_cost,
                    finished_piece_count=total_pieces,
                    task=Task(
                        id=idgen.task_id_v2(url),
                        url=url,
                        content_length=total_pieces * PIECE_LENGTH,
                        total_piece_count=total_pieces,
                        state="Succeeded",
                    ),
                    host=self._host_record(child),
                    parents=parents,
                )
            )
        return out

    def topology(self, n: int) -> list[NetworkTopology]:
        out = []
        for _ in range(n):
            src = int(self.rng.integers(0, len(self.hosts)))
            n_dest = int(self.rng.integers(1, MAX_DEST_HOSTS + 1))
            dst = self.rng.integers(0, len(self.hosts), n_dest)
            rtts = self.rtt_ns(np.full(n_dest, src), dst)
            src_rec = self._host_record(src)
            out.append(
                NetworkTopology(
                    id=idgen.host_id_v2(src_rec.ip, src_rec.hostname),
                    host=SrcHost(
                        id=src_rec.id,
                        type=src_rec.type,
                        hostname=src_rec.hostname,
                        ip=src_rec.ip,
                        port=src_rec.port,
                        network=src_rec.network,
                    ),
                    dest_hosts=[
                        DestHost(
                            id=self._host_record(int(d)).id,
                            type=("super" if self.hosts.is_seed[d]
                                  else "normal"),
                            hostname=f"host-{d}",
                            ip=self._host_record(int(d)).ip,
                            port=8002,
                            network=Network(
                                idc=self.hosts.idc_name(int(d)),
                                location=self.hosts.location(int(d)),
                            ),
                            probes=Probes(average_rtt=int(r)),
                        )
                        for d, r in zip(dst, rtts)
                    ],
                )
            )
        return out
