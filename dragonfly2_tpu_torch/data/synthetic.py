"""Synthetic P2P cluster — the columnar probe-graph path of
``dragonfly2_tpu/data/synthetic.py``, in numpy.

Hosts live in a ``region|zone|rack`` hierarchy with an IDC and a latent
upload bandwidth; probe RTT = base RTT by location distance × lognormal
noise, so topology is recoverable from probes. The draws from
``self.rng`` happen in the same order as in the JAX package, so one seed
gives bit-identical graphs in both packages. The record path (schema
objects, idgen) is not part of this port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dragonfly2_tpu_torch.data.features import Graph

# Base RTT (ns) by location proximity class: same rack / same zone /
# same region / cross-region.
_BASE_RTT_NS = np.array([200_000, 1_000_000, 10_000_000, 60_000_000])


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
