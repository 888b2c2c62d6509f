"""Scheduler-cluster affinity search for joining daemons.

Reference counterpart: manager/searcher/searcher.go:47-250. Identical
weights and sub-score math: CIDR containment 0.4, IDC match 0.35,
'|'-separated location prefix match 0.24 (max 5 elements), default-cluster
bonus 0.01; clusters with no active schedulers are filtered out first.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

CIDR_AFFINITY_WEIGHT = 0.4
IDC_AFFINITY_WEIGHT = 0.35
LOCATION_AFFINITY_WEIGHT = 0.24
CLUSTER_TYPE_WEIGHT = 0.01

AFFINITY_SEPARATOR = "|"
MAX_ELEMENTS = 5

CONDITION_IDC = "idc"
CONDITION_LOCATION = "location"


@dataclass
class Scopes:
    """A cluster's declared affinity scope (searcher.go:74-79)."""

    idc: str = ""
    location: str = ""
    cidrs: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict) -> "Scopes":
        return cls(
            idc=d.get("idc", "") or "",
            location=d.get("location", "") or "",
            cidrs=list(d.get("cidrs", []) or []),
        )


def cidr_affinity_score(ip: str, cidrs: Sequence[str]) -> float:
    """(searcher.go:159-188) 1.0 when ip falls in any scope CIDR."""
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def idc_affinity_score(dst: str, src: str) -> float:
    """(searcher.go:191-211) dst may match any '|'-element of src."""
    if not dst or not src:
        return 0.0
    if dst.lower() == src.lower():
        return 1.0
    return float(
        any(dst.lower() == e.lower() for e in src.split(AFFINITY_SEPARATOR))
    )


def location_affinity_score(dst: str, src: str) -> float:
    """(searcher.go:214-239) matched-prefix length / 5."""
    if not dst or not src:
        return 0.0
    if dst.lower() == src.lower():
        return 1.0
    dst_elements = dst.split(AFFINITY_SEPARATOR)
    src_elements = src.split(AFFINITY_SEPARATOR)
    n = min(len(dst_elements), len(src_elements), MAX_ELEMENTS)
    score = 0
    for i in range(n):
        if dst_elements[i].lower() != src_elements[i].lower():
            break
        score += 1
    return score / MAX_ELEMENTS


class Searcher:
    """Ranks scheduler clusters for a joining daemon
    (searcher.go:100-135 FindSchedulerClusters)."""

    def evaluate(self, ip: str, conditions: Dict[str, str], scopes: Scopes,
                 is_default: bool) -> float:
        return (
            CIDR_AFFINITY_WEIGHT * cidr_affinity_score(ip, scopes.cidrs)
            + IDC_AFFINITY_WEIGHT
            * idc_affinity_score(conditions.get(CONDITION_IDC, ""), scopes.idc)
            + LOCATION_AFFINITY_WEIGHT
            * location_affinity_score(
                conditions.get(CONDITION_LOCATION, ""), scopes.location)
            + CLUSTER_TYPE_WEIGHT * (1.0 if is_default else 0.0)
        )

    def find_scheduler_clusters(
        self, clusters: Sequence, ip: str, hostname: str,
        conditions: Dict[str, str] | None = None,
        has_active_schedulers=None,
    ) -> List:
        """``clusters`` rows need .scopes (dict) and .is_default;
        ``has_active_schedulers(cluster)`` filters empty clusters."""
        conditions = conditions or {}
        candidates = [
            c for c in clusters
            if has_active_schedulers is None or has_active_schedulers(c)
        ]
        return sorted(
            candidates,
            key=lambda c: self.evaluate(
                ip, conditions, Scopes.from_dict(c.scopes or {}),
                bool(c.is_default),
            ),
            reverse=True,
        )
