"""Prometheus bridge: every registered ``/debug/vars`` stats block,
scrapeable at ``/metrics``.

The reference wires a promhttp endpoint into every service
(scheduler/metrics/metrics.go, client/daemon/metrics, manager); our
services grew the same endpoint for their hand-built
``prometheus_client`` collectors — but the rich counter blocks the
subsystems publish (``data_plane``, ``scheduler``, ``recovery``,
``serving``, ``observability``, the sidecar's batcher stats, …) were
visible only as ``/debug/vars`` JSON. :class:`DebugVarsCollector` is the
generic adapter: at scrape time it snapshots every block registered via
:func:`dragonfly2_tpu_torch.utils.debugmon.register_debug_var` and flattens
each numeric leaf into an (untyped-as-gauge) metric named

    df2_<block>_<key...>{...}

Nested dicts join their path with ``_``; a list of dicts (the sidecar's
``per_lane`` breakdown) becomes one metric per leaf with an ``index``
label; booleans export as 0/1; strings and other non-numerics are
skipped. Percentile rings need no special casing — the blocks already
flatten them to ``*_p50_ms`` / ``*_p99_ms`` leaves.

Attach to an existing per-service registry with :func:`attach` (the
``cmd/`` entrypoints do, so one ``--metrics-port`` serves both the
service's native collectors and every stats block), or grab a
self-contained :func:`bridge_registry` for processes without one.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

from dragonfly2_tpu_torch.utils.prom import CollectorRegistry
from dragonfly2_tpu_torch.utils.prom import GaugeMetricFamily

from dragonfly2_tpu_torch.utils import debugmon
# Any process serving /metrics should expose the tracing pipeline's
# health too — importing registers the "observability" block (all
# zeros until tracing is enabled, which is itself the signal).
from dragonfly2_tpu_torch.utils import obsstats  # noqa: F401

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_PREFIX = "df2"


def _metric_name(*parts: str) -> str:
    name = "_".join(_NAME_RE.sub("_", p).strip("_") for p in parts if p)
    if name and name[0].isdigit():
        name = "_" + name
    return f"{_PREFIX}_{name}"


def flatten_block(value, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], Dict[str, str], float]]:
    """Yield ``(name_parts, labels, value)`` for every numeric leaf."""
    if isinstance(value, bool):
        yield prefix, {}, 1.0 if value else 0.0
    elif isinstance(value, (int, float)):
        yield prefix, {}, float(value)
    elif isinstance(value, dict):
        for key, sub in value.items():
            yield from flatten_block(sub, prefix + (str(key),))
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, dict) for v in value) and value:
            for i, sub in enumerate(value):
                for parts, labels, leaf in flatten_block(sub, prefix):
                    yield parts, {**labels, "index": str(i)}, leaf
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in value) and value:
            # Small numeric tuples (e.g. gc_counts) label by position.
            for i, leaf in enumerate(value):
                yield prefix, {"index": str(i)}, float(leaf)
    # strings / None / mixed lists: not a metric


class DebugVarsCollector:
    """A prometheus_client custom collector over the debug-vars blocks.

    Each scrape re-evaluates the registered callables — the same
    snapshot semantics as a ``/debug/vars`` GET, so the two surfaces
    can never disagree. A block that raises is skipped for that scrape
    (one bad var must not take down the whole endpoint, the debugmon
    contract)."""

    def collect(self):
        families: Dict[str, GaugeMetricFamily] = {}
        label_names: Dict[str, List[str]] = {}
        blocks = {"process": debugmon.process_vars}
        blocks.update(debugmon.registered_debug_vars())
        # Geo cluster label (docs/GEO.md): a cluster-labeled process
        # stamps every exported metric, so one federated Prometheus
        # scraping multiple sites can tell the series apart. Resolved
        # per scrape; cluster-blind processes emit no extra label and
        # their exposition text stays byte-identical.
        cluster = debugmon.cluster_id()
        for block, fn in blocks.items():
            try:
                value = fn()
            except Exception:  # noqa: BLE001 — mirror debug_vars()
                continue
            for parts, labels, leaf in flatten_block(value, (block,)):
                if cluster:
                    labels = {**labels, "cluster": cluster}
                name = _metric_name(*parts)
                names = sorted(labels)
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = GaugeMetricFamily(
                        name, f"debug-vars block {parts[0]!r} leaf "
                              f"{'.'.join(parts[1:]) or parts[0]}",
                        labels=names)
                    label_names[name] = names
                elif label_names[name] != names:
                    # Same leaf name, different label shape (block drift
                    # mid-scrape): skip rather than emit invalid text.
                    continue
                fam.add_metric([labels[k] for k in names], leaf)
        yield from families.values()


def attach(registry: CollectorRegistry) -> CollectorRegistry:
    """Register the bridge on an existing registry (idempotent)."""
    if not getattr(registry, "_df2_bridge_attached", False):
        registry.register(DebugVarsCollector())
        registry._df2_bridge_attached = True
    return registry


def bridge_registry() -> CollectorRegistry:
    """A fresh registry carrying only the bridge — for processes with no
    native prometheus collectors of their own."""
    return attach(CollectorRegistry())
