"""Training-record schemas with deterministic fixed-arity flattening —
port copy of ``dragonfly2_tpu/schema/records.py`` (dataclasses only, so
the port keeps its own copy): the same types, fields, arities and
flattened column order, so either package reads the other's datasets.

Reference counterpart: scheduler/storage/types.go (Download at :189-225,
NetworkTopology at :284-320, Host telemetry sub-structs from
scheduler/resource/host.go:200-340). Field names and arities match the
reference so datasets are semantically interchangeable; the flattened column
order defined here is the canonical feature layout for the ML pipeline.

Flattening rules:
- nested records flatten to dot-joined column names (``host.cpu.percent``)
- fixed-arity lists flatten each slot with a numeric path segment
  (``parents.3.host.network.idc``); absent slots are zero/empty-padded and a
  companion ``<list>.len`` column records true arity, so padding is
  distinguishable from real zeros downstream (the masks).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Tuple, Type, get_args

# Fixed arities, identical to the reference's csv[] tags
# (scheduler/storage/types.go:214 parents "20", :173 pieces "10",
#  :316 destHosts "5").
MAX_PARENTS = 20
MAX_PIECES_PER_PARENT = 10
MAX_DEST_HOSTS = 5


def _arity(f: dataclasses.Field) -> int:
    return f.metadata["arity"]


def list_field(arity: int):
    """A fixed-arity list field (flattened to ``arity`` column groups)."""
    return field(default_factory=list, metadata={"arity": arity})


# --------------------------------------------------------------------------
# Host telemetry (reference: scheduler/resource/host.go:200-340)
# --------------------------------------------------------------------------


@dataclass
class CPUTimes:
    user: float = 0.0
    system: float = 0.0
    idle: float = 0.0
    nice: float = 0.0
    iowait: float = 0.0
    irq: float = 0.0
    softirq: float = 0.0
    steal: float = 0.0
    guest: float = 0.0
    guest_nice: float = 0.0


@dataclass
class CPU:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0
    times: CPUTimes = field(default_factory=CPUTimes)


@dataclass
class Memory:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used_percent: float = 0.0
    free: int = 0


@dataclass
class Network:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""  # multi-element affinity path, '|'-separated
    idc: str = ""


@dataclass
class Disk:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclass
class Build:
    git_version: str = ""
    git_commit: str = ""
    platform: str = ""


@dataclass
class Host:
    """Full host snapshot attached to download records
    (reference: scheduler/storage/types.go:57-127)."""

    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPU = field(default_factory=CPU)
    memory: Memory = field(default_factory=Memory)
    network: Network = field(default_factory=Network)
    disk: Disk = field(default_factory=Disk)
    build: Build = field(default_factory=Build)
    scheduler_cluster_id: int = 0
    created_at: int = 0  # nanoseconds
    updated_at: int = 0


# --------------------------------------------------------------------------
# Download records → MLP training data
# --------------------------------------------------------------------------


@dataclass
class Task:
    """(reference: scheduler/storage/types.go:26-56)"""

    id: str = ""
    url: str = ""
    type: str = ""
    content_length: int = 0
    total_piece_count: int = 0
    back_to_source_limit: int = 0
    back_to_source_peer_count: int = 0
    state: str = ""
    created_at: int = 0
    updated_at: int = 0


@dataclass
class Piece:
    """One piece downloaded from a parent (types.go:129-141)."""

    length: int = 0
    cost: int = 0  # nanoseconds
    created_at: int = 0


@dataclass
class Parent:
    """One candidate/used parent of a download (types.go:143-175)."""

    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    cost: int = 0
    upload_piece_count: int = 0
    finished_piece_count: int = 0
    host: Host = field(default_factory=Host)
    pieces: List[Piece] = list_field(MAX_PIECES_PER_PARENT)
    created_at: int = 0
    updated_at: int = 0


@dataclass
class DownloadError:
    """(types.go:177-187)"""

    code: str = ""
    message: str = ""


@dataclass
class Download:
    """One peer download outcome — an MLP training example
    (types.go:189-225). The label (achieved bandwidth) derives from
    ``cost`` and the task content length; features come from host telemetry
    and parent interaction statistics."""

    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    error: DownloadError = field(default_factory=DownloadError)
    cost: int = 0
    finished_piece_count: int = 0
    task: Task = field(default_factory=Task)
    host: Host = field(default_factory=Host)
    parents: List[Parent] = list_field(MAX_PARENTS)
    created_at: int = 0
    updated_at: int = 0


# --------------------------------------------------------------------------
# Replay-plane records → decision corpus (offline evaluator scoring +
# learned piece-cost training data)
# --------------------------------------------------------------------------

#: Fixed candidate arity per recorded decision. The scheduling filter
#: samples ``filter_parent_limit`` (default 15, dynconfig-tunable) DAG
#: vertices per announce; 16 covers the default with headroom and keeps
#: the flattened row width static. The recorder truncates (and counts)
#: wider candidate sets.
MAX_REPLAY_CANDIDATES = 16

#: Bump when the decision layout changes incompatibly; the replay
#: harness refuses corpora whose version it does not understand instead
#: of silently mis-scoring them.
REPLAY_SCHEMA_VERSION = 1


@dataclass
class ReplayFeatureRow:
    """One candidate's canonical (parent, child) feature vector.

    Field order and names mirror ``scoring.FEATURE_NAMES`` EXACTLY: the
    cost trainer reads a recorded row by those names
    (``scheduler/replay.py`` ``_row_array``)."""

    parent_finished_pieces: float = 0.0
    child_finished_pieces: float = 0.0
    total_pieces: float = 0.0
    upload_count: float = 0.0
    upload_failed_count: float = 0.0
    free_upload_count: float = 0.0
    concurrent_upload_limit: float = 0.0
    is_seed: float = 0.0
    seed_ready: float = 0.0
    idc_match: float = 0.0
    location_matches: float = 0.0


@dataclass
class ReplayCandidate:
    """One post-filter candidate parent at decision time.

    ``cost_*`` is the candidate's windowed Welford piece-cost snapshot
    WHEN the decision was made (what ``is_bad_node`` judged from);
    ``realized_*`` is the snapshot when the child's outcome landed — the
    per-candidate realized cost the replay harness scores regret
    against. ``realized_cost`` is the windowed mean (-1.0 when the
    candidate never reported a cost by outcome time)."""

    id: str = ""
    rank: int = -1  # position in the delivered ranking; -1 = filtered out of top-k
    features: ReplayFeatureRow = field(default_factory=ReplayFeatureRow)
    cost_n: int = 0
    cost_last: float = 0.0
    cost_prior_mean: float = 0.0
    cost_prior_pstd: float = 0.0
    realized_n: int = 0
    realized_cost: float = -1.0


@dataclass
class ReplayDecision:
    """One recorded scheduling decision + its eventual outcome.

    The full decision event the offline replay plane re-drives: the
    post-filter candidate set with feature matrix and cost statistics,
    the verdict (ranked parents vs back-to-source), the chosen (top-
    ranked) parent, and the child's terminal state once known. Appended
    to the scheduler's rotating dataset sink next to Download /
    NetworkTopology records (docs/REPLAY.md)."""

    version: int = REPLAY_SCHEMA_VERSION
    seq: int = 0
    task_id: str = ""
    peer_id: str = ""
    total_piece_count: int = 0
    verdict: str = ""  # "parents" | "back_to_source"
    chosen: str = ""   # ranked[0] id for "parents" verdicts
    outcome: str = ""  # child peer FSM state at finalize ("" = evicted unfinished)
    outcome_cost: float = 0.0
    decided_at: int = 0    # nanoseconds
    finalized_at: int = 0  # nanoseconds
    candidates: List[ReplayCandidate] = list_field(MAX_REPLAY_CANDIDATES)


# --------------------------------------------------------------------------
# Network-topology records → GNN training data
# --------------------------------------------------------------------------


@dataclass
class Probes:
    """Aggregated probe statistics for one (src, dest) edge
    (types.go:227-239)."""

    average_rtt: int = 0  # nanoseconds, EWMA with alpha=0.1
    created_at: int = 0
    updated_at: int = 0


@dataclass
class SrcHost:
    """(types.go:241-263)"""

    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: Network = field(default_factory=Network)


@dataclass
class DestHost:
    """(types.go:265-290)"""

    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: Network = field(default_factory=Network)
    probes: Probes = field(default_factory=Probes)


@dataclass
class NetworkTopology:
    """One probe-graph star: a source host and ≤5 probed destinations —
    a GNN training example (types.go:292-320)."""

    id: str = ""
    host: SrcHost = field(default_factory=SrcHost)
    dest_hosts: List[DestHost] = list_field(MAX_DEST_HOSTS)
    created_at: int = 0


# --------------------------------------------------------------------------
# Flattening — single source of truth for column order
# --------------------------------------------------------------------------

_LEAF_TYPES = (int, float, str, bool)


def _elem_type(f: dataclasses.Field) -> type:
    args = get_args(f.type) if not isinstance(f.type, str) else None
    if args:
        return args[0]
    # Annotations may be strings under `from __future__ import annotations`;
    # resolve List[X] by name against this module's globals.
    t = f.type if isinstance(f.type, str) else str(f.type)
    inner = t[t.index("[") + 1 : t.rindex("]")]
    return globals()[inner]


def _resolved_type(f: dataclasses.Field) -> Any:
    if isinstance(f.type, str):
        resolved = globals().get(f.type)
        if resolved is not None:
            return resolved
        return {"int": int, "float": float, "str": str, "bool": bool}[f.type]
    return f.type


def column_spec(record_type: Type) -> List[Tuple[str, type]]:
    """Ordered ``(column_name, leaf_type)`` pairs for a record type.

    Deterministic: follows dataclass field order depth-first. Fixed-arity
    lists contribute ``arity`` repeated groups plus one ``<name>.len``
    int column (the mask source).
    """
    out: List[Tuple[str, type]] = []

    def walk(t: Type, prefix: str) -> None:
        for f in fields(t):
            name = f"{prefix}{f.name}"
            if "arity" in f.metadata:
                elem = _elem_type(f)
                out.append((f"{name}.len", int))
                for i in range(_arity(f)):
                    walk(elem, f"{name}.{i}.")
                continue
            ft = _resolved_type(f)
            if is_dataclass(ft):
                walk(ft, f"{name}.")
            elif ft in _LEAF_TYPES:
                out.append((name, ft))
            else:  # pragma: no cover - schema definition error
                raise TypeError(f"unsupported field type {ft!r} at {name}")

    walk(record_type, "")
    return out


def flatten_record(record: Any) -> dict:
    """Flatten a record instance into ``{column: leaf_value}`` following
    :func:`column_spec` order. List slots beyond the true length are padded
    with type defaults."""
    out: dict = {}

    def walk(obj: Any, t: Type, prefix: str) -> None:
        for f in fields(t):
            name = f"{prefix}{f.name}"
            value = getattr(obj, f.name) if obj is not None else None
            if "arity" in f.metadata:
                elem = _elem_type(f)
                items = list(value or [])
                arity = _arity(f)
                if len(items) > arity:
                    raise ValueError(
                        f"{name} has {len(items)} items, exceeds fixed arity {arity}"
                    )
                out[f"{name}.len"] = len(items)
                for i in range(arity):
                    walk(items[i] if i < len(items) else None, elem, f"{name}.{i}.")
                continue
            ft = _resolved_type(f)
            if is_dataclass(ft):
                walk(value, ft, f"{name}.")
            else:
                out[name] = value if value is not None else ft()

    walk(record, type(record), "")
    return out


def unflatten_record(record_type: Type, row: dict) -> Any:
    """Inverse of :func:`flatten_record`; list slots past ``<name>.len`` are
    dropped."""

    def build(t: Type, prefix: str) -> Any:
        kwargs = {}
        for f in fields(t):
            name = f"{prefix}{f.name}"
            if "arity" in f.metadata:
                elem = _elem_type(f)
                n = int(row[f"{name}.len"])
                kwargs[f.name] = [build(elem, f"{name}.{i}.") for i in range(n)]
                continue
            ft = _resolved_type(f)
            if is_dataclass(ft):
                kwargs[f.name] = build(ft, f"{name}.")
            else:
                kwargs[f.name] = ft(row[name])
        return t(**kwargs)

    return build(record_type, "")
