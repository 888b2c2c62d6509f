"""Dataset record schemas and their CSV and parquet IO — port copy of
``dragonfly2_tpu/schema`` without pyarrow.

The records are the training-data contract between the scheduler (the
producer), the trainer (the consumer) and the scorers (the feature
layout): ``Download`` rows train the MLP bandwidth predictor,
``NetworkTopology`` rows the graph models, ``ReplayDecision`` rows the
piece-cost model. Lists flatten at fixed arity (the reference's
``csv[]:"20"`` / ``"10"`` / ``"5"`` tags), so every flattened row has a
static width. Columnar form is a dict of numpy columns
(``schema.io.records_to_table``), and bulk IO is parquet through the
port's own codec (``schema.parquet``).
"""

from dragonfly2_tpu_torch.schema.records import (
    MAX_DEST_HOSTS,
    MAX_PARENTS,
    MAX_PIECES_PER_PARENT,
    MAX_REPLAY_CANDIDATES,
    REPLAY_SCHEMA_VERSION,
    CPU,
    CPUTimes,
    Build,
    DestHost,
    Disk,
    Download,
    DownloadError,
    Host,
    Memory,
    Network,
    NetworkTopology,
    Parent,
    Piece,
    Probes,
    ReplayCandidate,
    ReplayDecision,
    ReplayFeatureRow,
    SrcHost,
    Task,
    column_spec,
    flatten_record,
    unflatten_record,
)

__all__ = [
    "MAX_DEST_HOSTS",
    "MAX_PARENTS",
    "MAX_PIECES_PER_PARENT",
    "MAX_REPLAY_CANDIDATES",
    "REPLAY_SCHEMA_VERSION",
    "CPU",
    "CPUTimes",
    "Build",
    "DestHost",
    "Disk",
    "Download",
    "DownloadError",
    "Host",
    "Memory",
    "Network",
    "NetworkTopology",
    "Parent",
    "Piece",
    "Probes",
    "ReplayCandidate",
    "ReplayDecision",
    "ReplayFeatureRow",
    "SrcHost",
    "Task",
    "column_spec",
    "flatten_record",
    "unflatten_record",
]
