"""Training loops on the card — the GraphTransformer, GraphSAGE, the MLP
and the cost model — model artifacts, and federated multi-cluster
training (BASELINE config #4)."""

from dragonfly2_tpu_torch.train.federated import (
    GLOBAL_SCHEDULER_ID,
    ClusterDataset,
    ClusterUpdate,
    FederatedConfig,
    FederatedResult,
    ScreenReport,
    aggregate_cluster_models,
    aggregate_updates,
    cluster_datasets_from_corpora,
    column_moments,
    escalate_screened_clusters,
    fedavg,
    init_global_params,
    normalizer_from_moments,
    pooled_normalizers,
    register_federated_model,
    screen_updates,
    train_federated_mlp,
    trimmed_mean,
    update_norm,
)

__all__ = [
    "GLOBAL_SCHEDULER_ID",
    "ClusterDataset",
    "ClusterUpdate",
    "FederatedConfig",
    "FederatedResult",
    "ScreenReport",
    "aggregate_cluster_models",
    "aggregate_updates",
    "cluster_datasets_from_corpora",
    "column_moments",
    "escalate_screened_clusters",
    "fedavg",
    "init_global_params",
    "normalizer_from_moments",
    "pooled_normalizers",
    "register_federated_model",
    "screen_updates",
    "train_federated_mlp",
    "trimmed_mean",
    "update_norm",
]
