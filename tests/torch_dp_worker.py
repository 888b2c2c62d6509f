"""What a rank runs in the port's data-parallel tests
(``tests/test_torch_data_parallel.py``, ``tests/test_torch_multihost.py``),
spawned through ``tests/torch_dist_worker.py``.

Each case names one of the functions below and carries its inputs; the
function returns a flat ``{key: numpy array}``. A spawned child imports
this module afresh, so it imports no JAX (and nothing that does): only
torch, numpy and the port. The problems are small and made from seeds;
the tests build the JAX package's side of each comparison from the same
seeds.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np

# The tests' graph and pair examples: SyntheticCluster(48 hosts, seed 0).
N_HOSTS, N_PROBES, N_PAIRS = 48, 2000, 4000


def graph():
    from dragonfly2_tpu_torch.data import SyntheticCluster

    return SyntheticCluster(n_hosts=N_HOSTS, seed=0).probe_graph(N_PROBES)


def pairs():
    from dragonfly2_tpu_torch.data import SyntheticCluster

    return SyntheticCluster(n_hosts=N_HOSTS, seed=0).pair_example_columns(
        N_PAIRS)


def cost_pairs():
    """(X, realized cost in seconds of a 4 MB piece) from the pairs."""
    X, y = pairs()
    return X, (4.0 / np.maximum(y, 1e-3)).astype(np.float32)


def _state(result_state: dict) -> dict:
    return {f"param/{k}": v.detach().cpu().numpy()
            for k, v in result_state.items()}


def _torch_state(case: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in case["init"].items()}


def run_trainer(case: dict, rank: int, world: int) -> dict:
    """Train ``case["trainer"]`` ("gnn", "mlp", "cost" or "gat") with
    ``case["config"]`` from ``case["init"]`` (a port state dict) over the
    world's default group on the CPU, in the models' bf16 compute or,
    with ``case["f32"]``, in f32. A "gnn" case on the device path takes
    its salts from ``case["salts"]`` (the train steps', then the eval
    chunks'), so that it samples what the JAX trainer samples."""
    import torch

    from dragonfly2_tpu_torch.train import (
        gat_trainer,
        gnn_trainer,
        mlp_trainer,
    )

    models = ((gnn_trainer, "GraphSAGE"), (gat_trainer, "GraphTransformer"),
              (mlp_trainer, "MLPBandwidthPredictor"))
    real = [getattr(module, name) for module, name in models]
    if case.get("f32"):
        for (module, name), cls in zip(models, real):
            setattr(module, name, functools.partial(cls, dtype=torch.float32))
    try:
        return _train(case)
    finally:
        for (module, name), cls in zip(models, real):
            setattr(module, name, cls)


def _train(case: dict) -> dict:
    from dragonfly2_tpu_torch.train import cost_trainer, mlp_trainer
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
    )
    from dragonfly2_tpu_torch.train.gnn_trainer import (
        GNNTrainConfig,
        GNNTrainer,
    )

    kind, cfg = case["trainer"], dict(case["config"])
    if kind == "gnn":
        cfg["fanouts"] = tuple(cfg["fanouts"])
        trainer = GNNTrainer(graph(), GNNTrainConfig(**cfg), "cpu",
                             init_state=_torch_state(case))
        if cfg.get("device_sample", True):
            salts = iter([tuple(int(s) for s in pair)
                          for pair in case["salts"]])
            trainer._draw_salts = lambda gen: next(salts)
        result = trainer.fit()
        out = _state(result.state_dict)
        out.update(f1=np.array(result.f1), batch=np.array(trainer.batch))
    elif kind == "gat":
        trainer = GATTrainer(graph(), GATTrainConfig(**cfg), "cpu",
                             init_state=_torch_state(case))
        result = trainer.fit()
        out = _state(result.state_dict)
        out.update(f1=np.array(result.f1), batch=np.array(trainer.batch))
    elif kind == "mlp":
        cfg["hidden"] = tuple(cfg["hidden"])
        X, y = pairs()
        trainer = mlp_trainer.MLPTrainer(
            X, y, mlp_trainer.MLPTrainConfig(**cfg), "cpu",
            init_params=_torch_state(case))
        result = trainer.fit()
        out = _state(mlp_state_dict_from_flax(result.params))
        out.update(mae=np.array(result.mae), mse=np.array(result.mse),
                   batch=np.array(trainer.batch))
    else:
        cfg["hidden"] = tuple(cfg["hidden"])
        X, y = cost_pairs()
        # train_cost starts from its own seeded init; the JAX side's
        # comes in through train_mlp, as tests/test_torch_trainer.py
        # feeds it.
        real = cost_trainer.train_mlp
        cost_trainer.train_mlp = functools.partial(
            real, init_params=_torch_state(case))
        try:
            result = cost_trainer.train_cost(
                X, y, cost_trainer.CostTrainConfig(**cfg), "cpu")
        finally:
            cost_trainer.train_mlp = real
        out = _state(mlp_state_dict_from_flax(result.params))
        out.update(mae=np.array(result.mae), mse=np.array(result.mse))
    out.update(history=np.array(result.history),
               step_losses=np.array(result.step_losses))
    return out


def run_ring_artifact(case: dict, rank: int, world: int) -> dict:
    """``train_gat`` in ring mode with ``case["config"]`` over the world's
    default group; rank 0's result as a port artifact's bytes (uint8),
    the other ranks' empty."""
    from dragonfly2_tpu_torch.train.checkpoint import gat_artifact_from_result
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        train_gat,
    )

    tg = graph()
    result = train_gat(tg, GATTrainConfig(**case["config"]), "cpu")
    data = (gat_artifact_from_result(result, tg, "ring-world") if rank == 0
            else b"")
    return {"artifact": np.frombuffer(data, np.uint8)}


def run_budget(case: dict, rank: int, world: int) -> dict:
    """The MLP with a wall-clock budget on rank 1 alone, spent at the
    first step (0 s): every rank must stop where rank 1 stops."""
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    X, y = pairs()
    result = train_mlp(X, y, MLPTrainConfig(
        hidden=(8,), batch_size=256, epochs=1,
        max_seconds=0.0 if rank == 1 else None), "cpu")
    out = _state(mlp_state_dict_from_flax(result.params))
    out["steps"] = np.array(len(result.step_losses))
    return out


def run_federated_local(case: dict, rank: int, world: int) -> dict:
    """Each rank is one federated cluster: a ``LocalClusterEndpoint``
    round on its own rows (rank r fits cluster r, under ``mine/``),
    inside a default group of ``world`` ranks that the fit must not
    join. A world of one fits every cluster (under ``c<cluster>/``)."""
    from dragonfly2_tpu_torch.models.mlp import Normalizer
    from dragonfly2_tpu_torch.train.federated import ClusterDataset
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig
    from dragonfly2_tpu_torch.trainer.federation import LocalClusterEndpoint

    X, y = pairs()
    out = {}
    clusters = case["clusters"] if world == 1 else [rank]
    for cluster in clusters:
        rows = slice(cluster * 1000, cluster * 1000 + 600 + 200 * cluster)
        ds = ClusterDataset(cluster, X[rows], y[rows])
        endpoint = LocalClusterEndpoint(
            ds, MLPTrainConfig(hidden=(8,), batch_size=128, epochs=1), "cpu")
        update = endpoint.train_round(
            0, None, Normalizer.fit(X), Normalizer.fit(np.log1p(y)[:, None]))
        tag = f"c{cluster}" if world == 1 else "mine"
        for path, leaf in _flat(update.params):
            out[f"{tag}/{path}"] = leaf
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, np.asarray(tree)


class Recorder:
    """A registry that records what was uploaded to it."""

    def __init__(self):
        self.models = []

    def create_model(self, model_id, model_type, host_id, ip, hostname,
                     evaluation, artifact_dir, scheduler_id=0):
        self.models.append(model_type)


def run_training(case: dict, rank: int, world: int) -> dict:
    """``Training.train`` with ``group=`` the world's default group on
    seeded records in this rank's own storage: GraphSAGE, the MLP and the
    GraphTransformer."""
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.schema import io as port_io
    from dragonfly2_tpu_torch.schema import records as port_schema
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig
    from dragonfly2_tpu_torch.train.gnn_trainer import GNNTrainConfig
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig
    from dragonfly2_tpu_torch.trainer.storage import TrainerStorage
    from dragonfly2_tpu_torch.trainer.training import (
        Training,
        TrainingConfig,
    )

    cluster = SyntheticCluster(n_hosts=40, seed=3)
    parts = [("networktopology", port_schema.NetworkTopology,
              cluster.topology(150)),
             ("download", port_schema.Download, cluster.downloads(80))]
    registry = Recorder()
    with tempfile.TemporaryDirectory() as base:
        storage = TrainerStorage(os.path.join(base, "data"))
        for prefix, schema, records in parts:
            path = os.path.join(base, f"{prefix}.csv")
            with port_io.CsvRecordWriter(schema, path) as writer:
                for rec in records:
                    writer.write(rec)
            with open(path, "rb") as f:
                storage.append(prefix, "host", f.read(), new_file=True)
        storage.close_host("host")
        config = TrainingConfig(
            gnn=GNNTrainConfig(hidden=8, embed=4, fanouts=(3, 2), epochs=2,
                               batch_size=32, eval_fraction=0.25),
            mlp=MLPTrainConfig(hidden=(8,), epochs=2, batch_size=32),
            gat=GATTrainConfig(hidden=8, embed=4, layers=1, heads=2,
                               epochs=2, edge_batch_size=32,
                               eval_fraction=0.25),
            train_gat_model=True)
        outcome = Training(storage, registry, config, device="cpu",
                           group=None).train("10.0.0.1", "h", "host")
    return {"errors": np.array(len(outcome.errors)),
            "registered": np.array(",".join(sorted(registry.models))),
            "gnn_f1": np.array(outcome.gnn_evaluation["f1"]),
            "gat_f1": np.array(outcome.gat_evaluation["f1"]),
            "mlp_mae": np.array(outcome.mlp_evaluation["mae"])}


def multihost_rank(rank: int, world: int, address: str, mode: str,
                   out_dir: str) -> None:
    """One process of a fleet joined through the port's multihost entry
    points over ``tcp://address``: ``mode`` "env" calls
    ``init_multihost()`` with the ``DF2_*`` environment set, "args"
    calls ``maybe_init_multihost(address, world, rank)``. Then ``sync``,
    ``agree`` and, in "env" mode, the dryrun twin; what it saw goes to
    ``out_dir/<mode><rank>.npz`` (a traceback to ``.err``)."""
    import traceback

    import torch
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    try:
        if mode == "env":
            os.environ.update(DF2_COORDINATOR_ADDRESS=address,
                              DF2_NUM_PROCESSES=str(world),
                              DF2_PROCESS_ID=str(rank))
            info = multihost.init_multihost()
            group = dist.group.WORLD
        else:
            group = multihost.maybe_init_multihost(address, world, rank)
            info = multihost.MultihostInfo(dist.get_rank(),
                                           dist.get_world_size(),
                                           dist.get_backend(), None)
        try:
            multihost.sync("df2-test")
            out = {"process_id": np.array(info.process_id),
                   "num_processes": np.array(info.num_processes),
                   "backend": np.array(info.backend),
                   "device": np.array(str(info.device)),
                   "is_world": np.array(group is dist.group.WORLD),
                   "agree_int": multihost.agree(np.int64(rank * 10 + 1)),
                   "agree_vec": multihost.agree(
                       np.array([rank, -rank], np.float32))}
            if mode == "env":
                from dragonfly2_tpu_torch.parallel.dryrun import (
                    dryrun_data_parallel,
                )

                for name, loss in dryrun_data_parallel(device="cpu").items():
                    out[f"loss/{name}"] = np.array(loss)
            np.savez(os.path.join(out_dir, f"{mode}{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{mode}{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
