"""``df2-trainer`` — run the trainer service, port of
``dragonfly2_tpu/cmd/trainer.py``.

Reference counterpart: cmd/trainer + trainer/trainer.go — except the
training jobs are implemented (the reference's are TODO stubs). Usage::

    python -m dragonfly2_tpu_torch.cmd.trainer --data-dir ./trainer-data \\
        --manager-db ./manager.db --object-store-dir ./manager-objects \\
        --port 9090 [--device cuda] [--train-gat]

Serves :data:`~dragonfly2_tpu_torch.trainer.TRAINER_SPEC` over the port's
wire (``rpc/service.py``): a scheduler's announcer streams its datasets to
``Train``, and each finished stream trains the models on ``--device``
(default ``cuda``) and registers them in the manager's registry. Without a
card and without ``--device cpu`` it exits at start with
:class:`~dragonfly2_tpu_torch.device.DeviceFault`: it never falls back to
the CPU. It prints ``trainer serving on <host:port>`` once the listener is
bound (``--port 0`` picks a free port).

``--metrics-port`` serves ``TrainerMetrics`` (streams, dataset bytes,
cycles, job durations and throughput) and the debug-vars bridge on
``/metrics``. It differs from JAX's in two ways: ``--device``; and
``--profile-dir`` runs each training cycle under ``torch.profiler``,
writing one Chrome trace a cycle there, where JAX traces its step loops
with ``jax.profiler``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from dragonfly2_tpu_torch.cmd.common import (
    init_tracing,
    parse_with_config,
    add_common_flags,
    add_multihost_flags,
    init_logging,
    maybe_init_multihost,
    start_debug_monitor,
    start_metrics_server,
    wait_for_shutdown,
)


class ProfiledTraining:
    """``Training`` whose every cycle runs under ``torch.profiler`` (the
    card's kernels too on a card), one Chrome trace a cycle in
    ``out_dir``."""

    def __init__(self, training, out_dir: str, device):
        self.training = training
        self.out_dir = out_dir
        self.device = device

    def train(self, ip, hostname, host_id, scheduler_id=0):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            outcome = self.training.train(ip, hostname, host_id,
                                          scheduler_id)
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.out_dir, f"train-{host_id}-{time.time_ns()}.json"))
        return outcome


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-trainer")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--data-dir", default="./trainer-data")
    parser.add_argument("--manager-db", default="",
                        help="manager sqlite path for model registration "
                             "(co-located deployment)")
    parser.add_argument("--object-store-dir", default="./manager-objects")
    parser.add_argument("--train-gat", action="store_true",
                        help="also train + register the GraphTransformer "
                             "(BASELINE config #3) each cycle")
    parser.add_argument("--train-interval", type=float, default=0.0,
                        help="seconds between periodic retrain cycles: "
                             "every interval, hosts with NEW closed "
                             "dataset segments are retrained + "
                             "registered without waiting for the next "
                             "announcer stream EOF (0 = off; cycles and "
                             "skips counted in TrainerMetrics)")
    parser.add_argument("--profile-dir", default="",
                        help="run each training cycle under "
                             "torch.profiler; one Chrome trace a cycle "
                             "lands here")
    parser.add_argument("--federated-quorum", type=int, default=0,
                        help="K-of-N quorum for federated rounds driven "
                             "from the training cycle (0 = federation "
                             "off). Endpoints come from this trainer's "
                             "replay segments grouped by scheduler id; "
                             "each cycle commits one screened round "
                             "through the journal in "
                             "<data-dir>/federation")
    parser.add_argument("--round-deadline", type=float, default=60.0,
                        help="federated straggler deadline per round, "
                             "seconds: a slow or dead cluster delays "
                             "nothing past it")
    parser.add_argument("--aggregator", default="fedavg",
                        choices=("fedavg", "trimmed_mean"),
                        help="federated aggregator (trimmed_mean is the "
                             "Byzantine-robust coordinate-wise trim)")
    parser.add_argument("--device", default="cuda",
                        help="where the models train (cuda, or cpu for "
                             "the plain PyTorch path)")
    add_multihost_flags(parser)
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="trainer")
    init_tracing(args, "trainer")

    from dragonfly2_tpu_torch.device import default_device

    # No card and no --device cpu: DeviceFault here, before any job.
    device = default_device(args.device)
    # Joining a fleet precedes any training in the process.
    fleet_group = maybe_init_multihost(args)

    from dragonfly2_tpu_torch import __version__
    from dragonfly2_tpu_torch.rpc import serve
    from dragonfly2_tpu_torch.trainer import (
        TRAINER_SPEC,
        TrainerService,
        TrainerStorage,
        Training,
    )
    from dragonfly2_tpu_torch.trainer.metrics import TrainerMetrics

    registry = None
    if args.manager_db:
        from dragonfly2_tpu_torch.manager import (
            Database,
            FilesystemObjectStore,
            ManagerService,
        )

        registry = ManagerService(
            Database(args.manager_db),
            FilesystemObjectStore(args.object_store_dir), device=device)
    storage = TrainerStorage(args.data_dir)
    metrics = TrainerMetrics(version=__version__)
    training_config = None
    if args.train_gat:
        from dragonfly2_tpu_torch.trainer.training import TrainingConfig

        training_config = TrainingConfig(train_gat_model=True)
    training = Training(storage, registry, config=training_config,
                        metrics=metrics, device=device, group=fleet_group)
    if args.profile_dir:
        training = ProfiledTraining(training, args.profile_dir, device)
    service = TrainerService(storage, training, metrics=metrics)
    server = serve([(TRAINER_SPEC, service)], host=args.host, port=args.port)
    print(f"trainer serving on {server.target}", flush=True)
    if args.federated_quorum > 0:
        from dragonfly2_tpu_torch.trainer.federation import (
            FederationConfig,
            FederationCoordinator,
            endpoints_from_storage,
        )
        from dragonfly2_tpu_torch.train.federated import FederatedConfig

        fed_config = FederationConfig(
            fed=FederatedConfig(aggregator=args.aggregator),
            quorum=args.federated_quorum,
            round_deadline_s=args.round_deadline)

        # Endpoints follow the streamed datasets: (re)build from replay
        # segments at each cycle so clusters that announce later join
        # the next round.
        class _LazyFederation:
            def __init__(self):
                self._coordinator = None

            def run_round(self):
                endpoints = endpoints_from_storage(
                    storage, service._host_identities,
                    fed_config.fed.local, device=device)
                if len(endpoints) < args.federated_quorum:
                    raise RuntimeError(
                        f"{len(endpoints)} federated endpoints < quorum "
                        f"{args.federated_quorum}; waiting for replay "
                        f"segments")
                self._coordinator = FederationCoordinator(
                    endpoints,
                    os.path.join(args.data_dir, "federation"),
                    fed_config, manager=registry, device=device)
                return self._coordinator.run_round()

        service.attach_federation(_LazyFederation())
        print(f"federation enabled: quorum={args.federated_quorum} "
              f"deadline={args.round_deadline:g}s "
              f"aggregator={args.aggregator}", flush=True)
    if args.train_interval > 0:
        service.start_cycle_driver(args.train_interval)
        print(f"interval cycle driver running every "
              f"{args.train_interval:g}s", flush=True)
    metrics_server = start_metrics_server(args, metrics.registry)
    debug_monitor = start_debug_monitor(args)
    wait_for_shutdown()
    service.stop_cycle_driver()
    if metrics_server:
        metrics_server.stop()
    if debug_monitor is not None:
        debug_monitor.stop()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
