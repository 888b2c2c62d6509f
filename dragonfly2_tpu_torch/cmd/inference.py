"""``df2-inference`` — run the inference sidecar, port of
``dragonfly2_tpu/cmd/inference.py``.

The serving half the reference left external (its scheduler only had the
Triton client, pkg/rpc/inference/client/client_v1.go). Usage::

    python -m dragonfly2_tpu_torch.cmd.inference --manager-db ./manager.db \\
        --object-store-dir ./manager-objects --port 9000 [--device cuda]

Serves :data:`~dragonfly2_tpu_torch.inference.sidecar.INFERENCE_SPEC` over
the port's wire (``rpc/service.py``), loading each model type's active
version from the manager's registry onto ``--device`` (default ``cuda``)
and hot-reloading through the watcher every ``--reload-interval``
seconds. Without a card and without ``--device cpu`` it exits at start
with :class:`~dragonfly2_tpu_torch.device.DeviceFault`: it never falls
back to the CPU. It prints ``inference sidecar serving on <host:port>``
once the listener is bound (``--port 0`` picks a free port). A scheduler
points its evaluator at that target:
``new_evaluator("ml", sidecar_target=...)``.

``--metrics-port`` serves the debug-vars bridge on ``/metrics`` (the
batcher and serving stats blocks). It differs from JAX's in one way:
``--device``.
"""

from __future__ import annotations

import argparse
import sys

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
    start_debug_monitor,
    start_metrics_server,
    wait_for_shutdown,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-inference")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--manager-db", required=True,
                        help="manager sqlite path (model registry)")
    parser.add_argument("--object-store-dir", default="./manager-objects")
    parser.add_argument("--reload-interval", type=float, default=30.0)
    parser.add_argument("--no-micro-batch", action="store_true",
                        help="serve each ModelInfer as its own device "
                             "dispatch (debugging; loses coalescing)")
    parser.add_argument("--batch-max-wait-s", type=float, default=0.0,
                        help="hold every batch open this long for "
                             "stragglers (remote-device throughput mode; "
                             "0 = never wait)")
    parser.add_argument("--batch-adaptive-wait-s", type=float,
                        default=0.0005,
                        help="open the batch window this long only when "
                             "the queue is growing (keeps the idle path "
                             "zero-wait; 0 = disable)")
    parser.add_argument("--batch-max-rows", type=int, default=0,
                        help="rows per coalesced dispatch "
                             "(0 = the scorer's largest warm bucket)")
    parser.add_argument("--batch-lanes", type=int, default=2,
                        help="independent micro-batch lanes (queue + "
                             "worker + in-flight slot each); >1 removes "
                             "the single-worker serialization point "
                             "under concurrent scheduler load")
    parser.add_argument("--batch-queue-depth", type=int, default=32,
                        help="per-lane admission cap: a request whose "
                             "round-robin lane has this many queued "
                             "requests is shed with RESOURCE_EXHAUSTED "
                             "(scheduler degrades to rule scoring); "
                             "0 = unbounded")
    parser.add_argument("--no-shadow", action="store_true",
                        help="install new active versions directly "
                             "instead of shadow-loading them behind the "
                             "incumbent until the canary promotes "
                             "(docs/SERVING.md guarded rollout)")
    parser.add_argument("--canary-batches", type=int, default=8,
                        help="clean shadow score batches required before "
                             "a new version takes over decisions")
    parser.add_argument("--canary-latency-budget-s", type=float,
                        default=0.25,
                        help="per-batch shadow scoring latency above "
                             "this rejects (and quarantines) the "
                             "candidate version")
    parser.add_argument("--device", default="cuda",
                        help="where models load and score (cuda, or cpu "
                             "for the plain PyTorch path)")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="inference")
    init_tracing(args, "inference")

    from dragonfly2_tpu_torch.device import default_device

    # No card and no --device cpu: DeviceFault here, before any model.
    device = default_device(args.device)

    from dragonfly2_tpu_torch.inference.sidecar import (
        INFERENCE_SPEC,
        InferenceService,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.rpc import serve

    manager = ManagerService(
        Database(args.manager_db),
        FilesystemObjectStore(args.object_store_dir), device=device)
    service = InferenceService(
        manager=manager,
        reload_interval=args.reload_interval,
        micro_batch=not args.no_micro_batch,
        batch_max_wait_s=args.batch_max_wait_s,
        batch_adaptive_wait_s=args.batch_adaptive_wait_s,
        batch_max_rows=args.batch_max_rows or None,
        batch_lanes=args.batch_lanes,
        batch_queue_depth=args.batch_queue_depth,
        shadow_mode=not args.no_shadow,
        canary_batches=args.canary_batches,
        canary_latency_budget_s=args.canary_latency_budget_s,
        device=device)
    service.reload_from_manager()
    service.serve_watcher()
    # Live per-lane serving counters (dispatches, coalesce, sheds, lane
    # p99) on the debug monitor's /debug/vars for operators chasing the
    # serving-path latency budget under load.
    from dragonfly2_tpu_torch.utils.debugmon import register_debug_var

    register_debug_var("inference_batcher_stats", service.batcher_stats)
    # No native prometheus collectors here — the bridged registry
    # exports the batcher/serving stats blocks at /metrics.
    metrics_server = start_metrics_server(args)
    debug_monitor = start_debug_monitor(args)
    server = serve([(INFERENCE_SPEC, service)],
                   host=args.host, port=args.port)
    # Share the server's health service: hot-reload grace windows flip
    # it NOT_SERVING so health-aware clients drain to a replica.
    service.set_health(server.health)
    print(f"inference sidecar serving on {server.target}", flush=True)
    wait_for_shutdown()
    service.stop()  # marks NOT_SERVING before the listener dies
    server.stop()
    if metrics_server is not None:
        metrics_server.stop()
    if debug_monitor is not None:
        debug_monitor.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
