"""Minimal scheduler-replica process entry for the HA chaos plane.

``python -m dragonfly2_tpu_torch.scheduler.replica --port 0 --data-dir D``
builds a bare SchedulerService (resource model + rule scheduling + CSV
sink, no manager/trainer/topology extras) behind the gRPC surface,
prints one ``REPLICA <host:port>`` line on stdout, and serves until the
process dies. The chaos bench's scheduler-kill rung (and the rolling-
restart e2e) spawn several of these and SIGKILL/cycle them mid-swarm —
a REAL process death, which is the one failure mode an in-process
server can't produce (its Python state survives a ``stop()``).

Deliberately lighter than ``cmd/scheduler.py``: no argparse config
files, no metrics server, no jax anywhere on the import path — the
supervisor needs replicas that are up within ~1–2 s so the kill rung
fits inside the bench budget.
"""

from __future__ import annotations

import argparse
import sys
import threading


def build_replica(data_dir: str, *, host: str = "127.0.0.1", port: int = 0,
                  retry_interval: float = 0.01,
                  retry_back_to_source_limit: int = 2,
                  resource_shards: int = 0, gc_budget_s: float = 0.0,
                  gc_interval: float = 0.0, max_workers: int = 16,
                  serve_gc: bool = False):
    """(service, server) — the same assembly the e2e tests use.

    The cluster-bench knobs mirror ``cmd/scheduler.py``:
    ``resource_shards`` / ``gc_budget_s`` shape the sharded managers
    (0 = manager defaults), ``max_workers`` sizes the gRPC pool (each
    open AnnouncePeer stream holds a worker — a dense-swarm replica
    needs more than the default 16, the fan-out bench lesson), and
    ``serve_gc`` starts the interval GC so a long 100k rung reclaims
    left peers instead of growing monotonically."""
    from dragonfly2_tpu_torch.rpc import serve
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import (
        Resource,
        ResourceConfig,
    )
    from dragonfly2_tpu_torch.scheduler.rpcserver import (
        SCHEDULER_SPEC,
        SchedulerRpcService,
    )
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    rcfg = ResourceConfig()
    if resource_shards > 0:
        rcfg.shard_count = resource_shards
    if gc_budget_s > 0:
        rcfg.gc_budget_s = gc_budget_s
    if gc_interval > 0:
        rcfg.gc_interval = gc_interval
    resource = Resource(rcfg)
    service = SchedulerService(
        resource=resource,
        scheduling=Scheduling(
            BaseEvaluator(),
            SchedulingConfig(
                retry_interval=retry_interval,
                retry_back_to_source_limit=retry_back_to_source_limit),
        ),
        storage=Storage(data_dir),
    )
    if serve_gc:
        resource.serve()
    server = serve([(SCHEDULER_SPEC, SchedulerRpcService(service))],
                   host=host, port=port, max_workers=max_workers)
    return service, server


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-scheduler-replica")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--retry-interval", type=float, default=0.01)
    parser.add_argument("--retry-back-to-source-limit", type=int, default=2)
    parser.add_argument("--resource-shards", type=int, default=0,
                        help="manager map shards (0 = default 8)")
    parser.add_argument("--gc-budget-ms", type=float, default=0.0,
                        help="incremental-GC per-slice budget (0 = default)")
    parser.add_argument("--gc-interval", type=float, default=0.0,
                        help="GC firing interval seconds (0 = default 60)")
    parser.add_argument("--max-workers", type=int, default=16,
                        help="gRPC worker pool (1 open announce stream "
                             "holds 1 worker)")
    parser.add_argument("--serve-gc", action="store_true",
                        help="run the interval GC (cluster rungs)")
    # Observability passthrough (the SAME flag set as cmd/common, via
    # the shared helper, so chaos/cluster spawners can forward an
    # operator's flags verbatim): spans + /metrics on a bench replica
    # without paying the full df2-scheduler bootstrap.
    from dragonfly2_tpu_torch.cmd.common import add_observability_flags

    add_observability_flags(parser)
    args = parser.parse_args(argv)

    if args.trace_dir or args.otlp_endpoint:
        from dragonfly2_tpu_torch.cmd.common import init_tracing

        init_tracing(args, "scheduler-replica")

    _, server = build_replica(
        args.data_dir, host=args.host, port=args.port,
        retry_interval=args.retry_interval,
        retry_back_to_source_limit=args.retry_back_to_source_limit,
        resource_shards=args.resource_shards,
        gc_budget_s=args.gc_budget_ms / 1e3,
        gc_interval=args.gc_interval,
        max_workers=args.max_workers, serve_gc=args.serve_gc)
    # The supervisor parses this single line for the bound target —
    # keep it FIRST on stdout (the metrics server below prints its own
    # address line, which must not displace it).
    print(f"REPLICA {server.target}", flush=True)
    if args.metrics_port >= 0:
        from dragonfly2_tpu_torch.cmd.common import start_metrics_server

        start_metrics_server(args)
    # Serve until killed (the rung's whole point is that we never get a
    # clean shutdown path).
    threading.Event().wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
