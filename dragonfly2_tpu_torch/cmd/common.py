"""Shared CLI bootstrap (reference: cmd/dependency/dependency.go — config
loading, logging init, monitoring) — port of ``dragonfly2_tpu/cmd/common.py``.

The flags, the YAML layering, logging, tracing, the debug monitor and the
shutdown wait are JAX's. Left out: the geo cluster identity and the
multihost flags (no ported command takes them), and the Prometheus
endpoint (:func:`start_metrics_server` answers None).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def init_logging(verbose: bool, log_dir: str = "",
                 service: str = "df2") -> None:
    level = logging.DEBUG if verbose else logging.INFO
    if log_dir == "auto":
        # Standard per-service layout (pkg/dfpath role).
        from dragonfly2_tpu_torch.utils.dfpath import for_service

        log_dir = for_service(service).ensure().log_dir
    if log_dir:
        from dragonfly2_tpu_torch.utils.dflog import init_file_logging

        init_file_logging(log_dir, level=level)
        return
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default="",
                        help="YAML config file; keys mirror the flag names "
                             "(dashes or underscores). Flags given on the "
                             "command line override the file.")
    parser.add_argument("--verbose", action="store_true",
                        help="debug logging")
    parser.add_argument("--log-dir", default="",
                        help="rotated per-concern log files here; the "
                             "literal value 'auto' uses the standard "
                             "layout under $DF2_HOME (default: console "
                             "only)")
    add_observability_flags(parser)
    parser.add_argument("--pprof-port", type=int, default=-1,
                        help="debug monitor on this port (/debug/threads, "
                             "/debug/profile?seconds=N, /debug/vars — the "
                             "reference's pprof/statsview role; 0 = "
                             "ephemeral, -1 = disabled)")


def add_observability_flags(parser: argparse.ArgumentParser) -> None:
    """The tracing + metrics knobs, shared by ``add_common_flags`` and
    the light bench subprocess entrypoints (``scheduler/replica.py``,
    ``client/daemon_proc.py``) — ONE set of defaults, so operator
    services and bench fleets can never drift on observability
    behavior."""
    parser.add_argument("--metrics-port", type=int, default=-1,
                        help="serve Prometheus /metrics on this port "
                             "(native collectors + every debug-vars "
                             "stats block via the bridge; 0 = "
                             "ephemeral, -1 = disabled)")
    parser.add_argument("--trace-dir", default="",
                        help="write JSONL span traces here (rotated); "
                             "trace ids propagate across services via "
                             "gRPC metadata (default: tracing off)")
    parser.add_argument("--otlp-endpoint", default="",
                        help="export spans to this OTLP/HTTP collector "
                             "base URL, e.g. http://collector:4318 — the "
                             "reference's --jaeger role (default: off)")
    parser.add_argument("--trace-sample", type=float, default=0.05,
                        help="head-sampled fraction of traces written "
                             "through immediately; the rest buffer in "
                             "bounded memory and ship only when their "
                             "task breached an SLO (tail sampling; 1.0 "
                             "= record every span, the legacy behavior)")
    parser.add_argument("--trace-slo-s", type=float, default=30.0,
                        help="task-duration SLO for tail sampling: a "
                             "task slower than this promotes its whole "
                             "trace (failed / degraded / failovered "
                             "tasks always promote)")
    parser.add_argument("--trace-tail-buffer", type=int, default=512,
                        help="max concurrently buffered traces awaiting "
                             "a tail verdict (oldest evicted, counted "
                             "in the observability stats block)")


#: Services whose process contains the task-lifecycle verdict sites
#: (conductor run / scheduler terminal handlers) that promote or finish
#: tail-buffered traces. Only these install a tail sampler: a process
#: with no verdict call sites (sidecar, manager, trainer, the
#: daemon-gateway CLIs) would buffer ~95% of its spans awaiting a
#: verdict nobody ever delivers — there, every span writes through.
TAIL_CAPABLE_SERVICES = frozenset((
    "dfdaemon", "dfget", "scheduler", "daemon-proc", "scheduler-replica",
))


def init_tracing(args, service_name: str, cluster_id: str = "") -> None:
    """Install the process-wide tracer when --trace-dir or
    --otlp-endpoint was given (the reference's jaeger bootstrap,
    cmd/dependency/dependency.go:263-295), with tail-based sampling on
    the task-lifecycle services unless --trace-sample 1.0 asked for
    every span."""
    if getattr(args, "trace_dir", "") or getattr(args, "otlp_endpoint", ""):
        from dragonfly2_tpu_torch.utils.tracing import (
            TailSampler,
            Tracer,
            set_default_tracer,
        )

        fraction = getattr(args, "trace_sample", 1.0)
        sampler = None
        if fraction < 1.0 and service_name in TAIL_CAPABLE_SERVICES:
            sampler = TailSampler(
                head_fraction=fraction,
                max_traces=getattr(args, "trace_tail_buffer", 512),
                slow_slo_s=getattr(args, "trace_slo_s", 30.0))
        # Geo cluster tag: explicit cluster_id argument, else the
        # daemon CLIs' string --cluster-id. The isinstance guard is
        # load-bearing — the scheduler CLI's --cluster-id is the
        # manager's INTEGER scheduler-cluster id (it passes its
        # --geo-cluster explicitly instead).
        arg_cluster = getattr(args, "cluster_id", None)
        if not isinstance(arg_cluster, str):
            arg_cluster = ""
        set_default_tracer(Tracer(
            service_name, out_dir=args.trace_dir,
            otlp_endpoint=getattr(args, "otlp_endpoint", ""),
            sampler=sampler,
            cluster=cluster_id or arg_cluster))


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Two-pass parse implementing the reference's cobra+viper layering
    (cmd/dependency: config file < env-ish defaults < explicit flags).

    Pass 1 finds --config; the YAML's keys become parser DEFAULTS, so any
    flag actually present on the command line still wins. Unknown YAML
    keys are rejected loudly — a typo'd option silently ignored is the
    worst config bug to debug.
    """
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default="")
    known, _ = pre.parse_known_args(argv)
    if known.config:
        import yaml

        with open(known.config) as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            parser.error(f"{known.config}: top level must be a mapping")
        actions = {a.dest: a for a in parser._actions}
        # Dests whose flags appear on the command line: the flag wins
        # outright, so the file value must not even become a default —
        # append actions EXTEND defaults, which would merge instead of
        # override.
        given = set()
        for a in parser._actions:
            for opt in a.option_strings:
                if any(tok == opt or tok.startswith(opt + "=")
                       for tok in argv):
                    given.add(a.dest)
                    break
        defaults = {}
        for key, value in data.items():
            dest = key.replace("-", "_")
            action = actions.get(dest)
            if action is None:
                parser.error(f"{known.config}: unknown option {key!r}")
            if dest in given:
                continue
            if isinstance(action, argparse._AppendAction):
                value = value if isinstance(value, list) else [value]
                value = [action.type(v) if action.type and isinstance(v, str)
                         else v for v in value]
            elif action.type is not None and isinstance(value, str):
                # argparse applies type= to command-line strings, not to
                # objects injected as defaults — mirror it for quoted YAML.
                value = action.type(value)
            defaults[dest] = value
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def start_debug_monitor(args):
    """Start the debug monitor when --pprof-port was given (the
    reference's InitMonitor, cmd/dependency/dependency.go:95-130).
    Returns the DebugMonitor or None."""
    if getattr(args, "pprof_port", -1) < 0:
        return None
    from dragonfly2_tpu_torch.utils.debugmon import DebugMonitor

    mon = DebugMonitor(host="127.0.0.1", port=args.pprof_port)
    mon.start()
    print(f"debug monitor on {mon.address}/debug/threads", flush=True)
    return mon


def start_metrics_server(args, registry=None):
    """The /metrics endpoint of JAX's ``start_metrics_server`` is not
    ported: it serves prometheus_client's registries, and the card
    machine has no ``prometheus_client``. Always returns None, so a
    command's ``if metrics_server: metrics_server.stop()`` still reads
    the same; ``--metrics-port`` is accepted and ignored."""
    return None


def install_shutdown_handlers() -> threading.Event:
    """Install SIGINT/SIGTERM handlers that request a GRACEFUL stop;
    returns the event they set.

    Call this EARLY in a service ``main`` — before the long build/serve
    phase, not at the final ``wait_for_shutdown`` — so a signal
    delivered during startup still routes through the command's
    orderly teardown (daemon: ``stop()`` → ``storage.persist_all()``)
    instead of killing the process with default disposition and
    losing every unjournaled byte of state."""
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    try:
        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        # Not the main thread (embedded/test invocation): signals can't
        # route here; the caller still gets a working event it can set.
        pass
    return stop


def wait_for_shutdown(stop: threading.Event | None = None) -> None:
    """Block until SIGINT/SIGTERM (service commands). Pass the event
    from :func:`install_shutdown_handlers` when handlers were installed
    early; with no argument the handlers are installed here (commands
    whose startup holds no state worth a graceful path)."""
    if stop is None:
        stop = install_shutdown_handlers()
    stop.wait()
