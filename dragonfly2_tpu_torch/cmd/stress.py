"""``df2-stress`` — load harness for the proxy / daemon surfaces.

Reference counterpart: test/tools/stress/main.go (drives the proxy with N
concurrent downloads, reports a latency distribution). Same role here:
fixed worker pool, per-request latency capture, p50/p90/p95/p99 + error
taxonomy printed as one JSON object (and optionally appended to a file
for trend tracking).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
)


def percentile(sorted_vals, p: float):
    if not sorted_vals:
        return None
    idx = min(int(len(sorted_vals) * p), len(sorted_vals) - 1)
    return sorted_vals[idx]


def run_stress(url: str, *, proxy: str = "", daemon: str = "",
               concurrency: int = 8, requests: int = 100,
               timeout: float = 60.0) -> dict:
    latencies: list = []
    errors: Counter = Counter()
    bytes_total = [0]
    lock = threading.Lock()
    remaining = [requests]

    if daemon:
        import threading as _threading

        from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient

        # One channel per worker thread, reused across its requests —
        # per-request channel setup would measure gRPC connection churn,
        # not the daemon.
        tls = _threading.local()
        clients: list = []

        def one() -> None:
            client = getattr(tls, "client", None)
            if client is None:
                client = tls.client = RemoteDaemonClient(daemon)
                with lock:
                    clients.append(client)
            try:
                t0 = time.perf_counter()
                result = client.download(url, None, timeout=timeout)
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    if result.success:
                        latencies.append(dt)
                        bytes_total[0] += max(result.content_length, 0)
                    else:
                        errors[result.error[:60] or "failed"] += 1
            except Exception as exc:  # noqa: BLE001 — taxonomy, not crash
                with lock:
                    errors[type(exc).__name__] += 1
    else:
        handlers = []
        if proxy:
            handlers.append(urllib.request.ProxyHandler(
                {"http": f"http://{proxy}", "https": f"http://{proxy}"}))
        opener = urllib.request.build_opener(*handlers)

        def one() -> None:
            t0 = time.perf_counter()
            try:
                with opener.open(url, timeout=timeout) as resp:
                    n = len(resp.read())
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    latencies.append(dt)
                    bytes_total[0] += n
            except urllib.error.HTTPError as exc:
                with lock:
                    errors[f"HTTP {exc.code}"] += 1
            except Exception as exc:  # noqa: BLE001 — taxonomy, not crash
                with lock:
                    errors[type(exc).__name__] += 1

    def worker() -> None:
        while True:
            with lock:
                if remaining[0] <= 0:
                    return
                remaining[0] -= 1
            one()

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    if daemon:
        for c in clients:
            c.close()

    latencies.sort()
    return {
        "url": url,
        "via": ("daemon " + daemon) if daemon else (
            ("proxy " + proxy) if proxy else "direct"),
        "concurrency": concurrency,
        "requests": requests,
        "succeeded": len(latencies),
        "failed": sum(errors.values()),
        "errors": dict(errors),
        "wall_seconds": round(wall, 2),
        "requests_per_sec": round(len(latencies) / max(wall, 1e-9), 1),
        "throughput_mbps": round(
            bytes_total[0] / max(wall, 1e-9) / 1e6, 1),
        "latency_ms": {
            "p50": round(percentile(latencies, 0.50) or 0, 1),
            "p90": round(percentile(latencies, 0.90) or 0, 1),
            "p95": round(percentile(latencies, 0.95) or 0, 1),
            "p99": round(percentile(latencies, 0.99) or 0, 1),
            "max": round(latencies[-1], 1) if latencies else 0,
        },
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-stress")
    parser.add_argument("url", help="target URL (fetched repeatedly)")
    parser.add_argument("--proxy", default="",
                        help="host:port of a df2 proxy to drive")
    parser.add_argument("--daemon", default="",
                        help="host:port of a daemon rpc surface to drive "
                             "(instead of --proxy)")
    parser.add_argument("-c", "--concurrency", type=int, default=8)
    parser.add_argument("-n", "--requests", type=int, default=100)
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument("--output", default="",
                        help="append the JSON result to this file")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="stress")
    init_tracing(args, "stress")

    result = run_stress(
        args.url, proxy=args.proxy, daemon=args.daemon,
        concurrency=args.concurrency, requests=args.requests,
        timeout=args.timeout)
    line = json.dumps(result)
    print(line)
    if args.output:
        with open(args.output, "a") as f:
            f.write(line + "\n")
    return 0 if result["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
