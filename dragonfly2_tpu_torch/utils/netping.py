"""RTT measurement for the network-topology prober.

Reference counterpart: pkg/net/ping (ICMP echo). ICMP requires raw sockets
(root or CAP_NET_RAW), which a userland daemon can't assume — we measure a
TCP connect handshake to the target daemon's upload port instead. One
round-trip of SYN/SYN-ACK tracks path latency the same way an ICMP echo
does, and every mesh peer by construction has an open upload listener.
"""

from __future__ import annotations

import socket
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional, Tuple

DEFAULT_TIMEOUT = 1.0


def tcp_rtt(ip: str, port: int, timeout: float = DEFAULT_TIMEOUT) -> Optional[float]:
    """One TCP-connect RTT in seconds, or None if unreachable in time."""
    start = time.perf_counter()
    try:
        with socket.create_connection((ip, port), timeout=timeout):
            return time.perf_counter() - start
    except OSError:
        return None


def ping_hosts(
    targets: Iterable[Tuple[str, str, int]],
    timeout: float = DEFAULT_TIMEOUT,
    max_workers: int = 16,
) -> Dict[str, Optional[float]]:
    """Concurrently measure RTTs: ``(key, ip, port)`` → {key: rtt|None}.

    Mirrors the reference's concurrent pingHosts loop
    (client/daemon/networktopology/network_topology.go:155-203).
    """
    targets = list(targets)
    if not targets:
        return {}
    with ThreadPoolExecutor(
        max_workers=min(max_workers, len(targets)),
        thread_name_prefix="netping",
    ) as pool:
        rtts = pool.map(lambda t: tcp_rtt(t[1], t[2], timeout), targets)
        return {t[0]: rtt for t, rtt in zip(targets, rtts)}
