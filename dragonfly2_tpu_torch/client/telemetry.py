"""Host telemetry collection for AnnounceHost.

Reference counterpart: client/daemon/announcer/announcer.go:45-158 — the
daemon fills the Host schema's CPU/memory/network/disk/build sections from
gopsutil before announcing. Here Linux's ``/proc`` backs the same fields
(schema/records.py CPU/Memory/Network/Disk/Build), so the scheduler's
dataset export carries real machine features for MLP training instead of
zeros.

Port of ``dragonfly2_tpu/client/telemetry.py``, which reads them through
``psutil``; the port imports the standard library only, so it reads
``/proc`` as psutil does on Linux, with psutil's formulas. Elsewhere
the fields keep their defaults.

Every collector degrades to defaults on error — telemetry must never stop
a daemon from announcing.
"""

from __future__ import annotations

import logging
import os
import platform as _platform
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.schema import records

logger = logging.getLogger(__name__)

_CPU_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
               "steal", "guest", "guest_nice")


def _clock_ticks() -> float:
    return float(os.sysconf("SC_CLK_TCK"))


def _cpu_times() -> Dict[str, float]:
    """Seconds the machine's CPUs spent in each state (``/proc/stat``)."""
    with open("/proc/stat") as f:
        fields = f.readline().split()[1:]
    ticks = _clock_ticks()
    return {name: float(v) / ticks for name, v in zip(_CPU_FIELDS, fields)}


def _busy(times: Dict[str, float]) -> Tuple[float, float]:
    """(busy, total) seconds, as psutil counts them: guest time is already
    inside user and nice, and idle includes iowait."""
    total = sum(times.values()) - times.get("guest", 0.0) - times.get(
        "guest_nice", 0.0)
    return total - times["idle"] - times.get("iowait", 0.0), total


def _process_cpu_seconds() -> float:
    with open("/proc/self/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    return (float(fields[11]) + float(fields[12])) / _clock_ticks()


class _CpuMeter:
    """psutil's ``cpu_percent(interval=None)`` for the machine and this
    process: the share since the previous reading, 0.0 the first time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: Optional[Tuple[float, float, float, float]] = None

    def read(self) -> Tuple[float, float]:
        busy, total = _busy(_cpu_times())
        now = (busy, total, _process_cpu_seconds(), time.monotonic())
        with self._lock:
            last, self._last = self._last, now
        if last is None:
            return 0.0, 0.0
        d_total = now[1] - last[1]
        d_wall = now[3] - last[3]
        machine = (now[0] - last[0]) / d_total * 100.0 if d_total > 0 else 0.0
        process = ((now[2] - last[2]) / d_wall * 100.0 if d_wall > 0
                   else 0.0)
        return max(0.0, min(100.0, machine)), max(0.0, process)


_CPU_METER = _CpuMeter()


def _physical_cores() -> int:
    cores = set()
    package = ""
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if key == "physical id":
                package = value.strip()
            elif key == "core id":
                cores.add((package, value.strip()))
    return len(cores)


def collect_cpu() -> records.CPU:
    try:
        times = _cpu_times()
        percent, process_percent = _CPU_METER.read()
        try:
            physical = _physical_cores()
        except OSError:
            physical = 0
        return records.CPU(
            logical_count=os.cpu_count() or 0,
            physical_count=physical,
            percent=percent,
            process_percent=process_percent,
            times=records.CPUTimes(**{
                name: times.get(name, 0.0) for name in _CPU_FIELDS}),
        )
    except Exception:  # noqa: BLE001
        logger.debug("cpu telemetry failed", exc_info=True)
        return records.CPU()


def _meminfo() -> Dict[str, int]:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            parts = value.split()
            if parts:
                out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"]
                                            else 1)
    return out


def collect_memory() -> records.Memory:
    try:
        info = _meminfo()
        total, free = info["MemTotal"], info["MemFree"]
        available = info.get("MemAvailable", free)
        used = total - available
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        return records.Memory(
            total=total,
            available=available,
            used=used,
            used_percent=round((total - available) / total * 100.0, 1),
            process_used_percent=rss / total * 100.0,
            free=free,
        )
    except Exception:  # noqa: BLE001
        logger.debug("memory telemetry failed", exc_info=True)
        return records.Memory()


def collect_disk(path: str) -> records.Disk:
    try:
        du = shutil.disk_usage(path or "/")
        disk = records.Disk(
            total=du.total, free=du.free, used=du.used,
            used_percent=round(du.used / (du.used + du.free) * 100.0, 1)
            if du.used + du.free else 0.0,
        )
    except Exception:  # noqa: BLE001
        logger.debug("disk telemetry failed", exc_info=True)
        return records.Disk()
    try:
        st = os.statvfs(path or "/")
        disk.inodes_total = st.f_files
        disk.inodes_free = st.f_ffree
        disk.inodes_used = st.f_files - st.f_ffree
        if st.f_files:
            disk.inodes_used_percent = disk.inodes_used / st.f_files * 100.0
    except Exception:  # noqa: BLE001
        pass
    return disk


_TCP_ESTABLISHED = "01"


def _established_local_ports() -> List[int]:
    """Local ports of this process's established TCP sockets: its socket
    inodes (``/proc/self/fd``) matched against ``/proc/net/tcp{,6}``."""
    inodes = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if target.startswith("socket:["):
            inodes.add(target[8:-1])
    ports = []
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                next(f)
                for line in f:
                    cols = line.split()
                    if cols[3] == _TCP_ESTABLISHED and cols[9] in inodes:
                        ports.append(int(cols[1].rpartition(":")[2], 16))
        except OSError:
            continue
    return ports


def collect_network(idc: str = "", location: str = "",
                    upload_port: int = 0) -> records.Network:
    net = records.Network(idc=idc, location=location)
    try:
        ports = _established_local_ports()
        net.tcp_connection_count = len(ports)
        if upload_port:
            # Established only — the upload listener's own LISTEN socket
            # must not bias the announced load feature by +1.
            net.upload_tcp_connection_count = sum(
                1 for port in ports if port == upload_port)
    except Exception:  # noqa: BLE001
        logger.debug("network telemetry failed", exc_info=True)
    return net


def platform_info() -> dict:
    """os/platform/kernel fields of the Host schema (host.go InfoStat)."""
    try:
        uname = _platform.uname()
        return {
            "os": uname.system.lower(),
            "platform": uname.machine,
            "platform_family": uname.system.lower(),
            "platform_version": _platform.platform(),
            "kernel_version": uname.release,
        }
    except Exception:  # noqa: BLE001
        return {}


def collect_build() -> records.Build:
    try:
        import dragonfly2_tpu_torch

        return records.Build(
            git_version=getattr(dragonfly2_tpu_torch, "__version__", "dev"),
            platform=f"{_platform.system()}/{_platform.machine()}".lower(),
        )
    except Exception:  # noqa: BLE001
        return records.Build()
