"""Process resident-memory gauges for bench rungs.

The scheduler load ladder reports ``peak_rss_mb`` and a bytes/peer
gauge per rung (docs/SCHEDULER.md "Cluster scale-out") so the slim-state
work stays a BENCH NUMBER, not a claim. Linux ``/proc/self/status`` is
the primary source (``VmRSS`` current, ``VmHWM`` lifetime peak);
``resource.getrusage`` is the fallback (its ``ru_maxrss`` is the peak in
KiB on Linux).
"""

from __future__ import annotations


def _proc_status_kb(key: str) -> float | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return float(line.split()[1])  # kB
    except (OSError, ValueError, IndexError):
        pass
    return None


def rss_mb() -> float:
    """Current resident set size in MiB (0.0 when unreadable)."""
    kb = _proc_status_kb("VmRSS")
    if kb is not None:
        return kb / 1024.0
    return peak_rss_mb()  # best remaining evidence


def reset_peak_rss() -> bool:
    """Reset the kernel's peak-RSS watermark (``VmHWM``) to the current
    RSS — Linux ``/proc/self/clear_refs`` code 5 — so a subsequent
    :func:`peak_rss_mb` reads THIS phase's peak, not whatever earlier
    bench stages drove the process to. Returns False when the kernel
    doesn't support it (the caller should then label the peak as
    process-lifetime)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def peak_rss_mb() -> float:
    """Lifetime peak resident set size in MiB (0.0 when unreadable)."""
    kb = _proc_status_kb("VmHWM")
    if kb is not None:
        return kb / 1024.0
    try:
        import resource
        import sys

        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB; macOS — the platform that actually takes
        # this fallback (no /proc) — reports BYTES.
        divisor = (1 << 20) if sys.platform == "darwin" else 1024.0
        return maxrss / divisor
    except Exception:  # noqa: BLE001 — non-POSIX fallback
        return 0.0
