"""Token-bucket rate limiter.

Reference counterpart: golang.org/x/time/rate as used by the reference's
upload server (client/daemon/upload/upload_manager.go:110) and traffic
shaper (client/daemon/peer/traffic_shaper.go). Thread-safe; ``wait_n``
blocks until ``n`` tokens are available, ``allow_n`` is non-blocking.
"""

from __future__ import annotations

import threading
import time


INF = float("inf")


class Limiter:
    """Token bucket refilling at ``rate`` tokens/sec with capacity ``burst``.

    ``rate=INF`` disables limiting (every call succeeds immediately).
    """

    def __init__(self, rate: float, burst: int | None = None):
        self._lock = threading.Lock()
        self._rate = float(rate)
        self._burst = float(burst if burst is not None else max(rate, 1))
        self._tokens = self._burst
        self._last = time.monotonic()

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def burst(self) -> float:
        return self._burst

    def set_rate(self, rate: float, burst: int | None = None) -> None:
        with self._lock:
            self._advance()
            self._rate = float(rate)
            if burst is None and self._rate != INF and self._burst == INF:
                # Unlimited → finite without an explicit burst: an inf
                # bucket would never drain, making the new rate a no-op.
                burst = int(max(self._rate, 1))
            if burst is not None:
                self._burst = float(burst)
                self._tokens = min(self._tokens, self._burst)

    def _advance(self) -> None:
        now = time.monotonic()
        if self._rate != INF:
            self._tokens = min(
                self._burst, self._tokens + (now - self._last) * self._rate
            )
        self._last = now

    def allow_n(self, n: float) -> bool:
        if self._rate == INF:
            return True
        with self._lock:
            self._advance()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def reserve_n(self, n: float) -> float:
        """Deduct ``n`` tokens (possibly going negative) and return the
        delay in seconds the caller should sleep before proceeding."""
        if self._rate == INF:
            return 0.0
        with self._lock:
            self._advance()
            self._tokens -= n
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self._rate

    def return_n(self, n: float) -> None:
        """Refund tokens a caller reserved but provably never spent
        (e.g. a reserved body whose peer vanished before any byte went
        out). Capped at burst like every other credit."""
        if self._rate == INF or n <= 0:
            return
        with self._lock:
            self._advance()
            self._tokens = min(self._burst, self._tokens + n)

    def wait_n(self, n: float, timeout: float | None = None) -> bool:
        """Block until ``n`` tokens are granted. False on timeout."""
        if n > self._burst and self._rate != INF:
            raise ValueError(f"wait_n({n}) exceeds burst {self._burst}")
        delay = self.reserve_n(n)
        if delay == 0.0:
            return True
        if timeout is not None and delay > timeout:
            # Give the tokens back: the reservation is cancelled.
            with self._lock:
                self._advance()
                self._tokens = min(self._burst, self._tokens + n)
            return False
        time.sleep(delay)
        return True
