"""Closed/open/half-open circuit breaker.

The classic availability pattern, sized for the Leader's Helper leg:
after `failure_threshold` *consecutive* failures the breaker opens and
`allow()` answers False instantly — callers fast-fail instead of
paying a timeout+backoff ladder per request while the peer is down.
After `reset_timeout_ms` the next `allow()` admits exactly ONE probe
(half-open); the probe's outcome decides — success closes the breaker
(and consecutive-failure count resets), failure re-opens it for
another full reset window. A probe that never reports back (its
thread died) stops blocking after another reset window.

Transitions invoke listeners registered with `on_transition(cb)`
outside the lock — the serving session uses this to mirror the state
into a gauge (SLO burn signal) and to exit degraded mode the moment a
probe closes the breaker.

Stdlib-only; `clock` is injectable so tests drive the reset window
without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

__all__ = ["CircuitBreaker", "STATE_CODES"]

# Gauge encoding for /statusz and SLO objectives: anything >= the
# half-open code means the breaker is not fully closed.
STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_ms: float = 1000.0,
        name: str = "breaker",
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self._threshold = failure_threshold
        self._reset_s = reset_timeout_ms / 1e3
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_at: Optional[float] = None
        self._opens = 0
        self._fast_fails = 0
        self._listeners: List[Callable[[str, str], None]] = []

    # -- state machine ------------------------------------------------------

    def allow(self) -> bool:
        """Whether a request may try the guarded call right now. False
        means fast-fail; the one True per reset window while open is
        the half-open probe."""
        notify = None
        with self._lock:
            now = self._clock()
            if self._state == "closed":
                return True
            if self._state == "open":
                if now - self._opened_at >= self._reset_s:
                    notify = self._transition("half_open")
                    self._probe_at = now
                    allowed = True
                else:
                    self._fast_fails += 1
                    allowed = False
            else:  # half_open: one probe in flight
                if now - self._probe_at >= self._reset_s:
                    # The probe vanished without reporting; let another
                    # request probe rather than staying wedged.
                    self._probe_at = now
                    allowed = True
                else:
                    self._fast_fails += 1
                    allowed = False
        self._notify(notify)
        return allowed

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            notify = (
                self._transition("closed")
                if self._state != "closed"
                else None
            )
        self._notify(notify)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            notify = None
            if self._state == "half_open" or (
                self._state == "closed"
                and self._consecutive_failures >= self._threshold
            ):
                notify = self._transition("open")
                self._opened_at = self._clock()
                self._opens += 1
        self._notify(notify)

    def _transition(self, new: str):
        """Under the lock: flip state, return the (old, new) pair to
        notify with after the lock is released."""
        old, self._state = self._state, new
        return (old, new)

    def _notify(self, pair) -> None:
        if pair is None:
            return
        for cb in list(self._listeners):
            try:
                cb(*pair)
            except Exception:  # pragma: no cover - listeners never raise
                pass

    # -- reading ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_code(self) -> int:
        return STATE_CODES[self.state]

    def on_transition(self, cb: Callable[[str, str], None]) -> None:
        """`cb(old_state, new_state)` on every transition, outside the
        lock."""
        self._listeners.append(cb)

    def export(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "name": self.name,
                "state": self._state,
                "state_code": STATE_CODES[self._state],
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self._threshold,
                "reset_timeout_ms": self._reset_s * 1e3,
                "opens": self._opens,
                "fast_fails": self._fast_fails,
                "open_for_s": (
                    round(now - self._opened_at, 3)
                    if self._state == "open" and self._opened_at is not None
                    else None
                ),
            }
