"""Device utilization timeline: duty cycle, bubble attribution, and a
mesh straggler watch, copied from the JAX package's
`observability/utilization.py`.

The serving model (BBCGGI21, arXiv:2012.14884) makes throughput =
device duty cycle x kernel rate. This module is the measurement layer:
the batcher worker and
completion threads (`serving/batcher.py`), the Leader's helper leg
(`serving/service.py`), and the snapshot flip path
(`serving/snapshots.py`) report their device-busy and idle intervals
into a process-wide `UtilizationTracker`, and every idle bubble
carries a typed cause:

    empty_queue     the worker waited with nothing queued
    admission_shed  the worker waited on an empty queue *while*
                    requests were being shed at admission — idle the
                    admission policy manufactured, not absent demand
    batch_wait      the `_collect` max_wait_ms window: the worker held
                    a partial batch open waiting for co-batchable
                    arrivals
    pipeline_full   the worker blocked on the bounded depth-2 handoff
                    queue (completion is the bottleneck)
    staging_sync    exposed H2D transfer waits inside the evaluation
                    (the JAX package's; the port's batch is busy
                    from its first kernel to its last on the
                    batcher's CUDA stream, see `serving/batcher.py`)
    helper_rtt      the Leader's exposed helper-leg barrier: round-trip
                    time NOT hidden behind the own-share compute
    snapshot_flip   a generation flip's drain wait (pins/in-flight
                    batches) in `SnapshotManager.flip`
    other           escape hatch for duck-typed reporters

Time is bucketed into fixed windows (default 10 s): each closed window
records busy seconds, per-cause idle seconds, a duty-cycle percentage
(busy over tracked time), and an MFU-style `device_feed_efficiency`
(busy over wall — the fraction of the window's device-seconds that did
device work). On a multi-device mesh (the JAX package's) the
dispatch path reports per-shard busy seconds; when the max/min
per-shard busy ratio skew in a closed window exceeds the configured
band, the tracker journals a `util.straggler` event.

In the port, a batch's busy time is its span on the batcher's CUDA
stream, between two events recorded around the evaluation and read by
the completion thread once the result reached the host; the worker's
host time outside that span is attributed to the bubble causes above.

Layering: observability imports only utils/, stdlib, and robustness/.
Serving pushes into the tracker through duck-typed hooks
(`DynamicBatcher.set_utilization`, module-level
`default_utilization_tracker()`), never the reverse — same pattern as
`device.default_telemetry()` and `phases.default_phase_recorder()`.
All clocks are injectable for deterministic attribution tests.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from . import events as events_mod

__all__ = [
    "BUBBLE_CAUSES",
    "UtilizationTracker",
    "default_utilization_tracker",
    "set_default_utilization_tracker",
]

# The typed bubble taxonomy. Unknown causes from
# duck-typed reporters degrade to "other" instead of raising.
BUBBLE_CAUSES = (
    "empty_queue",
    "admission_shed",
    "batch_wait",
    "pipeline_full",
    "staging_sync",
    "helper_rtt",
    "snapshot_flip",
    "other",
)

# Bounded reservoir of individual bubble durations (ms, all causes)
# backing the `bubble_ms_p99` export the bench history locks in.
_BUBBLE_RESERVOIR = 4096


def _new_accum() -> dict:
    return {
        "busy_s": 0.0,
        "idle_s": {},
        "shards": {},
    }


class UtilizationTracker:
    """Busy/idle interval ledger with per-window duty cycle and typed
    bubble attribution.

    `window_s` is the aggregation bucket; `max_windows` bounds the
    retained timeline. `straggler_band` is the max/min per-shard
    busy-ratio skew a closed window tolerates before journaling
    `util.straggler` (with `straggler_min_busy_s` filtering out
    windows too quiet to judge). `clock` is injectable so tests can
    reproduce exact attribution.
    """

    def __init__(
        self,
        window_s: float = 10.0,
        max_windows: int = 360,
        straggler_band: float = 0.25,
        straggler_min_busy_s: float = 0.05,
        clock=time.monotonic,
        journal=None,
    ):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.enabled = True
        self._window_s = float(window_s)
        self._band = float(straggler_band)
        self._min_busy_s = float(straggler_min_busy_s)
        self._clock = clock
        self._journal = journal
        self._lock = threading.Lock()
        self._windows = collections.deque(maxlen=max(1, max_windows))
        self._win_start = clock()
        self._cur = _new_accum()
        self._totals = _new_accum()
        self._threads: Dict[str, dict] = {}
        self._bubbles = collections.deque(maxlen=_BUBBLE_RESERVOIR)
        self._stragglers = 0
        self._registry = None

    # -- wiring --------------------------------------------------------------

    def bind_registry(self, registry) -> None:
        """Mirror the tracker into a `MetricsRegistry` (duck-typed:
        `gauge`/`histogram` by name): per-window `util.duty_cycle_pct`
        and `util.device_feed_efficiency` gauges plus a
        `util.bubble_ms{cause=...}` histogram per idle record."""
        with self._lock:
            self._registry = registry

    def set_journal(self, journal) -> None:
        """Route straggler events to `journal` instead of the
        process-global event journal (tests)."""
        with self._lock:
            self._journal = journal

    # -- recording -----------------------------------------------------------

    def record_busy(self, seconds: float, thread: str = "worker") -> None:
        """Credit `seconds` of device-feeding work (an evaluation
        dispatch on the worker, result fan-out on the completer)."""
        if not self.enabled or seconds <= 0.0:
            return
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            self._cur["busy_s"] += seconds
            self._totals["busy_s"] += seconds
            t = self._threads.setdefault(
                thread, {"busy_s": 0.0, "idle_s": 0.0}
            )
            t["busy_s"] += seconds

    def record_idle(
        self, cause: str, seconds: float, thread: str = "worker"
    ) -> None:
        """Attribute `seconds` of idle time to one typed bubble
        cause."""
        if not self.enabled or seconds <= 0.0:
            return
        if cause not in BUBBLE_CAUSES:
            cause = "other"
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            cur = self._cur["idle_s"]
            cur[cause] = cur.get(cause, 0.0) + seconds
            tot = self._totals["idle_s"]
            tot[cause] = tot.get(cause, 0.0) + seconds
            t = self._threads.setdefault(
                thread, {"busy_s": 0.0, "idle_s": 0.0}
            )
            t["idle_s"] += seconds
            self._bubbles.append(seconds * 1e3)
            registry = self._registry
        if registry is not None:
            try:
                registry.histogram(
                    "util.bubble_ms", labels={"cause": cause}
                ).observe(seconds * 1e3)
            except Exception:  # noqa: BLE001 - telemetry never raises
                pass

    def record_shard_busy(self, shard: int, seconds: float) -> None:
        """Credit `seconds` of busy time to one mesh shard (the sharded
        dispatch path reports every participating shard per step)."""
        if not self.enabled or seconds <= 0.0:
            return
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            key = int(shard)
            cur = self._cur["shards"]
            cur[key] = cur.get(key, 0.0) + seconds
            tot = self._totals["shards"]
            tot[key] = tot.get(key, 0.0) + seconds

    def busy(self, thread: str = "worker"):
        """Context manager: bracket a busy interval on `clock`."""
        return _Bracket(self, None, thread)

    def idle(self, cause: str, thread: str = "worker"):
        """Context manager: bracket an idle interval of `cause`."""
        return _Bracket(self, cause, thread)

    # -- windowing -----------------------------------------------------------

    def _roll_locked(self, now: float) -> None:
        """Close every whole window between `_win_start` and `now`.
        Activity is attributed to the window it was *reported* in —
        exact for the deterministic-clock tests, and within one window
        of exact for live brackets."""
        while now >= self._win_start + self._window_s:
            self._close_window_locked()
            self._win_start += self._window_s

    def _close_window_locked(self) -> None:
        cur = self._cur
        self._cur = _new_accum()
        idle_total = sum(cur["idle_s"].values())
        tracked = cur["busy_s"] + idle_total
        if tracked <= 0.0 and not cur["shards"]:
            return  # an empty window adds nothing to the timeline
        duty = 100.0 * cur["busy_s"] / tracked if tracked > 0 else 0.0
        feed = min(1.0, cur["busy_s"] / self._window_s)
        shards = {
            s: {
                "busy_s": round(b, 6),
                "busy_ratio": round(min(1.0, b / self._window_s), 6),
            }
            for s, b in sorted(cur["shards"].items())
        }
        window = {
            "t_start": round(self._win_start, 6),
            "t_end": round(self._win_start + self._window_s, 6),
            "busy_s": round(cur["busy_s"], 6),
            "idle_s": {
                c: round(v, 6) for c, v in sorted(cur["idle_s"].items())
            },
            "idle_total_s": round(idle_total, 6),
            "duty_cycle_pct": round(duty, 3),
            "device_feed_efficiency": round(feed, 5),
            "shards": shards,
        }
        straggler = self._check_straggler_locked(window)
        self._windows.append(window)
        registry = self._registry
        if registry is not None:
            try:
                registry.gauge("util.duty_cycle_pct").set(
                    window["duty_cycle_pct"]
                )
                registry.gauge("util.device_feed_efficiency").set(
                    window["device_feed_efficiency"]
                )
            except Exception:  # noqa: BLE001 - telemetry never raises
                pass
        if straggler is not None:
            self._stragglers += 1
            journal = self._journal
            # Emit outside nothing: we hold self._lock, but the journal
            # takes only its own lock (no path back into the tracker).
            try:
                emit = (
                    journal.emit if journal is not None else events_mod.emit
                )
                emit(
                    "util.straggler",
                    f"shard busy skew {straggler['skew']:.2f} exceeds "
                    f"band {self._band:.2f} "
                    f"(slowest shard {straggler['min_shard']})",
                    severity="warning",
                    coalesce_key="util.straggler",
                    coalesce_s=30.0,
                    **straggler,
                )
            except Exception:  # noqa: BLE001 - telemetry never raises
                pass

    def _check_straggler_locked(self, window: dict) -> Optional[dict]:
        shards = window["shards"]
        if len(shards) < 2:
            return None
        ratios = {s: e["busy_ratio"] for s, e in shards.items()}
        busiest = max(ratios, key=ratios.get)
        laziest = min(ratios, key=ratios.get)
        if shards[busiest]["busy_s"] < self._min_busy_s:
            return None  # too quiet a window to judge skew
        skew = ratios[busiest] - ratios[laziest]
        if skew <= self._band:
            return None
        return {
            "skew": round(skew, 4),
            "band": self._band,
            "max_shard": busiest,
            "max_busy_ratio": ratios[busiest],
            "min_shard": laziest,
            "min_busy_ratio": ratios[laziest],
            "window_t_start": window["t_start"],
        }

    # -- reading -------------------------------------------------------------

    @staticmethod
    def _percentile(ordered, p: float) -> Optional[float]:
        if not ordered:
            return None
        i = min(len(ordered) - 1, max(0, round(p / 100 * (len(ordered) - 1))))
        return ordered[i]

    def export(self) -> dict:
        """The whole timeline: closed windows, the in-progress window,
        process totals (with `bubble_ms_p99` over the bubble
        reservoir), per-thread busy/idle, per-shard busy, and the
        straggler count. Closes any windows the clock has passed
        first, so a quiet reader still sees fresh windows."""
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            windows = [dict(w) for w in self._windows]
            cur = self._cur
            totals = self._totals
            idle_total = sum(totals["idle_s"].values())
            tracked = totals["busy_s"] + idle_total
            ordered = sorted(self._bubbles)
            cur_idle = sum(cur["idle_s"].values())
            out = {
                "enabled": self.enabled,
                "window_s": self._window_s,
                "straggler_band": self._band,
                "windows": windows,
                "current": {
                    "t_start": round(self._win_start, 6),
                    "age_s": round(now - self._win_start, 6),
                    "busy_s": round(cur["busy_s"], 6),
                    "idle_s": {
                        c: round(v, 6)
                        for c, v in sorted(cur["idle_s"].items())
                    },
                    "idle_total_s": round(cur_idle, 6),
                },
                "totals": {
                    "busy_s": round(totals["busy_s"], 6),
                    "idle_s": {
                        c: round(v, 6)
                        for c, v in sorted(totals["idle_s"].items())
                    },
                    "idle_total_s": round(idle_total, 6),
                    "duty_cycle_pct": round(
                        100.0 * totals["busy_s"] / tracked, 3
                    )
                    if tracked > 0
                    else None,
                    "bubble_ms_p50": self._percentile(ordered, 50),
                    "bubble_ms_p99": self._percentile(ordered, 99),
                    "bubbles": len(ordered),
                },
                "threads": {
                    name: {
                        "busy_s": round(t["busy_s"], 6),
                        "idle_s": round(t["idle_s"], 6),
                    }
                    for name, t in sorted(self._threads.items())
                },
                "shards": {
                    s: {"busy_s": round(b, 6)}
                    for s, b in sorted(totals["shards"].items())
                },
                "stragglers": self._stragglers,
            }
        return out

    def last_duty_cycle_pct(self) -> Optional[float]:
        """The most recent closed window's duty cycle (None before the
        first window closes) — the sampler's headline series."""
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            if not self._windows:
                return None
            return self._windows[-1]["duty_cycle_pct"]

    def reset(self) -> None:
        """Drop the timeline and totals (bench A/B legs); keeps the
        registry binding and configuration."""
        now = self._clock()
        with self._lock:
            self._windows.clear()
            self._win_start = now
            self._cur = _new_accum()
            self._totals = _new_accum()
            self._threads.clear()
            self._bubbles.clear()
            self._stragglers = 0


class _Bracket:
    """Clock-delta bracket for `UtilizationTracker.busy()/idle()`."""

    __slots__ = ("_tracker", "_cause", "_thread", "_t0")

    def __init__(self, tracker, cause, thread):
        self._tracker = tracker
        self._cause = cause
        self._thread = thread
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracker._clock()
        return self

    def __exit__(self, *exc):
        elapsed = self._tracker._clock() - self._t0
        if self._cause is None:
            self._tracker.record_busy(elapsed, thread=self._thread)
        else:
            self._tracker.record_idle(
                self._cause, elapsed, thread=self._thread
            )
        return False


_default_tracker = UtilizationTracker()
_default_lock = threading.Lock()


def default_utilization_tracker() -> UtilizationTracker:
    """The process-wide tracker every serving hook reports into
    (mirrors `device.default_telemetry`)."""
    return _default_tracker


def set_default_utilization_tracker(
    tracker: UtilizationTracker,
) -> UtilizationTracker:
    """Swap the process-wide tracker (tests); returns the new one."""
    global _default_tracker
    with _default_lock:
        _default_tracker = tracker
    return tracker
