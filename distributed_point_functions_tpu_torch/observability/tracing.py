"""Request tracing: spans, trace IDs, and a bounded flight recorder.

The serving runtime answers "how fast" through `serving/metrics.py`;
this module answers "why was THIS request slow". Each request gets a
`Trace` (a 16-hex-char id plus an append-only list of stage spans);
code on the request path marks stages with `span("stage")` — queue
wait, batch assembly, device compute, the helper leg — and the trace
decomposes end-to-end latency into those stages. Traces cross threads
by value (the batcher worker appends spans onto the submitting
request's trace object) and cross the wire by id (the Leader injects
the id into the Helper request; the Helper's server-side spans come
back in the response envelope and are grafted on with a `remote.`
prefix, so helper-leg RTT splits into network vs. remote compute).

Three always-on consumers, all dependency-free:

* the **flight recorder** keeps the N slowest and the N most recent
  errored traces (plus a short recent ring) for `/tracez` postmortems;
* **stage stats** aggregate per-stage durations process-wide (count,
  total, bounded reservoir percentiles) for bench span summaries;
* **runtime counters** are a tiny process-global counter group for
  layers below `serving/` (the PIR planner's tier decisions) that must
  not import the serving metrics registry.

Everything here is stdlib + `utils/` only (serving -> observability ->
utils, no pir/ops imports) and
cheap enough for the hot path: a span is two `perf_counter()` calls,
one tuple append, and one lock-protected stats update.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils.profiling import annotate

__all__ = [
    "Trace",
    "FlightRecorder",
    "CounterGroup",
    "new_trace_id",
    "current_trace",
    "trace_request",
    "span",
    "add_span",
    "default_recorder",
    "set_default_recorder",
    "stage_summary",
    "reset_stages",
    "runtime_counters",
]

# Per-stage reservoir bound for the process-wide stage stats.
_STAGE_RESERVOIR = 512


def new_trace_id() -> str:
    """16 hex chars (64 bits of entropy) — short enough to grep, long
    enough to never collide within one flight recorder."""
    return os.urandom(8).hex()


class Trace:
    """One request's spans. Append-only and thread-safe: the batcher
    worker (a different thread) appends queue-wait/device-compute spans
    onto the submitting request's trace."""

    __slots__ = (
        "trace_id", "name", "start_unix", "_t0", "duration_ms",
        "error", "spans", "attrs", "_lock",
    )

    def __init__(self, name: str, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.name = name
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self.duration_ms: Optional[float] = None
        self.error: Optional[str] = None
        self.spans: List[dict] = []
        self.attrs: Dict[str, object] = {}
        self._lock = threading.Lock()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def add_span(
        self,
        name: str,
        duration_ms: float,
        offset_ms: Optional[float] = None,
        **attrs,
    ) -> None:
        if offset_ms is None:
            offset_ms = self.elapsed_ms() - duration_ms
        # A span recorded from another thread after the trace advanced
        # (or a skew-corrected remote span) can compute a negative
        # offset; clamp so merged timelines stay monotone, but keep the
        # evidence in a `clamped` attr.
        clamped = offset_ms < 0.0
        entry = {
            "name": name,
            "offset_ms": round(max(0.0, offset_ms), 3),
            "duration_ms": round(duration_ms, 3),
        }
        if clamped:
            entry["clamped"] = True
        if attrs:
            entry.update(attrs)
        with self._lock:
            self.spans.append(entry)

    def add_remote_spans(
        self,
        spans: List[dict],
        prefix: str = "remote.",
        base_offset_ms: Optional[float] = None,
    ) -> None:
        """Graft a peer's server-side spans (from the response envelope)
        onto this trace. Remote offsets are in the peer's clock domain:
        without a skew estimate only durations are kept; with
        `base_offset_ms` (the peer's trace start mapped into THIS
        trace's timeline via the NTP-style offset from
        `critical_path.estimate_skew`) each remote span lands at its
        skew-corrected position, clamped at 0 like `add_span`."""
        with self._lock:
            for s in spans:
                entry = {
                    "name": prefix + str(s.get("name", "?")),
                    "duration_ms": float(s.get("duration_ms", 0.0)),
                    "remote": True,
                }
                if base_offset_ms is not None and "offset_ms" in s:
                    off = base_offset_ms + float(s["offset_ms"])
                    if off < 0.0:
                        entry["clamped"] = True
                    entry["offset_ms"] = round(max(0.0, off), 3)
                self.spans.append(entry)

    def span_list(self) -> List[dict]:
        """Snapshot of the spans so far (for response envelopes taken
        before the trace finishes)."""
        with self._lock:
            return list(self.spans)

    def finish(self, error: Optional[str] = None) -> "Trace":
        self.duration_ms = round(self.elapsed_ms(), 3)
        if error is not None:
            self.error = error
        return self

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        out = {
            "trace_id": self.trace_id,
            "name": self.name,
            "start_unix": round(self.start_unix, 3),
            "duration_ms": self.duration_ms,
            "spans": spans,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.error is not None:
            out["error"] = self.error
        return out


class FlightRecorder:
    """Bounded postmortem store: the N slowest completed traces, the N
    most recent errored traces, and a short ring of recent traces.

    Retention: `slowest` evicts the *fastest* of its members when full
    (so it converges on the true slowest-N), `errors` and `recent` are
    plain most-recent-wins rings. `enabled=False` turns `record` into a
    no-op so the <5% tracing overhead budget can be bought back
    entirely when an operator wants to.
    """

    def __init__(
        self,
        max_slow: int = 16,
        max_errors: int = 16,
        max_recent: int = 32,
    ):
        self._lock = threading.Lock()
        self._max_slow = max(1, max_slow)
        self._errors = collections.deque(maxlen=max(1, max_errors))
        self._recent = collections.deque(maxlen=max(1, max_recent))
        self._slow: List[Trace] = []  # sorted ascending by duration
        self._seq = 0
        self.enabled = True

    def record(self, trace: Trace) -> None:
        if not self.enabled:
            return
        if trace.duration_ms is None:
            trace.finish()
        with self._lock:
            self._seq += 1
            self._recent.append(trace)
            if trace.error is not None:
                self._errors.append(trace)
                return
            durations = [t.duration_ms for t in self._slow]
            self._slow.insert(
                bisect.bisect_left(durations, trace.duration_ms), trace
            )
            if len(self._slow) > self._max_slow:
                self._slow.pop(0)  # evict the fastest member

    def dump(self) -> dict:
        with self._lock:
            return {
                "recorded": self._seq,
                "slowest": [
                    t.to_dict() for t in reversed(self._slow)
                ],
                "errors": [t.to_dict() for t in reversed(self._errors)],
                "recent": [t.to_dict() for t in reversed(self._recent)],
            }

    def clear(self) -> None:
        with self._lock:
            self._seq = 0
            self._slow.clear()
            self._errors.clear()
            self._recent.clear()


_DEFAULT_RECORDER = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _DEFAULT_RECORDER


def set_default_recorder(recorder: FlightRecorder) -> FlightRecorder:
    global _DEFAULT_RECORDER
    _DEFAULT_RECORDER = recorder
    return recorder


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "observability_trace", default=None
)


def current_trace() -> Optional[Trace]:
    return _CURRENT.get()


@contextlib.contextmanager
def trace_request(
    name: str,
    trace_id: Optional[str] = None,
    recorder: Optional[FlightRecorder] = None,
    record: bool = True,
    fresh: bool = False,
    **attrs,
):
    """Root a trace for the enclosed request and hand it to the flight
    recorder on exit (exceptions land in the errored ring and re-raise).
    Nested calls reuse the active trace — the outermost root wins — so
    role entry points can trace unconditionally. `fresh=True` forces a
    new trace even inside an active one: a wire entry point that
    received a propagated trace id is serving a *peer's* request (an
    RPC boundary), so its spans must form their own server-side trace
    — sharing the caller's trace object would double-report them when
    they also travel back in the response envelope (the in-process
    transport is the case where both sides share one thread)."""
    existing = _CURRENT.get()
    if existing is not None and not fresh:
        yield existing
        return
    trace = Trace(name, trace_id=trace_id)
    if attrs:
        trace.attrs.update(attrs)
    token = _CURRENT.set(trace)
    try:
        yield trace
    except BaseException as e:
        trace.finish(error=f"{type(e).__name__}: {e}"[:300])
        raise
    finally:
        _CURRENT.reset(token)
        trace.finish()
        if record:
            (recorder or _DEFAULT_RECORDER).record(trace)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time the enclosed block as one stage: appended to the current
    trace (if any), aggregated into the process-wide stage stats, and
    nested as a TraceAnnotation inside any active xprof trace."""
    t0 = time.perf_counter()
    with annotate(name):
        try:
            yield
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            trace = _CURRENT.get()
            if trace is not None:
                trace.add_span(name, dur_ms, **attrs)
            _STAGES.observe(name, dur_ms)


def add_span(
    name: str,
    duration_ms: float,
    trace: Optional[Trace] = None,
    **attrs,
) -> None:
    """Out-of-band span: record an externally measured duration (e.g.
    the batcher worker timing queue wait for a request submitted on
    another thread) onto `trace` or the current trace."""
    trace = trace if trace is not None else _CURRENT.get()
    if trace is not None:
        trace.add_span(name, duration_ms, **attrs)
    _STAGES.observe(name, duration_ms)


# ---------------------------------------------------------------------------
# Process-wide stage aggregates (bench span summaries)
# ---------------------------------------------------------------------------


class _StageStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, list] = {}

    def observe(self, name: str, dur_ms: float) -> None:
        with self._lock:
            entry = self._stats.get(name)
            if entry is None:
                entry = [0, 0.0, collections.deque(maxlen=_STAGE_RESERVOIR)]
                self._stats[name] = entry
            entry[0] += 1
            entry[1] += dur_ms
            entry[2].append(dur_ms)

    def summary(self) -> dict:
        with self._lock:
            items = [
                (name, count, total, sorted(res))
                for name, (count, total, res) in self._stats.items()
            ]
        out = {}
        for name, count, total, ordered in sorted(items):
            def pct(p):
                i = min(
                    len(ordered) - 1,
                    max(0, round(p / 100 * (len(ordered) - 1))),
                )
                return round(ordered[i], 4)
            out[name] = {
                "count": count,
                "total_ms": round(total, 3),
                "mean_ms": round(total / count, 4),
                "p50_ms": pct(50),
                "p95_ms": pct(95),
                "max_ms": round(ordered[-1], 4),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


_STAGES = _StageStats()


def stage_summary() -> dict:
    """Per-stage aggregate over every `span()` since the last reset."""
    return _STAGES.summary()


def reset_stages() -> None:
    _STAGES.reset()


# ---------------------------------------------------------------------------
# Runtime counters for layers below serving/
# ---------------------------------------------------------------------------


class CounterGroup:
    """Minimal named-counter group. Layers that must not depend on the
    serving metrics registry (the PIR planner) count decisions here;
    the admin endpoint and bench snapshots merge them in."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def export(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counts.items()))

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


runtime_counters = CounterGroup()
