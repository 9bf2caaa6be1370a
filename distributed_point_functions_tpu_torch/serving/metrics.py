"""Dependency-free serving metrics: counters, gauges, histograms.

The serving runtime needs observability (queue depth, batch-size
distribution, padding waste, jit-cache hits vs. recompiles, Helper
retry/timeout counts, latency percentiles) without pulling a metrics
client into the image. This registry is the stdlib answer: thread-safe
instruments keyed by name, exported as one plain dict so any caller —
the closed-loop bench, a debug endpoint, a log line — can serialize it.

Timed regions double as profiler annotations: `registry.timed(name)`
wraps the block in `utils.profiling.annotate(name)` (a named TraceAnnotation
inside an active xprof trace) *and* records the wall-clock milliseconds
into the `name` histogram, so the same instrumentation feeds both the
metrics dict and a device trace.

**Labels.** The registry is a flat namespace; instruments that vary by
role, level, or tier use the labeling convention `base{k=v,k2=v2}` —
built with `labeled_name()` or by passing `labels=` to
`counter`/`gauge`/`histogram`/`timed`. Keys are sorted, so the same
label set always maps to the same instrument. The Prometheus renderer
(`observability/exposition.py`) splits the suffix back into label
pairs, turning e.g. `request_ms{role=leader}` and
`request_ms{role=helper}` into one labeled metric family instead of
two colliding flat names.

**Exemplars.** When a histogram observation happens inside an active
request trace (`observability.tracing.current_trace()`), the bucket it
lands in remembers that observation's value and trace id (most recent
wins). The Prometheus renderer exposes them OpenMetrics-style
(`_bucket{le="50"} 12 # {trace_id="deadbeef..."} 48.2 <ts>`), so an
operator staring at a slow bucket can jump straight to the matching
flight-recorder trace on `/tracez` instead of guessing which request
put it there.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import threading
import time
from typing import Dict, Optional, Sequence

from ..observability import tracing
from ..utils.profiling import annotate

# Default latency bucket upper bounds, in milliseconds.
DEFAULT_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 10000.0,
)

# Bounded reservoir per histogram: enough samples for stable p99 at
# serving rates without unbounded growth on long-lived processes.
_RESERVOIR = 8192


def labeled_name(base: str, labels: Optional[Dict[str, object]] = None) -> str:
    """Canonical `base{k=v,k2=v2}` instrument name (keys sorted). Label
    values must not contain `,` `=` `{` `}` — they would corrupt the
    parse on exposition."""
    if not labels:
        return base
    for k, v in labels.items():
        if any(c in f"{k}{v}" for c in ",={}"):
            raise ValueError(
                f"label {k}={v!r} contains a reserved character"
            )
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}{{{inner}}}"


def split_labeled_name(name: str):
    """Inverse of `labeled_name`: `base{k=v,k2=v2}` -> (base, {k: v}).
    Values come back as strings (labels are stringified on the way in)."""
    if name.endswith("}") and "{" in name:
        base, _, inner = name.partition("{")
        pairs = [p.split("=", 1) for p in inner[:-1].split(",") if p]
        return base, {k: v for k, v in pairs}
    return name, {}


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value (queue depth, in-flight requests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Cumulative bucket counts plus a bounded sample reservoir.

    Buckets give the exported dict a stable, mergeable shape; the
    reservoir (most recent `_RESERVOIR` observations) gives exact
    percentiles at serving horizons.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self._bounds) + 1)  # +inf overflow
        self._samples = collections.deque(maxlen=_RESERVOIR)
        self._count = 0
        self._sum = 0.0
        # bucket index -> (value, trace_id, unix_ts); most recent
        # traced observation per bucket (see module docstring).
        self._exemplars: Dict[int, tuple] = {}

    def observe(self, v: float) -> None:
        trace = tracing.current_trace()
        with self._lock:
            idx = bisect.bisect_left(self._bounds, v)
            self._counts[idx] += 1
            self._samples.append(v)
            self._count += 1
            self._sum += v
            if trace is not None:
                self._exemplars[idx] = (v, trace.trace_id, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @staticmethod
    def _rank(ordered, p: float) -> Optional[float]:
        """Percentile `p` from an already-sorted sample list — the one
        shared implementation, so callers that need several percentiles
        (export) sort the reservoir exactly once."""
        if not ordered:
            return None
        i = min(len(ordered) - 1, max(0, round(p / 100 * (len(ordered) - 1))))
        return ordered[i]

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._samples.clear()
            self._count = 0
            self._sum = 0.0
            self._exemplars.clear()

    def percentile(self, p: float) -> Optional[float]:
        """Exact percentile over the reservoir; None with no samples."""
        with self._lock:
            ordered = sorted(self._samples)
        return self._rank(ordered, p)

    def export(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            ordered = sorted(self._samples)
            exemplars = dict(self._exemplars)

        def pct(p):
            v = self._rank(ordered, p)
            return None if v is None else round(v, 4)

        keys = [str(b) for b in self._bounds] + ["+inf"]
        out = {
            "count": count,
            "sum": round(total, 4),
            "mean": round(total / count, 4) if count else None,
            "p50": pct(50),
            "p95": pct(95),
            "p99": pct(99),
            "max": round(ordered[-1], 4) if ordered else None,
            "buckets": {
                **{str(b): c for b, c in zip(self._bounds, counts)},
                "+inf": counts[-1],
            },
        }
        if exemplars:
            out["exemplars"] = {
                keys[idx]: {
                    "value": round(value, 4),
                    "trace_id": trace_id,
                    "ts": round(ts, 3),
                }
                for idx, (value, trace_id, ts) in sorted(exemplars.items())
            }
        return out


class MetricsRegistry:
    """Named instruments, created on first use, exported as one dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, labels: Optional[Dict] = None) -> Counter:
        name = labeled_name(name, labels)
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str, labels: Optional[Dict] = None) -> Gauge:
        name = labeled_name(name, labels)
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
        labels: Optional[Dict] = None,
    ) -> Histogram:
        name = labeled_name(name, labels)
        with self._lock:
            return self._histograms.setdefault(name, Histogram(buckets))

    @contextlib.contextmanager
    def timed(self, name: str, labels: Optional[Dict] = None):
        """Time the block into histogram `name` (ms) inside a profiler
        annotation of the same name."""
        hist = self.histogram(name, labels=labels)
        t0 = time.perf_counter()
        with annotate(name):
            try:
                yield
            finally:
                hist.observe((time.perf_counter() - t0) * 1e3)

    def export(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.export() for k, h in sorted(histograms.items())
            },
        }

    def snapshot(self) -> dict:
        """`export()` under a name that pairs with `reset()`: tests and
        benchmarks take a snapshot of exactly the activity since the
        last reset, instead of a since-process-start aggregate."""
        return self.export()

    def histogram_counts(self, suffix: str) -> Dict[str, int]:
        """Observation counts for histograms whose base name (labels
        stripped) ends with `suffix`. O(matching histograms) with no
        reservoir sort — the fleet QPS derivation polls this on every
        telemetry sample, where a full `export()` would sort every
        reservoir just to read one integer."""
        with self._lock:
            items = list(self._histograms.items())
        return {
            name: h.count
            for name, h in items
            if name.split("{", 1)[0].endswith(suffix)
        }

    def scoped(self, labels: Dict[str, object]) -> "ScopedRegistry":
        """Cheap child registry: every instrument created through it
        carries `labels` (e.g. `{"replica": "r0"}`) merged into the
        call-site labels, and its `export`/`snapshot`/`reset` see only
        its own slice of the parent namespace. The parent keeps the
        single flat store, so `default_telemetry().bind_registry(parent)`
        mirrors and `parent.reset()` keep their existing semantics."""
        return ScopedRegistry(self, labels)

    def reset(self) -> None:
        """Zero every instrument IN PLACE so metric state cannot leak
        across test cases or bench repetitions sharing one registry.
        Instruments stay registered and long-lived holders (the
        batcher's counters, the sampler) keep writing to the same live
        objects — no orphans, no re-fetch after a reset. Counters drop
        to 0, gauges to 0.0, histograms to empty (bucket counts,
        reservoir, exemplars)."""
        with self._lock:
            instruments = (
                list(self._counters.values())
                + list(self._gauges.values())
                + list(self._histograms.values())
            )
        for instrument in instruments:
            instrument._reset()


class ScopedRegistry:
    """Label-scoped view over a parent `MetricsRegistry`.

    Construction is O(len(labels)) and allocates no instrument storage:
    the parent owns every Counter/Gauge/Histogram, this view only merges
    its scope labels into each lookup. That makes one process hosting N
    replicas cheap — N views over one registry — while `reset()` and
    `snapshot()` on a view touch only instruments whose name carries
    all of the view's labels, so one replica's bench reset cannot zero
    its neighbors (the `reset()`/`snapshot()` interplay that a shared
    flat registry used to get wrong). Nested `scoped()` composes by
    merging label dicts (child wins on key conflicts).
    """

    def __init__(self, parent: MetricsRegistry, labels: Dict[str, object]):
        if not labels:
            raise ValueError("a scoped registry needs at least one label")
        labeled_name("scope", labels)  # validate reserved characters now
        self._parent = parent
        self._labels = {str(k): str(v) for k, v in labels.items()}

    @property
    def parent(self) -> MetricsRegistry:
        return self._parent

    @property
    def labels(self) -> Dict[str, str]:
        return dict(self._labels)

    def _merged(self, labels: Optional[Dict]) -> Dict:
        if not labels:
            return dict(self._labels)
        merged = dict(self._labels)
        merged.update(labels)
        return merged

    def counter(self, name: str, labels: Optional[Dict] = None) -> Counter:
        return self._parent.counter(name, self._merged(labels))

    def gauge(self, name: str, labels: Optional[Dict] = None) -> Gauge:
        return self._parent.gauge(name, self._merged(labels))

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
        labels: Optional[Dict] = None,
    ) -> Histogram:
        return self._parent.histogram(name, buckets, self._merged(labels))

    def timed(self, name: str, labels: Optional[Dict] = None):
        return self._parent.timed(name, self._merged(labels))

    def scoped(self, labels: Dict[str, object]) -> "ScopedRegistry":
        return ScopedRegistry(self._parent, self._merged(labels))

    def owns(self, name: str) -> bool:
        """True when instrument `name` carries every scope label."""
        _, labels = split_labeled_name(name)
        return all(labels.get(k) == v for k, v in self._labels.items())

    def export(self) -> dict:
        full = self._parent.export()
        return {
            kind: {k: v for k, v in section.items() if self.owns(k)}
            for kind, section in full.items()
        }

    def snapshot(self) -> dict:
        return self.export()

    def reset(self) -> None:
        """Zero only this view's slice of the parent (in place, same
        live-object guarantee as `MetricsRegistry.reset`)."""
        with self._parent._lock:
            instruments = [
                obj
                for section in (
                    self._parent._counters,
                    self._parent._gauges,
                    self._parent._histograms,
                )
                for name, obj in section.items()
                if self.owns(name)
            ]
        for instrument in instruments:
            instrument._reset()
