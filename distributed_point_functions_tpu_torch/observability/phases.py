"""Per-request latency attribution: the phase waterfall.

Tracing answers "which spans ran in THIS request"; device telemetry
answers "what did the device do". Neither answers the question *where
does a millisecond of request latency go* —
because spans are free-form (names differ per call site, nest, and
overlap) and device counters have no per-request denominator. This
module adds the canonical decomposition: every request accumulates
milliseconds into a fixed phase taxonomy

    queue          waiting in the batcher admission queue
    batch          batch-assembly window (waiting for co-batchable
                   arrivals after the batch opened)
    h2d_transfer   host->device staging of keys/database for this batch
    compile        first dispatch of a jit entry point at a new shape
                   (trace+compile dominates that call)
    dispatch       batcher/handler overhead around the device step
                   (padding, slicing, result fan-out)
    device_compute re-dispatch of an already-compiled program (the
                   steady-state device step, including the result
                   readback sync)
    helper_rtt     the Leader's helper-leg round trip (overlaps
                   device_compute when own-share compute runs in the
                   transport's on_sent window)
    helper_net     decomposition of helper_rtt (critical_path.py):
    helper_queue   wire time / Helper non-compute overhead / Helper
    helper_compute device compute — these three re-slice helper_rtt
                   using the Helper's v2 envelope digest, they are not
                   additional wall time
    respond        wire decode/encode and share reconstruction
    other          the unattributed remainder (computed at request end,
                   so attributed phases + other ~= end-to-end)

and the recorder aggregates (role, phase) across requests into
count/mean/p50/p99 summaries for `/statusz` and bench history records.

Mechanics mirror `tracing.py` deliberately:

* a contextvar carries the active `RequestPhases`; `phase("name")`
  brackets attribute *exclusive* time (nested brackets subtract their
  elapsed from the parent, so a staging bracket inside a compute
  bracket does not double-count);
* the record crosses threads **by reference** — the batcher worker
  captures `current_request()` at submit time and calls
  `RequestPhases.add` from its own thread (same pattern as grafting
  spans onto `_Pending.trace`);
* the worker's own evaluation runs under `recorder.collect()`, a
  batch-scoped record that soaks up the phase brackets inside
  `pir/server.py`, which the worker then re-attributes to every
  request in the batch;
* at request exit the waterfall attaches to the current `Trace` under
  `attrs["phases"]`, so phases ride the trace ids through
  `/tracez` and the cross-party envelopes unchanged.

`enabled=False` turns `request()`/`collect()` into no-ops (they yield
None, `phase()` sees no active record) so the attribution layer costs
nothing when an operator buys the overhead back. Stdlib-only, so every
layer above `utils/` may import it. In the port, `compile` is the first
dispatch of a serving bucket shape (`observability/device.py`): the
kernels are built once per process by `ops.cuda_lib`, not per shape.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
from typing import Dict, Optional

from . import tracing

__all__ = [
    "PHASES",
    "PhaseRecorder",
    "RequestPhases",
    "current_request",
    "default_phase_recorder",
    "phase",
    "record",
    "set_default_phase_recorder",
]

PHASES = (
    "queue",
    "batch",
    "h2d_transfer",
    "compile",
    "dispatch",
    "device_compute",
    "helper_rtt",
    "helper_net",
    "helper_queue",
    "helper_compute",
    "respond",
    "other",
)

# Phases that re-slice helper_rtt (already attributed) rather than
# adding wall time; excluded from the `other` remainder so the split
# is not double-counted against end-to-end.
_OVERLAY_PHASES = frozenset(
    ("helper_net", "helper_queue", "helper_compute")
)


class RequestPhases:
    """One request's phase accumulator. Thread-safe by reference: the
    batcher worker adds phases onto a record owned by the submitting
    thread. Closed at request exit — late adds from a worker finishing
    after a deadline-abandoned submitter are dropped, not misfiled
    into the next aggregate window."""

    __slots__ = (
        "role", "_t0", "_phases", "_stack", "_closed", "_lock", "_meta",
    )

    def __init__(self, role: str):
        self.role = role
        self._t0 = time.perf_counter()
        self._phases: Dict[str, float] = {}
        # Active bracket stack (this thread only): [name, t0, child_ms].
        self._stack: list = []
        self._closed = False
        self._lock = threading.Lock()
        # Out-of-band attachments (e.g. the helper-leg skew/decomposition
        # stashed by the Leader for the critical-path close listener).
        self._meta: Dict[str, object] = {}

    def set_meta(self, key: str, value) -> None:
        """Attach out-of-band data to this record (survives close)."""
        with self._lock:
            self._meta[key] = value

    def get_meta(self, key: str, default=None):
        with self._lock:
            return self._meta.get(key, default)

    def add(self, name: str, ms: float) -> None:
        """Attribute `ms` milliseconds to phase `name` (additive)."""
        if ms <= 0.0:
            return
        with self._lock:
            if self._closed:
                return
            self._phases[name] = self._phases.get(name, 0.0) + float(ms)

    def add_many(self, phases: Dict[str, float]) -> None:
        for name, ms in phases.items():
            self.add(name, ms)

    # -- exclusive-time brackets (single-threaded per record) ---------------

    def begin(self, name: str) -> None:
        with self._lock:
            self._stack.append([name, time.perf_counter(), 0.0])

    def end(self) -> None:
        with self._lock:
            name, t0, child_ms = self._stack.pop()
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            if self._stack:
                self._stack[-1][2] += elapsed_ms
            if self._closed:
                return
            own = max(0.0, elapsed_ms - child_ms)
            if own > 0.0:
                self._phases[name] = self._phases.get(name, 0.0) + own

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._phases)

    def close(self) -> Dict[str, float]:
        """Seal the record and return the final phase map."""
        with self._lock:
            self._closed = True
            return dict(self._phases)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "observability_phases", default=None
)


def current_request() -> Optional[RequestPhases]:
    """The request phase record active on this thread (or None)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def phase(name: str):
    """Bracket the enclosed block as phase `name` of the active request
    (exclusive time — nested brackets deduct). No active record (or a
    disabled recorder) makes this a no-op."""
    req = _ACTIVE.get()
    if req is None:
        yield
        return
    req.begin(name)
    try:
        yield
    finally:
        req.end()


def record(name: str, ms: float, request: Optional[RequestPhases] = None):
    """Out-of-band attribution: add an externally measured duration
    (e.g. the helper-leg RTT) to `request` or the active record."""
    req = request if request is not None else _ACTIVE.get()
    if req is not None:
        req.add(name, ms)


class PhaseRecorder:
    """Aggregates per-request waterfalls into (role, phase) summaries.

    `request(role)` roots a record for the enclosed request (nested
    calls reuse it — outermost wins, like `tracing.trace_request`;
    `fresh=True` forces a new record at RPC boundaries where both
    halves share a thread). On exit the unattributed remainder lands in
    `other`, the waterfall attaches to the current trace, and every
    phase feeds the (role, phase) reservoir summarized by
    `waterfall()`.
    """

    def __init__(self, enabled: bool = True, reservoir: int = 512,
                 registry=None):
        self.enabled = enabled
        self._reservoir = max(8, reservoir)
        self._registry = registry
        self._lock = threading.Lock()
        # role -> phase -> [count, total_ms, deque of samples]
        self._agg: Dict[str, Dict[str, list]] = {}
        # role -> [count, total_ms, deque] for end-to-end latency
        self._e2e: Dict[str, list] = {}
        # Fired at request close, while the trace is still current:
        # fn(role, phases, total_ms, request). The critical-path
        # analyzer hooks here to merge the two-party timeline.
        self._close_listeners: list = []

    def add_close_listener(self, fn) -> None:
        """Register `fn(role, phases, total_ms, request)` to run when a
        request record closes (inside the still-active trace context).
        Idempotent per function object; listeners must not raise."""
        with self._lock:
            if fn not in self._close_listeners:
                self._close_listeners.append(fn)

    def bind_registry(self, registry) -> None:
        """Mirror per-request phase totals into `registry` (duck-typed
        `histogram(name, labels=...)`)."""
        with self._lock:
            self._registry = registry

    # -- request lifecycle --------------------------------------------------

    @contextlib.contextmanager
    def request(self, role: str, fresh: bool = False):
        if not self.enabled:
            yield None
            return
        existing = _ACTIVE.get()
        if existing is not None and not fresh:
            yield existing
            return
        req = RequestPhases(role)
        token = _ACTIVE.set(req)
        try:
            yield req
        finally:
            _ACTIVE.reset(token)
            total_ms = req.elapsed_ms()
            phases = req.close()
            attributed = sum(
                ms for name, ms in phases.items()
                if name not in _OVERLAY_PHASES
            )
            if total_ms > attributed:
                phases["other"] = total_ms - attributed
            self._observe(role, phases, total_ms)
            trace = tracing.current_trace()
            if trace is not None:
                trace.attrs["phases"] = {
                    k: round(v, 3) for k, v in sorted(phases.items())
                }
                trace.attrs["phase_total_ms"] = round(total_ms, 3)
            with self._lock:
                listeners = list(self._close_listeners)
            for fn in listeners:
                try:
                    fn(role, phases, total_ms, req)
                except Exception:  # pragma: no cover - never raises
                    pass

    @contextlib.contextmanager
    def collect(self):
        """Batch-scoped record for a worker thread: soaks up `phase()`
        brackets during one batched evaluation WITHOUT feeding the
        aggregates — the worker re-attributes the collected phases to
        every request in the batch by reference."""
        if not self.enabled:
            yield None
            return
        req = RequestPhases("_batch")
        token = _ACTIVE.set(req)
        try:
            yield req
        finally:
            _ACTIVE.reset(token)
            req.close()

    # -- aggregation --------------------------------------------------------

    def _observe(self, role: str, phases: Dict[str, float],
                 total_ms: float) -> None:
        with self._lock:
            agg = self._agg.setdefault(role, {})
            for name, ms in phases.items():
                entry = agg.get(name)
                if entry is None:
                    entry = [
                        0, 0.0,
                        collections.deque(maxlen=self._reservoir),
                    ]
                    agg[name] = entry
                entry[0] += 1
                entry[1] += ms
                entry[2].append(ms)
            e2e = self._e2e.get(role)
            if e2e is None:
                e2e = [0, 0.0, collections.deque(maxlen=self._reservoir)]
                self._e2e[role] = e2e
            e2e[0] += 1
            e2e[1] += total_ms
            e2e[2].append(total_ms)
            registry = self._registry
        if registry is not None:
            try:
                for name, ms in phases.items():
                    registry.histogram(
                        "phase_ms", labels={"role": role, "phase": name}
                    ).observe(ms)
                registry.histogram(
                    "phase_total_ms", labels={"role": role}
                ).observe(total_ms)
            except Exception:  # pragma: no cover - telemetry never raises
                pass

    @staticmethod
    def _summarize(count: int, total: float, samples) -> dict:
        ordered = sorted(samples)
        if not ordered:
            return {"count": 0, "total_ms": 0.0, "mean_ms": 0.0,
                    "p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}

        def pct(p):
            i = min(len(ordered) - 1,
                    max(0, round(p / 100 * (len(ordered) - 1))))
            return round(ordered[i], 4)

        return {
            "count": count,
            "total_ms": round(total, 3),
            "mean_ms": round(total / count, 4) if count else 0.0,
            "p50_ms": pct(50),
            "p99_ms": pct(99),
            "max_ms": round(ordered[-1], 4),
        }

    def waterfall(self) -> dict:
        """{role: {requests, end_to_end_ms: {...}, phases: {phase:
        {count, total_ms, mean_ms, p50_ms, p99_ms, max_ms, share}}}}
        where `share` is the phase's fraction of the role's summed
        end-to-end time. Phases are ordered by the canonical taxonomy,
        then alphabetically for any out-of-taxonomy names."""
        with self._lock:
            agg = {
                role: {name: (e[0], e[1], list(e[2]))
                       for name, e in phases.items()}
                for role, phases in self._agg.items()
            }
            e2e = {role: (e[0], e[1], list(e[2]))
                   for role, e in self._e2e.items()}
        out = {}
        order = {name: i for i, name in enumerate(PHASES)}
        for role in sorted(agg):
            count, total, samples = e2e.get(role, (0, 0.0, []))
            names = sorted(
                agg[role], key=lambda n: (order.get(n, len(order)), n)
            )
            phases = {}
            for name in names:
                c, t, s = agg[role][name]
                entry = self._summarize(c, t, s)
                entry["share"] = round(t / total, 4) if total else 0.0
                phases[name] = entry
            out[role] = {
                "requests": count,
                "end_to_end_ms": self._summarize(count, total, samples),
                "phases": phases,
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._e2e.clear()


_DEFAULT = PhaseRecorder()


def default_phase_recorder() -> PhaseRecorder:
    """The process-wide recorder the serving paths report into (swap
    with `set_default_phase_recorder` in tests)."""
    return _DEFAULT


def set_default_phase_recorder(recorder: PhaseRecorder) -> PhaseRecorder:
    global _DEFAULT
    _DEFAULT = recorder
    return recorder
