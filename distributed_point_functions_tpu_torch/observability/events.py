"""Unified event journal: one ordered timeline of operational
transitions.

PRs 4-8 gave every subsystem its own private log — the circuit breaker
has transitions, brownout has a transition list, the SLO tracker has
burn state, tier demotions and sweep resumes are bare counters, and
failpoint arming is invisible outside `export()`. During an incident
the operator has to mentally merge five timelines. The `EventJournal`
is the merge: a process-global bounded ring of typed events, each with
a sequence number, wall + monotonic timestamps, a kind, a severity,
and the active trace id when one exists — surfaced at `/eventz`, as a
tail section on `/statusz`, and snapshotted into debug bundles.

Event kinds emitted by the library (the taxonomy; see DESIGN.md §15):

    breaker.transition     Leader helper-leg breaker state change
    service.degraded       Leader entered leader-share-only degraded mode
    brownout.engage        brownout ladder stepped up
    brownout.revert        brownout ladder stepped down
    slo.burn               a hard/soft objective entered breach
    slo.recovered          a burning objective left breach
    pir.tier_demotion      device OOM demoted a batch shape's tier
    hh.sweep_resume        a heavy-hitters sweep resumed from checkpoint
    admission.shed         a request was shed (coalesced per
                           tenant+reason to bound journal churn)
    failpoint.armed        a fault-injection site was armed
    failpoint.disarmed     a fault-injection site was disarmed
    prober.mismatch        a blackbox probe failed bit-identity
    prober.error           a probe raised instead of answering
    prober.recovered       a failing probe kind passed again
    bundle.captured        a debug bundle was written
    capacity.drift         a cost-model cell's residuals left (or
                           re-entered) the configured drift band
    capacity.correction_applied   recalibration moved a cell's price
                           correction factor (coalesced per cell)
    capacity.correction_reverted  the recalibration kill switch
                           bypassed the learned factors
    capacity.calibration_fallback throughput calibration fell back to
                           the conservative built-in for a metric
    snapshot.flip          a database generation flip was applied
    snapshot.mismatch      Leader refused a cross-generation Helper
                           answer (typed SnapshotMismatch, retried)
    snapshot.abort         a rotation was aborted before its flip
    snapshot.check_disabled a pre-v3 peer answers with generation
                           checking disabled (coalesced per peer)
    snapshot.drained       a retired generation's stagings were freed
                           after its last in-flight batch landed
    prober.goldens_rotated the prober re-keyed its golden pairs to a
                           new database generation
    util.straggler         a closed utilization window's max/min
                           per-shard busy skew left the configured band
    util.anomaly           the time-series sampler's rate-of-change
                           watch tripped on a series (coalesced per
                           series)
    forecast.breach_predicted  the forecast plane predicts a watched
                           series will cross its declared ceiling
                           within the page horizon (coalesced per
                           series; warning — pages, never drains)
    governor.scale         the predictive governor changed the fleet's
                           token-bucket refill scale (coalesced)

Emitters call the module-level `emit(...)` (the process-global
journal, mirroring `tracing.runtime_counters`); sessions that want an
isolated journal construct their own `EventJournal` and pass it where
a `journal=` parameter is accepted. High-frequency emitters pass
`coalesce_key`/`coalesce_s` so a shed storm becomes one event with a
`repeats` count instead of evicting the interesting history.

Layering: this module imports only stdlib, `tracing` (same package),
and `robustness/failpoints` (the true bottom layer) — importable from
every layer above, so any subsystem can emit without an upward edge.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from ..robustness import failpoints as _failpoints
from . import tracing

__all__ = [
    "SEVERITIES",
    "EventJournal",
    "default_journal",
    "set_default_journal",
    "emit",
    "watch_failpoints",
]

SEVERITIES = ("info", "warning", "error")

# Bound on distinct coalesce keys remembered (oldest forgotten first);
# forgetting a key only means the next event with it is emitted fresh.
_COALESCE_KEYS_MAX = 128


class EventJournal:
    """Process-global bounded ring of typed operational events.

    `capacity` bounds memory (oldest events evicted); `clock` is the
    monotonic source (injectable for tests). Thread-safe; `emit` is a
    deque append under one lock — cheap enough for transition-rate
    call sites (state changes, not per-request paths).

    `scope` tags the journal with a replica identity: every event gains
    a `replica` field (unless the emitter set one explicitly) and
    coalesce keys are prefixed with the scope, so two replicas sharing
    an emitter implementation in one process cannot coalesce each
    other's storms together. Untagged journals (`scope=None`, the
    default and the process-global journal) behave exactly as before.
    """

    def __init__(
        self,
        capacity: int = 256,
        clock=time.monotonic,
        scope: Optional[str] = None,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._capacity = capacity
        self._clock = clock
        self._scope = scope
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._emitted = 0
        self._coalesced = 0
        # coalesce_key -> (t_mono of last fresh emit, that event dict)
        self._coalesce: "collections.OrderedDict[str, tuple]" = (
            collections.OrderedDict()
        )

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def scope(self) -> Optional[str]:
        return self._scope

    def emit(
        self,
        kind: str,
        message: str = "",
        severity: str = "info",
        coalesce_key: Optional[str] = None,
        coalesce_s: float = 0.0,
        **fields,
    ) -> dict:
        """Append one event; returns the (live) event dict. With
        `coalesce_key`, a repeat within `coalesce_s` of the last fresh
        emit bumps that event's `repeats` counter instead of appending
        (shed storms become one line, not a ring flush)."""
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {severity!r}"
            )
        if self._scope is not None:
            fields.setdefault("replica", self._scope)
            if coalesce_key is not None:
                coalesce_key = f"{self._scope}:{coalesce_key}"
        now = self._clock()
        trace = tracing.current_trace()
        with self._lock:
            if coalesce_key is not None and coalesce_s > 0.0:
                prev = self._coalesce.get(coalesce_key)
                if prev is not None and now - prev[0] < coalesce_s:
                    prev[1]["repeats"] = prev[1].get("repeats", 0) + 1
                    self._coalesced += 1
                    return prev[1]
            self._seq += 1
            self._emitted += 1
            event = {
                "seq": self._seq,
                "t_wall": round(time.time(), 6),
                "t_mono": round(now, 6),
                "kind": str(kind),
                "severity": severity,
                "message": str(message),
                "trace_id": trace.trace_id if trace is not None else None,
            }
            event.update(fields)
            self._events.append(event)
            if coalesce_key is not None:
                self._coalesce[coalesce_key] = (now, event)
                self._coalesce.move_to_end(coalesce_key)
                while len(self._coalesce) > _COALESCE_KEYS_MAX:
                    self._coalesce.popitem(last=False)
            return event

    # -- reading ------------------------------------------------------------

    def tail(
        self,
        n: Optional[int] = None,
        kind: Optional[str] = None,
        min_severity: Optional[str] = None,
    ) -> List[dict]:
        """Newest-last slice of the ring. `kind` matches exactly or as
        a dotted prefix ("prober" matches "prober.mismatch");
        `min_severity` filters at or above that severity."""
        with self._lock:
            events = list(self._events)
        if kind:
            events = [
                e for e in events
                if e["kind"] == kind or e["kind"].startswith(kind + ".")
            ]
        if min_severity:
            floor = SEVERITIES.index(min_severity)
            events = [
                e for e in events
                if SEVERITIES.index(e["severity"]) >= floor
            ]
        if n is not None:
            events = events[-max(0, int(n)):]
        return [dict(e) for e in events]

    def kinds(self) -> Dict[str, int]:
        """Event count per kind over the retained window."""
        with self._lock:
            events = list(self._events)
        out: Dict[str, int] = {}
        for e in events:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return dict(sorted(out.items()))

    def export(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "scope": self._scope,
                "emitted": self._emitted,
                "coalesced": self._coalesced,
                "dropped": max(0, self._emitted - len(self._events)),
                "events": [dict(e) for e in self._events],
            }

    def clear(self) -> None:
        """Drop retained events (tests); counters and seq keep going so
        ordering stays provable across a clear."""
        with self._lock:
            self._events.clear()
            self._coalesce.clear()


_default_journal = EventJournal()


def default_journal() -> EventJournal:
    return _default_journal


def set_default_journal(journal: EventJournal) -> EventJournal:
    global _default_journal
    _default_journal = journal
    return journal


def emit(kind: str, message: str = "", severity: str = "info", **kwargs):
    """Emit to the process-global journal (the library call sites'
    entry point — one line, no wiring)."""
    return _default_journal.emit(kind, message, severity=severity, **kwargs)


# ---------------------------------------------------------------------------
# Failpoint arming -> journal (the one source that cannot emit itself:
# robustness/ is stdlib-only and sits below this package, so the edge
# runs downward from here via a plain-callback listener).
# ---------------------------------------------------------------------------


def watch_failpoints(registry=None, journal: Optional[EventJournal] = None):
    """Subscribe `journal` (default: process journal) to `registry`'s
    arming changes (default: the default failpoint registry). Sites
    already armed before the subscription —
    are emitted retroactively so the timeline still shows them."""
    registry = (
        registry if registry is not None else _failpoints.default_failpoints()
    )

    def _journal() -> EventJournal:
        return journal if journal is not None else _default_journal

    for site, spec in registry.export()["sites"].items():
        _journal().emit(
            "failpoint.armed",
            f"{site}={spec['action']} (armed before watch)",
            severity="warning",
            site=site,
            action=spec["action"],
        )

    def on_change(site, spec):
        if spec is None:
            _journal().emit(
                "failpoint.disarmed", site, severity="info", site=site
            )
        else:
            _journal().emit(
                "failpoint.armed",
                f"{site}={spec.action}",
                severity="warning",
                site=site,
                action=spec.action,
            )

    registry.add_arm_listener(on_change)
    return registry


# Wire the default registry at import: every process that touches
# observability gets failpoint arming on its timeline for free.
watch_failpoints()
