"""Cross-party critical-path analysis: one skew-corrected timeline per
request, with helper_rtt decomposed into network / queue / compute.

`phases.py` gives each party its own waterfall and `propagation.py` v2
brings the Helper's digest plus recv/send monotonic timestamps back to
the Leader — but the two clocks are unrelated `perf_counter` domains,
and the question "how much of p99 helper_rtt could overlap with local
compute?" needs them merged. This module is the
Dapper-style unifier:

**Skew estimation (NTP-style).** One request IS one NTP exchange: the
Leader stamps send t0 / recv t3, the Helper stamps recv t1 / send t2,
all in each party's own `perf_counter` ms. Then

    offset      = ((t1 + t2) - (t0 + t3)) / 2      (helper - leader)
    rtt         = t3 - t0
    service     = t2 - t1
    uncertainty = (rtt - service) / 2

The uncertainty is exact, not heuristic: the true offset lies within
+-uncertainty of the estimate, because all the estimator cannot see is
how the non-service time splits between the outbound and return legs.
When the Leader's own-share compute runs inside the transport's
`on_sent` window it serially occupies part of [t0, t3] without being
wire time; callers pass that measured `overlap_ms` so the *exchange*
rtt (`rtt - overlap`) is what gets split. The subtraction is capped at
`rtt - service` — wire time cannot be negative — because over a
threaded transport (real TCP) the own share runs *concurrently* with
the Helper's service rather than serially; the capped remainder
re-enters the uncertainty instead of silently vanishing. `service >
rtt` (possible under clock granularity jitter) still flags the
estimate invalid — the decomposition refuses to produce a bogus split
rather than clamping its way to a confident-looking one.

**Decomposition.** With a valid estimate, `helper_rtt` splits as

    helper_net     = exchange_rtt - service        (wire, both legs)
    helper_compute = compute-ish digest phases (device_compute +
                     compile + h2d_transfer + dispatch), capped at
                     service
    helper_queue   = service - helper_compute      (queueing, batch
                     window, wire codec — everything non-compute)

so helper_net + helper_queue + helper_compute == exchange_rtt by
construction, and each term is attributable: net to the wire, queue to
Helper load, compute to the Helper's device.

**Critical-path DAG.** The two-party request shape is

    queue -> batch -> [own-share compute || helper leg]
          -> reconstruct -> respond

The serial head and tail are always critical; inside the parallel
section the longer leg is (`helper` when the exchange rtt >= the
own-share wall time, else `local`). `CriticalPathAnalyzer` aggregates
critical time into per-(phase, party) reservoirs for `/criticalz`,
mirrors `critical.*` metrics into the serving registry for SLO gauges,
and attaches the merged timeline to the flight-recorder trace so
`/tracez` shows both parties on one clock.

Stdlib + sibling observability modules only (layer DAG: observability
imports nothing above itself)."""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from . import phases as phases_mod
from . import tracing

__all__ = [
    "COMPUTE_PHASES",
    "CriticalPathAnalyzer",
    "SkewEstimate",
    "build_timeline",
    "decompose_helper_leg",
    "default_analyzer",
    "estimate_skew",
    "install",
    "set_default_analyzer",
]

# Digest phases attributed to Helper device compute; the rest of the
# Helper's service time is queueing/overhead.
COMPUTE_PHASES = ("device_compute", "compile", "h2d_transfer", "dispatch")

# Leader-side phases forming the own-share leg of the parallel section.
_OWN_LEG_PHASES = ("queue", "batch", "h2d_transfer", "compile",
                   "dispatch", "device_compute")

# Serial tail after the parallel section joins.
_TAIL_PHASES = ("respond", "other")


@dataclasses.dataclass(frozen=True)
class SkewEstimate:
    """NTP-style clock-offset estimate from one request exchange.

    `offset_ms` maps Helper perf_counter ms into the Leader's domain
    (leader_time = helper_time - offset). `rtt_ms` is the raw measured
    round trip; `exchange_ms` excludes the Leader's own-share compute
    overlap; `uncertainty_ms` bounds the offset error (exact, see
    module docstring). `valid=False` means jitter made the Helper's
    service time exceed even the raw round trip — no split is
    possible."""

    offset_ms: float
    uncertainty_ms: float
    rtt_ms: float
    exchange_ms: float
    helper_service_ms: float
    overlap_ms: float
    valid: bool

    def as_dict(self) -> dict:
        return {
            "offset_ms": round(self.offset_ms, 3),
            "uncertainty_ms": round(self.uncertainty_ms, 3),
            "rtt_ms": round(self.rtt_ms, 3),
            "exchange_ms": round(self.exchange_ms, 3),
            "helper_service_ms": round(self.helper_service_ms, 3),
            "overlap_ms": round(self.overlap_ms, 3),
            "valid": self.valid,
        }


def estimate_skew(
    send_ms: float,
    recv_ms: float,
    helper_recv_ms: float,
    helper_send_ms: float,
    overlap_ms: float = 0.0,
) -> SkewEstimate:
    """Estimate the Helper-vs-Leader clock offset from one exchange.

    `send_ms`/`recv_ms`: Leader perf_counter ms around the round trip.
    `helper_recv_ms`/`helper_send_ms`: Helper perf_counter ms at wire
    receive/send. `overlap_ms`: Leader own-share compute that ran
    inside the round-trip window (the transport's `on_sent` hook) —
    the serial part is excluded from the exchange rtt so it is not
    booked as wire time, capped at `rtt - service` since wire time
    cannot be negative; the concurrent remainder (threaded transports)
    widens `uncertainty_ms` instead."""
    rtt = recv_ms - send_ms
    overlap = max(0.0, min(float(overlap_ms), max(0.0, rtt)))
    service = helper_send_ms - helper_recv_ms
    # The overlap claim is trusted only as far as physics allows: wire
    # time cannot be negative, so the serial subtraction is capped at
    # rtt - service. Whatever remains must have run concurrently with
    # the Helper's service (threaded transports overlap the own-share
    # compute with the round trip); its true position inside the
    # bracket is unknown, so it re-enters the uncertainty — bounded by
    # the bracket, not by its own size.
    serial = min(overlap, max(0.0, rtt - max(service, 0.0)))
    exchange = rtt - serial
    hidden = overlap - serial
    offset = ((helper_recv_ms + helper_send_ms) - (send_ms + recv_ms)) / 2.0
    uncertainty = abs(exchange - service) / 2.0 + (
        min(hidden, max(0.0, rtt - exchange)) / 2.0
    )
    valid = rtt >= 0.0 and service >= 0.0 and exchange + 1e-9 >= service
    return SkewEstimate(
        offset_ms=offset,
        uncertainty_ms=abs(uncertainty),
        rtt_ms=rtt,
        exchange_ms=exchange,
        helper_service_ms=service,
        overlap_ms=overlap,
        valid=valid,
    )


def decompose_helper_leg(
    skew: Optional[SkewEstimate],
    helper_phases: Optional[Dict[str, float]],
) -> Optional[dict]:
    """Split the helper leg into net / queue / compute, or None when the
    skew estimate is invalid (a refused split beats a bogus one).

    Invariant: helper_net_ms + helper_queue_ms + helper_compute_ms ==
    skew.exchange_ms. `uncertain=True` flags estimates whose stated
    uncertainty exceeds the service time being split — the numbers are
    still the best available, but jitter dominates them."""
    if skew is None or not skew.valid:
        return None
    digest = helper_phases or {}
    service = max(0.0, skew.helper_service_ms)
    net = max(0.0, skew.exchange_ms - service)
    compute = sum(
        max(0.0, float(digest.get(name, 0.0))) for name in COMPUTE_PHASES
    )
    compute = min(compute, service)
    queue = max(0.0, service - compute)
    return {
        "helper_net_ms": round(net, 4),
        "helper_queue_ms": round(queue, 4),
        "helper_compute_ms": round(compute, 4),
        "uncertainty_ms": round(skew.uncertainty_ms, 4),
        "uncertain": skew.uncertainty_ms > max(service, 1e-9),
    }


def build_timeline(
    phases: Dict[str, float], leg: dict
) -> Tuple[List[dict], str]:
    """Walk the two-party DAG and return (segments, critical_leg).

    `phases` is the Leader's closed waterfall; `leg` is the helper-leg
    meta stashed by the Leader (`rtt_ms`, `own_ms`, optional `decomp`
    and `skew`). Segments are `{party, phase, start_ms, duration_ms,
    critical}` on the Leader's request timeline; within the parallel
    section only the longer leg is marked critical. The model hoists
    the own-share submit's queue/batch to the serial head and places
    helper_net as symmetric half-legs around the Helper's service —
    an approximation the estimator's uncertainty already covers."""
    segments: List[dict] = []
    cursor = 0.0

    def seg(party: str, phase: str, start: float, dur: float,
            critical: bool) -> None:
        if dur <= 0.0:
            return
        segments.append({
            "party": party,
            "phase": phase,
            "start_ms": round(start, 3),
            "duration_ms": round(dur, 3),
            "critical": critical,
        })

    # Serial head: admission queue + batch window.
    for name in ("queue", "batch"):
        dur = float(phases.get(name, 0.0))
        seg("leader", name, cursor, dur, critical=True)
        cursor += dur

    par_start = cursor
    own_phases = [
        (name, float(phases.get(name, 0.0)))
        for name in _OWN_LEG_PHASES
        if name not in ("queue", "batch")
    ]
    own_sum = sum(dur for _, dur in own_phases)
    own_ms = float(leg.get("own_ms") or own_sum)
    rtt_ms = float(leg.get("rtt_ms", 0.0))
    decomp = leg.get("decomp")
    skew = leg.get("skew") or {}
    helper_wall = float(skew.get("exchange_ms", rtt_ms))
    critical_leg = "helper" if helper_wall >= own_ms else "local"

    # Own-share leg.
    t = par_start
    for name, dur in own_phases:
        seg("leader", name, t, dur, critical=(critical_leg == "local"))
        t += dur

    # Helper leg: net/2 out, queue, compute, net/2 back.
    t = par_start
    helper_critical = critical_leg == "helper"
    if decomp is not None:
        net = float(decomp["helper_net_ms"])
        seg("net", "helper_net", t, net / 2.0, helper_critical)
        t += net / 2.0
        seg("helper", "helper_queue", t,
            float(decomp["helper_queue_ms"]), helper_critical)
        t += float(decomp["helper_queue_ms"])
        seg("helper", "helper_compute", t,
            float(decomp["helper_compute_ms"]), helper_critical)
        t += float(decomp["helper_compute_ms"])
        seg("net", "helper_net", t, net / 2.0, helper_critical)
    else:
        seg("helper", "helper_rtt", t, helper_wall, helper_critical)

    cursor = par_start + max(own_ms, helper_wall)

    # Serial tail: reconstruction + respond (+ unattributed remainder).
    for name in _TAIL_PHASES:
        dur = float(phases.get(name, 0.0))
        seg("leader", name, cursor, dur, critical=True)
        cursor += dur

    return segments, critical_leg


class CriticalPathAnalyzer:
    """Aggregates per-request critical time into (party, phase)
    reservoirs, mirrors `critical.*` metrics, and attaches merged
    timelines to the flight-recorder trace.

    Wiring: `attach(recorder)` registers a `PhaseRecorder` close
    listener; requests whose `RequestPhases` carry a `helper_leg` meta
    (stashed by the Leader in `_send_to_helper`) get the full DAG walk.
    `observe_round` is the lighter entry point for the heavy-hitters
    sweep, which times each round's legs directly."""

    def __init__(self, reservoir: int = 512, registry=None):
        self._reservoir = max(8, reservoir)
        self._registry = registry
        self._lock = threading.Lock()
        # (party, phase) -> [count, total_ms, deque]
        self._crit: Dict[Tuple[str, str], list] = {}
        self._legs = {"helper": 0, "local": 0}
        self._requests = 0
        self._skew_invalid = 0
        self._last: Dict[str, dict] = {}

    def bind_registry(self, registry) -> None:
        with self._lock:
            self._registry = registry

    def attach(self, recorder: phases_mod.PhaseRecorder) -> None:
        """Hook this analyzer into a PhaseRecorder (idempotent —
        `add_close_listener` dedupes on the bound method object)."""
        recorder.add_close_listener(self._on_close)

    # -- ingestion ----------------------------------------------------------

    def _on_close(self, role: str, phases: Dict[str, float],
                  total_ms: float, req) -> None:
        leg = req.get_meta("helper_leg")
        if leg is None:
            return
        segments, critical_leg = build_timeline(phases, leg)
        summary = self._observe(role, segments, critical_leg, leg)
        trace = tracing.current_trace()
        if trace is not None:
            trace.attrs["critical_path"] = {
                "critical_leg": critical_leg,
                "timeline": segments,
                **{k: v for k, v in summary.items()
                   if k not in ("critical_leg",)},
            }

    def observe_round(self, role: str, own_ms: float, rtt_ms: float,
                      decomp: Optional[dict],
                      skew: Optional[SkewEstimate]) -> None:
        """Per-round ingestion for sweep-style sessions (heavy
        hitters): only the parallel section, no serial head/tail."""
        leg = {
            "rtt_ms": rtt_ms,
            "own_ms": own_ms,
            "decomp": decomp,
            "skew": skew.as_dict() if skew is not None else {},
        }
        segments, critical_leg = build_timeline({}, leg)
        self._observe(role, segments, critical_leg, leg)

    def _observe(self, role: str, segments: List[dict],
                 critical_leg: str, leg: dict) -> dict:
        decomp = leg.get("decomp")
        skew = leg.get("skew") or {}
        with self._lock:
            self._requests += 1
            self._legs[critical_leg] = self._legs.get(critical_leg, 0) + 1
            if decomp is None:
                self._skew_invalid += 1
            for s in segments:
                if not s["critical"]:
                    continue
                key = (s["party"], s["phase"])
                entry = self._crit.get(key)
                if entry is None:
                    entry = [
                        0, 0.0,
                        collections.deque(maxlen=self._reservoir),
                    ]
                    self._crit[key] = entry
                entry[0] += 1
                entry[1] += s["duration_ms"]
                entry[2].append(s["duration_ms"])
            summary = {
                "critical_leg": critical_leg,
                "rtt_ms": round(float(leg.get("rtt_ms", 0.0)), 3),
                "own_ms": round(float(leg.get("own_ms") or 0.0), 3),
            }
            if skew:
                summary["exchange_ms"] = skew.get("exchange_ms")
                summary["offset_ms"] = skew.get("offset_ms")
                summary["uncertainty_ms"] = skew.get("uncertainty_ms")
                summary["skew_valid"] = skew.get("valid", False)
            if decomp is not None:
                summary.update({
                    "helper_net_ms": decomp["helper_net_ms"],
                    "helper_queue_ms": decomp["helper_queue_ms"],
                    "helper_compute_ms": decomp["helper_compute_ms"],
                    "uncertain": decomp["uncertain"],
                })
            self._last[role] = summary
            registry = self._registry
        if registry is not None:
            try:
                registry.counter(
                    "critical.legs", labels={"leg": critical_leg}
                ).inc()
                for s in segments:
                    if s["critical"]:
                        registry.histogram(
                            "critical.path_ms",
                            labels={"party": s["party"],
                                    "phase": s["phase"]},
                        ).observe(s["duration_ms"])
                if decomp is not None:
                    for key in ("helper_net_ms", "helper_queue_ms",
                                "helper_compute_ms", "uncertainty_ms"):
                        registry.gauge(f"critical.{key}").set(decomp[key])
                else:
                    registry.counter("critical.skew_invalid").inc()
            except Exception:  # pragma: no cover - telemetry never raises
                pass
        return summary

    # -- export -------------------------------------------------------------

    @staticmethod
    def _summarize(count: int, total: float, samples) -> dict:
        ordered = sorted(samples)
        if not ordered:
            return {"count": 0, "total_ms": 0.0, "mean_ms": 0.0,
                    "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                    "max_ms": 0.0}

        def pct(p):
            i = min(len(ordered) - 1,
                    max(0, round(p / 100 * (len(ordered) - 1))))
            return round(ordered[i], 4)

        return {
            "count": count,
            "total_ms": round(total, 3),
            "mean_ms": round(total / count, 4) if count else 0.0,
            "p50_ms": pct(50),
            "p95_ms": pct(95),
            "p99_ms": pct(99),
            "max_ms": round(ordered[-1], 4),
        }

    def last(self, role: str) -> Optional[dict]:
        """The most recent request's critical-path summary for `role`
        (what the blackbox prober attaches to leader_e2e results)."""
        with self._lock:
            summary = self._last.get(role)
            return dict(summary) if summary is not None else None

    def export(self) -> dict:
        """{requests, legs, skew_invalid, profile: {party: {phase:
        {count, ..., p50/p95/p99, share}}}, last: {role: summary}} where
        `share` is the cell's fraction of all critical time."""
        with self._lock:
            crit = {
                key: (e[0], e[1], list(e[2]))
                for key, e in self._crit.items()
            }
            out = {
                "requests": self._requests,
                "legs": dict(self._legs),
                "skew_invalid": self._skew_invalid,
                "last": {r: dict(s) for r, s in self._last.items()},
            }
        grand_total = sum(t for _, t, _ in crit.values())
        profile: Dict[str, dict] = {}
        order = {name: i for i, name in enumerate(phases_mod.PHASES)}
        for party in sorted({p for p, _ in crit}):
            names = sorted(
                (ph for pa, ph in crit if pa == party),
                key=lambda n: (order.get(n, len(order)), n),
            )
            profile[party] = {}
            for name in names:
                c, t, s = crit[(party, name)]
                entry = self._summarize(c, t, s)
                entry["share"] = (
                    round(t / grand_total, 4) if grand_total else 0.0
                )
                profile[party][name] = entry
        out["profile"] = profile
        return out

    def reset(self) -> None:
        with self._lock:
            self._crit.clear()
            self._legs = {"helper": 0, "local": 0}
            self._requests = 0
            self._skew_invalid = 0
            self._last.clear()


_DEFAULT = CriticalPathAnalyzer()


def default_analyzer() -> CriticalPathAnalyzer:
    """The process-wide analyzer the serving paths report into (swap
    with `set_default_analyzer` in tests)."""
    return _DEFAULT


def set_default_analyzer(
    analyzer: CriticalPathAnalyzer,
) -> CriticalPathAnalyzer:
    global _DEFAULT
    _DEFAULT = analyzer
    return analyzer


def install(registry=None,
            recorder: Optional[phases_mod.PhaseRecorder] = None
            ) -> CriticalPathAnalyzer:
    """Attach the default analyzer to the (default) phase recorder and
    optionally bind a metrics registry. Idempotent; called by the
    Leader session at construction."""
    analyzer = default_analyzer()
    if registry is not None:
        analyzer.bind_registry(registry)
    analyzer.attach(recorder or phases_mod.default_phase_recorder())
    return analyzer
