"""Declarative SLOs evaluated against the metrics registry, copied from
the JAX package's `observability/slo.py` (stdlib only); the cost ledger
(`costmodel.py`) grades its drift with an `SloObjective`.

The ROADMAP's "fast as the hardware allows" north star needs
machine-checkable objectives, not eyeballed JSON tails: a process
declares ceilings and floors over its own instruments and the tracker
continuously grades them, so `/statusz` shows burn state and
`/healthz` degrades to 503 while a *hard* objective is in breach
(load balancers drain the process; recovery flips it back).

Objective kinds:

* ``p99_ms_max``   — p99 of a registry histogram must stay <= threshold
                     (latency ceiling).
* ``rate_min``     — the per-second growth rate of a registry counter
                     must stay >= threshold (a q/s floor). Rates need
                     two observations; until then the objective reports
                     ``no_data`` (never a breach — a process that has
                     not served yet is not failing its SLO).
* ``counter_max``  — a registry counter must stay <= threshold
                     (compile-count budget per process: a serving
                     binary whose bucket discipline holds compiles a
                     bounded number of programs, so compile count
                     crossing the budget is a bug, not load).
* ``gauge_max``    — a registry gauge must stay <= threshold (HBM
                     watermark ceilings).
* ``gauge_min``    — a registry gauge must stay >= threshold (a floor:
                     the fleet's routable-replica count must not fall
                     below quorum). An absent gauge is ``no_data``, not
                     a breach — same grace as ``rate_min``.

Config is data, not code (`SloTracker.from_config` accepts the parsed
dict or a JSON path):

    {"objectives": [
        {"name": "plain_latency", "kind": "p99_ms_max",
         "metric": "plain.request_ms", "threshold": 50.0,
         "severity": "hard"},
        {"name": "throughput_floor", "kind": "rate_min",
         "metric": "batcher.requests_submitted", "threshold": 100.0,
         "severity": "soft"},
        {"name": "compile_budget", "kind": "counter_max",
         "metric": "device.compiles{site=batcher.evaluate}",
         "threshold": 8, "severity": "hard"}]}

Like everything in `observability/`, the registry is duck-typed
(`.export() -> dict`) and nothing here imports serving/pir.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

from . import events as events_mod

__all__ = ["SloObjective", "SloTracker", "KINDS"]

KINDS = ("p99_ms_max", "rate_min", "counter_max", "gauge_max", "gauge_min")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective over a registry instrument."""

    name: str
    kind: str
    metric: str
    threshold: float
    severity: str = "hard"  # "hard" degrades /healthz; "soft" is advisory

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; expected one of {KINDS}"
            )
        if self.severity not in ("hard", "soft"):
            raise ValueError(
                f"severity must be 'hard' or 'soft', got {self.severity!r}"
            )


class SloTracker:
    """Grades objectives against registry exports; remembers burn state.

    Evaluation is pull-based: `/healthz` and `/statusz` call
    `evaluate()` on scrape (tests drive it directly), and an optional
    `start(period_s)` daemon keeps burn clocks honest between scrapes.
    """

    def __init__(
        self,
        objectives: List[SloObjective],
        registry,
        clock=time.monotonic,
    ):
        self._objectives = list(objectives)
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        # Called once per burn *transition* (an objective newly entering
        # breach), with that objective's evaluation record — outside the
        # lock, after the full evaluation pass. The SLO-triggered
        # auto-profiler hangs off this.
        self._burn_listeners: List = []
        # name -> monotonic time the current breach started
        self._burning_since: Dict[str, float] = {}
        # name -> (counter value, monotonic ts) for rate_min objectives
        self._rate_marks: Dict[str, tuple] = {}
        self._last_eval: Optional[List[dict]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @classmethod
    def from_config(cls, config, registry) -> "SloTracker":
        """Build from a parsed config dict or a JSON file path."""
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        objectives = [
            SloObjective(
                name=str(o["name"]),
                kind=str(o["kind"]),
                metric=str(o["metric"]),
                threshold=float(o["threshold"]),
                severity=str(o.get("severity", "hard")),
            )
            for o in config.get("objectives", [])
        ]
        return cls(objectives, registry)

    @property
    def objectives(self) -> List[SloObjective]:
        return list(self._objectives)

    def add_burn_listener(self, listener) -> None:
        """Register `listener(record)` to fire once each time an
        objective transitions into breach (NOT on every evaluation of a
        continuing breach). `record` is the objective's `evaluate()`
        dict. Listeners run outside the tracker lock and must not
        raise; exceptions are swallowed — grading always completes."""
        with self._lock:
            self._burn_listeners.append(listener)

    # -- grading ------------------------------------------------------------

    def _observe(self, objective: SloObjective, export: dict, now: float):
        """(observed value or None, state) for one objective."""
        if objective.kind == "p99_ms_max":
            hist = export.get("histograms", {}).get(objective.metric)
            p99 = hist.get("p99") if hist else None
            if p99 is None:
                return None, "no_data"
            return p99, ("ok" if p99 <= objective.threshold else "breach")
        if objective.kind == "counter_max":
            value = export.get("counters", {}).get(objective.metric)
            if value is None:
                return None, "no_data"
            return value, ("ok" if value <= objective.threshold else "breach")
        if objective.kind == "gauge_max":
            value = export.get("gauges", {}).get(objective.metric)
            if value is None:
                return None, "no_data"
            return value, ("ok" if value <= objective.threshold else "breach")
        if objective.kind == "gauge_min":
            value = export.get("gauges", {}).get(objective.metric)
            if value is None:
                return None, "no_data"
            return value, ("ok" if value >= objective.threshold else "breach")
        # rate_min: needs a previous mark to compute a rate.
        value = export.get("counters", {}).get(objective.metric)
        if value is None:
            return None, "no_data"
        mark = self._rate_marks.get(objective.name)
        self._rate_marks[objective.name] = (value, now)
        if mark is None or now <= mark[1]:
            return None, "no_data"
        rate = (value - mark[0]) / (now - mark[1])
        return (
            round(rate, 4),
            "ok" if rate >= objective.threshold else "breach",
        )

    def evaluate(self) -> List[dict]:
        """Grade every objective now. Returns one record per objective:
        {name, kind, metric, threshold, severity, observed, state,
        burn_s} where state is ok|breach|no_data and burn_s is how long
        the objective has been continuously in breach."""
        export = self._registry.export()
        now = self._clock()
        results = []
        new_burns = []
        recoveries = []
        with self._lock:
            for objective in self._objectives:
                observed, state = self._observe(objective, export, now)
                entered_burn = (
                    state == "breach"
                    and objective.name not in self._burning_since
                )
                if state == "breach":
                    self._burning_since.setdefault(objective.name, now)
                else:
                    ended = self._burning_since.pop(objective.name, None)
                    if ended is not None:
                        recoveries.append(
                            (objective, round(now - ended, 3))
                        )
                burn = self._burning_since.get(objective.name)
                record = {
                    "name": objective.name,
                    "kind": objective.kind,
                    "metric": objective.metric,
                    "threshold": objective.threshold,
                    "severity": objective.severity,
                    "observed": observed,
                    "state": state,
                    "burn_s": (
                        round(now - burn, 3) if burn is not None else 0.0
                    ),
                }
                results.append(record)
                if entered_burn:
                    new_burns.append(record)
            self._last_eval = results
            listeners = list(self._burn_listeners)
        for record in new_burns:
            events_mod.emit(
                "slo.burn",
                f"{record['name']} observed {record['observed']} vs "
                f"{record['threshold']}",
                severity=(
                    "error" if record["severity"] == "hard" else "warning"
                ),
                objective=record["name"],
                metric=record["metric"],
                observed=record["observed"],
                threshold=record["threshold"],
            )
            for listener in listeners:
                try:
                    listener(record)
                except Exception:  # pragma: no cover - grading completes
                    pass
        for objective, burned_s in recoveries:
            events_mod.emit(
                "slo.recovered",
                f"{objective.name} after {burned_s}s in breach",
                severity="info",
                objective=objective.name,
                metric=objective.metric,
                burn_s=burned_s,
            )
        return results

    def healthy(self) -> bool:
        """False iff any *hard* objective is currently in breach.
        Re-evaluates, so recovery flips health back on the next probe."""
        return not self.breaches(evaluate=True)

    def breaches(self, evaluate: bool = False) -> List[dict]:
        if evaluate or self._last_eval is None:
            self.evaluate()
        with self._lock:
            last = self._last_eval or []
            return [
                r for r in last
                if r["state"] == "breach" and r["severity"] == "hard"
            ]

    def burn_summary(self) -> dict:
        """Fresh compact burn view (drives the brownout ladder and the
        /statusz needle): whether any hard objective is burning, the
        longest continuous burn, and the burning objective names."""
        breaching = self.breaches(evaluate=True)
        return {
            "breaching": bool(breaching),
            "max_burn_s": max(
                (r["burn_s"] for r in breaching), default=0.0
            ),
            "objectives": [r["name"] for r in breaching],
        }

    def export(self) -> dict:
        """Last grading (evaluating if never graded) for /statusz."""
        results = self.evaluate()
        return {
            "objectives": results,
            "healthy": not any(
                r["state"] == "breach" and r["severity"] == "hard"
                for r in results
            ),
        }

    # -- optional background burner -----------------------------------------

    def start(self, period_s: float = 10.0) -> "SloTracker":
        """Evaluate every `period_s` seconds on a daemon thread so burn
        durations accrue even when nobody scrapes."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:  # pragma: no cover - keep burning
                    pass

        self._thread = threading.Thread(
            target=run, daemon=True, name="slo-tracker"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
