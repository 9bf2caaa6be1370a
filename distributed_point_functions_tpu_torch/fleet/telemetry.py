"""Fleet telemetry plane: per-replica scopes + the fleet aggregator.

A port of the JAX package's `fleet/telemetry.py`. `observability/federation.py` knows how to *merge* telemetry exports;
this module knows where they come from. Two pieces:

`ReplicaTelemetry` is one replica's scope: a replica-tagged
`EventJournal` (every event gains `replica=<id>`, coalesce keys are
prefixed so two replicas' storms cannot merge), a per-replica
`UtilizationTracker`, a per-replica `TimeSeriesStore` fed by one
`MetricsSampler` per session registry, and the wiring (`adopt`) that
threads the scope into the replica's existing components — sessions
(`set_journal`/`set_utilization`), `SnapshotManager`s, and the pair's
prober. Before this, N replicas in one process silently shared the
process-global journal/tracker/TSDB and an incident timeline could not
say *which* replica's breaker opened.

`FleetTelemetry` is the aggregator: it scrapes every scope into one
merged metrics view (`replica`-labeled rows + sum/mean/bucket-merge
aggregates), one causally ordered cross-replica timeline
(monotonic-rebased — see federation.py), fleet-level TSDB series
(`fleet.qps`, `fleet.duty_cycle_pct`, `fleet.routable_replicas`,
per-replica generation lag), and a fleet `SloTracker` over its own
derived gauges:

    fleet_routable_floor      gauge_min  fleet.routable_replicas
    fleet_rotation_staleness  gauge_max  fleet.rotation_staleness_ms
    fleet_probe_freshness     gauge_max  fleet.divergence_probe_age_s
    fleet_spillover_rate      gauge_max  fleet.spillover_rate_pct

Hard breaches degrade the fleet `/healthz` verdict, and `wire_bundles`
turns the first hard burn (or a probe divergence) into ONE fleet-wide
debug bundle: every replica's scrape as its own section plus the merged
timeline, in one directory.

Scraping is transport-agnostic by construction: `FleetTelemetry`
consumes `ReplicaTelemetry.scrape()` dicts and duck-typed exports, so
a multi-host deployment can implement the same scrape over the
network without this module changing. Layering: fleet -> serving ->
observability, one-way.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..observability import events as events_mod
from ..observability import federation
from ..observability.events import EventJournal
from ..observability.slo import SloObjective, SloTracker
from ..observability.timeseries import MetricsSampler, TimeSeriesStore
from ..observability.utilization import UtilizationTracker
from ..serving.metrics import MetricsRegistry, split_labeled_name

__all__ = [
    "ReplicaTelemetry",
    "FleetTelemetry",
    "default_fleet_objectives",
]


def default_fleet_objectives(
    min_routable: int = 2,
    rotation_staleness_ceiling_ms: float = 30_000.0,
    probe_age_ceiling_s: float = 120.0,
    spillover_ceiling_pct: float = 35.0,
) -> List[SloObjective]:
    """The fleet SLO catalog. Routable floor and probe
    freshness are hard — a fleet below quorum or unable to prove
    bit-identity must stop taking traffic; staleness and spillover rate
    are soft — they page, they do not drain."""
    return [
        SloObjective(
            name="fleet_routable_floor",
            kind="gauge_min",
            metric="fleet.routable_replicas",
            threshold=float(min_routable),
            severity="hard",
        ),
        SloObjective(
            name="fleet_rotation_staleness",
            kind="gauge_max",
            metric="fleet.rotation_staleness_ms",
            threshold=float(rotation_staleness_ceiling_ms),
            severity="soft",
        ),
        SloObjective(
            name="fleet_probe_freshness",
            kind="gauge_max",
            metric="fleet.divergence_probe_age_s",
            threshold=float(probe_age_ceiling_s),
            severity="hard",
        ),
        SloObjective(
            name="fleet_spillover_rate",
            kind="gauge_max",
            metric="fleet.spillover_rate_pct",
            threshold=float(spillover_ceiling_pct),
            severity="soft",
        ),
    ]


class ReplicaTelemetry:
    """One replica's telemetry scope (see module docstring)."""

    def __init__(
        self,
        replica_id: str,
        *,
        journal: Optional[EventJournal] = None,
        utilization: Optional[UtilizationTracker] = None,
        store: Optional[TimeSeriesStore] = None,
        journal_capacity: int = 256,
        max_series: int = 64,
        workload=None,
        clock=time.monotonic,
    ):
        self.replica_id = str(replica_id)
        # workload is a replica-scoped WorkloadObservatory (opt-in via
        # the constructor or set_workload); its export rides the scrape
        # so the aggregator can federate per-replica traffic shapes.
        self.workload = workload
        self.journal = (
            journal
            if journal is not None
            else EventJournal(
                capacity=journal_capacity, clock=clock, scope=self.replica_id
            )
        )
        self.utilization = (
            utilization
            if utilization is not None
            else UtilizationTracker(clock=clock, journal=self.journal)
        )
        self.store = (
            store
            if store is not None
            else TimeSeriesStore(max_series=max_series, clock=clock)
        )
        self._clock = clock
        self._registries: List = []
        self._samplers: List[MetricsSampler] = []
        self._replica = None

    def adopt(self, replica) -> "ReplicaTelemetry":
        """Thread this scope into `replica`'s components: sessions get
        the scoped journal + utilization tracker, snapshot managers and
        the pair's prober get the journal, and one sampler per session
        registry feeds the scoped TSDB. Components lacking the setters
        (stub sessions in tests) are skipped — adoption is best-effort
        by design, the scrape below works either way."""
        self._replica = replica
        for session in (replica.leader, getattr(replica, "helper", None)):
            if session is None:
                continue
            if callable(getattr(session, "set_journal", None)):
                session.set_journal(self.journal)
            # Only rebind utilization where the session had tracking on
            # (config.utilization=False stays off).
            if getattr(session, "_util", None) is not None and callable(
                getattr(session, "set_utilization", None)
            ):
                session.set_utilization(self.utilization)
            registry = getattr(session, "metrics", None)
            if registry is not None and all(
                registry is not r for r in self._registries
            ):
                self._registries.append(registry)
        managers = (
            replica.managers() if callable(getattr(replica, "managers", None))
            else []
        )
        for manager in managers:
            if callable(getattr(manager, "set_journal", None)):
                manager.set_journal(self.journal)
        prober = getattr(replica, "prober", None)
        if prober is not None and callable(
            getattr(prober, "set_journal", None)
        ):
            prober.set_journal(self.journal)
        self._samplers = [
            MetricsSampler(
                store=self.store,
                registry=registry,
                utilization=self.utilization if i == 0 else None,
                journal=self.journal,
                clock=self._clock,
            )
            for i, registry in enumerate(self._registries)
        ]
        return self

    def sample_once(self, now: Optional[float] = None) -> int:
        """One deterministic sampling pass over every session registry
        (and the utilization tracker) into the scoped TSDB."""
        return sum(s.sample_once(now) for s in self._samplers)

    def metrics_export(self) -> dict:
        """The replica's registries merged to one flat registry-shaped
        export (leader + helper summed where names collide, histogram
        buckets merged)."""
        if not self._registries:
            return {"counters": {}, "gauges": {}, "histograms": {}}
        if len(self._registries) == 1:
            return self._registries[0].export()
        return federation.merged_flat(
            {
                f"party{i}": registry.export()
                for i, registry in enumerate(self._registries)
            }
        )

    def request_count(self) -> int:
        """Requests served, read from the `*.request_ms` histogram
        counts every session exports — the fleet QPS series derives
        from deltas of this. Uses the registry's cheap count accessor
        when present (a full export sorts every reservoir; this runs on
        every fleet sample)."""
        total = 0
        for registry in self._registries:
            if callable(getattr(registry, "histogram_counts", None)):
                total += sum(
                    registry.histogram_counts(".request_ms").values()
                )
                continue
            for name, hist in registry.export().get(
                "histograms", {}
            ).items():
                base = name.split("{", 1)[0]
                if base.endswith(".request_ms"):
                    total += int(hist.get("count", 0))
        return total

    def set_workload(self, observatory) -> "ReplicaTelemetry":
        """Attach (or replace) this replica's workload observatory and
        wire its gauge source into the scoped samplers so its headline
        numbers become TSDB series on every sampling pass."""
        self.workload = observatory
        if observatory is not None:
            for sampler in self._samplers:
                sampler.add_extra_source(observatory.gauge_source)
        return self

    def scrape(self) -> dict:
        """Everything the aggregator (or a scraper over the network) needs,
        as one plain dict."""
        out = {
            "replica_id": self.replica_id,
            "metrics": self.metrics_export(),
            "journal": self.journal.export(),
            "utilization": self.utilization.export(),
            "timeseries": {
                "series_count": self.store.export()["series_count"],
                "dropped_series": self.store.export().get(
                    "dropped_series", 0
                ),
            },
        }
        if self.workload is not None:
            out["workload"] = self.workload.export()
        return out


class FleetTelemetry:
    """Aggregate N `ReplicaTelemetry` scopes into one fleet view."""

    def __init__(
        self,
        replica_set,
        *,
        router=None,
        rotation=None,
        probe=None,
        journal: Optional[EventJournal] = None,
        objectives: Optional[List[SloObjective]] = None,
        store: Optional[TimeSeriesStore] = None,
        registry: Optional[MetricsRegistry] = None,
        clock=time.monotonic,
        name: str = "fleet",
    ):
        self._set = replica_set
        self._router = router
        self._rotation = rotation
        self._probe = probe
        self._name = name
        self._clock = clock
        # Fleet-level events (fleet.replica_state, fleet.rotation,
        # fleet.spillover_storm ...) live on whatever journal the fleet
        # components were built with; default: the process journal.
        self.journal = (
            journal if journal is not None else events_mod.default_journal()
        )
        self.registry = registry if registry is not None else MetricsRegistry()
        self.store = (
            store
            if store is not None
            else TimeSeriesStore(max_series=64, clock=clock)
        )
        self.slo = SloTracker(
            objectives
            if objectives is not None
            else default_fleet_objectives(),
            self.registry,
            clock=clock,
        )
        self._lock = threading.Lock()
        self._scopes: Dict[str, ReplicaTelemetry] = {}
        self._bundles = None
        self._samples = 0
        self._last_sample_mono: Optional[float] = None
        # replica_id -> (request_count, t_mono) marks for QPS deltas
        self._qps_marks: Dict[str, tuple] = {}
        self._qps: Dict[str, float] = {}

    # -- scoping -------------------------------------------------------------

    def scope(self, replica, **kwargs) -> ReplicaTelemetry:
        """Create a `ReplicaTelemetry` for `replica`, adopt it into the
        replica's components, and register it with the aggregator."""
        telemetry = ReplicaTelemetry(
            replica.replica_id, clock=self._clock, **kwargs
        ).adopt(replica)
        return self.attach(telemetry)

    def attach(self, telemetry: ReplicaTelemetry) -> ReplicaTelemetry:
        with self._lock:
            self._scopes[telemetry.replica_id] = telemetry
            bundles = self._bundles
        if bundles is not None:
            self._add_replica_source(bundles, telemetry)
        return telemetry

    def scopes(self) -> Dict[str, ReplicaTelemetry]:
        with self._lock:
            return dict(self._scopes)

    def set_router(self, router):
        self._router = router
        return router

    def set_rotation(self, rotation):
        self._rotation = rotation
        return rotation

    def set_probe(self, probe):
        self._probe = probe
        return probe

    # -- sampling ------------------------------------------------------------

    def _routable(self) -> int:
        try:
            return len(self._set.healthy())
        except Exception:  # noqa: BLE001 - sampling never raises
            return 0

    def sample(self, now: Optional[float] = None) -> dict:
        """One aggregation pass: refresh every fleet gauge from the live
        fleet objects, drive each scope's sampler, append the fleet TSDB
        series, and grade the fleet SLOs (burn listeners — the bundle
        trigger — fire from here). Returns the derived values."""
        if now is None:
            now = self._clock()
        scopes = self.scopes()
        for telemetry in scopes.values():
            telemetry.sample_once(now)

        gauges = self.registry
        routable = self._routable()
        gauges.gauge("fleet.routable_replicas").set(float(routable))

        # Per-replica QPS from request-count deltas; fleet QPS is the sum.
        fleet_qps = 0.0
        for rid, telemetry in scopes.items():
            count = telemetry.request_count()
            mark = self._qps_marks.get(rid)
            self._qps_marks[rid] = (count, now)
            if mark is not None and now > mark[1]:
                rate = max(0.0, (count - mark[0]) / (now - mark[1]))
                self._qps[rid] = round(rate, 3)
                gauges.gauge(
                    "fleet.replica_qps", labels={"replica": rid}
                ).set(self._qps[rid])
        fleet_qps = round(sum(self._qps.values()), 3)
        gauges.gauge("fleet.qps").set(fleet_qps)

        # Fleet duty cycle: mean of the replicas' trackers (a percent
        # sums wrong — federation's mean rule, applied at the source).
        duties = [
            telemetry.utilization.last_duty_cycle_pct()
            for telemetry in scopes.values()
        ]
        duties = [d for d in duties if d is not None]
        duty = round(sum(duties) / len(duties), 3) if duties else None
        if duty is not None:
            gauges.gauge("fleet.duty_cycle_pct").set(duty)

        # Per-replica generation lag behind the fleet max.
        lags: Dict[str, int] = {}
        try:
            generations = self._set.generations()
        except Exception:  # noqa: BLE001
            generations = {}
        if generations:
            newest = max(generations.values())
            for rid, generation in generations.items():
                lags[rid] = int(newest - generation)
                gauges.gauge(
                    "fleet.generation_lag", labels={"replica": rid}
                ).set(float(lags[rid]))

        if self._router is not None and callable(
            getattr(self._router, "spillover_rate_pct", None)
        ):
            gauges.gauge("fleet.spillover_rate_pct").set(
                self._router.spillover_rate_pct()
            )
        if self._rotation is not None:
            report = (self._rotation.export() or {}).get("last_report")
            if report and report.get("staleness_ms") is not None:
                gauges.gauge("fleet.rotation_staleness_ms").set(
                    float(report["staleness_ms"])
                )
        if self._probe is not None and callable(
            getattr(self._probe, "last_pass_age_s", None)
        ):
            age = self._probe.last_pass_age_s()
            if age is not None:
                gauges.gauge("fleet.divergence_probe_age_s").set(
                    round(age, 3)
                )

        # Fleet TSDB series (the `extra_sources` shape, recorded here
        # directly so a deployment without a sampler thread still gets
        # series on every sample()).
        series = self.fleet_series()
        for series_name, value in series.items():
            self.store.record(series_name, value, t=now)

        self.slo.evaluate()
        with self._lock:
            self._samples += 1
            self._last_sample_mono = now
        return {
            "routable": routable,
            "qps": fleet_qps,
            "duty_cycle_pct": duty,
            "generation_lag": lags,
            "series": series,
        }

    def fleet_series(self) -> Dict[str, float]:
        """Current fleet gauge values as `{series_name: value}` — also
        usable verbatim as a `MetricsSampler` extra source."""
        out: Dict[str, float] = {}
        for name, value in self.registry.export().get("gauges", {}).items():
            base, labels = split_labeled_name(name)
            rid = labels.get("replica")
            # Labeled per-replica gauges become dotted series names
            # (`fleet.generation_lag.r1`) — TSDB series are flat.
            out[f"{base}.{rid}" if rid is not None else base] = value
        return out

    # -- merged views --------------------------------------------------------

    def metrics(self) -> dict:
        """The merged fleet metrics view: per-replica rows + aggregates
        (federation merge rules), plus the fleet's own derived
        instruments under `fleet`."""
        scopes = self.scopes()
        merged = federation.merge_metrics(
            {
                rid: telemetry.metrics_export()
                for rid, telemetry in scopes.items()
            }
        )
        merged["fleet"] = self.registry.export()
        return merged

    def timeline(
        self,
        n: Optional[int] = None,
        kind: Optional[str] = None,
        min_severity: Optional[str] = None,
    ) -> dict:
        """The fleet timeline: every replica's scoped journal plus the
        fleet-level journal, interleaved on the rebased clock."""
        scopes = self.scopes()
        journals: Dict[str, object] = {
            rid: telemetry.journal.export()
            for rid, telemetry in scopes.items()
        }
        journals[self._name] = self.journal.export()
        return federation.merge_timelines(
            journals, n=n, kind=kind, min_severity=min_severity
        )

    def healthz(self) -> dict:
        """The fleet-level health verdict: hard fleet-SLO breaches (on
        freshly sampled gauges) degrade it, exactly like a session's
        `/healthz`."""
        self.sample()
        breaches = self.slo.breaches(evaluate=True)
        try:
            states = {
                r.replica_id: self._set.state(r.replica_id)
                for r in self._set.replicas()
            }
        except Exception:  # noqa: BLE001
            states = {}
        healthy = not breaches
        return {
            "fleet": self._name,
            "status": "ok" if healthy else "degraded",
            "healthy": healthy,
            "routable": self._routable(),
            "replicas": states,
            "breaches": breaches,
        }

    def export(self) -> dict:
        """The `/fleet-statusz` state: per-replica scrapes, the merged
        metrics view, fleet SLOs, router/rotation/probe summaries."""
        scopes = self.scopes()
        per_replica = {}
        for rid, telemetry in scopes.items():
            scrape = telemetry.scrape()
            scrape["qps"] = self._qps.get(rid)
            try:
                scrape["state"] = self._set.state(rid)
            except Exception:  # noqa: BLE001
                scrape["state"] = None
            per_replica[rid] = scrape
        with self._lock:
            samples = self._samples
            last = self._last_sample_mono
        out = {
            "name": self._name,
            "replicas": per_replica,
            "merged": self.metrics(),
            "slo": self.slo.export(),
            "samples": samples,
            "last_sample_age_s": (
                round(self._clock() - last, 3) if last is not None else None
            ),
            "timeseries": {
                "series_count": self.store.export()["series_count"],
            },
        }
        workloads = {
            rid: scrape["workload"]
            for rid, scrape in per_replica.items()
            if scrape.get("workload") is not None
        }
        if workloads:
            out["workload"] = federation.merge_workloads(workloads)
        if self._router is not None:
            out["router"] = self._router.export()
        if self._rotation is not None:
            out["rotation"] = self._rotation.export()
        if self._probe is not None:
            probe_export = dict(self._probe.export())
            probe_export.pop("history", None)
            out["probe"] = probe_export
        return out

    # -- bundles -------------------------------------------------------------

    def _add_replica_source(self, bundles, telemetry: ReplicaTelemetry):
        bundles.add_source(
            f"replica_{telemetry.replica_id}", telemetry.scrape
        )

    def wire_bundles(self, bundles):
        """Register fleet-wide sources on `bundles` and arm the
        triggers: one hard fleet-SLO burn or one probe divergence
        captures ONE bundle holding every replica's section plus the
        merged timeline (the manager's cooldown keeps a storm from
        multiplying it)."""
        with self._lock:
            self._bundles = bundles
            scopes = list(self._scopes.values())
        for telemetry in scopes:
            self._add_replica_source(bundles, telemetry)
        bundles.add_source("fleet_timeline", self.timeline)
        bundles.add_source("fleet_status", self.export)
        self.slo.add_burn_listener(bundles.on_burn)
        if self._probe is not None and callable(
            getattr(self._probe, "add_failure_listener", None)
        ):
            self._probe.add_failure_listener(bundles.on_probe_failure)
        return bundles
