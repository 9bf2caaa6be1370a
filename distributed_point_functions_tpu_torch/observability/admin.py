"""The port of the JAX package's `observability/admin.py`.

Operator telemetry endpoint: /metrics, /varz, /healthz, /statusz,
/tracez, /profilez, /eventz, /probez, /debugz, /criticalz, /capacityz,
/utilz, /timeseriesz, /workloadz, /forecastz, /fleetz, /fleet-statusz,
/fleet-timelinez — a stdlib `http.server` surface any session can hang
off a port.

The serving runtime's observability state (metrics registry, flight
recorder, stage aggregates, runtime counters, device telemetry, SLO
tracker, event journal, blackbox prober, debug bundles) is in-process;
this server is the scrape surface:

    /healthz                 liveness ("ok", 200); with an SLO tracker
                             attached, degrades to 503 while any hard
                             objective is in breach and recovers on
                             the next probe after the breach clears.
                             With a prober attached the reply is JSON
                             and gains per-kind probe freshness — a
                             bit-identity probe that has not passed
                             within its window also degrades to 503
    /metrics                 Prometheus text exposition of the registry
                             plus the observability runtime counters
    /varz                    the same state as one JSON document
                             (registry export, stage summary, uptime)
    /statusz                 operator incident page (HTML): per-role
                             phase-latency waterfall, host<->device
                             transfer ledger, auto-captured profiles,
                             compile counts and cache-hit ratios per
                             dispatch site, HBM watermarks per phase,
                             SLO burn table, probe summary, and the
                             event-journal tail; `?format=json` for
                             the same data machine-readable
    /tracez                  flight-recorder dump (slowest / errored /
                             recent traces, JSON)
    /eventz                  the unified event journal, newest last
                             (text; `?format=json`, `?kind=` prefix
                             filter, `?n=` tail length)
    /probez                  per-kind blackbox probe history and
                             freshness (JSON; requires a prober)
    /debugz                  captured incident debug bundles (JSON;
                             requires a `BundleManager`)
    /criticalz               cross-party critical-path profile: which
                             (party, phase) pairs the merged two-party
                             timelines charge critical time to, with
                             p50/p95/p99 per pair, the last merged
                             request's skew-corrected helper_rtt
                             decomposition, and skew-estimate health
                             (text; `?format=json`)
    /capacityz               cost-model accuracy ledger: per-(workload,
                             tier, shape-bucket) predicted-vs-actual
                             device-ms residual percentiles, drift
                             state, learned correction factors, and
                             throughput-calibration staleness (text;
                             `?format=json`; requires a capacity
                             accuracy export)
    /utilz                   device-utilization timeline: per-window
                             duty-cycle %, typed bubble-cause
                             breakdown, per-shard busy ratios and the
                             straggler count (text; `?format=json`)
    /timeseriesz             the in-process flight-data TSDB: one
                             sparkline per sampled series (text;
                             `?format=json` dumps every tier's points;
                             requires a `timeseries` store/sampler)
    /workloadz               live traffic characterization: per-tenant
                             arrival rate / burstiness, hot-key table
                             with count-min estimates, online Zipf
                             exponent, deadline and batch-size
                             histograms, detected periodicity (text;
                             `?format=json`; requires a `workload`
                             observatory)
    /forecastz               the predictive capacity plane: per-series
                             Holt forecasts with confidence bands and
                             predicted time-to-breach against declared
                             ceilings, plus the predictive governor's
                             current refill scale (text;
                             `?format=json`; requires a `forecast`
                             forecaster)
    /fleetz                  replica-fleet registry view: per-replica
                             health state, serving/staging generation,
                             queue depth and live price card, plus
                             state counts and the transition history
                             (JSON; requires a `fleet` export)
    /fleet-statusz           the merged fleet telemetry view: fleet SLO
                             verdict, per-replica rows (state, qps,
                             scoped journal/TSDB counts), federated
                             metric aggregates with replica labels and
                             the router's spillover summary (text;
                             `?format=json`; requires `fleet_telemetry`)
    /fleet-timelinez         every replica's event journal interleaved
                             on a monotonic-rebased fleet clock with
                             replica attribution (text; `?format=json`,
                             `?kind=`, `?n=`, `?min_severity=`;
                             requires `fleet_telemetry`)
    /profilez?duration_ms=N  on-demand `torch.profiler` capture via
                             `autoprofile.capture_profile` into a fresh
                             directory (`trace.json`, Chrome trace
                             format: the host's operators and the
                             card's kernels); returns the trace dir
                             (bounded at 60 s; one capture at a time)

The 404 reply's endpoint index is generated from the same route table
`_route` dispatches on, so it can never go stale (`routes` is the
public list).

The registry is duck-typed (`.export() -> dict`) so this layer never
imports `serving/` (serving -> observability -> utils);
`prober` is equally duck-typed (`export()`/`freshness()`) because the
prober lives *above* serving. Bind is loopback by default — the
surface is for operators, not the internet.

Uptime is computed from a monotonic clock (a wall-clock step — NTP,
leap smear, manual set — must not bend it); `started_at` keeps the
wall-clock start for display.
"""

from __future__ import annotations

import html
import http.server
import json
import logging
import threading
import time
import urllib.parse
from typing import Optional

from . import tracing
from . import critical_path as critical_path_mod
from . import events as events_mod
from .autoprofile import capture_profile
from .device import DeviceTelemetry, default_telemetry
from .phases import PhaseRecorder, default_phase_recorder
from .utilization import default_utilization_tracker

logger = logging.getLogger(__name__)

__all__ = ["AdminServer", "MAX_PROFILE_MS"]

MAX_PROFILE_MS = 60_000.0


class AdminServer:
    """Threaded HTTP admin server over the observability state.

    `registry` is anything with `export() -> dict` (a
    `serving.metrics.MetricsRegistry`); `recorder` defaults to the
    process-wide flight recorder. `port=0` picks a free port
    (`server.port` after start).
    """

    def __init__(
        self,
        registry=None,
        recorder: Optional[tracing.FlightRecorder] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "admin",
        profile_dir: Optional[str] = None,
        device: Optional[DeviceTelemetry] = None,
        slo=None,
        phases: Optional[PhaseRecorder] = None,
        autoprofiler=None,
        breakers=None,
        brownout=None,
        admission=None,
        journal=None,
        prober=None,
        bundles=None,
        critical=None,
        capacity=None,
        snapshots=None,
        mesh=None,
        utilization=None,
        timeseries=None,
        workload=None,
        forecast=None,
        governor=None,
        fleet=None,
        fleet_telemetry=None,
        identity=None,
    ):
        self._registry = registry
        self._recorder = (
            recorder if recorder is not None else tracing.default_recorder()
        )
        # device defaults to the process-wide telemetry every dispatch
        # site reports into; slo (an `slo.SloTracker` or anything with
        # `breaches()`/`export()`) is opt-in — without one, /healthz
        # stays a bare liveness probe.
        self._device = device if device is not None else default_telemetry()
        self._slo = slo
        # phases defaults to the process-wide recorder the serving paths
        # report into; autoprofiler (an `autoprofile.AutoProfiler` or
        # anything with `export()`) is opt-in.
        self._phases = (
            phases if phases is not None else default_phase_recorder()
        )
        self._autoprofiler = autoprofiler
        # breakers: {name: breaker} where each value is duck-typed
        # (anything with `export() -> dict`, in production a
        # `robustness.CircuitBreaker` or a session's `breaker_export`
        # via a small adapter). Opt-in; /statusz grows a "Circuit
        # breakers" section when present.
        self._breakers = breakers
        # brownout (`capacity.BrownoutController`) and admission
        # (`capacity.AdmissionController`) are duck-typed
        # (`export() -> dict`) and opt-in; /statusz grows a "Brownout
        # ladder" needle and a per-tenant admission table when present.
        self._brownout = brownout
        self._admission = admission
        # journal defaults to the process-global event journal (the
        # library's emit sites all land there); prober (a
        # `serving.prober.Prober` or anything with `export()` +
        # `freshness()`) and bundles (`bundle.BundleManager`) are
        # opt-in. Handing over a BundleManager auto-registers the
        # standard snapshot sources on it.
        self._journal = (
            journal if journal is not None else events_mod.default_journal()
        )
        self._prober = prober
        self._bundles = bundles
        # critical defaults to the process-wide cross-party analyzer the
        # Leader paths report into (`critical_path.install`).
        self._critical = (
            critical
            if critical is not None
            else critical_path_mod.default_analyzer()
        )
        # capacity (`capacity.recalibrate.CapacityAccuracy`) is
        # duck-typed (`export() -> dict` with "ledger"/"model"/
        # "recalibration" keys) and opt-in; it backs /capacityz and a
        # "Cost-model accuracy" section on /statusz.
        self._capacity = capacity
        # snapshots (`serving.snapshots.SnapshotManager`) is duck-typed
        # (`export() -> dict` with serving/staging generations, drain
        # refcounts and flip history) and opt-in; /statusz grows a
        # "Snapshots" section when present.
        self._snapshots = snapshots
        # mesh is the pod-scale serving export: a zero-arg callable (a
        # `DenseDpfPirServer.mesh_export` bound method) or anything
        # with `export() -> dict` — mesh shape, plan, per-shard staging
        # bytes/copies and HBM watermarks. Opt-in; /statusz grows a
        # "Mesh" section when present.
        self._mesh = mesh
        # utilization defaults to the process-wide tracker the serving
        # hooks report into (`utilization.default_utilization_tracker`);
        # timeseries is a `timeseries.MetricsSampler` (or a bare
        # `TimeSeriesStore` — anything with `.store` or
        # `series()/export()`), opt-in. A sampler handed over here is
        # stopped with the server.
        self._utilization = (
            utilization
            if utilization is not None
            else default_utilization_tracker()
        )
        self._timeseries = timeseries
        # workload (`workload.WorkloadObservatory`) and forecast
        # (`forecast.Forecaster`) are the traffic-characterization and
        # predictive-capacity planes; governor is a
        # `capacity.PredictiveGovernor` (duck-typed `export()` —
        # capacity sits above this layer). All three are opt-in:
        # workload backs /workloadz, forecast backs /forecastz (and a
        # /statusz section), governor folds into /capacityz.
        self._workload = workload
        self._forecast = forecast
        self._governor = governor
        # fleet is the replica-fleet registry view: a zero-arg callable
        # or anything with `export() -> dict` (a `fleet.ReplicaSet` —
        # duck-typed because fleet/ sits ABOVE this layer). identity is
        # a static {"replica_id", "role", ...} dict stamped onto /varz
        # and /statusz so every scrape of a fleet member says which
        # replica (and which serving generation, read live from
        # `snapshots`) produced it.
        self._fleet = fleet
        # fleet_telemetry is the merged fleet telemetry plane (a
        # `fleet.telemetry.FleetTelemetry` — duck-typed here because
        # fleet/ sits ABOVE this layer: anything with `export()`,
        # `timeline(n=, kind=, min_severity=)`, and `healthz()`).
        # Opt-in; backs /fleet-statusz and /fleet-timelinez, and folds
        # its verdict into /healthz (a fleet below its routable floor
        # must drain at the front door, not per replica).
        self._fleet_telemetry = fleet_telemetry
        self._identity = dict(identity) if identity else None
        self._name = name
        self._profile_dir = profile_dir
        self._profile_lock = threading.Lock()
        # Monotonic for arithmetic, wall for display: an NTP step must
        # never produce a negative (or century-long) uptime.
        self._started_mono = time.monotonic()
        self._started_unix = time.time()
        if bundles is not None:
            bundles.add_source("statusz", self._status_state)
            bundles.add_source("metrics", self._merged_export)
            bundles.add_source("traces", self._recorder.dump)
            bundles.add_source(
                "events", lambda: self._journal.export()
            )
            if prober is not None:
                bundles.add_source("probes", prober.export)
            if capacity is not None:
                bundles.add_source("capacity", capacity.export)
            if snapshots is not None:
                bundles.add_source("snapshots", snapshots.export)
            if mesh is not None:
                bundles.add_source("mesh", self._mesh_state)
            bundles.add_source(
                "utilization", self._utilization.export
            )
            if timeseries is not None:
                bundles.add_source("timeseries", self._timeseries_state)
            if workload is not None:
                bundles.add_source("workload", workload.export)
            if forecast is not None:
                bundles.add_source("forecast", forecast.export)
            if fleet is not None:
                bundles.add_source("fleet", self._fleet_state)
            if fleet_telemetry is not None:
                bundles.add_source(
                    "fleet_telemetry", fleet_telemetry.export
                )
        # The dispatch table IS the endpoint index: `_route` looks
        # paths up here and the 404 body is generated from the same
        # rows, so the "try ..." list can never go stale.
        self._routes = (
            ("/healthz", self._healthz),
            ("/metrics", self._metricsz),
            ("/varz", self._varz),
            ("/statusz", self._statusz),
            ("/tracez", self._tracez),
            ("/eventz", self._eventz),
            ("/probez", self._probez),
            ("/debugz", self._debugz),
            ("/criticalz", self._criticalz),
            ("/capacityz", self._capacityz),
            ("/utilz", self._utilz),
            ("/timeseriesz", self._timeseriesz),
            ("/workloadz", self._workloadz),
            ("/forecastz", self._forecastz),
            ("/fleetz", self._fleetz),
            ("/fleet-statusz", self._fleet_statusz),
            ("/fleet-timelinez", self._fleet_timelinez),
            ("/profilez", self._profilez),
        )
        self._route_map = dict(self._routes)
        self._unknown_body = (
            "unknown endpoint; try "
            + " ".join(path for path, _ in self._routes)
            + "\n"
        ).encode()
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # The default handler logs every request to stderr.
            def log_message(self, fmt, *args):  # noqa: D102
                logger.debug("[%s] %s", outer._name, fmt % args)

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    outer._route(self)
                except BrokenPipeError:  # scraper went away mid-reply
                    pass
                except Exception as e:  # noqa: BLE001 - keep serving
                    logger.exception("[%s] %s failed", outer._name,
                                     self.path)
                    try:
                        outer._reply(
                            self, 500, "text/plain; charset=utf-8",
                            f"internal error: {e}\n".encode(),
                        )
                    except OSError:
                        pass

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _reply(handler, status: int, ctype: str, body: bytes) -> None:
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _merged_export(self) -> dict:
        export = (
            self._registry.export()
            if self._registry is not None
            else {"counters": {}, "gauges": {}, "histograms": {}}
        )
        export = {
            "counters": dict(export.get("counters", {})),
            "gauges": dict(export.get("gauges", {})),
            "histograms": dict(export.get("histograms", {})),
        }
        for name, value in tracing.runtime_counters.export().items():
            export["counters"].setdefault(name, value)
        return export

    def _uptime_s(self) -> float:
        return round(time.monotonic() - self._started_mono, 1)

    def _mesh_state(self) -> Optional[dict]:
        if self._mesh is None:
            return None
        source = getattr(self._mesh, "export", self._mesh)
        return source() if callable(source) else None

    def _fleet_state(self) -> Optional[dict]:
        if self._fleet is None:
            return None
        source = getattr(self._fleet, "export", self._fleet)
        return source() if callable(source) else None

    def _identity_state(self) -> Optional[dict]:
        """The stable replica identity plus the LIVE serving generation
        (identity says who this scrape came from; the generation says
        which database it was answering with at scrape time)."""
        if self._identity is None:
            return None
        state = dict(self._identity)
        if self._snapshots is not None:
            state["serving_generation"] = (
                self._snapshots.serving_generation()
            )
        return state

    @property
    def routes(self) -> tuple:
        """The dispatched endpoint paths, in index order (the same
        rows the 404 body is generated from)."""
        return tuple(path for path, _ in self._routes)

    def _route(self, handler) -> None:
        parsed = urllib.parse.urlsplit(handler.path)
        path = parsed.path.rstrip("/") or "/"
        target = self._route_map.get(path)
        if target is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                self._unknown_body,
            )
            return
        target(handler, parsed.query)

    def _metricsz(self, handler, query: str = "") -> None:
        from .exposition import render_prometheus

        body = render_prometheus(self._merged_export()).encode()
        self._reply(
            handler, 200,
            "text/plain; version=0.0.4; charset=utf-8", body,
        )

    def _varz(self, handler, query: str = "") -> None:
        body = json.dumps(
            {
                "name": self._name,
                "uptime_s": self._uptime_s(),
                "started_at": self._started_unix,
                "identity": self._identity_state(),
                "metrics": self._merged_export(),
                "stages": tracing.stage_summary(),
            },
            indent=2, default=str,
        ).encode()
        self._reply(handler, 200, "application/json", body)

    def _tracez(self, handler, query: str = "") -> None:
        body = json.dumps(
            self._recorder.dump(), indent=2, default=str
        ).encode()
        self._reply(handler, 200, "application/json", body)

    def _healthz(self, handler, query: str = "") -> None:
        breaches = (
            self._slo.breaches(evaluate=True)
            if self._slo is not None
            else []
        )
        # Fleet verdict (opt-in): a hard fleet-SLO breach — routable
        # replicas below the floor, stale divergence probes — degrades
        # this endpoint the same way a local SLO breach does.
        fleet_verdict = None
        if self._fleet_telemetry is not None:
            try:
                fleet_verdict = self._fleet_telemetry.healthz()
            except Exception as e:  # noqa: BLE001 - verdict must not 500
                fleet_verdict = {
                    "healthy": False,
                    "status": f"error: {type(e).__name__}",
                }
        fleet_ok = fleet_verdict is None or bool(
            fleet_verdict.get("healthy")
        )
        if self._prober is None:
            # Legacy shape: bare liveness text, 503 on hard SLO breach.
            if not breaches and fleet_ok:
                self._reply(
                    handler, 200, "text/plain; charset=utf-8", b"ok\n"
                )
                return
            lines = "".join(
                f"slo breach: {b['name']} ({b['metric']} observed "
                f"{b['observed']} vs {b['threshold']}, "
                f"burning {b['burn_s']}s)\n"
                for b in breaches
            )
            if not fleet_ok:
                lines += "".join(
                    f"fleet breach: {b['name']} ({b['metric']} observed "
                    f"{b['observed']} vs {b['threshold']})\n"
                    for b in (fleet_verdict or {}).get("breaches", [])
                ) or "fleet: degraded\n"
            self._reply(
                handler, 503, "text/plain; charset=utf-8",
                ("unhealthy\n" + lines).encode(),
            )
            return
        # With a prober attached the reply is JSON and gains probe
        # freshness: a serving process whose bit-identity probes have
        # not passed within their window may be serving wrong bits with
        # 200s everywhere else — that is exactly what must drain it.
        freshness = self._prober.freshness()
        stale = sorted(
            k for k, v in freshness.items() if not v.get("fresh", True)
        )
        healthy = not breaches and not stale and fleet_ok
        detail = {
            "status": "ok" if healthy else "unhealthy",
            "slo_breaches": breaches,
            "probes": freshness,
            "stale_probes": stale,
        }
        if fleet_verdict is not None:
            detail["fleet"] = fleet_verdict
        self._reply(
            handler,
            200 if healthy else 503,
            "application/json",
            json.dumps(detail, indent=2, default=str).encode(),
        )

    def _eventz(self, handler, query: str) -> None:
        params = urllib.parse.parse_qs(query)
        kind = params.get("kind", [None])[0]
        try:
            n = int(params.get("n", ["64"])[0])
        except ValueError:
            self._reply(
                handler, 400, "text/plain; charset=utf-8",
                b"n must be an integer\n",
            )
            return
        events = self._journal.tail(n=n, kind=kind)
        if params.get("format", [""])[0] == "json":
            body = json.dumps(
                {
                    "journal": {
                        k: v
                        for k, v in self._journal.export().items()
                        if k != "events"
                    },
                    "events": events,
                },
                indent=2, default=str,
            ).encode()
            self._reply(handler, 200, "application/json", body)
            return
        lines = [
            f"# {self._name} event journal "
            f"(newest last; ?format=json ?kind= ?n=)"
        ]
        for e in events:
            extra = {
                k: v
                for k, v in e.items()
                if k not in (
                    "seq", "t_wall", "t_mono", "kind", "severity",
                    "message", "trace_id",
                )
            }
            when = time.strftime(
                "%H:%M:%S", time.localtime(e["t_wall"])
            )
            lines.append(
                f"{e['seq']:>6} {when} [{e['severity']:>7}] "
                f"{e['kind']:<24} {e['message']}"
                + (f"  {extra}" if extra else "")
                + (
                    f"  trace={e['trace_id']}"
                    if e.get("trace_id")
                    else ""
                )
            )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _probez(self, handler, query: str = "") -> None:
        if self._prober is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no prober attached\n",
            )
            return
        body = json.dumps(
            self._prober.export(), indent=2, default=str
        ).encode()
        self._reply(handler, 200, "application/json", body)

    def _debugz(self, handler, query: str = "") -> None:
        if self._bundles is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no bundle manager attached\n",
            )
            return
        body = json.dumps(
            self._bundles.export(), indent=2, default=str
        ).encode()
        self._reply(handler, 200, "application/json", body)

    def _criticalz(self, handler, query: str) -> None:
        params = urllib.parse.parse_qs(query)
        state = self._critical.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        lines = [
            f"# {self._name} cross-party critical path "
            f"(?format=json for machine-readable)",
            f"merged requests: {state['requests']}  "
            f"invalid skew estimates: {state['skew_invalid']}",
        ]
        legs = state.get("legs") or {}
        if legs:
            total = sum(legs.values()) or 1
            lines.append(
                "critical leg: "
                + "  ".join(
                    f"{leg}={n} ({n / total * 100:.1f}%)"
                    for leg, n in sorted(legs.items())
                )
            )
        last = state.get("last") or {}
        for role, s in last.items():
            lines.append(f"last merged request [{role}]:")
            if "helper_net_ms" in s:
                lines.append(
                    f"  critical leg {s['critical_leg']}; rtt "
                    f"{s['rtt_ms']} ms (exchange "
                    f"{s.get('exchange_ms', '-')} ms) = net "
                    f"{s['helper_net_ms']} + queue "
                    f"{s['helper_queue_ms']} + compute "
                    f"{s['helper_compute_ms']}; own-share "
                    f"{s['own_ms']} ms"
                )
            else:
                lines.append(
                    f"  critical leg {s['critical_leg']}; rtt "
                    f"{s['rtt_ms']} ms; own-share {s['own_ms']} ms; "
                    f"no valid decomposition (skew invalid or v1 peer)"
                )
            if "offset_ms" in s:
                lines.append(
                    f"  clock offset {s['offset_ms']} ms "
                    f"+/- {s.get('uncertainty_ms', '-')} ms "
                    f"(valid={s.get('skew_valid')}, "
                    f"uncertain={s.get('uncertain', False)})"
                )
        profile = state.get("profile") or {}
        if not profile:
            lines.append("no critical time attributed yet")
        for party, phases in profile.items():
            lines.append(f"critical time by phase [{party}]:")
            lines.append(
                f"  {'phase':<16}{'count':>7}{'p50 ms':>10}"
                f"{'p95 ms':>10}{'p99 ms':>10}{'share':>8}"
            )
            for phase, entry in phases.items():
                lines.append(
                    f"  {phase:<16}{entry['count']:>7}"
                    f"{entry['p50_ms']:>10}{entry['p95_ms']:>10}"
                    f"{entry['p99_ms']:>10}"
                    f"{entry['share'] * 100:>7.1f}%"
                )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _capacityz(self, handler, query: str) -> None:
        if self._capacity is None and self._governor is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no capacity accuracy export attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        state = self._capacity.export() if self._capacity is not None else {}
        if self._governor is not None:
            state["governor"] = self._governor.export()
            admission = getattr(self._governor, "admission", None)
            if admission is not None:
                state["admission"] = admission.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        ledger = state.get("ledger") or {}
        cells = ledger.get("cells") or {}
        drifting = ledger.get("drifting") or []
        lines = [
            f"# {self._name} cost-model accuracy "
            f"(?format=json for machine-readable)",
            f"samples: {ledger.get('total_samples', 0)}  "
            f"unpriced: {ledger.get('total_unpriced', 0)}  "
            f"window: {ledger.get('window_size')}  "
            f"drift band: +/-{ledger.get('drift_band')} "
            f"for {ledger.get('drift_windows')} windows",
        ]
        if drifting:
            lines.append(
                "DRIFTING: " + "  ".join(sorted(drifting))
            )
        if not cells:
            lines.append("no priced batches observed yet")
        else:
            lines.append(
                f"{'cell':<28}{'n':>6}{'p50':>9}{'p95':>9}{'p99':>9}"
                f"{'pred ms':>10}{'actual ms':>11}{'win p50':>9}"
                f"{'drift':>7}"
            )
            for key in sorted(cells):
                c = cells[key]
                win = c.get("last_window_p50")
                lines.append(
                    f"{key:<28}{c['samples']:>6}"
                    f"{c['residual_p50']:>+9.3f}"
                    f"{c['residual_p95']:>+9.3f}"
                    f"{c['residual_p99']:>+9.3f}"
                    f"{c['mean_predicted_ms']:>10.3f}"
                    f"{c['mean_actual_ms']:>11.3f}"
                    f"{'-' if win is None else f'{win:+.3f}':>9}"
                    f"{'YES' if c.get('drifting') else '-':>7}"
                )
                worst = c.get("worst")
                if worst and worst.get("trace_id"):
                    lines.append(
                        f"  worst residual {worst['residual']:+.3f} "
                        f"trace={worst['trace_id']}"
                    )
        recal = state.get("recalibration")
        if recal is not None:
            status = "enabled" if recal.get("enabled") else (
                f"DISABLED via {recal.get('kill_switch_env')} "
                f"(pricing raw)"
            )
            factors = recal.get("factors") or {}
            factor_txt = (
                "  ".join(
                    f"{k}=x{v}" for k, v in sorted(factors.items())
                )
                or "none learned"
            )
            lines.append(
                f"recalibration: {status}; alpha {recal.get('alpha')}, "
                f"clamp {recal.get('clamp')}, min samples "
                f"{recal.get('min_samples')}"
            )
            lines.append(f"correction factors: {factor_txt}")
        model = state.get("model") or {}
        calib = model.get("calibration") or {}
        metrics = calib.get("metrics") or {}
        lines.append(
            f"throughput calibration ({calib.get('history_path')}): "
            + ("STALE" if calib.get("stale") else "fresh")
        )
        for metric, entry in sorted(metrics.items()):
            age = entry.get("age_s")
            lines.append(
                f"  {metric} = {entry.get('value')} "
                f"(age {'-' if age is None else f'{age:.0f} s'}, "
                f"{'STALE' if entry.get('stale') else 'fresh'})"
            )
        if not metrics:
            lines.append(
                "  no calibrated records; pricing from conservative "
                "defaults"
            )
        skipped = calib.get("skipped_records") or {}
        if skipped:
            lines.append(
                "  skipped records: "
                + "  ".join(
                    f"{status}={n}" for status, n in sorted(skipped.items())
                )
            )
        governor = state.get("governor")
        if governor is not None:
            ttb = governor.get("time_to_breach_s")
            lines.append(
                f"predictive governor: scale x{governor.get('scale')} "
                f"(time-to-breach "
                f"{'-' if ttb is None else f'{ttb:.0f} s'}, "
                f"horizon {governor.get('horizon_s')} s, "
                f"floor {governor.get('floor')}, "
                f"tightenings {governor.get('tightenings', 0)})"
            )
            admission = state.get("admission") or {}
            for tenant, entry in sorted(
                (admission.get("tenants") or {}).items()
            ):
                if entry.get("rate_qps") is None:
                    continue
                lines.append(
                    f"  {tenant}: rate {entry['rate_qps']} -> "
                    f"{entry.get('effective_rate_qps')} q/s "
                    f"(tokens {entry.get('tokens')})"
                )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    # -- /statusz -----------------------------------------------------------

    def _status_state(self) -> dict:
        state = {
            "name": self._name,
            "uptime_s": self._uptime_s(),
            "started_at": self._started_unix,
            "identity": self._identity_state(),
            "device": self._device.export(),
            "slo": self._slo.export() if self._slo is not None else None,
            "phases": self._phases.waterfall(),
            "profiles": (
                self._autoprofiler.export()
                if self._autoprofiler is not None
                else None
            ),
            "breakers": (
                {
                    name: breaker.export()
                    for name, breaker in self._breakers.items()
                }
                if self._breakers
                else None
            ),
            "brownout": (
                self._brownout.export()
                if self._brownout is not None
                else None
            ),
            "admission": (
                self._admission.export()
                if self._admission is not None
                else None
            ),
            "critical": self._critical.export(),
            "capacity": (
                self._capacity.export()
                if self._capacity is not None
                else None
            ),
            "snapshots": (
                self._snapshots.export()
                if self._snapshots is not None
                else None
            ),
            "mesh": self._mesh_state(),
            "prober": (
                self._prober.export()
                if self._prober is not None
                else None
            ),
            "bundles": (
                self._bundles.export()
                if self._bundles is not None
                else None
            ),
            "workload": (
                self._workload.export()
                if self._workload is not None
                else None
            ),
            # last_run, not export(): /statusz must not trigger a fresh
            # forecast pass on every scrape.
            "forecast": (
                self._forecast.last_run()
                if self._forecast is not None
                else None
            ),
            "governor": (
                self._governor.export()
                if self._governor is not None
                else None
            ),
            "events": {
                "kinds": self._journal.kinds(),
                "tail": self._journal.tail(n=32),
            },
        }
        return state

    def _statusz(self, handler, query: str) -> None:
        params = urllib.parse.parse_qs(query)
        state = self._status_state()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        self._reply(
            handler, 200, "text/html; charset=utf-8",
            _render_statusz(state).encode(),
        )

    def _utilz(self, handler, query: str = "") -> None:
        params = urllib.parse.parse_qs(query)
        state = self._utilization.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        totals = state.get("totals", {})
        duty = totals.get("duty_cycle_pct")
        lines = [
            f"# {self._name} device utilization "
            f"(?format=json for machine-readable)",
            f"enabled: {state.get('enabled')}  "
            f"window: {state.get('window_s')}s  "
            f"stragglers: {state.get('stragglers', 0)}",
            "overall duty cycle: "
            + (f"{duty:.1f}%" if duty is not None else "no data")
            + f"  busy: {totals.get('busy_s', 0.0):.3f}s"
            + f"  idle: {totals.get('idle_total_s', 0.0):.3f}s",
        ]
        idle = totals.get("idle_s") or {}
        if idle:
            lines.append("bubble breakdown (idle seconds by cause):")
            total_idle = sum(idle.values()) or 1.0
            for cause, seconds in sorted(
                idle.items(), key=lambda kv: -kv[1]
            ):
                lines.append(
                    f"  {cause:<16} {seconds:>10.3f}s "
                    f"({seconds / total_idle * 100:5.1f}%)"
                )
        p50 = totals.get("bubble_ms_p50")
        p99 = totals.get("bubble_ms_p99")
        if p99 is not None:
            lines.append(
                f"bubble p50/p99: {p50:.2f}/{p99:.2f} ms "
                f"over {totals.get('bubbles', 0)} bubbles"
            )
        windows = state.get("windows") or []
        if windows:
            lines.append(f"windows ({len(windows)} closed, newest last):")
            for w in windows[-12:]:
                worst = max(
                    w["idle_s"].items(), key=lambda kv: kv[1]
                )[0] if w["idle_s"] else "-"
                lines.append(
                    f"  t={w['t_start']:.1f} duty={w['duty_cycle_pct']:5.1f}% "
                    f"feed={w['device_feed_efficiency']:.3f} "
                    f"busy={w['busy_s']:.3f}s idle={w['idle_total_s']:.3f}s "
                    f"worst_bubble={worst}"
                )
        shards = state.get("shards") or {}
        if shards:
            lines.append("per-shard busy seconds:")
            for shard, entry in sorted(shards.items()):
                lines.append(
                    f"  shard {shard}: {entry['busy_s']:.3f}s"
                )
        threads = state.get("threads") or {}
        if threads:
            lines.append(
                "threads: " + "  ".join(
                    f"{name}(busy={t['busy_s']:.3f}s "
                    f"idle={t['idle_s']:.3f}s)"
                    for name, t in sorted(threads.items())
                )
            )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _timeseries_store(self):
        """The underlying `TimeSeriesStore` — `timeseries` may be the
        sampler (has `.store`) or the store itself."""
        if self._timeseries is None:
            return None
        return getattr(self._timeseries, "store", self._timeseries)

    def _timeseries_state(self) -> Optional[dict]:
        store = self._timeseries_store()
        if store is None:
            return None
        state = {"store": store.export()}
        sampler_export = getattr(self._timeseries, "export", None)
        if callable(sampler_export) and self._timeseries is not store:
            state["sampler"] = sampler_export()
        return state

    def _timeseriesz(self, handler, query: str = "") -> None:
        store = self._timeseries_store()
        if store is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no timeseries store attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        if params.get("format", [""])[0] == "json":
            body = json.dumps(
                self._timeseries_state(), indent=2, default=str
            ).encode()
            self._reply(handler, 200, "application/json", body)
            return
        from .timeseries import render_sparklines

        try:
            tier = int(params.get("tier", ["0"])[0])
        except ValueError:
            tier = 0
        export = store.export()
        header = [
            f"# {self._name} flight-data timeseries "
            f"(?format=json for machine-readable, ?tier=N)",
            "tiers: " + "  ".join(
                f"[{i}] {t['step_s']:g}s x {t['slots']}"
                for i, t in enumerate(export.get("tiers", []))
            ),
            f"series: {export.get('series_count', 0)}"
            f"/{export.get('max_series', 0)}"
            f"  dropped: {export.get('dropped_series', 0)}"
            f"  samples: {export.get('samples', 0)}",
            "",
        ]
        body = "\n".join(header) + render_sparklines(
            store, tier=tier
        ) + "\n"
        self._reply(
            handler, 200, "text/plain; charset=utf-8", body.encode()
        )

    def _workloadz(self, handler, query: str = "") -> None:
        """Live traffic characterization (text; ?format=json)."""
        if self._workload is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no workload observatory attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        state = self._workload.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        lines = [
            f"# {self._name} workload observatory "
            f"(?format=json for machine-readable)",
            f"observations: {state.get('observations', 0)}  "
            f"keys: {state.get('keys_observed', 0)}  "
            f"rate: {state.get('rate_qps')} q/s  "
            f"burstiness cv2: {state.get('burstiness_cv2')}",
            f"zipf exponent: {state.get('zipf_exponent')}  "
            f"hot share: {state.get('hot_share_pct')}%",
        ]
        periodicity = state.get("periodicity")
        if periodicity:
            lines.append(
                f"periodicity: {periodicity['period_s']:g} s "
                f"(strength {periodicity['strength']})"
            )
        sketch = state.get("sketch") or {}
        lines.append(
            f"sketch: {sketch.get('width')}x{sketch.get('depth')} "
            f"error bound +/-{sketch.get('error_bound')} "
            f"({sketch.get('total', 0)} keys)"
        )
        top = state.get("top_keys") or []
        if top:
            lines.append(f"{'key':>12}{'count':>10}{'err':>8}{'share':>8}")
            for entry in top[:16]:
                lines.append(
                    f"{entry['key']:>12}{entry['count']:>10}"
                    f"{entry['error']:>8}"
                    f"{entry['share_pct']:>7.1f}%"
                )
        tenants = state.get("tenants") or {}
        if tenants:
            lines.append("per-tenant:")
            for tenant, entry in sorted(tenants.items()):
                lines.append(
                    f"  {tenant:<16} rate {entry.get('rate_qps')} q/s  "
                    f"cv2 {entry.get('burstiness_cv2')}  "
                    f"share {entry.get('share_pct')}%"
                )
        for title, key in (
            ("deadline ms", "deadline_ms"),
            ("batch keys", "batch_keys"),
        ):
            hist = (state.get(key) or {}).get("buckets") or {}
            if any(hist.values()):
                lines.append(
                    f"{title}: " + "  ".join(
                        f"<={bound}:{n}" for bound, n in hist.items() if n
                    )
                )
        lines.append(
            f"memory: {state.get('approx_bytes')} / "
            f"{state.get('byte_budget')} bytes "
            f"({'within' if state.get('within_budget') else 'OVER'} budget)"
        )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _forecastz(self, handler, query: str = "") -> None:
        """Predictive capacity plane (text; ?format=json)."""
        if self._forecast is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no forecaster attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        state = self._forecast.export()
        if self._governor is not None:
            state["governor"] = self._governor.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(state, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        min_ttb = state.get("min_time_to_breach_s")
        lines = [
            f"# {self._name} capacity forecast "
            f"(?format=json for machine-readable)",
            f"window: {state.get('window_s'):g} s  "
            f"horizon: {state.get('horizon_s'):g} s  "
            f"page horizon: {state.get('page_horizon_s'):g} s",
            "earliest predicted breach: "
            + (
                f"{min_ttb:.0f} s"
                if min_ttb is not None
                else "none inside horizon"
            ),
        ]
        paging = state.get("paging") or []
        if paging:
            lines.append("PAGING: " + "  ".join(paging))
        for entry in state.get("series") or []:
            ttb = entry.get("time_to_breach_earliest_s")
            lines.append(
                f"{entry['label']}: state={entry['state']} "
                f"last={entry.get('last')} level={entry.get('level')} "
                f"trend/s={entry.get('trend_per_s')} "
                f"ceiling={entry.get('ceiling')} "
                f"breach in "
                + ("-" if ttb is None else f"{ttb:.0f} s")
            )
        governor = state.get("governor")
        if governor is not None:
            lines.append(
                f"governor: scale x{governor.get('scale')} "
                f"(tightenings {governor.get('tightenings', 0)})"
            )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _fleetz(self, handler, query: str = "") -> None:
        state = self._fleet_state()
        if state is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no fleet attached\n",
            )
            return
        body = json.dumps(state, indent=2, default=str).encode()
        self._reply(handler, 200, "application/json", body)

    def _fleet_statusz(self, handler, query: str = "") -> None:
        """Merged fleet status: per-replica rows + federated aggregates
        + fleet SLO verdict (text; ?format=json)."""
        if self._fleet_telemetry is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no fleet telemetry attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        verdict = self._fleet_telemetry.healthz()
        state = self._fleet_telemetry.export()
        if params.get("format", [""])[0] == "json":
            body = json.dumps(
                {"verdict": verdict, **state}, indent=2, default=str
            ).encode()
            self._reply(handler, 200, "application/json", body)
            return
        lines = [
            f"# fleet status ({state.get('name', 'fleet')}; ?format=json)",
            f"verdict: {verdict['status']}  "
            f"routable={verdict.get('routable')}  "
            f"samples={state.get('samples')}",
            "",
            "slo:",
        ]
        for o in state.get("slo", {}).get("objectives", []):
            lines.append(
                f"  {o['name']:<28} {o['state']:<8} "
                f"observed={o['observed']} vs {o['threshold']} "
                f"[{o['severity']}] burn={o['burn_s']}s"
            )
        lines.append("")
        lines.append("replicas:")
        for rid, row in sorted(state.get("replicas", {}).items()):
            ts = row.get("timeseries", {})
            lines.append(
                f"  {rid:<10} state={row.get('state')} "
                f"qps={row.get('qps')} "
                f"series={ts.get('series_count')} "
                f"journal_events="
                f"{row.get('journal', {}).get('emitted', 0)}"
            )
        merged = state.get("merged", {})
        fleet_gauges = merged.get("fleet", {}).get("gauges", {})
        if fleet_gauges:
            lines.append("")
            lines.append("fleet gauges:")
            for name, value in sorted(fleet_gauges.items()):
                lines.append(f"  {name:<40} {value}")
        router = state.get("router")
        if router:
            lines.append("")
            lines.append(
                f"router: spillovers={router.get('spillovers')} "
                f"rate={router.get('spillover_rate_pct')}% "
                f"storms={router.get('spillover_storms')} "
                f"fleet_sheds={router.get('fleet_sheds')}"
            )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _fleet_timelinez(self, handler, query: str = "") -> None:
        """Cross-replica event timeline, causally ordered on the
        rebased clock (text; ?format=json ?kind= ?n= ?min_severity=)."""
        if self._fleet_telemetry is None:
            self._reply(
                handler, 404, "text/plain; charset=utf-8",
                b"no fleet telemetry attached\n",
            )
            return
        params = urllib.parse.parse_qs(query)
        kind = params.get("kind", [None])[0]
        min_severity = params.get("min_severity", [None])[0]
        try:
            n = int(params.get("n", ["128"])[0])
        except ValueError:
            self._reply(
                handler, 400, "text/plain; charset=utf-8",
                b"n must be an integer\n",
            )
            return
        timeline = self._fleet_telemetry.timeline(
            n=n, kind=kind, min_severity=min_severity
        )
        if params.get("format", [""])[0] == "json":
            body = json.dumps(timeline, indent=2, default=str).encode()
            self._reply(handler, 200, "application/json", body)
            return
        lines = [
            "# fleet timeline (newest last; rebased cross-replica clock;"
            " ?format=json ?kind= ?n= ?min_severity=)",
            "replicas: " + " ".join(timeline.get("replicas", [])),
        ]
        for e in timeline.get("events", []):
            t_fleet = e.get("t_fleet")
            when = (
                time.strftime("%H:%M:%S", time.localtime(t_fleet))
                if t_fleet is not None
                else "--:--:--"
            )
            lines.append(
                f"{when} {str(e.get('replica', '?')):<10} "
                f"[{e['severity']:>7}] {e['kind']:<24} {e['message']}"
            )
        self._reply(
            handler, 200, "text/plain; charset=utf-8",
            ("\n".join(lines) + "\n").encode(),
        )

    def _profilez(self, handler, query: str) -> None:
        params = urllib.parse.parse_qs(query)
        try:
            duration_ms = float(params.get("duration_ms", ["1000"])[0])
        except ValueError:
            self._reply(
                handler, 400, "text/plain; charset=utf-8",
                b"duration_ms must be a number\n",
            )
            return
        duration_ms = min(max(duration_ms, 1.0), MAX_PROFILE_MS)
        if not self._profile_lock.acquire(blocking=False):
            self._reply(
                handler, 409, "text/plain; charset=utf-8",
                b"a profile capture is already running\n",
            )
            return
        try:
            # The capture window: serving threads keep running; the
            # profiler records them while this handler sleeps.
            body = json.dumps(
                capture_profile(self._profile_dir, self._name, duration_ms),
                indent=2,
            ).encode()
        finally:
            self._profile_lock.release()
        self._reply(handler, 200, "application/json", body)

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def registry(self):
        return self._registry

    def start(self) -> "AdminServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"{self._name}-http",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        # A sampler handed over as `timeseries` shares the server's
        # lifecycle: stop its background thread before the listener so
        # nothing keeps sampling a dead surface.
        sampler_stop = getattr(self._timeseries, "stop", None)
        if callable(sampler_stop):
            try:
                sampler_stop()
            except Exception:  # noqa: BLE001 - shutdown keeps going
                pass
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# /statusz rendering (server-side HTML, no JS, survives a pager-duty curl)
# ---------------------------------------------------------------------------

_STATUSZ_STYLE = (
    "<style>body{font-family:monospace;margin:1.5em}"
    "table{border-collapse:collapse;margin:0.5em 0}"
    "td,th{border:1px solid #999;padding:2px 8px;text-align:left}"
    "th{background:#eee}.breach{background:#fdd}.ok{background:#dfd}"
    ".nodata{color:#777}</style>"
)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"  # pragma: no cover - loop always returns


def _render_statusz(state: dict) -> str:
    esc = html.escape
    out = [
        "<!doctype html><html><head><title>statusz</title>",
        _STATUSZ_STYLE,
        "</head><body>",
        f"<h1>{esc(str(state['name']))} /statusz</h1>",
        f"<p>uptime: {state['uptime_s']} s</p>",
    ]
    identity = state.get("identity")
    if identity is not None:
        out.append(
            "<p>"
            + " &middot; ".join(
                f"{esc(str(k))}: <b>{esc(str(v))}</b>"
                for k, v in identity.items()
            )
            + "</p>"
        )

    slo = state.get("slo")
    out.append("<h2>SLO burn</h2>")
    if slo is None:
        out.append("<p class=nodata>no SLO tracker attached</p>")
    else:
        health = "healthy" if slo["healthy"] else "UNHEALTHY (hard breach)"
        cls = "ok" if slo["healthy"] else "breach"
        out.append(f"<p class={cls}>{health}</p>")
        out.append(
            "<table><tr><th>objective</th><th>kind</th><th>metric</th>"
            "<th>observed</th><th>threshold</th><th>severity</th>"
            "<th>state</th><th>burn</th></tr>"
        )
        for r in slo["objectives"]:
            cls = {"breach": "breach", "ok": "ok"}.get(r["state"], "nodata")
            observed = "-" if r["observed"] is None else r["observed"]
            out.append(
                f"<tr class={cls}><td>{esc(r['name'])}</td>"
                f"<td>{esc(r['kind'])}</td><td>{esc(r['metric'])}</td>"
                f"<td>{observed}</td><td>{r['threshold']}</td>"
                f"<td>{esc(r['severity'])}</td><td>{esc(r['state'])}</td>"
                f"<td>{r['burn_s']} s</td></tr>"
            )
        out.append("</table>")

    breakers = state.get("breakers")
    if breakers is not None:
        out.append("<h2>Circuit breakers</h2>")
        out.append(
            "<table><tr><th>breaker</th><th>state</th>"
            "<th>consecutive failures</th><th>threshold</th>"
            "<th>opens</th><th>fast-fails</th><th>open for</th>"
            "<th>degraded</th></tr>"
        )
        for name, b in breakers.items():
            cls = "ok" if b.get("state") == "closed" else "breach"
            open_for = b.get("open_for_s")
            degraded = b.get("degraded_mode")
            out.append(
                f"<tr class={cls}><td>{esc(str(name))}</td>"
                f"<td>{esc(str(b.get('state')))}</td>"
                f"<td>{b.get('consecutive_failures')}</td>"
                f"<td>{b.get('failure_threshold')}</td>"
                f"<td>{b.get('opens')}</td>"
                f"<td>{b.get('fast_fails')}</td>"
                f"<td>{'-' if open_for is None else f'{open_for} s'}</td>"
                f"<td>{'-' if degraded is None else degraded}</td></tr>"
            )
        out.append("</table>")

    brownout = state.get("brownout")
    if brownout is not None:
        out.append("<h2>Brownout ladder</h2>")
        level, max_level = brownout["level"], brownout["max_level"]
        cls = "ok" if level == 0 else "breach"
        needle = " &rarr; ".join(
            f"<b>[{esc(s)}]</b>" if i < level else esc(s)
            for i, s in enumerate(brownout["ladder"])
        )
        out.append(
            f"<p class={cls}>level {level}/{max_level}: {needle}</p>"
        )
        if brownout["transitions"]:
            out.append(
                "<table><tr><th>when (unix)</th><th>step</th>"
                "<th>action</th><th>level after</th></tr>"
            )
            for t in brownout["transitions"][-16:]:
                t_cls = "breach" if t["action"] == "engage" else "ok"
                out.append(
                    f"<tr class={t_cls}><td>{round(t['wall_time'], 1)}</td>"
                    f"<td>{esc(t['step'])}</td><td>{esc(t['action'])}</td>"
                    f"<td>{t['level_after']}</td></tr>"
                )
            out.append("</table>")
        else:
            out.append("<p class=nodata>no transitions yet</p>")

    admission = state.get("admission")
    if admission is not None:
        out.append("<h2>Admission (cost-aware)</h2>")
        out.append(
            f"<p>queued cost: {admission['outstanding_ms']} ms of "
            f"{admission['queue_budget_ms']} ms budget; priority floor: "
            f"{admission['min_priority']}</p>"
        )
        if admission["tenants"]:
            out.append(
                "<table><tr><th>tenant</th><th>weight</th>"
                "<th>priority</th><th>rate (keys/s)</th><th>tokens</th>"
                "<th>admitted</th><th>shed</th></tr>"
            )
            for tenant, row in admission["tenants"].items():
                out.append(
                    f"<tr><td>{esc(str(tenant))}</td>"
                    f"<td>{row['weight']}</td><td>{row['priority']}</td>"
                    f"<td>{row['rate_qps'] if row['rate_qps'] is not None else '-'}</td>"
                    f"<td>{row['tokens'] if row['tokens'] is not None else '-'}</td>"
                    f"<td>{row['admitted']}</td><td>{row['shed']}</td></tr>"
                )
            out.append("</table>")
        else:
            out.append("<p class=nodata>no tenants seen yet</p>")

    workload = state.get("workload")
    if workload is not None:
        out.append("<h2>Workload</h2>")
        out.append(
            f"<p>rate {workload.get('rate_qps')} q/s, burstiness cv&sup2; "
            f"{workload.get('burstiness_cv2')}, zipf exponent "
            f"{workload.get('zipf_exponent')}, hot share "
            f"{workload.get('hot_share_pct')}% "
            f"({workload.get('observations', 0)} observations over "
            f"{len(workload.get('tenants') or {})} tenants)</p>"
        )

    forecast = state.get("forecast")
    if forecast is not None:
        out.append("<h2>Forecast</h2>")
        paging = forecast.get("paging") or []
        min_ttb = forecast.get("min_time_to_breach_s")
        cls = "breach" if paging else "ok"
        out.append(
            f"<p class={cls}>earliest predicted breach: "
            + (
                f"{min_ttb:.0f} s" if min_ttb is not None
                else "none inside horizon"
            )
            + (
                "; paging: " + ", ".join(esc(s) for s in paging)
                if paging else ""
            )
            + f" (horizon {forecast.get('horizon_s')} s)</p>"
        )
        rows = forecast.get("series") or []
        if rows:
            out.append(
                "<table><tr><th>series</th><th>state</th><th>last</th>"
                "<th>trend/s</th><th>ceiling</th>"
                "<th>breach in</th></tr>"
            )
            for entry in rows:
                ttb = entry.get("time_to_breach_earliest_s")
                row_cls = (
                    "breach"
                    if ttb is not None
                    and ttb <= forecast.get("page_horizon_s", 0)
                    else "ok"
                )
                out.append(
                    f"<tr class={row_cls}><td>{esc(entry['label'])}</td>"
                    f"<td>{esc(entry['state'])}</td>"
                    f"<td>{entry.get('last', '-')}</td>"
                    f"<td>{entry.get('trend_per_s', '-')}</td>"
                    f"<td>{entry.get('ceiling', '-')}</td>"
                    f"<td>{'-' if ttb is None else f'{ttb:.0f} s'}</td>"
                    "</tr>"
                )
            out.append("</table>")
        governor = state.get("governor")
        if governor is not None:
            g_cls = "ok" if governor.get("scale", 1.0) >= 1.0 else "breach"
            out.append(
                f"<p class={g_cls}>predictive governor: scale "
                f"x{governor.get('scale')} "
                f"(floor {governor.get('floor')}, tightenings "
                f"{governor.get('tightenings', 0)})</p>"
            )

    capacity = state.get("capacity")
    if capacity is not None:
        ledger = capacity.get("ledger") or {}
        cells = ledger.get("cells") or {}
        drifting = ledger.get("drifting") or []
        out.append("<h2>Cost-model accuracy</h2>")
        cls = "breach" if drifting else "ok"
        out.append(
            f"<p class={cls}>samples: {ledger.get('total_samples', 0)}, "
            f"unpriced: {ledger.get('total_unpriced', 0)}, drifting "
            f"cells: {len(drifting)} "
            f"(band &plusmn;{ledger.get('drift_band')} for "
            f"{ledger.get('drift_windows')} windows of "
            f"{ledger.get('window_size')})</p>"
        )
        if not cells:
            out.append("<p class=nodata>no priced batches observed yet</p>")
        else:
            out.append(
                "<table><tr><th>workload/tier/bucket</th><th>samples</th>"
                "<th>residual p50</th><th>p95</th><th>p99</th>"
                "<th>mean predicted ms</th><th>mean actual ms</th>"
                "<th>drifting</th></tr>"
            )
            for key in sorted(cells):
                c = cells[key]
                row_cls = "breach" if c.get("drifting") else "ok"
                out.append(
                    f"<tr class={row_cls}><td>{esc(key)}</td>"
                    f"<td>{c['samples']}</td>"
                    f"<td>{c['residual_p50']:+.3f}</td>"
                    f"<td>{c['residual_p95']:+.3f}</td>"
                    f"<td>{c['residual_p99']:+.3f}</td>"
                    f"<td>{c['mean_predicted_ms']:.3f}</td>"
                    f"<td>{c['mean_actual_ms']:.3f}</td>"
                    f"<td>{'YES' if c.get('drifting') else '-'}</td></tr>"
                )
            out.append("</table>")
        recal = capacity.get("recalibration")
        if recal is not None:
            factors = recal.get("factors") or {}
            factor_txt = ", ".join(
                f"{esc(k)}=x{v}" for k, v in sorted(factors.items())
            ) or "none learned"
            if recal.get("enabled"):
                out.append(
                    f"<p class=ok>recalibration enabled; factors: "
                    f"{factor_txt}</p>"
                )
            else:
                out.append(
                    f"<p class=breach>recalibration DISABLED via "
                    f"{esc(str(recal.get('kill_switch_env')))} (pricing "
                    f"raw); learned factors bypassed: {factor_txt}</p>"
                )
        calib = (capacity.get("model") or {}).get("calibration") or {}
        stale_cls = "breach" if calib.get("stale") else "ok"
        out.append(
            f"<p class={stale_cls}>throughput calibration: "
            + ("STALE" if calib.get("stale") else "fresh")
            + "".join(
                f"; {esc(m)}={e.get('value')} "
                f"(age {e.get('age_s', '-')} s)"
                for m, e in sorted((calib.get("metrics") or {}).items())
            )
            + "</p>"
        )

    snapshots = state.get("snapshots")
    if snapshots is not None:
        out.append("<h2>Snapshots</h2>")
        staging = snapshots.get("staging_generation")
        mismatches = snapshots.get("mismatches", 0)
        cls = "breach" if mismatches else "ok"
        out.append(
            f"<p class={cls}>serving generation "
            f"{snapshots.get('serving_generation')}"
            + (
                f", staging {staging}" if staging is not None
                else ", nothing staged"
            )
            + f"; flips: {snapshots.get('flips', 0)}, aborts: "
            f"{snapshots.get('aborts', 0)}, mismatches: {mismatches}, "
            f"pins: {snapshots.get('pins', 0)}</p>"
        )
        inflight = snapshots.get("inflight") or {}
        retired = snapshots.get("retired_awaiting_drain") or []
        if inflight or retired:
            out.append(
                "<p>in-flight per generation: "
                + (", ".join(
                    f"{esc(g)}={n}" for g, n in sorted(inflight.items())
                ) or "none")
                + "; retired awaiting drain: "
                + (", ".join(str(g) for g in retired) or "none")
                + "</p>"
            )
        history = snapshots.get("history") or []
        if history:
            out.append(
                "<table><tr><th>from</th><th>to</th>"
                "<th>staleness ms</th><th>in-flight at flip</th>"
                "<th>old staging</th></tr>"
            )
            for r in history[-16:]:
                staleness = r.get("staleness_ms")
                out.append(
                    f"<tr class=ok><td>{r.get('from_generation')}</td>"
                    f"<td>{r.get('to_generation')}</td>"
                    f"<td>{'-' if staleness is None else staleness}</td>"
                    f"<td>{r.get('inflight_old')}</td>"
                    f"<td>{esc(str(r.get('old_freed')))}</td></tr>"
                )
            out.append("</table>")
        else:
            out.append("<p class=nodata>no rotations yet</p>")

    mesh = state.get("mesh")
    if mesh is not None:
        out.append("<h2>Mesh</h2>")
        if not mesh.get("configured"):
            out.append("<p class=nodata>no device mesh configured</p>")
        else:
            shape = mesh.get("shape") or {}
            shape_txt = " &times; ".join(
                f"{esc(str(axis))}={n}" for axis, n in shape.items()
            ) or "-"
            fallback = mesh.get("fallback_error")
            cls = "breach" if fallback else "ok"
            out.append(
                f"<p class={cls}>{mesh.get('devices')} devices, "
                f"{shape_txt}"
                + (
                    f"; FALLBACK to single-device: {esc(str(fallback))}"
                    if fallback
                    else ""
                )
                + "</p>"
            )
            plan = mesh.get("plan")
            if plan is not None:
                scratch = plan.get("scratch") or {}
                out.append(
                    f"<p>plan: walk {plan.get('walk_levels')} + cut "
                    f"{plan.get('cut_levels')} + chunk "
                    f"{plan.get('chunk_levels')} levels, ip "
                    f"{esc(str(plan.get('ip')))}; requests: "
                    f"{plan.get('requests')}; donated scratch: "
                    f"{'on' if plan.get('donate') else 'OFF'} "
                    f"(staged {scratch.get('staged_copies')}, reused "
                    f"{scratch.get('reuses')})</p>"
                )
            staging = mesh.get("staging")
            if staging is None:
                out.append("<p class=nodata>no mesh-staged database</p>")
            else:
                out.append(
                    f"<p>generation {staging.get('generation')}: "
                    f"{staging.get('num_chunks')} chunks over "
                    f"{staging.get('num_shards')} shards, "
                    f"{_fmt_bytes(staging.get('total_bytes', 0))} in "
                    f"{staging.get('copies')} staging copies</p>"
                )
                out.append(
                    "<table><tr><th>device</th><th>chunks</th>"
                    "<th>staged bytes</th><th>staging copies</th>"
                    "<th>HBM watermark</th></tr>"
                )
                for shard in staging.get("shards", ()):
                    watermark = shard.get("hbm_watermark_bytes")
                    out.append(
                        f"<tr><td>{shard.get('device')}</td>"
                        f"<td>[{shard.get('chunk_start')}, "
                        f"{shard.get('chunk_stop')})</td>"
                        f"<td>{_fmt_bytes(shard.get('bytes', 0))}</td>"
                        f"<td>{shard.get('copies')}</td>"
                        f"<td>"
                        + (
                            "-" if watermark is None
                            else _fmt_bytes(watermark)
                        )
                        + "</td></tr>"
                    )
                out.append("</table>")

    waterfall = state.get("phases") or {}
    out.append("<h2>Phase waterfall</h2>")
    if not waterfall:
        out.append("<p class=nodata>no attributed requests yet</p>")
    for role, summary in waterfall.items():
        e2e = summary["end_to_end_ms"]
        out.append(
            f"<h3>{esc(role)} ({summary['requests']} requests, "
            f"end-to-end p50 {e2e['p50_ms']} ms / "
            f"p99 {e2e['p99_ms']} ms)</h3>"
        )
        out.append(
            "<table><tr><th>phase</th><th>count</th><th>mean ms</th>"
            "<th>p50 ms</th><th>p99 ms</th><th>max ms</th>"
            "<th>share</th></tr>"
        )
        for name, entry in summary["phases"].items():
            out.append(
                f"<tr><td>{esc(name)}</td><td>{entry['count']}</td>"
                f"<td>{entry['mean_ms']}</td><td>{entry['p50_ms']}</td>"
                f"<td>{entry['p99_ms']}</td><td>{entry['max_ms']}</td>"
                f"<td>{entry['share'] * 100:.1f}%</td></tr>"
            )
        out.append("</table>")

    critical = state.get("critical")
    if critical is not None:
        out.append("<h2>Critical path (cross-party)</h2>")
        if not critical.get("requests"):
            out.append(
                "<p class=nodata>no merged two-party timelines yet</p>"
            )
        else:
            legs = critical.get("legs") or {}
            total_legs = sum(legs.values()) or 1
            leg_txt = ", ".join(
                f"{esc(leg)}: {n} ({n / total_legs * 100:.1f}%)"
                for leg, n in sorted(legs.items())
            )
            out.append(
                f"<p>merged requests: {critical['requests']}; "
                f"critical leg — {leg_txt}; invalid skew estimates: "
                f"{critical['skew_invalid']}</p>"
            )
            out.append(
                "<table><tr><th>party</th><th>phase</th><th>count</th>"
                "<th>p50 ms</th><th>p95 ms</th><th>p99 ms</th>"
                "<th>share of critical time</th></tr>"
            )
            for party, phases_ in (critical.get("profile") or {}).items():
                for phase, entry in phases_.items():
                    out.append(
                        f"<tr><td>{esc(party)}</td><td>{esc(phase)}</td>"
                        f"<td>{entry['count']}</td>"
                        f"<td>{entry['p50_ms']}</td>"
                        f"<td>{entry['p95_ms']}</td>"
                        f"<td>{entry['p99_ms']}</td>"
                        f"<td>{entry['share'] * 100:.1f}%</td></tr>"
                    )
            out.append("</table>")

    transfers = state["device"].get("transfers") or {}
    out.append("<h2>Host&#8596;device transfers</h2>")
    if not transfers.get("phases"):
        out.append("<p class=nodata>no recorded transfers</p>")
    else:
        totals = transfers["totals"]
        out.append(
            f"<p>total: {totals['h2d_copies']} h2d copies "
            f"({_fmt_bytes(totals['h2d_bytes'])}), "
            f"{totals['d2h_copies']} d2h copies "
            f"({_fmt_bytes(totals['d2h_bytes'])}), "
            f"{totals['syncs']} sync waits</p>"
        )
        hidden = float(totals.get("overlapped_ms", 0.0))
        exposed = float(totals.get("sync_wait_ms", 0.0))
        out.append(
            f"<p>transfer time: {hidden:.1f} ms hidden behind host "
            f"work (pipelined staging), {exposed:.1f} ms exposed in "
            f"sync waits</p>"
        )
        out.append(
            "<table><tr><th>phase</th><th>h2d copies</th>"
            "<th>h2d bytes</th><th>d2h copies</th><th>d2h bytes</th>"
            "<th>syncs</th><th>exposed ms</th><th>hidden ms</th></tr>"
        )
        for phase, entry in transfers["phases"].items():
            out.append(
                f"<tr><td>{esc(phase)}</td><td>{entry['h2d_copies']}</td>"
                f"<td>{_fmt_bytes(entry['h2d_bytes'])}</td>"
                f"<td>{entry['d2h_copies']}</td>"
                f"<td>{_fmt_bytes(entry['d2h_bytes'])}</td>"
                f"<td>{entry['syncs']}</td>"
                f"<td>{float(entry.get('sync_wait_ms', 0.0)):.1f}</td>"
                f"<td>{float(entry.get('overlapped_ms', 0.0)):.1f}</td>"
                "</tr>"
            )
        out.append("</table>")

    prober = state.get("prober")
    if prober is not None:
        out.append("<h2>Blackbox probes</h2>")
        out.append(
            f"<p>cycles: {prober['cycles']}, probes: {prober['probes']}, "
            f"passes: {prober['passes']}, mismatches: "
            f"{prober['mismatches']}, errors: {prober['errors']}, "
            f"degraded: {prober['degraded']}</p>"
        )
        out.append(
            "<table><tr><th>kind</th><th>last status</th>"
            "<th>last ms</th><th>pass age (s)</th><th>fresh</th>"
            "<th>detail</th></tr>"
        )
        for kind, entry in prober.get("freshness", {}).items():
            cls = (
                "ok" if entry.get("last_status") == "pass"
                else ("nodata" if entry.get("last_status") is None
                      else "breach")
            )
            age = entry.get("last_pass_age_s")
            out.append(
                f"<tr class={cls}><td>{esc(kind)}</td>"
                f"<td>{esc(str(entry.get('last_status')))}</td>"
                f"<td>{entry.get('last_ms', '-')}</td>"
                f"<td>{'-' if age is None else age}</td>"
                f"<td>{entry.get('fresh')}</td>"
                f"<td>{esc(str(entry.get('detail') or ''))[:120]}</td>"
                f"</tr>"
            )
        out.append("</table>")

    bundles = state.get("bundles")
    if bundles is not None:
        out.append("<h2>Debug bundles</h2>")
        out.append(
            f"<p>dir: {esc(bundles['directory'])}; fired: "
            f"{bundles['fired']}, suppressed (cooldown/in-flight): "
            f"{bundles['suppressed_cooldown']}/"
            f"{bundles['suppressed_inflight']}, "
            f"cooldown: {bundles['cooldown_s']} s</p>"
        )
        if not bundles["bundles"]:
            out.append("<p class=nodata>no bundles captured</p>")
        else:
            out.append(
                "<table><tr><th>seq</th><th>when (unix)</th>"
                "<th>reason</th><th>path</th></tr>"
            )
            for b in bundles["bundles"]:
                where = b.get("path") or b.get("error") or "-"
                out.append(
                    f"<tr><td>{b.get('seq')}</td><td>{b.get('ts_unix')}</td>"
                    f"<td>{esc(str(b.get('reason')))}</td>"
                    f"<td>{esc(str(where))}</td></tr>"
                )
            out.append("</table>")

    profiles = state.get("profiles")
    if profiles is not None:
        out.append("<h2>Auto-captured profiles</h2>")
        out.append(
            f"<p>fired: {profiles['fired']}, suppressed "
            f"(cooldown/in-flight/kind): "
            f"{profiles['suppressed_cooldown']}/"
            f"{profiles['suppressed_inflight']}/"
            f"{profiles['suppressed_kind']}, "
            f"cooldown: {profiles['cooldown_s']} s</p>"
        )
        if not profiles["captures"]:
            out.append("<p class=nodata>no captures yet</p>")
        else:
            out.append(
                "<table><tr><th>when (unix)</th><th>objective</th>"
                "<th>metric</th><th>observed</th><th>threshold</th>"
                "<th>trace dir</th></tr>"
            )
            for cap in profiles["captures"]:
                where = cap.get("log_dir") or cap.get("error") or "-"
                out.append(
                    f"<tr><td>{cap.get('ts_unix')}</td>"
                    f"<td>{esc(str(cap.get('objective')))}</td>"
                    f"<td>{esc(str(cap.get('metric')))}</td>"
                    f"<td>{cap.get('observed')}</td>"
                    f"<td>{cap.get('threshold')}</td>"
                    f"<td>{esc(str(where))}</td></tr>"
                )
            out.append("</table>")

    compile_state = state["device"]["compile"]
    out.append(
        f"<h2>Compilations (total: {compile_state['total_compiles']})</h2>"
    )
    compile_cache = state["device"].get("compile_cache")
    if compile_cache is not None:
        if "error" in compile_cache:
            out.append(
                f"<p class=breach>persistent compile cache failed: "
                f"{esc(str(compile_cache['error']))}</p>"
            )
        else:
            out.append(
                f"<p>persistent compile cache: "
                f"{esc(str(compile_cache.get('dir')))} — warm entries at "
                f"start: {compile_cache.get('warm_entries_at_start')}, "
                f"entries now: {compile_cache.get('entries')}, persisted "
                f"this process: "
                f"{compile_cache.get('persisted_this_process')}</p>"
            )
    if not compile_state["sites"]:
        out.append("<p class=nodata>no tracked dispatches yet</p>")
    else:
        out.append(
            "<table><tr><th>site</th><th>shapes</th><th>compiles</th>"
            "<th>hits</th><th>hit ratio</th><th>compile p50/max ms</th></tr>"
        )
        for site, entry in compile_state["sites"].items():
            lat = entry.get("compile_ms")
            lat_s = f"{lat['p50']} / {lat['max']}" if lat else "-"
            ratio = entry["hit_ratio"]
            out.append(
                f"<tr><td>{esc(site)}</td><td>{len(entry['shapes'])}</td>"
                f"<td>{entry['compiles']}</td><td>{entry['hits']}</td>"
                f"<td>{'-' if ratio is None else ratio}</td>"
                f"<td>{lat_s}</td></tr>"
            )
        out.append("</table>")
        out.append("<details><summary>per-shape dispatch counts</summary>")
        out.append(
            "<table><tr><th>site</th><th>shape</th><th>compiles</th>"
            "<th>hits</th></tr>"
        )
        for site, entry in compile_state["sites"].items():
            for key, counts in entry["shapes"].items():
                out.append(
                    f"<tr><td>{esc(site)}</td><td>{esc(key)}</td>"
                    f"<td>{counts['compiles']}</td>"
                    f"<td>{counts['hits']}</td></tr>"
                )
        out.append("</table></details>")

    hbm = state["device"]["hbm"]
    out.append("<h2>HBM</h2>")
    out.append(
        f"<p>live: {_fmt_bytes(hbm['live_bytes'])} "
        f"(source: {esc(str(hbm['source']))}, samples: {hbm['samples']}, "
        f"phase: {esc(str(hbm['current_phase']))})</p>"
    )
    if hbm["watermark_bytes"]:
        out.append(
            "<table><tr><th>phase</th><th>watermark</th></tr>"
        )
        for phase, watermark in hbm["watermark_bytes"].items():
            out.append(
                f"<tr><td>{esc(phase)}</td>"
                f"<td>{_fmt_bytes(watermark)}</td></tr>"
            )
        out.append("</table>")

    events = state.get("events") or {}
    tail = events.get("tail") or []
    out.append("<h2>Recent events</h2>")
    if not tail:
        out.append("<p class=nodata>no events journaled yet</p>")
    else:
        out.append(
            "<table><tr><th>seq</th><th>when</th><th>severity</th>"
            "<th>kind</th><th>message</th></tr>"
        )
        for e in tail:
            cls = {"error": "breach", "warning": "breach"}.get(
                e["severity"], "ok"
            )
            when = time.strftime(
                "%H:%M:%S", time.localtime(e["t_wall"])
            )
            message = e["message"]
            if e.get("repeats"):
                message += f" (x{e['repeats'] + 1})"
            out.append(
                f"<tr class={cls}><td>{e['seq']}</td><td>{when}</td>"
                f"<td>{esc(e['severity'])}</td><td>{esc(e['kind'])}</td>"
                f"<td>{esc(message)[:160]}</td></tr>"
            )
        out.append("</table>")
    out.append("</body></html>")
    return "".join(out)
