"""The operator surface's pure-Python modules against the JAX package's,
byte for byte.

`exposition`, `timeseries`, `forecast` and `bundle` are copies of the JAX
package's modules: each test drives both packages' modules with the same
scripted inputs under an injected clock and compares what they give (the
rendered text, the JSON of every export, the journaled events less their
wall-clock stamps, the files a bundle writes). The auto-profiler runs
with an injected capture function and a fake clock; the forecaster feeds
the port's `PredictiveGovernor` and `RotationCoordinator.suggest_window`.
"""

import json
import os

import pytest
import torch

import distributed_point_functions_tpu.observability.bundle as j_bundle
import distributed_point_functions_tpu.observability.events as j_events
import distributed_point_functions_tpu.observability.exposition as j_exposition
import distributed_point_functions_tpu.observability.forecast as j_forecast
import distributed_point_functions_tpu.observability.slo as j_slo
import distributed_point_functions_tpu.observability.timeseries as j_timeseries
from distributed_point_functions_tpu_torch.capacity.admission import (
    AdmissionController,
    PredictiveGovernor,
    TenantPolicy,
)
import distributed_point_functions_tpu_torch.observability.bundle as p_bundle
import distributed_point_functions_tpu_torch.observability.events as p_events
import distributed_point_functions_tpu_torch.observability.exposition as p_exposition
import distributed_point_functions_tpu_torch.observability.forecast as p_forecast
import distributed_point_functions_tpu_torch.observability.slo as p_slo
import distributed_point_functions_tpu_torch.observability.timeseries as p_timeseries
from distributed_point_functions_tpu_torch.observability.autoprofile import (
    AutoProfiler,
    capture_profile,
)
from distributed_point_functions_tpu_torch.pir import DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.serving import (
    PlainSession,
    RotationCoordinator,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
from distributed_point_functions_tpu_torch.utils import get_backend_mode_string
from distributed_point_functions_tpu_torch.utils.profiling import TRACE_FILE, trace

PACKAGES = {
    "jax": dict(exposition=j_exposition, timeseries=j_timeseries,
                forecast=j_forecast, bundle=j_bundle, events=j_events, slo=j_slo),
    "port": dict(exposition=p_exposition, timeseries=p_timeseries,
                 forecast=p_forecast, bundle=p_bundle, events=p_events, slo=p_slo),
}


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _events(journal):
    """The journal's events without their wall-clock stamps."""
    return [{k: v for k, v in e.items() if k != "t_wall"} for e in journal.tail(n=256)]


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


# -- exposition ---------------------------------------------------------------

EXPORT = {
    "counters": {"prober.probes": 12, "prober.passes{kind=pir_chunked}": 3,
                 "device.h2d_bytes{phase=db_staging}": 1 << 30,
                 'weird.name{label=a"b\\c}': 1},
    "gauges": {"plain.batcher.pipeline_depth": 2.0, "leader.degraded_mode": 0.0,
               "governor.scale": 0.25},
    "histograms": {
        "leader.request_ms{role=leader}": {
            "count": 5, "sum": 41.5,
            "buckets": {"1.0": 1, "5.0": 2, "10.0": 1, "+inf": 1},
            "exemplars": {"5.0": {"value": 4.2, "trace_id": "abc", "ts": 1.7e9}},
        },
        "prober.probe_ms{kind=pir_unbatched}": {
            "count": 2, "sum": 3.0, "buckets": {"1.0": 0, "2.0": 2, "+inf": 0}},
    },
}


def test_exposition_renders_as_jax():
    texts = {name: mods["exposition"].render_prometheus(EXPORT)
             for name, mods in PACKAGES.items()}
    assert texts["port"] == texts["jax"]
    assert "prober_probes 12" in texts["port"]
    for name in ("prober.passes{kind=pir_chunked}", "a.b{x=1,y=2}", "plain"):
        assert (p_exposition.parse_labeled_name(name)
                == j_exposition.parse_labeled_name(name))


# -- timeseries -----------------------------------------------------------------


class ScriptedRegistry:
    def __init__(self):
        self.t = 0

    def export(self):
        self.t += 1
        spike = 40.0 if self.t == 12 else 0.0
        return {"counters": {"prober.probes": 4 * self.t,
                             "leader.requests": 10 * self.t + spike},
                "gauges": {"plain.batcher.queue_depth": float(self.t % 5) + spike},
                "histograms": {"leader.request_ms": {
                    "count": self.t, "sum": 2.0 * self.t, "p50": 1.5, "p99": 3.0 + spike}}}


class ScriptedUtilization:
    def __init__(self):
        self.t = 0

    def export(self):
        self.t += 1
        return {"totals": {"busy_s": 0.1 * self.t, "idle_total_s": 0.05 * self.t,
                           "idle_s": {"host_prep": 0.01 * self.t}},
                "windows": [{"duty_cycle_pct": 50.0 + self.t,
                             "device_feed_efficiency": 0.9}]}


def _timeseries_run(mods):
    ts, events = mods["timeseries"], mods["events"]
    clock = FakeClock()
    journal = events.EventJournal(clock=clock)
    store = ts.TimeSeriesStore(tiers=((1.0, 16), (4.0, 8)), max_series=12, clock=clock)
    watch = ts.AnomalyWatch(ratio=3.0, floor=1.0, min_samples=4, journal=journal)
    sampler = ts.MetricsSampler(store, registry=ScriptedRegistry(),
                                utilization=ScriptedUtilization(), watch=watch,
                                clock=clock, seed=3,
                                extra_sources=[lambda: {"extra.gauge": clock.now % 7}])
    written = []
    for _ in range(20):
        clock.now += 1.0
        written.append(sampler.sample_once())
    return {
        "written": written,
        "store": _dump(store.export()),
        "range": _dump(store.query_range("prober.probes", 1005.0, 1015.0)),
        "sampler": _dump(sampler.export()),
        "sparklines": ts.render_sparklines(store) + "\n" + ts.render_sparklines(store, tier=1),
        "sparkline": ts.sparkline([1, 5, 2, 8, 3]),
        "events": _dump(_events(journal)),
        "watch": _dump(watch.export()),
    }


def test_timeseries_samples_sparklines_and_anomalies_as_jax():
    jax_run, port_run = (_timeseries_run(PACKAGES[k]) for k in ("jax", "port"))
    assert port_run == jax_run
    assert "util.anomaly" in port_run["events"]  # the scripted spike was seen
    assert port_run["sparklines"].count("\n") >= 8


# -- forecast -------------------------------------------------------------------


def _forecast_run(mods):
    ts, fc, events = mods["timeseries"], mods["forecast"], mods["events"]
    clock = FakeClock()
    journal = events.EventJournal(clock=clock)
    store = ts.TimeSeriesStore(tiers=((1.0, 300),), clock=clock)
    for i in range(120):
        clock.now += 1.0
        store.record("arrival.qps", 100.0 + 2.5 * i + (i % 3), clock.now)
        store.record("util.duty_cycle_pct", 40.0 + 10.0 * ((i // 20) % 2), clock.now)
        store.record("calm", 5.0, clock.now)
    registry = MetricsRegistry()
    forecaster = fc.Forecaster(store, window_s=60.0, horizon_s=300.0,
                               page_horizon_s=200.0, registry=registry,
                               journal=journal, clock=clock)
    forecaster.watch("arrival.qps", ceiling=600.0)
    forecaster.watch("util.duty_cycle_pct", ceiling_source=lambda: 95.0)
    forecaster.watch("calm", ceiling=10.0)
    state = forecaster.export()
    objective = forecaster.objective()
    return {
        "export": _dump(state),
        "ttb": forecaster.min_time_to_breach_s(),
        "trough": _dump(forecaster.trough_window("util.duty_cycle_pct", 30.0)),
        "window": _dump(forecaster.window_source("arrival.qps")(20.0)),
        "holt": _dump(fc.holt_fit([1.0, 2.0, 4.0, 7.0, 11.0], alpha=0.5, beta=0.3)),
        "objective": (objective.name, objective.kind, objective.metric,
                      objective.threshold, objective.severity),
        "events": _dump(_events(journal)),
        "gauges": _dump(registry.export()["gauges"]),
    }


def test_forecast_ttb_and_trough_as_jax():
    jax_run, port_run = (_forecast_run(PACKAGES[k]) for k in ("jax", "port"))
    assert port_run == jax_run
    assert port_run["ttb"] is not None and port_run["ttb"] < 300.0
    assert "forecast.breach_predicted" in port_run["events"]


def test_forecast_drives_the_governor_and_the_rotation_window():
    clock = FakeClock()
    store = p_timeseries.TimeSeriesStore(tiers=((1.0, 300),), clock=clock)
    for i in range(60):
        clock.now += 1.0
        store.record("arrival.qps", 50.0 + 5.0 * i, clock.now)
        store.record("util.duty_cycle_pct", 80.0 - i, clock.now)
    forecaster = p_forecast.Forecaster(store, window_s=60.0, horizon_s=120.0,
                                       journal=p_events.EventJournal(), clock=clock)
    forecaster.watch("arrival.qps", ceiling=500.0)
    admission = AdmissionController(queue_budget_ms=100.0, clock=clock)
    admission.set_tenant("gold", TenantPolicy(rate_qps=100.0, burst=10))
    governor = PredictiveGovernor(admission, forecaster.min_time_to_breach_s,
                                  horizon_s=120.0, floor=0.25, clock=clock)
    ttb = forecaster.min_time_to_breach_s()
    assert ttb is not None and ttb < 120.0
    assert governor.update() == pytest.approx(governor.scale_for(ttb))
    assert governor.update() < 1.0
    db = DenseDpfPirDatabase([bytes([i]) * 4 for i in range(64)], device="cpu")
    with PlainSession(db, ServingConfig(request_timeout_ms=10_000.0), device="cpu") as s:
        coordinator = RotationCoordinator(SnapshotManager(s))
        assert coordinator.suggest_window(20.0) == {
            "window_s": 20.0, "start_offset_s": 0.0, "source": "none"}
        coordinator.set_window_source(forecaster.window_source("util.duty_cycle_pct"))
        suggestion = coordinator.suggest_window(20.0)
        assert suggestion["source"] == "forecast" and suggestion["state"] == "ok"
        assert suggestion == {**forecaster.trough_window("util.duty_cycle_pct", 20.0),
                              "source": "forecast"}

        def broken(window_s):
            raise RuntimeError("no forecast")

        coordinator.set_window_source(broken)
        assert coordinator.suggest_window(5.0)["source"] == "error"


# -- bundle ---------------------------------------------------------------------


def _bundle_run(mods, directory):
    bundle, events = mods["bundle"], mods["events"]
    clock = FakeClock()
    journal = events.EventJournal(clock=clock)
    manager = bundle.BundleManager(directory, cooldown_s=60.0, max_bundles=2,
                                   journal=journal, clock=clock)
    manager.add_source("statusz", lambda: {"name": "admin", "uptime_s": 3.0})
    manager.add_source("metrics", lambda: EXPORT)
    manager.add_source("probez", lambda: {"cycles": 1, "mismatches": 4})

    def broken():
        raise RuntimeError("source down")

    manager.add_source("broken", broken)
    entries = [manager.trigger("probe_failure", {"kind": "pir_streaming"})]
    entries.append(manager.trigger("again"))  # inside the cooldown: suppressed
    for reason in ("second", "third: evicts the first"):
        clock.now += 61.0
        entries.append(manager.on_probe_failure({"kind": "pir_chunked", "status": "mismatch",
                                                 "detail": reason, "seq": 9}))
    files = {}
    for name in sorted(os.listdir(directory)):
        for leaf in sorted(os.listdir(os.path.join(directory, name))):
            with open(os.path.join(directory, name, leaf)) as f:
                data = json.load(f)
            if leaf == "manifest.json":
                data.pop("ts_unix")
            files[f"{name}/{leaf}"] = _dump(data)

    def strip(entry):
        if entry is None:
            return None
        return {k: (os.path.basename(v) if k == "path" else v)
                for k, v in entry.items() if k != "ts_unix"}

    export = manager.export()
    export["directory"] = None
    export["bundles"] = [strip(b) for b in export["bundles"]]
    events_seen = [{k: (os.path.basename(v) if k in ("path",) else v)
                    for k, v in e.items()} for e in _events(journal)]
    for e in events_seen:
        e["message"] = e["message"].split(" -> ")[0]
    return {"entries": [strip(e) for e in entries], "files": files,
            "export": _dump(export), "events": _dump(events_seen)}


def test_bundle_manifest_files_and_ring_as_jax(tmp_path):
    jax_run = _bundle_run(PACKAGES["jax"], str(tmp_path / "jax"))
    port_run = _bundle_run(PACKAGES["port"], str(tmp_path / "port"))
    assert port_run == jax_run
    manifest = json.loads(next(v for k, v in port_run["files"].items()
                               if k.endswith("manifest.json")))
    assert manifest["sources"]["probez"] == "ok"
    assert manifest["sources"]["broken"].startswith("RuntimeError")
    assert port_run["entries"][1] is None
    assert len([k for k in port_run["files"] if k.endswith("manifest.json")]) == 2


# -- auto-profiler and the trace ------------------------------------------------


def _burn(name="p99", kind="p99_ms_max"):
    return {"name": name, "kind": kind, "metric": "leader.request_ms",
            "observed": 80.0, "threshold": 50.0, "burn_s": 1.0}


def test_autoprofiler_cooldown_inflight_and_ring():
    tracker = p_slo.SloTracker([], MetricsRegistry())
    clock = FakeClock()
    calls = []

    def capture(record):
        calls.append(record["name"])
        return {"log_dir": f"/profiles/{len(calls)}", "duration_ms": 5.0}

    profiler = AutoProfiler(tracker, capture_fn=capture, clock=clock, cooldown_s=300.0,
                            max_captures=2, async_capture=False)
    profiler._on_burn(_burn(kind="counter_max"))  # not a latency objective
    profiler._on_burn(_burn("a"))
    profiler._on_burn(_burn("b"))  # inside the cooldown
    for name in ("c", "d"):
        clock.now += 301.0
        profiler._on_burn(_burn(name))
    state = profiler.export()
    assert calls == ["a", "c", "d"]
    assert (state["fired"], state["suppressed_cooldown"], state["suppressed_kind"]) == (3, 1, 1)
    assert [c["objective"] for c in state["captures"]] == ["c", "d"]
    assert state["captures"][-1]["log_dir"] == "/profiles/3"

    def failing(record):
        raise OSError("disk full")

    profiler._capture_fn = failing
    clock.now += 301.0
    profiler._on_burn(_burn("e"))
    assert profiler.captures()[-1]["error"] == "OSError: disk full"


def test_capture_profile_writes_a_chrome_trace(tmp_path):
    result = capture_profile(str(tmp_path), "test", 5.0)
    path = os.path.join(result["log_dir"], TRACE_FILE)
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    with trace(str(tmp_path / "block")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "block" / TRACE_FILE) as f:
        assert any("cumsum" in str(e.get("name")) for e in json.load(f)["traceEvents"])


def test_backend_mode_string_names_the_backend():
    text = get_backend_mode_string()
    assert text.startswith("backend=cpu devices=0 ") and f"torch={torch.__version__}" in text
