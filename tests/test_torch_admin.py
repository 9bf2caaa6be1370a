"""The admin endpoint against the JAX package's `AdminServer`.

Both servers listen on port 0 and are handed the same duck-typed state:
a `device="cpu"` session's registry, capacity accuracy export and
snapshot manager, a prober over that session, a time-series sampler, a
workload observatory and a forecaster (each server takes its own
package's `BundleManager`; the defaults, such as the flight recorder and
the device telemetry, are each package's own). Then:

* the route list, the 404 body, and every route's status code and
  content type are equal, and equal to the table `chip_smoke.py` gates
  the card's scrape against (`chip_smoke.ADMIN_ROUTES`);
* `/metrics` holds every line of the registry's Prometheus text and
  parses as Prometheus text (`chip_smoke.PROMETHEUS_SAMPLE`, the check
  the card's scrape runs); `/varz` has the same keys;
* a bit-identity probe that has not passed within its window turns
  `/healthz` into the same 503 on both;
* `/statusz` carries the transfer ledger's `overlapped_ms`, and a bundle
  manager handed to the port's server gets the standard sources.
"""

import json

import numpy as np
import pytest

from distributed_point_functions_tpu.observability.admin import AdminServer as JAdminServer
from distributed_point_functions_tpu.observability.bundle import BundleManager as JBundles
from distributed_point_functions_tpu_torch.observability.admin import AdminServer
from distributed_point_functions_tpu_torch.observability.bundle import BundleManager
from distributed_point_functions_tpu_torch.observability.device import DeviceTelemetry
from distributed_point_functions_tpu_torch.observability.events import EventJournal
from distributed_point_functions_tpu_torch.observability.exposition import (
    render_prometheus,
)
from distributed_point_functions_tpu_torch.observability.forecast import Forecaster
from distributed_point_functions_tpu_torch.observability.timeseries import (
    MetricsSampler,
    TimeSeriesStore,
)
from distributed_point_functions_tpu_torch.observability.workload import (
    WorkloadObservatory,
)
from distributed_point_functions_tpu_torch.pir import DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.serving import (
    PlainSession,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.serving.prober import Prober

import chip_smoke

_RNG = np.random.default_rng(5)
RECORDS = [_RNG.bytes(8) for _ in range(256)]


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    clock = FakeClock()
    db = DenseDpfPirDatabase(RECORDS, device="cpu")
    session = PlainSession(db, ServingConfig(request_timeout_ms=60_000.0), device="cpu")
    prober = Prober(session, RECORDS, journal=EventJournal(), clock=clock,
                    period_s=1.0, freshness_window_s=5.0)
    prober.run_cycle()
    store = TimeSeriesStore(tiers=((1.0, 64),), clock=clock)
    sampler = MetricsSampler(store, registry=session.metrics, clock=clock)
    workload = WorkloadObservatory()
    for i in range(40):
        clock.now += 1.0
        workload.observe(num_keys=1 + i % 3, tenant="gold" if i % 2 else "bronze",
                         key_indices=[i % 7], now=clock.now)
        store.record("arrival.qps", 10.0 + i, clock.now)
        sampler.sample_once()
    forecaster = Forecaster(store, clock=clock, journal=EventJournal())
    forecaster.watch("arrival.qps", ceiling=80.0)
    prober.run_cycle()  # fresh at the fixture's clock
    attachments = dict(registry=session.metrics, prober=prober,
                       capacity=session.capacity_accuracy,
                       snapshots=SnapshotManager(session), timeseries=store,
                       workload=workload, forecast=forecaster)
    yield dict(clock=clock, attachments=attachments, prober=prober,
               dirs=tmp_path_factory)
    session.close()


def _serve(cls, bundles_cls, state, name):
    bundles = bundles_cls(str(state["dirs"].mktemp(name)))
    return cls(port=0, bundles=bundles, **state["attachments"]), bundles


def _scrape_both(state):
    port_admin, port_bundles = _serve(AdminServer, BundleManager, state, "port")
    jax_admin, _ = _serve(JAdminServer, JBundles, state, "jax")
    with port_admin, jax_admin:
        return (chip_smoke.scrape_admin(port_admin.port),
                chip_smoke.scrape_admin(jax_admin.port), port_admin, jax_admin,
                port_bundles)


def test_every_route_answers_as_jax_and_as_the_smoke_table(state):
    port, jax_side, port_admin, jax_admin, bundles = _scrape_both(state)
    assert port_admin.routes == jax_admin.routes == tuple(chip_smoke.ADMIN_ROUTES)
    got = {route: (status, ctype) for route, (status, ctype, _) in port.items()}
    want = {route: (status, ctype) for route, (status, ctype, _) in jax_side.items()}
    assert got == want == chip_smoke.ADMIN_ROUTES
    for route in ("/fleetz", "/fleet-statusz", "/fleet-timelinez"):
        assert port[route][2] == jax_side[route][2]  # "no fleet attached" and kin
    assert json.loads(port["/probez"][2])["cycles"] == 2
    assert sorted(json.loads(port["/varz"][2])) == sorted(json.loads(jax_side["/varz"][2]))
    assert "arrival.qps" in port["/timeseriesz"][2].decode()
    assert "breach in" in port["/forecastz"][2].decode()
    trace = json.loads(port["/profilez"][2])
    assert set(trace) == {"log_dir", "duration_ms"}
    assert {"statusz", "metrics", "probes", "timeseries", "workload",
            "forecast"} <= set(bundles.export()["sources"])


def test_unknown_route_body_equals_jax(state):
    port_admin, _ = _serve(AdminServer, BundleManager, state, "p404")
    jax_admin, _ = _serve(JAdminServer, JBundles, state, "j404")
    with port_admin, jax_admin:
        got = chip_smoke.http_get(f"http://127.0.0.1:{port_admin.port}/nope")
        want = chip_smoke.http_get(f"http://127.0.0.1:{jax_admin.port}/nope")
    assert got == want and got[0] == 404
    assert got[2].decode().split("try ")[1].split() == list(chip_smoke.ADMIN_ROUTES)


def test_metrics_text_parses_and_holds_the_registry(state):
    registry = state["attachments"]["registry"]
    port_admin, _ = _serve(AdminServer, BundleManager, state, "pm")
    jax_admin, _ = _serve(JAdminServer, JBundles, state, "jm")
    with port_admin, jax_admin:
        texts = [chip_smoke.http_get(f"http://127.0.0.1:{a.port}/metrics")[2].decode()
                 for a in (port_admin, jax_admin)]
    want = [line for line in render_prometheus(registry.export()).splitlines()
            if not line.startswith("#")]
    for text in texts:
        lines = text.splitlines()
        assert set(want) <= set(lines)
        bad = [line for line in lines if line and not line.startswith("#")
               and not chip_smoke.PROMETHEUS_SAMPLE.match(line)]
        assert not bad, bad[:5]
    assert "prober_probes" in texts[0]


def test_stale_probe_turns_healthz_503_as_jax(state):
    prober, clock = state["prober"], state["clock"]
    port_admin, _ = _serve(AdminServer, BundleManager, state, "ph")
    jax_admin, _ = _serve(JAdminServer, JBundles, state, "jh")
    with port_admin, jax_admin:
        def health():
            return [chip_smoke.http_get(f"http://127.0.0.1:{a.port}/healthz")
                    for a in (port_admin, jax_admin)]

        fresh = health()
        clock.now += 10.0  # past the 5 s window since the last pass
        stale = health()
        prober.run_cycle()
        again = health()
    assert [s for s, _, _ in fresh] == [200, 200]
    assert [s for s, _, _ in stale] == [503, 503]
    assert stale[0][2] == stale[1][2]
    detail = json.loads(stale[0][2])
    assert detail["status"] == "unhealthy"
    assert detail["stale_probes"] == sorted(prober.kinds())
    assert [s for s, _, _ in again] == [200, 200]


def test_statusz_shows_the_overlap_and_the_ledger(state):
    telemetry = DeviceTelemetry()
    telemetry.transfers.record_h2d(1 << 20, "db_staging")
    telemetry.transfers.record_overlap(12.5, "db_staging")
    telemetry.transfers.record_sync("db_staging", wait_ms=1.5)
    port_admin = AdminServer(port=0, device=telemetry, **state["attachments"])
    with port_admin:
        status, ctype, body = chip_smoke.http_get(
            f"http://127.0.0.1:{port_admin.port}/statusz?format=json")
        html = chip_smoke.http_get(f"http://127.0.0.1:{port_admin.port}/statusz")[2]
    transfers = json.loads(body)["device"]["transfers"]
    assert transfers["totals"]["overlapped_ms"] == 12.5
    assert b"transfer time: 12.5 ms hidden behind host" in html
