"""The fleet telemetry plane: per-replica scopes, the aggregator and the
admin's fleet routes.

* A session's and a `SnapshotManager`'s own events land in the replica's
  scoped journal once `ReplicaTelemetry.adopt` has run (`set_journal`),
  each carrying the replica's id, and no longer in the process journal;
  `set_journal(None)` routes them back. The session's event is a real
  one: the Helper leg fails under the `service.helper_leg` failpoint
  until the Leader's breaker opens, which also drains the replica.
* `FleetTelemetry` against the JAX package's, with equality: the same
  duck-typed stub replicas (each package's own registry) under one
  injected clock give equal `sample()` results, `export()`, `healthz()`,
  `timeline()` (each replica's events in order) and fleet bundles, less
  wall-clock stamps, trace ids, the wall-anchored clock rebase and bundle
  paths.
* An `AdminServer` with a `ReplicaSet`, a `FleetTelemetry`, the fleet's
  registry, time-series store, bundles and journal attached
  (`chip_smoke.fleet_admin`) answers every route
  with the status and content type of the JAX package's `AdminServer`
  given the same attachments, which is the table `chip_smoke.py` gates
  the card's fleet scrape on (`chip_smoke.FLEET_ADMIN_ROUTES`); the
  fleet routes' bodies carry every replica.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest

import distributed_point_functions_tpu.observability.bundle as j_bundle
from distributed_point_functions_tpu.observability.admin import AdminServer as JAdminServer
import distributed_point_functions_tpu_torch.observability.bundle as p_bundle
from distributed_point_functions_tpu_torch.capacity.model import CapacityModel
from distributed_point_functions_tpu_torch.fleet import (
    FleetTelemetry,
    Replica,
    ReplicaSet,
)
from distributed_point_functions_tpu_torch.observability import events as p_events
from distributed_point_functions_tpu_torch.observability.admin import AdminServer
from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient, DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.robustness import failpoints
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    HelperUnavailable,
    InProcessTransport,
    LeaderSession,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

import chip_smoke
from test_torch_fleet import PACKAGES, FakeClock, make_fleet

# Keys that differ between two runs of one script: wall-clock stamps, trace
# ids, the wall-anchored rebase and each run's own bundle directory.
WALL = ("t_wall", "trace_id", "t_fleet", "offsets", "path", "directory")


def _timeless(obj):
    """`obj` less the keys of `WALL`."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, (list, tuple)):
        return [_timeless(v) for v in obj]
    return obj


def _dump(obj):
    return _timeless(json.loads(json.dumps(obj, sort_keys=True, default=str)))


# -- the repair: sessions and managers journal into their replica's scope ------

RECORDS = [bytes([i]) * 16 for i in range(64)]


def test_session_and_flip_events_land_in_the_replica_scope():
    process = p_events.default_journal()
    p_events.set_default_journal(p_events.EventJournal(capacity=256))
    config = ServingConfig(max_batch_size=4, request_timeout_ms=60_000.0,
                           helper_retries=0, breaker_failure_threshold=2,
                           breaker_reset_ms=60_000.0)
    ldb = DenseDpfPirDatabase(RECORDS, device="cpu")
    hdb = DenseDpfPirDatabase(RECORDS, device="cpu")
    helper = HelperSession(hdb, encrypt_decrypt.decrypt, config, device="cpu")
    leader = LeaderSession(ldb, InProcessTransport(helper.handle_wire), config,
                           device="cpu")
    try:
        lm, hm = SnapshotManager(leader), SnapshotManager(helper)
        replica_set = ReplicaSet()
        replica = replica_set.add(Replica("r7", leader, helper, leader_snapshots=lm,
                                          helper_snapshots=hm, capacity=CapacityModel()))
        scope = FleetTelemetry(replica_set).scope(replica)
        client = DenseDpfPirClient.create(len(RECORDS), encrypt_decrypt.encrypt)
        request, state = client.create_request([5])
        assert client.handle_response(leader.handle_request(request), state)[0] == RECORDS[5]
        failpoints.default_failpoints().arm("service.helper_leg", "error", times=None)
        try:
            for _ in range(2):
                with pytest.raises(HelperUnavailable):
                    leader.handle_request(client.create_request([1])[0])
        finally:
            failpoints.default_failpoints().clear()
        assert leader.breaker.state == "open"
        assert replica_set.state("r7") == "draining"
        builder = DenseDpfPirDatabase.Builder()
        builder.update(5, b"\xee" * 16)
        hm.stage(builder.build_from(hdb))
        hm.flip()
        lm.stage(builder.build_from(ldb))
        lm.flip()
        scoped = scope.journal.tail(n=256)
        kinds = [e["kind"] for e in scoped]
        assert "breaker.transition" in kinds and kinds.count("snapshot.flip") == 2
        assert {e["replica"] for e in scoped} == {"r7"}
        unscoped = [e["kind"] for e in p_events.default_journal().tail(n=256)]
        assert "breaker.transition" not in unscoped and "snapshot.flip" not in unscoped
        # None restores the process journal.
        leader.set_journal(None)
        lm.set_journal(None)
        leader._emit("service.note", "to the process journal")
        lm.abort("nothing staged")
        unscoped = [e["kind"] for e in p_events.default_journal().tail(n=256)]
        assert "service.note" in unscoped and "snapshot.abort" in unscoped
    finally:
        p_events.set_default_journal(process)
        leader.close()
        helper.close()


# -- FleetTelemetry against the JAX package's ----------------------------------


def telemetry_script(pkg, tmp_path):
    clock = FakeClock()
    rs, replicas, journal, _ = make_fleet(pkg, clock, helpers=True)
    router = pkg.fleet.FleetRouter(rs, journal=journal, metrics=pkg.metrics.MetricsRegistry())
    rotation = pkg.fleet.FleetRotationCoordinator(rs, quorum=2, clock=clock, journal=journal)
    telemetry = pkg.fleet.FleetTelemetry(rs, router=router, rotation=rotation,
                                         journal=journal, clock=clock)
    for replica in replicas:
        telemetry.scope(replica)
    rotation.set_telemetry(telemetry)
    bundles = (j_bundle if pkg is PACKAGES["jax"] else p_bundle).BundleManager(
        directory=str(tmp_path), cooldown_s=60.0, clock=clock, journal=journal)
    telemetry.wire_bundles(bundles)
    out = [telemetry.sample()]
    for t in range(6):
        router.handle_request("q", tenant=f"t{t}")
    replicas[1].leader.metrics.gauge("r1.batcher.device_feed_efficiency").set(0.5)
    replicas[2].leader.metrics.gauge("r2.batcher.device_feed_efficiency").set(0.25)
    clock.now += 10.0
    out.append(telemetry.sample())
    rotation.rotate({r.replica_id: (SimpleNamespace(generation=1),
                                    SimpleNamespace(generation=1)) for r in replicas})
    clock.now += 1.0
    out.append(telemetry.healthz())
    rs.kill("r1", reason="test")
    rs.kill("r2", reason="test")
    clock.now += 1.0
    out.append(telemetry.healthz())
    for timeline in (telemetry.timeline(), telemetry.timeline(kind="fleet.replica_state"),
                     telemetry.timeline(n=12, min_severity="warning")):
        # The journals' order in the merge rests on the wall clock (the
        # rebase), which the injected clock does not drive.
        timeline["events"].sort(key=lambda e: (e["replica"], e["seq"]))
        out.append(timeline)
    out.append(telemetry.export())
    out.append([dataclasses.asdict(o) for o in pkg.fleet.default_fleet_objectives()])
    out.append({k: v for k, v in bundles.export().items() if k != "bundles"})
    out.append(sorted(bundles.export()["bundles"][0]["sources"]))
    return _dump(out)


def test_fleet_telemetry_equals_jax(tmp_path):
    got = telemetry_script(PACKAGES["port"], tmp_path / "port")
    want = telemetry_script(PACKAGES["jax"], tmp_path / "jax")
    assert got == want
    first, second, ok, degraded = got[:4]
    assert second["routable"] == 3 and second["qps"] == 0.6
    assert ok["status"] == "ok" and degraded["status"] == "degraded"
    assert [b["name"] for b in degraded["breaches"]] == ["fleet_routable_floor"]
    assert {"replica_r0", "replica_r1", "replica_r2", "fleet_timeline",
            "fleet_status"} <= set(got[-1])


# -- the admin's fleet routes ----------------------------------------------------


@pytest.fixture(scope="module")
def fleet_state(tmp_path_factory):
    pkg = PACKAGES["port"]
    clock = FakeClock()
    rs, replicas, journal, _ = make_fleet(pkg, clock, helpers=True)
    router = pkg.fleet.FleetRouter(rs, journal=journal)
    telemetry = pkg.fleet.FleetTelemetry(rs, router=router, journal=journal)
    for replica in replicas:
        scope = telemetry.scope(replica)
        scope.journal.emit("snapshot.flip", "generation 0 -> 1")
    for t in range(6):
        router.handle_request("q", tenant=f"t{t}")
    telemetry.sample()
    return dict(rs=rs, telemetry=telemetry, journal=journal, dirs=tmp_path_factory)


def _serve(cls, bundles_mod, state, name):
    """`cls` with the attachments of `chip_smoke.fleet_phase`'s admin step."""
    work = state["dirs"].mktemp(name)
    return chip_smoke.fleet_admin(cls, bundles_mod.BundleManager(str(work / "bundles")),
                                  state["rs"], state["telemetry"], state["journal"],
                                  str(work))


def test_fleet_routes_answer_as_jax_and_as_the_smoke_table(fleet_state):
    port_admin = _serve(AdminServer, p_bundle, fleet_state, "port")
    jax_admin = _serve(JAdminServer, j_bundle, fleet_state, "jax")
    with port_admin, jax_admin:
        port = chip_smoke.scrape_admin(port_admin.port, chip_smoke.FLEET_ADMIN_ROUTES)
        jax_side = chip_smoke.scrape_admin(jax_admin.port, chip_smoke.FLEET_ADMIN_ROUTES)
    assert tuple(chip_smoke.FLEET_ADMIN_ROUTES) == port_admin.routes == jax_admin.routes
    got = {route: (status, ctype) for route, (status, ctype, _) in port.items()}
    want = {route: (status, ctype) for route, (status, ctype, _) in jax_side.items()}
    assert got == want == chip_smoke.FLEET_ADMIN_ROUTES
    fleetz = json.loads(port["/fleetz"][2])
    assert sorted(fleetz["replicas"]) == ["r0", "r1", "r2"]
    assert sorted(json.loads(jax_side["/fleetz"][2])) == sorted(fleetz)
    assert port["/fleet-statusz"][2].startswith(b"# fleet status")
    for route in ("/fleet-statusz", "/fleet-timelinez"):
        assert port[route][2].split(b"\n")[0] == jax_side[route][2].split(b"\n")[0]


def test_fleet_timeline_json_carries_every_replica(fleet_state):
    with _serve(AdminServer, p_bundle, fleet_state, "timeline") as admin:
        status, _, body = chip_smoke.http_get(
            f"http://127.0.0.1:{admin.port}/fleet-timelinez?format=json")
        status_json, _, statusz = chip_smoke.http_get(
            f"http://127.0.0.1:{admin.port}/fleet-statusz?format=json")
    assert status == status_json == 200
    events = json.loads(body)["events"]
    flips = {e["replica"] for e in events if e["kind"] == "snapshot.flip"}
    assert flips == {"r0", "r1", "r2"}
    doc = json.loads(statusz)
    assert doc["verdict"]["status"] == "ok" and sorted(doc["replicas"]) == ["r0", "r1", "r2"]
