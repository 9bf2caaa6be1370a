"""The replica fleet: registry, router, quorum rotation and the
cross-replica probe.

Against the JAX package, with equality: one set of duck-typed stubs (a
session, a breaker, a price model, a snapshot manager; the registry,
events, failpoints and `Overloaded` each package's own) drives both
packages' `ReplicaSet`, `FleetRouter`, `FleetRotationCoordinator` and
`CrossReplicaProbe` through the same scripted steps under an injected
clock. Their answers, exceptions, exports and journals (less wall-clock
stamps and trace ids) must be equal.

Against the records oracle: the port's fleet on `device="cpu"`, three
Leader/Helper replicas at 128 records x 24 B (each party its own
database and `SnapshotManager`, the Leader reaching its Helper in
process). Every answer routed through the `FleetRouter` reconstructs to
its generation's records; a shed replica's tenants spill over within
their generation; a quorum rotation flips every replica, a replica whose
`fleet.stage.<rid>` failpoint fires is shed, brought back and readmitted,
as is one whose flip faults (its aborted delta staged again from its
base's staging), and two failed stagings make `QuorumFailed` with nothing
flipped; a delta that serves, staged, lets go of its base; the
`CrossReplicaProbe` passes, reports a split during a rotation without
failing, and fails on a word XORed into one replica's staging.
"""

import contextlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import distributed_point_functions_tpu.fleet as j_fleet
import distributed_point_functions_tpu.observability.events as j_events
import distributed_point_functions_tpu.robustness.failpoints as j_failpoints
import distributed_point_functions_tpu.serving.batcher as j_batcher
import distributed_point_functions_tpu.serving.metrics as j_metrics
import distributed_point_functions_tpu.serving.prober as j_prober
import distributed_point_functions_tpu_torch.fleet as p_fleet
import distributed_point_functions_tpu_torch.observability.events as p_events
import distributed_point_functions_tpu_torch.robustness.failpoints as p_failpoints
import distributed_point_functions_tpu_torch.serving.batcher as p_batcher
import distributed_point_functions_tpu_torch.serving.metrics as p_metrics
import distributed_point_functions_tpu_torch.serving.prober as p_prober
from distributed_point_functions_tpu_torch.capacity.model import CapacityModel
from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient, DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.serving import (
    CrossReplicaProbe,
    HelperSession,
    InProcessTransport,
    LeaderSession,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.serving.service import evaluated_generation
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

import chip_smoke

PACKAGES = {
    "jax": SimpleNamespace(fleet=j_fleet, events=j_events, failpoints=j_failpoints,
                           metrics=j_metrics, Overloaded=j_batcher.Overloaded,
                           prober=j_prober),
    "port": SimpleNamespace(fleet=p_fleet, events=p_events, failpoints=p_failpoints,
                            metrics=p_metrics, Overloaded=p_batcher.Overloaded,
                            prober=p_prober),
}


class FakeClock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


class StubBreaker:
    def __init__(self):
        self.listeners = []

    def on_transition(self, cb):
        self.listeners.append(cb)

    def force(self, old, new):
        for cb in self.listeners:
            cb(old, new)


class StubCapacity:
    """A price model with a pinned device-ms a probe batch."""

    def __init__(self, device_ms):
        self.device_ms = float(device_ms)
        self.replica = None

    def set_replica(self, rid):
        self.replica = rid

    def price_export(self, num_keys=8, num_blocks=None):
        return {"replica": self.replica, "probe_keys": num_keys,
                "num_blocks": num_blocks, "device_ms": self.device_ms}


class StubManager:
    """A party's `SnapshotManager`: stages database stand-ins, flips on
    the injected clock, and fails to stage while `fail` is set."""

    def __init__(self, clock, name, log):
        self.clock, self.name, self.log = clock, name, log
        self.generation = 0
        self.staged = None
        self.pins = 0
        self.fail = False
        self.journal = None

    def serving_generation(self):
        return self.generation

    def staging_generation(self):
        return None if self.staged is None else self.staged.generation

    @contextlib.contextmanager
    def pin(self):
        self.pins += 1
        try:
            yield self.generation
        finally:
            self.pins -= 1

    def stage(self, db):
        if self.fail:
            raise RuntimeError(f"{self.name}: disk gone")
        self.staged = db
        self.log.append((self.name, "stage", db.generation))
        return 1000 + db.generation

    def flip(self, timeout=10.0):
        if self.staged is None:
            raise RuntimeError(f"{self.name}: nothing staged")
        self.clock.now += 0.002
        self.generation, self.staged = self.staged.generation, None
        self.log.append((self.name, "flip", self.generation))
        return {"to_generation": self.generation}

    def abort(self, reason):
        self.staged = None
        self.log.append((self.name, "abort", reason))

    def note_staleness(self, ms):
        self.log.append((self.name, "staleness", round(ms, 3)))

    def set_journal(self, journal):
        self.journal = journal


class StubSession:
    """A Leader session: answers with its name and generation, sheds with
    `shed`, and keeps the gauges and the latency histogram the fleet reads."""

    def __init__(self, pkg, name, manager=None, role="plain"):
        self.name = name
        self.manager = manager
        self.shed = None
        self.breaker = StubBreaker()
        self.degraded = False
        self.metrics = pkg.metrics.MetricsRegistry()
        self.depth = self.metrics.gauge(f"{name}.batcher.queue_depth")
        self.server = SimpleNamespace(database=SimpleNamespace(generation=0), role=role,
                                      _num_blocks=64)
        self.journal = None
        self.records = None  # the golden records a probe pair must answer
        self._calls = 0

    def handle_request(self, request, deadline=None, tenant="default"):
        if self.shed is not None:
            raise self.shed
        self.metrics.histogram(f"{self.name}.request_ms").observe(1.0)
        if self.records is not None:
            # One probe pair: the first share carries the records XOR a
            # mask, the second the mask.
            self._calls += 1
            mask = bytes([(self._calls + 1) // 2 % 251]) * 4
            if self._calls % 2:
                return _response([_xor(r, mask) for r in self.records])
            return _response([mask] * len(self.records))
        generation = self.manager.generation if self.manager else 0
        return (self.name, request, tenant, generation)

    def set_journal(self, journal):
        self.journal = journal


def _xor(a, b):
    return bytes(x ^ y for x, y in zip(a, b))


def _response(masked):
    return SimpleNamespace(dpf_pir_response=SimpleNamespace(masked_response=masked))


def _events(journal):
    """The journal's events less their wall-clock stamps and random trace ids."""
    return [{k: v for k, v in e.items() if k not in ("t_wall", "trace_id")}
            for e in journal.tail(n=256)]


def _dump(obj):
    return json.loads(json.dumps(obj, sort_keys=True, default=str))


def make_fleet(pkg, clock, prices=(1.0, 2.0, 0.5), helpers=False):
    journal = pkg.events.EventJournal(clock=clock)
    rs = pkg.fleet.ReplicaSet(journal=journal, clock=clock)
    log = []
    replicas = []
    for i, price in enumerate(prices):
        rid = f"r{i}"
        lm = StubManager(clock, f"{rid}.leader", log)
        hm = StubManager(clock, f"{rid}.helper", log) if helpers else None
        leader = StubSession(pkg, rid, lm)
        helper = StubSession(pkg, f"{rid}h", hm) if helpers else None
        replicas.append(rs.add(pkg.fleet.Replica(
            rid, leader, helper, leader_snapshots=lm, helper_snapshots=hm,
            capacity=StubCapacity(price))))
    return rs, replicas, journal, log


class StubProber:
    def __init__(self):
        self.fresh = True

    def freshness(self):
        return {"pir_materialized": {"fresh": self.fresh, "identity": True},
                "hh_sweep": {"fresh": False, "identity": False}}


def registry_script(pkg):
    clock = FakeClock()
    rs, replicas, journal, _ = make_fleet(pkg, clock)
    out = []
    seen = []
    rs.add_listener(lambda *a: seen.append(a))
    replicas[0].prober = StubProber()
    for step, action in enumerate([
        lambda: replicas[1].leader.breaker.force("closed", "open"),
        lambda: replicas[1].leader.breaker.force("open", "closed"),
        lambda: rs.shed("r2", reason="operator"),
        lambda: replicas[2].leader.breaker.force("open", "closed"),  # stays drained
        lambda: rs.readmit("r2"),
        lambda: setattr(replicas[0].prober, "fresh", False),
        rs.refresh,
        lambda: setattr(replicas[0].prober, "fresh", True),
        rs.refresh,
        lambda: rs.kill("r1", reason="gone"),
        lambda: rs.mark("r1", "serving", reason="operator"),
    ]):
        clock.now += 0.25
        got = action()
        out.append((step, got, [r.replica_id for r in rs.healthy()],
                    [r.replica_id for r in rs.alive()], rs.generations()))
    for bad in (lambda: rs.mark("r0", "asleep"), lambda: rs.mark("nope", "serving"),
                lambda: rs.add(replicas[0])):
        with pytest.raises((ValueError, KeyError)) as e:
            bad()
        out.append(type(e.value).__name__)
    return _dump({"steps": out, "export": rs.export(), "listener": seen,
                  "events": _events(journal),
                  "replica_export": replicas[0].export()})


def test_replica_set_equals_jax():
    got, want = registry_script(PACKAGES["port"]), registry_script(PACKAGES["jax"])
    assert got == want
    assert got["export"]["sheds"] == 1 and got["export"]["deaths"] == 1
    assert [h["to"] for h in got["export"]["history"]][:2] == ["draining", "serving"]


def router_script(pkg):
    clock = FakeClock()
    rs, replicas, journal, _ = make_fleet(pkg, clock)
    metrics = pkg.metrics.MetricsRegistry()
    router = pkg.fleet.FleetRouter(rs, journal=journal, metrics=metrics, storm_window=8)
    replicas[2].leader.depth.set(9.0)  # cheap but backlogged: 0.5 x 10 > 1 x 1
    out = []

    def call(tenant, request="q"):
        try:
            got = router.handle_request(request, tenant=tenant)
            out.append(("served", tenant, got[0], got[3]))
        except pkg.Overloaded as e:
            out.append(("shed", tenant, str(e), e.reason, e.retry_after_s))

    for t in range(4):
        call(f"t{t}")
    out.append(("pick", router.pick("t0").replica_id, router.affinity("t1")))
    replicas[0].leader.shed = pkg.Overloaded("queue full", retry_after_s=0.5,
                                             reason="queue_cost")
    for t in range(4):
        call(f"t{t}")
    replicas[2].snapshots.generation = 1  # mid-rotation: no spillover there
    replicas[2].leader.depth.set(0.0)
    call("t0")
    replicas[1].leader.shed = pkg.Overloaded("busy", retry_after_s=0.25, reason="quota")
    call("t0")
    replicas[2].leader.shed = pkg.Overloaded("busy", retry_after_s=0.0, reason="quota")
    call("t5")
    for r in replicas:
        r.leader.shed = None
    rs.shed("r0", reason="operator")
    call("t0")
    router.forget("t3")
    call("t3")
    for r in replicas:
        r.leader.shed = pkg.Overloaded("down", reason="queue_cost")
    call("t9")
    rs.kill("r1")
    rs.kill("r2")
    call("t9")
    return _dump({"calls": out, "export": router.export(),
                  "counters": metrics.export()["counters"],
                  "rate": router.spillover_rate_pct(), "events": _events(journal)})


def test_router_equals_jax():
    got, want = router_script(PACKAGES["port"]), router_script(PACKAGES["jax"])
    assert got == want
    export = got["export"]
    assert export["spillovers"] > 0 and export["generation_skips"] > 0
    assert export["fleet_sheds"] == 3 and export["affinity_moves"] > 0


def rotation_script(pkg):
    clock = FakeClock()
    rs, replicas, journal, log = make_fleet(pkg, clock, helpers=True)
    coordinator = pkg.fleet.FleetRotationCoordinator(rs, quorum=2, clock=clock,
                                                     journal=journal)
    registry = pkg.failpoints.default_failpoints()
    out = []

    def dbs(generation):
        return {r.replica_id: (SimpleNamespace(generation=generation),
                               SimpleNamespace(generation=generation))
                for r in replicas}

    def generations():
        return [(r.snapshots.generation, r.helper_snapshots.generation) for r in replicas]

    try:
        out.append(coordinator.rotate(dbs(1)))
        registry.arm("fleet.stage.r1", "error", times=1)
        out.append(coordinator.rotate(lambda r: dbs(2)[r.replica_id]))
        registry.clear()
        registry.arm("fleet.stage.r0", "error", times=1)
        registry.arm("fleet.stage.r2", "error", times=1)
        with pytest.raises(pkg.fleet.QuorumFailed) as e:
            coordinator.rotate(dbs(3))
        out.append((str(e.value), e.value.acked, e.value.failed, e.value.quorum))
        out.append(generations())
        registry.clear()
        # A laggard whose re-stage fails too is buried.
        replicas[2].helper_snapshots.fail = True
        out.append(coordinator.rotate(dbs(4)))
        with pytest.raises(ValueError):
            coordinator.rotate({r.replica_id: (SimpleNamespace(generation=5), None)
                                for r in replicas})
    finally:
        registry.clear()
    out.append(generations())
    return _dump({"out": out, "log": log, "export": coordinator.export(),
                  "set": rs.export(), "events": _events(journal)})


def test_rotation_equals_jax():
    got, want = rotation_script(PACKAGES["port"]), rotation_script(PACKAGES["jax"])
    assert got == want
    first, lagged, failed, before, buried = got["out"][:5]
    assert first["flipped"] == ["r0", "r1", "r2"] and first["laggards"] == {}
    assert lagged["laggards"] == {"r1": "recovered"}
    assert failed[1] == ["r1"] and sorted(failed[2]) == ["r0", "r2"]
    assert before == [[2, 2]] * 3
    assert buried["laggards"] == {"r2": "dead"}
    assert got["set"]["counts"]["dead"] == 1


def probe_script(pkg):
    clock = FakeClock()
    records = [bytes([i]) * 4 for i in range(16)]
    indices = [0, 8, 15]
    rs, replicas, journal, _ = make_fleet(pkg, clock, helpers=True)
    for r in replicas:
        r.leader.records = [records[i] for i in indices]
    provider_calls = []

    def provider(generation):
        provider_calls.append(generation)
        return records if generation == 0 else None

    probe = pkg.prober.CrossReplicaProbe(
        rs.healthy, records, journal=journal, clock=clock,
        metrics=pkg.metrics.MetricsRegistry(), records_provider=provider)
    failures = []
    probe.add_failure_listener(failures.append)
    out = []

    def timeless(result):
        return {k: v for k, v in result.items() if k not in ("ms", "t_wall", "t_mono")}

    def cycle():
        out.append(timeless(probe.run_cycle()))

    cycle()
    replicas[1].leader.records = [b"\xff" * 4] + replicas[1].leader.records[1:]
    cycle()
    replicas[1].leader.records = [records[i] for i in indices]
    replicas[2].snapshots.generation = 1  # a split across generations
    replicas[2].leader.records = [b"\x01" * 4] * 3
    cycle()
    replicas[0].leader.shed = RuntimeError("replica down")
    clock.now += 3.0
    cycle()
    out.append(probe.last_pass_age_s())
    export = probe.export()
    export["history"] = [timeless(r) for r in export["history"]]
    return _dump({"out": out, "failures": len(failures), "export": export,
                  "events": _events(journal), "provider": provider_calls})


def test_cross_replica_probe_equals_jax():
    got, want = probe_script(PACKAGES["port"]), probe_script(PACKAGES["jax"])
    assert got == want
    statuses = [r["status"] for r in got["out"][:4]]
    assert statuses == ["pass", "mismatch", "pass", "pass"]
    assert got["out"][2]["generations"] == {"0": ["r0", "r1"], "1": ["r2"]}
    assert got["failures"] == 1 and got["out"][4] == 0.0


# -- the port's fleet on the CPU against the records oracle --------------------

N = 128
RECORD_BYTES = 24
_RNG = np.random.default_rng(16)
RECORDS = [_RNG.bytes(RECORD_BYTES) for _ in range(N)]
UPDATED = [3, 64, 127]


def _config(**kw):
    return ServingConfig(max_batch_size=8, max_wait_ms=2.0, request_timeout_ms=60_000.0,
                         **kw)


class Fleet:
    """Three port replicas on the CPU behind a `ReplicaSet` and a router."""

    def __init__(self, n=3):
        self.journal = p_events.EventJournal(capacity=1024)
        self.set = p_fleet.ReplicaSet(journal=self.journal)
        self.dbs = {}
        self.replicas = []
        for i in range(n):
            rid = f"r{i}"
            ldb = DenseDpfPirDatabase(RECORDS, device="cpu")
            hdb = DenseDpfPirDatabase(RECORDS, device="cpu")
            ldb.staged()  # a rotation then stages a delta
            hdb.staged()
            helper = HelperSession(hdb, encrypt_decrypt.decrypt, _config(), device="cpu")
            leader = LeaderSession(ldb, InProcessTransport(helper.handle_wire),
                                   _config(admission_enabled=True,
                                           admission_queue_budget_ms=1e9),
                                   device="cpu")
            replica = p_fleet.Replica(
                rid, leader, helper, leader_snapshots=SnapshotManager(leader),
                helper_snapshots=SnapshotManager(helper),
                capacity=CapacityModel())
            self.replicas.append(self.set.add(replica))
            self.dbs[rid] = (ldb, hdb)
        self.router = p_fleet.FleetRouter(self.set, journal=self.journal)
        self.client = DenseDpfPirClient.create(N, encrypt_decrypt.encrypt)

    def records_at(self, generation):
        return [bytes([generation]) * RECORD_BYTES if generation and i in UPDATED
                else RECORDS[i] for i in range(N)]

    def ask(self, tenant, index):
        request, state = self.client.create_request([index])
        response = self.router.handle_request(request, tenant=tenant)
        return self.client.handle_response(response, state)[0], evaluated_generation()

    def traffic(self, tenants=4, per_tenant=4, rounds_done=None):
        """Tenants in threads, closed loop; returns [(tenant, index,
        answer, generation)]."""
        out, errors, lock = [], [], threading.Lock()

        def run(t):
            rng = np.random.default_rng(t)
            for k in range(per_tenant):
                i = UPDATED[k % len(UPDATED)] if k % 2 else int(rng.integers(0, N))
                try:
                    answer, generation = self.ask(f"t{t}", i)
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
                    return
                with lock:
                    out.append((f"t{t}", i, answer, generation))

        threads = [threading.Thread(target=run, args=(t,)) for t in range(tenants)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        if errors:
            raise errors[0]
        assert len(out) == tenants * per_tenant
        return out

    def check(self, answers):
        for tenant, i, answer, generation in answers:
            assert answer == self.records_at(generation)[i], (tenant, i, generation)

    def databases(self, generation):
        out = {}
        for rid, (ldb, hdb) in self.dbs.items():
            builder = DenseDpfPirDatabase.Builder()
            for i in UPDATED:
                builder.update(i, self.records_at(generation)[i])
            out[rid] = (builder.build_from(ldb), builder.build_from(hdb))
        return out

    def rotate(self, generation, **kw):
        dbs = self.databases(generation)
        report = p_fleet.FleetRotationCoordinator(self.set, quorum=2, **kw).rotate(dbs)
        self.dbs = dbs
        return report

    def close(self):
        for r in self.replicas:
            r.leader.close()
            r.helper.close()


@pytest.fixture(scope="module")
def fleet():
    fleet = Fleet()
    yield fleet
    fleet.close()
    p_failpoints.default_failpoints().clear()


def test_fleet_answers_equal_the_records(fleet):
    answers = fleet.traffic()
    fleet.check(answers)
    assert {g for *_, g in answers} == {0}
    routed = fleet.router.export()["routed"]
    assert sum(routed.values()) == len(answers)
    assert fleet.router.export()["tenants"] == 4


def test_shed_replica_spills_over_within_its_generation(fleet):
    victim = fleet.replicas[0]
    tenant_on_victim = None
    for t in range(16):
        if fleet.router.pick(f"s{t}").replica_id == victim.replica_id:
            tenant_on_victim = f"s{t}"
            break
    assert tenant_on_victim is not None
    before = fleet.router.export()["spillovers"]
    victim.leader.admission.queue_budget_ms = 1e-9  # every request sheds
    try:
        answers = [(tenant_on_victim, i, *fleet.ask(tenant_on_victim, i)) for i in UPDATED]
    finally:
        victim.leader.admission.queue_budget_ms = 1e9
    fleet.check(answers)
    assert len({g for *_, g in answers}) == 1
    assert fleet.router.export()["spillovers"] - before == len(UPDATED)


def test_quorum_rotation_laggard_and_quorum_failure(fleet):
    registry = p_failpoints.default_failpoints()
    assert fleet.set.generations() == {"r0": 0, "r1": 0, "r2": 0}
    report = fleet.rotate(1)
    assert report["flipped"] == ["r0", "r1", "r2"] and report["laggards"] == {}
    assert all(m.export()["last_stage"]["mode"] == "delta"
               for r in fleet.replicas for m in r.managers())
    fleet.check(fleet.traffic())
    registry.arm("fleet.stage.r1", "error", times=1)
    try:
        report = fleet.rotate(2)
    finally:
        registry.clear()
    assert report["acked"] == ["r0", "r2"] and report["laggards"] == {"r1": "recovered"}
    export = fleet.set.export()
    assert export["counts"]["serving"] == 3 and export["readmissions"] >= 1
    answers = fleet.traffic()
    fleet.check(answers)
    assert {g for *_, g in answers} == {2}
    registry.arm("fleet.stage.r0", "error", times=1)
    registry.arm("fleet.stage.r2", "error", times=1)
    dbs = fleet.databases(3)
    try:
        with pytest.raises(p_fleet.QuorumFailed) as e:
            p_fleet.FleetRotationCoordinator(fleet.set, quorum=2).rotate(dbs)
    finally:
        registry.clear()
    assert e.value.acked == ["r1"]
    assert fleet.set.generations() == {"r0": 2, "r1": 2, "r2": 2}
    assert all(m.staging_generation() is None for r in fleet.replicas for m in r.managers())
    fleet.check(fleet.traffic(tenants=2, per_tenant=2))


def test_flip_fault_laggard_stages_again_and_is_readmitted(fleet):
    """A flip fault aborts the pair's staged candidates (their stagings
    released); the laggard then stages the same delta databases again,
    from their base's staging, flips and is readmitted."""
    registry = p_failpoints.default_failpoints()
    gen = fleet.set.generations()["r0"]
    registry.arm("snapshot.flip", "error", times=1)
    try:
        report = fleet.rotate(gen + 1)
    finally:
        registry.clear()
    assert report["flipped"] == ["r1", "r2"] and report["laggards"] == {"r0": "recovered"}
    assert "flip_error" in report["per_replica"]["r0"]
    assert fleet.set.generations() == {"r0": gen + 1, "r1": gen + 1, "r2": gen + 1}
    assert [m.export()["last_stage"]["mode"] for m in fleet.replicas[0].managers()] == [
        "delta", "delta"]
    answers = fleet.traffic(tenants=3, per_tenant=2)
    fleet.check(answers)
    assert {g for *_, g in answers} == {gen + 1}


@pytest.mark.parametrize("staged_before_swap", [True, False])
def test_a_serving_delta_lets_go_of_its_base(staged_before_swap):
    """Until it serves, a delta holds its base (an aborted candidate stages
    again from it); once swapped in and staged it holds it no more, so a
    caller that drops the old generation frees its staging."""
    import gc
    import weakref

    from distributed_point_functions_tpu_torch.pir.server import DenseDpfPirServer

    base = DenseDpfPirDatabase(RECORDS, device="cpu")
    base.staged()
    server = DenseDpfPirServer.create_plain(base, device="cpu")
    new = DenseDpfPirDatabase.Builder().update(UPDATED[0], b"\x01" * 24).build_from(base)
    if staged_before_swap:
        new.prestage()
        new.release_stagings()  # an aborted candidate: stages again from its base
        new.prestage()
        assert new.last_prestage_stats["mode"] == "delta"
    gone = weakref.ref(base)
    old = server.swap_database(new)
    if not staged_before_swap:
        new.staged()  # the first batch's staging, from the base's
    old.release_stagings()
    del base, old
    gc.collect()
    assert gone() is None
    assert new.rows_at([UPDATED[0], 1]).tobytes()[:48] == b"\x01" * 24 + RECORDS[1]


def test_cross_replica_probe_split_and_corruption(fleet):
    gen = fleet.set.generations()["r0"]
    failures = []
    probe = CrossReplicaProbe(fleet.set.healthy, fleet.records_at(gen),
                              generation=gen, records_provider=fleet.records_at,
                              indices=[0, UPDATED[0], N - 1], journal=fleet.journal)
    probe.add_failure_listener(failures.append)
    assert probe.run_cycle()["status"] == "pass"
    # A split: r0 alone moves on a generation.
    dbs = fleet.databases(gen + 1)
    r0 = fleet.replicas[0]
    r0.helper_snapshots.stage(dbs["r0"][1])
    r0.helper_snapshots.flip()
    r0.snapshots.stage(dbs["r0"][0])
    r0.snapshots.flip()
    split = probe.run_cycle()
    assert split["status"] == "pass"
    assert split["generations"] == {str(gen): ["r1", "r2"], str(gen + 1): ["r0"]}
    # Wrong bits in one replica's staging at a golden row.
    db = fleet.replicas[1].leader.server.database
    assert chip_smoke.xor_staged_word(db, UPDATED[0], 0, 0x5A5A) >= 1
    try:
        bad = probe.run_cycle()
    finally:
        chip_smoke.xor_staged_word(db, UPDATED[0], 0, 0x5A5A)
    assert bad["status"] == "mismatch" and bad["divergences"][0]["replica"] == "r1"
    assert len(failures) == 1
    assert [e["kind"] for e in fleet.journal.tail(kind="fleet.divergence")]
    assert probe.run_cycle()["status"] == "pass"
