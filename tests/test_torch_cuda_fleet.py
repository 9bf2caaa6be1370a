"""The replica fleet on the card.

Marked `cuda`; each test skips without a CUDA device. Three Leader/Helper
replicas at 2^12 x 32 B, every party a session over its own database on
the card with its own `SnapshotManager`, the Leader reaching its Helper
in process, behind a `ReplicaSet` and a `FleetRouter`:

* tenants' requests through the router reconstruct to their records, and
  each party's launches equal the plans of the buckets its batcher formed
  (`chip_smoke.planned_launches`);
* a quorum rotation to a delta whose first flip faults: the laggard's
  aborted delta stages again from its base's staging on the card, flips
  and is readmitted, and every answer after it is the new generation's;
  two failed stagings make `QuorumFailed` with nothing flipped;
* the `CrossReplicaProbe` passes, catches a word XORed into one replica's
  staging at a golden row, and passes again once it is undone.

This file imports no JAX, so on a machine with a card and without JAX it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_fleet.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.capacity.model import CapacityModel
from distributed_point_functions_tpu_torch.fleet import (
    FleetRotationCoordinator,
    FleetRouter,
    QuorumFailed,
    Replica,
    ReplicaSet,
)
from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient, DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.robustness import failpoints
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402 - the plans' launch counts, the staging XOR

pytestmark = pytest.mark.cuda

NUM_RECORDS = 1 << 12
RECORD_BYTES = 32
UPDATED = [7, 2048, NUM_RECORDS - 1]
# Covers a first request's build of the kernels.
CONFIG = ServingConfig(max_batch_size=8, max_wait_ms=2.0, request_timeout_ms=600_000.0)


def _records():
    rng = np.random.default_rng(1616)
    return [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]


RECORDS = _records()


def _at(generation):
    return [bytes([generation]) * RECORD_BYTES if generation and i in UPDATED
            else r for i, r in enumerate(RECORDS)]


@pytest.fixture(scope="module")
def fleet():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    replica_set = ReplicaSet()
    dbs = {}
    for k in range(3):
        rid = f"r{k}"
        ldb = DenseDpfPirDatabase(RECORDS, device=dev)
        hdb = DenseDpfPirDatabase(RECORDS, device=dev)
        ldb.staged()
        hdb.staged()
        helper = HelperSession(hdb, encrypt_decrypt.decrypt, CONFIG, device=dev)
        leader = LeaderSession(ldb, InProcessTransport(helper.handle_wire), CONFIG,
                               device=dev)
        replica_set.add(Replica(rid, leader, helper,
                                leader_snapshots=SnapshotManager(leader),
                                helper_snapshots=SnapshotManager(helper),
                                capacity=CapacityModel()))
        dbs[rid] = [ldb, hdb]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    yield dict(set=replica_set, router=FleetRouter(replica_set), dbs=dbs, client=client)
    failpoints.default_failpoints().clear()
    for r in replica_set.replicas():
        r.leader.close()
        r.helper.close()


def _ask(fleet, tenant, index):
    request, state = fleet["client"].create_request([index])
    response = fleet["router"].handle_request(request, tenant=tenant)
    generation = evaluated_generation()
    return fleet["client"].handle_response(response, state)[0], generation


def _delta(fleet, generation):
    out = {}
    for rid, (ldb, hdb) in fleet["dbs"].items():
        builder = DenseDpfPirDatabase.Builder()
        for i in UPDATED:
            builder.update(i, _at(generation)[i])
        out[rid] = (builder.build_from(ldb), builder.build_from(hdb))
    return out


def test_routed_answers_and_launches_equal_the_plans(fleet):
    parties = [(s, p) for r in fleet["set"].replicas()
               for s, p in ((r.leader, "leader"), (r.helper, "helper"))]
    before = [chip_smoke.launch_mark(s, p) for s, p in parties]
    for k, i in enumerate([0, 5, 7, 2048, NUM_RECORDS - 1, 99]):
        answer, generation = _ask(fleet, f"t{k}", i)
        assert (answer, generation) == (RECORDS[i], 0)
    torch.cuda.synchronize()
    for (session, party), mark in zip(parties, before):
        _, want, got = chip_smoke.planned_launches(session, party, mark)
        assert got == want


def test_flip_fault_laggard_and_quorum_failure_on_the_card(fleet):
    registry = failpoints.default_failpoints()
    coordinator = FleetRotationCoordinator(fleet["set"], quorum=2)
    new = _delta(fleet, 1)
    registry.arm("snapshot.flip", "error", times=1)
    try:
        report = coordinator.rotate(new)
    finally:
        registry.clear()
    assert report["laggards"] == {"r0": "recovered"}
    assert fleet["set"].generations() == {"r0": 1, "r1": 1, "r2": 1}
    assert [m.export()["last_stage"]["mode"]
            for m in fleet["set"].get("r0").managers()] == ["delta", "delta"]
    fleet["dbs"] = {rid: list(pair) for rid, pair in new.items()}
    for k, i in enumerate(UPDATED + [3]):
        assert _ask(fleet, f"t{k}", i) == (_at(1)[i], 1)
    registry.arm("fleet.stage.r0", "error", times=1)
    registry.arm("fleet.stage.r1", "error", times=1)
    try:
        with pytest.raises(QuorumFailed):
            coordinator.rotate(_delta(fleet, 2))
    finally:
        registry.clear()
    assert fleet["set"].generations() == {"r0": 1, "r1": 1, "r2": 1}
    assert _ask(fleet, "t0", UPDATED[0]) == (_at(1)[UPDATED[0]], 1)


def test_cross_replica_probe_catches_a_wrong_word(fleet):
    generation = fleet["set"].generations()["r0"]
    probe = CrossReplicaProbe(fleet["set"].healthy, _at(generation),
                              generation=generation, indices=[0, UPDATED[1]])
    assert probe.run_cycle()["status"] == "pass"
    db = fleet["set"].get("r2").leader.server.database
    chip_smoke.xor_staged_word(db, UPDATED[1], 3, 0x1234)
    try:
        bad = probe.run_cycle()
    finally:
        chip_smoke.xor_staged_word(db, UPDATED[1], 3, 0x1234)
    assert bad["status"] == "mismatch"
    assert [d["replica"] for d in bad["divergences"]] == ["r2"]
    assert probe.run_cycle()["status"] == "pass"
