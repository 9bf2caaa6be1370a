"""The serving runtime's overload control and sparse sessions on the card,
against the same sessions on the CPU.

Marked `cuda`; each test skips without a CUDA device. At 2^12 records of
32 B and 1,000 sparse keys (numpy seeds):

* a Leader and a Helper with cost-aware admission and tenants answer
  concurrent requests on the card with the bytes of the same pair on the
  CPU; under brownout step 3 (the streaming tier floor) each party's own
  launches equal the streaming plan of the batches it formed, and the
  ladder's revert restores the materialized tier;
* the sparse sessions answer with the CPU's bytes in every role (plain,
  Leader behind Helper, the bare Helper leg), and a `build_from` rotation
  on the card stages only the touched bucket rows.

This file imports no JAX, so on a machine with a card and without JAX it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_overload.py
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch import serialization
from distributed_point_functions_tpu_torch.capacity import BrownoutController, TenantPolicy
from distributed_point_functions_tpu_torch.observability import propagation
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingSparseDpfPirServer,
    DenseDpfPirClient,
    DenseDpfPirDatabase,
)
from distributed_point_functions_tpu_torch.pir import server as pir_server
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    ServingConfig,
    SnapshotManager,
    SparseHelperSession,
    SparseLeaderSession,
    SparsePlainSession,
    make_sparse_client,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402 - the plans' launch counts

pytestmark = pytest.mark.cuda

NUM_RECORDS = 1 << 12
RECORD_BYTES = 32
SPARSE_KEYS = 1000
# Covers a first request's build of the kernels.
TIMEOUT_MS = 600_000.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clear_tier_floor():
    yield
    pir_server.clear_tier_floor()


def _pair(records, device, config):
    helper = HelperSession(DenseDpfPirDatabase(records, device=device),
                           encrypt_decrypt.decrypt, config, device=device)
    leader = LeaderSession(DenseDpfPirDatabase(records, device=device),
                           InProcessTransport(helper.handle_wire), config, device=device)
    leader.set_tenant("gold", TenantPolicy(weight=3.0, priority=2))
    leader.set_tenant("bronze", TenantPolicy(weight=1.0, priority=1))
    return leader, helper


def test_admitted_sessions_equal_cpu_and_launch_the_cheap_tier_plan(dev):
    rng = np.random.default_rng(1717)
    records = [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    wires = [serialization.serialize_pir_request(
        client.dpf, client.create_request([int(i)])[0])
        for i in rng.integers(0, NUM_RECORDS, 24)]
    config = ServingConfig(max_batch_size=8, request_timeout_ms=TIMEOUT_MS,
                           admission_enabled=True, admission_queue_budget_ms=1e9)
    answers = {}
    for device in ("cpu", dev):
        leader, helper = _pair(records, device, config)
        out = [None] * len(wires)

        def serve(k, leader=leader, out=out):
            out[k] = leader.handle_wire(wires[k], tenant=["gold", "bronze"][k % 2])

        threads = [threading.Thread(target=serve, args=(k,)) for k in range(len(wires))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_MS / 1e3)
        answers[str(device)] = out
        if device != "cpu":
            ladder = leader.attach_brownout(BrownoutController(), cheap_tier="streaming")
            ladder.force_level(3)
            before = {p: s.launches for p, s in (("leader", leader), ("helper", helper))}
            for w in wires[:4]:  # one request a batch: a one-key bucket
                leader.handle_wire(w, tenant="gold")
            plan = leader.server._plan_serving(1)
            assert plan.mode == "streaming"
            want = {n: 4 * c // 2 for n, c in chip_smoke.tier_launches(
                plan, leader.server.expansion, 1).items()}
            for party, session in (("leader", leader), ("helper", helper)):
                own = session.launches
                got = {n: own.get(n, 0) - before[party].get(n, 0) for n in own}
                assert {n: c for n, c in got.items() if c} == want, party
            ladder.force_level(0)
            assert pir_server.tier_floor() == "materialized"
            assert leader.server._plan_serving(1).mode == "materialized"
        leader.close()
        helper.close()
    assert answers[str(dev)] == answers["cpu"]


def _sparse_db(params, records, device):
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params)
    for kv in records.items():
        builder.insert(kv)
    return builder.build(device=device)


def test_sparse_sessions_equal_cpu_in_every_role(dev):
    rng = np.random.default_rng(1818)
    records = {b"k%06d" % i: rng.bytes(16) for i in range(SPARSE_KEYS)}
    params = CuckooHashingSparseDpfPirServer.generate_params(
        SPARSE_KEYS, seed=b"0123456789abcdef")
    keys = list(records)
    queries = [keys[int(i)] for i in rng.integers(0, SPARSE_KEYS, 6)] + [b"absent"]
    config = ServingConfig(request_timeout_ms=TIMEOUT_MS, admission_enabled=True,
                           admission_queue_budget_ms=1e9)
    upserts = [(keys[i], rng.bytes(16)) for i in range(32)]
    upserts += [(b"new%03d" % i, rng.bytes(16)) for i in range(32)]
    out = {}
    for device in ("cpu", dev):
        legs = []
        helper = SparseHelperSession(params, _sparse_db(params, records, device),
                                     encrypt_decrypt.decrypt, config, device=device)

        def helper_wire(data, helper=helper, legs=legs):
            legs.append(data)
            return helper.handle_wire(data)

        leader = SparseLeaderSession(params, _sparse_db(params, records, device),
                                     InProcessTransport(helper_wire), config, device=device)
        plain = SparsePlainSession(params, _sparse_db(params, records, device), config,
                                   device=device)
        client = make_sparse_client(leader, encrypt_decrypt.encrypt)
        if device == "cpu":
            request, _ = client.create_request(queries)
            r0, _ = client.create_plain_requests(queries)
            wires = (serialization.serialize_pir_request(leader.server.dpf, request),
                     serialization.serialize_pir_request(leader.server.dpf, r0))
        got = [leader.handle_wire(wires[0]), plain.handle_wire(wires[1])]
        got.append(helper.handle_wire(propagation.try_decode_request_ext(legs[0])[1]))
        # A rotation of 64 upserts stages only the touched bucket rows.
        manager = SnapshotManager(plain)
        builder = CuckooHashedDpfPirDatabase.Builder()
        for kv in upserts:
            builder.insert(kv)
        db1 = builder.build_from(plain.server.database)
        manager.stage(db1)
        stage = manager.export()["last_stage"]
        assert stage["mode"] == "delta" and stage["bytes_saved"] > 0
        manager.flip()
        got.append(plain.handle_wire(wires[1]))
        out[str(device)] = got
        for s in (leader, helper, plain):
            s.close()
    assert out[str(dev)] == out["cpu"]
