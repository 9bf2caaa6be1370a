"""The serving runtime on the card, against the plain versions.

Marked `cuda`; each test skips without a CUDA device. At 2^12 records of
32 B (numpy seeds): a `PlainSession` on the card answers one request at
every key count that lands in each power-of-two bucket from 1 to 128
(and counts between), each equal to the same session on the CPU; a
Leader and a Helper session on the card answer concurrent threads with
the bytes of the same pair on the CPU; and a delta rotation on the card
stages only the updated rows and frees the retired generation's
staging. One batch's copies and syncs on the card are what the process
telemetry's transfer ledger records, byte for byte, and a session's
launch counts are its own. This file imports no JAX, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_serving.py
"""

import threading

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.observability.device import (
    DeviceTelemetry,
    default_telemetry,
    set_default_telemetry,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    messages,
)
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    PlainSession,
    RotationCoordinator,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

pytestmark = pytest.mark.cuda

NUM_RECORDS = 1 << 12
RECORD_BYTES = 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(4096)
    return [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]


# Every session's requests carry a deadline, so that a stalled batch fails
# its test instead of holding the test process; it covers a first
# request's build of the kernels.
TIMEOUT_MS = 600_000.0


def _plain(keys):
    return messages.PirRequest(plain_request=messages.PlainRequest(dpf_keys=keys))


def test_every_bucket_equals_the_plain_version(dev, records):
    rng = np.random.default_rng(1)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    config = ServingConfig(max_batch_size=128, request_timeout_ms=TIMEOUT_MS)
    card = PlainSession(DenseDpfPirDatabase(records, device=dev), config, device=dev)
    host = PlainSession(DenseDpfPirDatabase(records, device="cpu"), config, device="cpu")
    with card, host:
        for n in (1, 2, 3, 4, 7, 8, 16, 31, 32, 33, 64, 100, 127, 128):
            idx = [int(i) for i in rng.integers(0, NUM_RECORDS, n)]
            r0, r1 = client.create_plain_requests(idx)
            cuda_lib.reset_launch_counts()
            got = [card.handle_request(r).dpf_pir_response.masked_response
                   for r in (r0, r1)]
            assert cuda_lib.LAUNCHES["xor_inner_product"] == 2
            assert cuda_lib.LAUNCHES["leaf_blocks"] == 2
            want = [host.handle_request(r).dpf_pir_response.masked_response
                    for r in (r0, r1)]
            assert got == want
            assert [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(*got)] == [
                records[i] for i in idx]
        buckets = card.metrics.export()["counters"]
        assert {k for k in buckets if "bucket_batches" in k} == {
            f"plain.batcher.bucket_batches{{bucket={b}}}"
            for b in (1, 2, 4, 8, 16, 32, 64, 128)}


def _pair(records, device, config):
    helper = HelperSession(DenseDpfPirDatabase(records, device=device),
                           encrypt_decrypt.decrypt, config=config, device=device)
    leader = LeaderSession(DenseDpfPirDatabase(records, device=device),
                           InProcessTransport(helper.handle_wire), config=config,
                           device=device)
    return leader, helper


def test_leader_helper_on_the_card_equal_the_cpu(dev, records):
    rng = np.random.default_rng(2)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    reqs = [client.create_request([int(i)]) for i in rng.integers(0, NUM_RECORDS, 16)]
    config = ServingConfig(max_batch_size=8, max_wait_ms=5.0,
                           request_timeout_ms=TIMEOUT_MS)
    out = {}
    for device in (dev, "cpu"):
        leader, helper = _pair(records, device, config)
        got = [None] * len(reqs)

        def run(t):
            got[t] = leader.handle_request(reqs[t][0]).dpf_pir_response.masked_response

        with leader, helper:
            threads = [threading.Thread(target=run, args=(t,), daemon=True)
                       for t in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "a request never returned"
        out[str(device)] = got
    assert out[str(dev)] == out["cpu"]
    for (request, state), masked in zip(reqs, out["cpu"]):
        response = messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(masked_response=masked))
        assert client.handle_response(response, state)[0] in records


def test_delta_rotation_on_the_card_frees_the_retired_staging(dev, records):
    rng = np.random.default_rng(3)
    builder = DenseDpfPirDatabase.Builder()
    gen1 = list(records)
    for i in rng.choice(NUM_RECORDS, 64, replace=False):
        gen1[int(i)] = rng.bytes(RECORD_BYTES)
        builder.update(int(i), gen1[int(i)])
    leader, helper = _pair(records, dev, ServingConfig(request_timeout_ms=TIMEOUT_MS))
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with leader, helper:
        lm, hm = SnapshotManager(leader), SnapshotManager(helper)
        request, state = client.create_request([5])
        assert client.handle_response(leader.handle_request(request), state) == [records[5]]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        old = leader.server.database, helper.server.database
        RotationCoordinator(lm, hm).rotate(builder.build_from(old[0]),
                                           builder.build_from(old[1]))
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated(dev) - before) <= 2 << 20
        assert old[0].staged_bytes() == old[1].staged_bytes() == 0
        for m in (lm, hm):
            stage = m.export()["last_stage"]
            assert stage["mode"] == "delta" and stage["bytes_saved"] > 0
            assert stage["bytes_staged"] == 64 * (8 + RECORD_BYTES)
        for i in rng.integers(0, NUM_RECORDS, 8):
            request, state = client.create_request([int(i)])
            assert client.handle_response(leader.handle_request(request), state) == [
                gen1[int(i)]]
        want = DenseDpfPirDatabase(gen1, device=dev).staged()
        assert torch.equal(leader.server.database.staged(), want)


def test_one_batch_copies_and_syncs_in_the_transfer_ledger(dev, records):
    """One 3-key request (a bucket of 4) through a `PlainSession` on the
    card: the ledger holds the database's one staging copy and its
    publishing sync, the padded keys' staging bytes, and the result's
    one read-back with the one sync that ends the batch; the tracker one
    first dispatch of bucket 4; the memory accountant a `db_staging`
    watermark of at least the staging and the live bytes of
    `memory_allocated`. The session counts its own launches."""
    prev = default_telemetry()
    tel = set_default_telemetry(DeviceTelemetry())
    try:
        client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
        keys = client.create_plain_requests([1, 2, 3])[0].plain_request.dpf_keys
        db = DenseDpfPirDatabase(records, device=dev)
        config = ServingConfig(max_batch_size=8, request_timeout_ms=TIMEOUT_MS)
        with PlainSession(db, config, device=dev) as session:
            cuda_lib.reset_launch_counts()
            session.handle_request(_plain(keys))
            torch.cuda.synchronize()
            assert session.launches == {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            assert session.launches["xor_inner_product"] == 1
            walk_levels = session.server.walk_levels
        staged_db = db.staged()
        words = staged_db.shape[-1]
        staged_keys = stage_keys(keys + keys[:1], walk_levels, device=dev)
        out = tel.export()
        phases = out["transfers"]["phases"]
        assert set(phases) == {"db_staging", "key_staging", "result_readback"}
        assert phases["db_staging"]["h2d_copies"] == 1
        assert phases["db_staging"]["h2d_bytes"] == staged_db.numel() * staged_db.element_size()
        assert phases["db_staging"]["syncs"] == 1
        assert phases["key_staging"]["h2d_copies"] == 1
        assert phases["key_staging"]["h2d_bytes"] == sum(
            t.numel() * t.element_size() for t in staged_keys)
        assert phases["key_staging"]["syncs"] == 0
        readback = phases["result_readback"]
        assert (readback["d2h_copies"], readback["d2h_bytes"], readback["syncs"]) == (
            1, 4 * words * 4, 1)
        assert out["compile"]["sites"]["plain.batcher.evaluate"]["shapes"] == {
            "k4": {"compiles": 1, "hits": 0}}
        staging = staged_db.numel() * staged_db.element_size()
        assert tel.hbm.watermark("db_staging") >= staging
        assert db.release_stagings() == 1
        hbm = tel.hbm.export()
        assert hbm["source"] == "memory_allocated"
        assert hbm["live_bytes"] == torch.cuda.memory_allocated()
    finally:
        set_default_telemetry(prev)
