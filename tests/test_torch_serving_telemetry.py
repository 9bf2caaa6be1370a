"""The serving runtime's device telemetry on the CPU.

A `PlainSession` at 128 records of 16 B (numpy seed) serves batches of
1, 2, 2, 3, 4 and 8 keys one after another: the process telemetry's
first-dispatch tracker counts one "compile" per new power-of-two bucket
and a hit per repeat, the transfer ledger records nothing (no copy
crosses a bus on the CPU), the memory accountant one `db_staging`
phase, and the session's own registry gets no `device.*` metric unless
the process binds one. The memory accountant's
per-phase watermarks are checked on a stub sampler. The card's copies
and syncs are checked in `test_torch_cuda_serving.py`.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu_torch.observability.device import (
    DeviceTelemetry,
    HbmAccountant,
    default_telemetry,
    set_default_telemetry,
)
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    messages,
)
from distributed_point_functions_tpu_torch.serving import (
    MetricsRegistry,
    PlainSession,
    ServingConfig,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NUM_RECORDS = 128
RECORD_BYTES = 16


@pytest.fixture
def telemetry():
    prev = default_telemetry()
    tel = set_default_telemetry(DeviceTelemetry())
    yield tel
    set_default_telemetry(prev)


def test_first_dispatch_of_each_bucket_counts_once(telemetry):
    rng = np.random.default_rng(6)
    records = [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    process = MetricsRegistry()
    config = ServingConfig(max_batch_size=8, request_timeout_ms=10_000.0)
    with PlainSession(DenseDpfPirDatabase(records, device="cpu"), config,
                      device="cpu") as session:
        telemetry.bind_registry(process)
        for n in (1, 2, 2, 3, 4, 8):
            idx = [int(i) for i in rng.integers(0, NUM_RECORDS, n)]
            request = client.create_plain_requests(idx)[0]
            keys = request.plain_request.dpf_keys
            response = session.handle_request(messages.PirRequest(
                plain_request=messages.PlainRequest(dpf_keys=keys)))
            assert len(response.dpf_pir_response.masked_response) == n
        own = session.metrics.export()["counters"]
    out = telemetry.export()
    site = out["compile"]["sites"]["plain.batcher.evaluate"]
    assert site["shapes"] == {
        "k1": {"compiles": 1, "hits": 0},
        "k2": {"compiles": 1, "hits": 1},
        "k4": {"compiles": 1, "hits": 1},
        "k8": {"compiles": 1, "hits": 0},
    }
    assert (site["compiles"], site["hits"]) == (4, 2)
    assert site["compile_ms"]["count"] == 4
    assert out["compile"]["total_compiles"] == 4
    assert out["transfers"]["phases"] == {}
    # The staging's memory phase ran (the CPU has no device bytes).
    assert out["hbm"]["watermark_bytes"] == {"db_staging": 0}
    assert out["hbm"]["source"] == "cpu"
    counters = process.export()["counters"]
    assert counters["device.compiles{site=plain.batcher.evaluate}"] == 4
    assert counters["device.dispatch_hits{site=plain.batcher.evaluate}"] == 2
    assert not [k for k in own if k.startswith("device.")]


def test_hbm_watermarks_per_phase():
    samples = iter([100, 300, 200, 50, 400, 70])
    hbm = HbmAccountant(sampler=lambda: (next(samples), "stub"))
    hbm.sample()                    # 100, outside any phase
    with hbm.phase("db_staging"):   # 300 on entry
        hbm.sample()                # 200
    # 50 on exit
    with hbm.phase("selection"):    # 400 on entry, 70 on exit
        pass
    out = hbm.export()
    assert out["watermark_bytes"] == {"db_staging": 300, "process": 100,
                                      "selection": 400}
    assert (out["live_bytes"], out["source"], out["samples"]) == (70, "stub", 6)
    assert out["current_phase"] is None
