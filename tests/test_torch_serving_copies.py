"""The serving runtime's copied modules against the JAX package's.

The port copies the JAX package's framework-free serving modules
(`serving/metrics.py`, `serving/transport.py`, `robustness/breaker.py`,
`observability/propagation.py`, `observability/critical_path.py`) and
ports `serving/batcher.py`. Each is driven here with the same calls on
both packages, from a numpy seed; the results must be equal: the
envelope bytes of every version and kind (so that either package's
Leader talks to either's Helper), the TCP framing, `bucket_size`, the
metrics export, the breaker's transitions under one fake clock, and the
critical-path split of the same digests. No XLA program runs here.
"""

import socket

import numpy as np
import pytest

from distributed_point_functions_tpu.observability import critical_path as jcp
from distributed_point_functions_tpu.observability import propagation as jprop
from distributed_point_functions_tpu.robustness import breaker as jbreaker
from distributed_point_functions_tpu.serving import batcher as jbatcher
from distributed_point_functions_tpu.serving import metrics as jmetrics
from distributed_point_functions_tpu.serving import transport as jtransport
from distributed_point_functions_tpu_torch.observability import critical_path as cp
from distributed_point_functions_tpu_torch.observability import propagation as prop
from distributed_point_functions_tpu_torch.robustness import breaker
from distributed_point_functions_tpu_torch.serving import batcher
from distributed_point_functions_tpu_torch.serving import metrics
from distributed_point_functions_tpu_torch.serving import transport

SEED = 1212


def test_bucket_size_equals_jax():
    for n in list(range(1, 300)) + [1023, 1024, 1025, 1 << 20]:
        assert batcher.bucket_size(n) == jbatcher.bucket_size(n)
    for mod in (batcher, jbatcher):
        with pytest.raises(ValueError):
            mod.bucket_size(0)


def _spans(rng, n):
    return [{"name": f"s{i}", "offset_ms": float(rng.integers(0, 1000)) / 7,
             "duration_ms": float(rng.integers(1, 500)) / 3} for i in range(n)]


@pytest.mark.parametrize("version", [1, 2, 3])
def test_envelope_bytes_equal_jax(version):
    rng = np.random.default_rng(SEED + version)
    trace_id = rng.bytes(8).hex()
    inner = rng.bytes(int(rng.integers(0, 300)))
    for generation in (None, 0, 7):
        want = jprop.encode_request(trace_id, inner, version=version,
                                    generation=generation)
        got = prop.encode_request(trace_id, inner, version=version,
                                  generation=generation)
        assert got == want
        assert prop.try_decode_request_ext(want) == jprop.try_decode_request_ext(got)
    spans = _spans(rng, 5)
    phases = {"queue": 1.25, "device_compute": 3.5, "respond": 0.125}
    kwargs = dict(server_ms=12.5, spans=spans, version=version, phases=phases,
                  recv_ms=1000.25, send_ms=1013.5, generation=3)
    want = jprop.encode_response(inner, trace_id, **kwargs)
    got = prop.encode_response(inner, trace_id, **kwargs)
    assert got == want
    assert prop.try_decode_response(want) == jprop.try_decode_response(got)
    # The bare proto passes through both unchanged.
    assert prop.try_decode_request_ext(inner) == jprop.try_decode_request_ext(inner)


def test_error_envelope_equals_jax():
    kwargs = dict(message="queue full", retry_after_s=0.25,
                  trace_id="0123456789abcdef")
    want = jprop.encode_error("overloaded", **kwargs)
    assert prop.encode_error("overloaded", **kwargs) == want
    with pytest.raises(prop.WireErrorResponse) as err:
        prop.try_decode_response(want)
    with pytest.raises(jprop.WireErrorResponse) as jerr:
        jprop.try_decode_response(want)
    assert (err.value.error_type, err.value.retry_after_s) == (
        jerr.value.error_type, jerr.value.retry_after_s)


def test_send_msg_framing_equals_jax():
    rng = np.random.default_rng(SEED)
    payloads = [b"", rng.bytes(1), rng.bytes(4096), rng.bytes(70_000)]
    for send in (transport.send_msg, jtransport.send_msg):
        a, b = socket.socketpair()
        with a, b:
            for p in payloads:
                send(a, p)
            a.shutdown(socket.SHUT_WR)
            raw = b""
            while chunk := b.recv(1 << 16):
                raw += chunk
        framed = b"".join(len(p).to_bytes(4, "big") + p for p in payloads)
        assert raw == framed
        # Each package reads the other's frames.
        for recv in (transport.recv_msg, jtransport.recv_msg):
            c, d = socket.socketpair()
            with c, d:
                c.sendall(raw)
                assert [recv(d) for _ in payloads] == payloads


def _drive_metrics(mod, rng_seed):
    rng = np.random.default_rng(rng_seed)
    reg = mod.MetricsRegistry()
    for i in range(200):
        reg.counter("batcher.batches").inc()
        reg.counter("device.h2d_bytes", labels={"phase": "db_staging"}).inc(
            int(rng.integers(0, 4096)))
        reg.gauge("batcher.queue_depth").set(float(rng.integers(0, 64)))
        reg.histogram("batcher.batch_keys",
                      buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)).observe(
            int(rng.integers(1, 129)))
        reg.histogram("request_ms", labels={"role": "leader"}).observe(
            float(rng.random() * 100))
    return reg.export()


def test_metrics_export_equals_jax():
    assert _drive_metrics(metrics, SEED) == _drive_metrics(jmetrics, SEED)


def test_breaker_transitions_equal_jax():
    rng = np.random.default_rng(SEED)
    ops = rng.integers(0, 4, 400)
    logs = []
    for mod in (breaker, jbreaker):
        now = [0.0]
        b = mod.CircuitBreaker(failure_threshold=3, reset_timeout_ms=50.0,
                               clock=lambda: now[0])
        log = []
        b.on_transition(lambda old, new: log.append((old, new)))
        for op in ops:
            if op == 0:
                log.append(("allow", b.allow()))
            elif op == 1:
                b.record_failure()
            elif op == 2:
                b.record_success()
            else:
                now[0] += 0.02
            log.append(("state", b.state, b.state_code()))
        log.append(b.export())
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("closed", "open") in logs[0] and ("open", "half_open") in logs[0]


def test_decompose_helper_leg_equals_jax():
    rng = np.random.default_rng(SEED)
    for _ in range(50):
        send = float(rng.random() * 1e6)
        rtt = float(rng.random() * 50)
        helper_recv = send + float(rng.random() * 1e4) - 5e3
        service = float(rng.random() * rtt)
        overlap = float(rng.random() * rtt / 2)
        digest = {name: float(rng.random() * service / 2)
                  for name in ("device_compute", "compile", "queue", "h2d_transfer")}
        args = (send, send + rtt, helper_recv, helper_recv + service)
        skew = cp.estimate_skew(*args, overlap_ms=overlap)
        jskew = jcp.estimate_skew(*args, overlap_ms=overlap)
        assert skew.as_dict() == jskew.as_dict()
        assert cp.decompose_helper_leg(skew, digest) == jcp.decompose_helper_leg(
            jskew, digest)
        assert cp.decompose_helper_leg(skew, None) == jcp.decompose_helper_leg(
            jskew, None)
