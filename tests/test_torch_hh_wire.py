"""The port's heavy-hitters wire and sessions, on the CPU.

The `DPHH` request and response bytes of wire versions 1-4 equal the JAX
package's, each package decodes the other's, and both decoders reject the
same malformed frames with the same errors. The Leader and Helper run in
process and over TCP; a Helper of an older version makes the Leader step
its version down, a damaged frame makes it retry and never step down;
and a sweep crashed by a failpoint resumes from its checkpoint. The JAX
package here is only its codec (no XLA program); the round against a
JAX Helper is in `test_torch_heavy_hitters.py`, which shares its
compiled shapes.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import heavy_hitters as jhh
from distributed_point_functions_tpu_torch import heavy_hitters as thh
from distributed_point_functions_tpu_torch.robustness import failpoints
from distributed_point_functions_tpu_torch.robustness.checkpoint import (
    CheckpointError,
    CheckpointStore,
)
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
from distributed_point_functions_tpu_torch.serving.transport import (
    FramedTcpServer,
    InProcessTransport,
    TcpTransport,
    TransportError,
)

VALUES = [3, 3, 3, 77, 77, 9, 9, 200]
CONFIG = thh.HeavyHittersConfig(domain_bits=8, level_bits=4, threshold=2)
FRONTIER = np.array([0, 5, 1 << 40, (1 << 64) - 1], dtype=np.uint64)
SHARES = np.array([7, 0, 0xFFFFFFFF, 12345], dtype=np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of ops on tensors of a few KiB."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def key_pairs():
    client = thh.HeavyHittersClient(CONFIG, device="cpu")
    pairs = [client.generate_report(v) for v in VALUES]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _servers(key_pairs, **kwargs):
    return [thh.HeavyHittersServer(CONFIG, k, device="cpu", **kwargs) for k in key_pairs]


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_wire_bytes_equal_the_jax_package(version):
    trace = "ab" * 8 if version >= 2 else None
    req = thh.encode_eval_request(3, FRONTIER, version=version, trace_id=trace)
    assert req == jhh.encode_eval_request(3, FRONTIER, version=version, trace_id=trace)
    extra = dict(helper_ms=1.5, epoch=42, recv_ms=100.25, send_ms=101.75, compute_ms=1.125)
    resp = thh.encode_eval_response(3, SHARES, version=version, **extra)
    assert resp == jhh.encode_eval_response(3, SHARES, version=version, **extra)
    for ours, theirs, payload in (
            (thh.decode_eval_request_full, jhh.decode_eval_request_full, req),
            (thh.decode_eval_response_full, jhh.decode_eval_response_full, resp)):
        a, b = ours(payload), theirs(payload)
        assert len(a) == len(b) and a[0] == b[0] and np.array_equal(a[1], b[1])
        assert a[2:] == b[2:] and a[2] == version
    assert np.array_equal(thh.decode_eval_request(req)[1], FRONTIER)
    assert np.array_equal(thh.decode_eval_response(resp)[1], SHARES)


def _corrupt(payload: bytes, at: int) -> bytes:
    out = bytearray(payload)
    out[at] ^= 0x01
    return bytes(out)


def test_both_decoders_reject_the_same_frames():
    req = thh.encode_eval_request(1, FRONTIER)
    resp = thh.encode_eval_response(1, SHARES, epoch=9)
    old = thh.encode_eval_request(1, FRONTIER, version=2)
    bad = [
        (req[:3], "short"),
        (b"XXXX" + req[4:], "magic"),
        (req[:4] + bytes([9]) + req[5:], "unsupported wire version"),
        (resp, "kind"),
        (req[:12], "truncated eval header"),
        (req[:20], "truncated v4 extension"),
        (old[:-3], "body"),
        (_corrupt(req, len(req) - 1), "checksum"),
        (_corrupt(req, 20), "checksum"),
    ]
    for payload, match in bad:
        errors = []
        for decode, pkg in ((thh.decode_eval_request, thh), (jhh.decode_eval_request, jhh)):
            with pytest.raises(pkg.ProtocolError, match=match) as info:
                decode(payload)
            errors.append((type(info.value).__name__, str(info.value)))
        assert errors[0] == errors[1], match
    with pytest.raises(thh.IntegrityError):
        thh.decode_eval_response(_corrupt(resp, len(resp) - 2))
    assert issubclass(thh.IntegrityError, thh.ProtocolError)
    with pytest.raises(ValueError):
        thh.encode_eval_request(0, FRONTIER, version=5)


def test_leader_and_helper_in_process(key_pairs):
    leader_server, helper_server = _servers(key_pairs)
    metrics = MetricsRegistry()
    helper = thh.HeavyHittersHelper(helper_server, epoch=77)
    leader = thh.HeavyHittersLeader(leader_server, InProcessTransport(helper.handle_wire),
                                    metrics=metrics)
    result = leader.run()
    assert result.as_dict() == thh.plaintext_heavy_hitters(VALUES, CONFIG) == {3: 3, 77: 2, 9: 2}
    snap = metrics.snapshot()
    assert snap["counters"]["hh.rounds"] == len(result.rounds) == 2
    assert snap["counters"]["hh.bytes_sent"] == sum(r.bytes_sent for r in result.rounds)
    assert snap["gauges"]["hh.keys_live"] == len(VALUES)
    assert leader.helper_epoch == 77 and leader.wire_version == 4
    # A second sweep after the Helper's reset gives the same answer.
    leader.reset_helper()
    assert leader.run().as_dict() == result.as_dict()


def test_leader_and_helper_over_tcp(key_pairs):
    leader_server, helper_server = _servers(key_pairs)
    helper = thh.HeavyHittersHelper(helper_server)
    with FramedTcpServer(helper.handle_wire, port=0, name="hh-test") as srv:
        with TcpTransport("localhost", srv.port) as transport:
            leader = thh.HeavyHittersLeader(leader_server, transport,
                                            round_timeout_ms=120_000.0)
            result = leader.run()
    assert result.as_dict() == thh.plaintext_heavy_hitters(VALUES, CONFIG)


def test_leader_downgrades_for_an_older_helper_but_not_for_damage(key_pairs):
    leader_server, helper_server = _servers(key_pairs, allow_resume=True)
    helper = thh.HeavyHittersHelper(helper_server)

    def v2_helper(payload):
        if payload[4] > 2:
            raise thh.ProtocolError(f"unsupported wire version {payload[4]}")
        return helper.handle_wire(payload)

    metrics = MetricsRegistry()
    leader = thh.HeavyHittersLeader(leader_server, InProcessTransport(v2_helper),
                                    metrics=metrics)
    assert leader.run().as_dict() == thh.plaintext_heavy_hitters(VALUES, CONFIG)
    assert leader.wire_version == 2
    assert metrics.snapshot()["counters"]["hh.wire_downgrades"] == 2

    # A damaged response: retried at the same version, never downgraded.
    leader_server.reset()
    helper_server.reset()
    reg = failpoints.default_failpoints()
    reg.arm("transport.response", "corrupt", times=1)
    try:
        metrics = MetricsRegistry()
        leader = thh.HeavyHittersLeader(leader_server, InProcessTransport(helper.handle_wire),
                                        metrics=metrics, round_retries=2,
                                        retry_backoff_ms=0.0)
        assert leader.run().as_dict() == thh.plaintext_heavy_hitters(VALUES, CONFIG)
    finally:
        reg.clear()
    counters = metrics.snapshot()["counters"]
    assert leader.wire_version == 4
    assert counters["hh.corrupt_frames"] == 1 and counters["hh.round_retries"] == 1
    assert counters["hh.wire_downgrades"] == 0


def test_sweep_resumes_from_its_checkpoint_after_a_crash(key_pairs, tmp_path):
    """The Leader persists the frontier after each round; a failpoint
    fails the second round trip, and a fresh Leader (a new local server,
    `allow_resume=True` on both) resumes at the crashed round and gives
    the oracle's answer."""
    path = str(tmp_path / "hh" / "sweep.json")
    helper_server = _servers(key_pairs, allow_resume=True)[1]
    helper = thh.HeavyHittersHelper(helper_server)
    reg = failpoints.default_failpoints()
    reg.arm("transport.inproc.roundtrip", "error", times=None, after=1)
    try:
        crashed = thh.HeavyHittersLeader(_servers(key_pairs, allow_resume=True)[0],
                                         InProcessTransport(helper.handle_wire),
                                         checkpoint=path)
        with pytest.raises(TransportError):
            crashed.run()
    finally:
        reg.clear()
    saved = CheckpointStore(path).load()
    assert saved["round_index"] == 1 and saved["config"] == thh.config_fingerprint(CONFIG)
    metrics = MetricsRegistry()
    fresh = thh.HeavyHittersLeader(_servers(key_pairs, allow_resume=True)[0],
                                   InProcessTransport(helper.handle_wire),
                                   metrics=metrics, checkpoint=CheckpointStore(path))
    result = fresh.run()
    assert result.as_dict() == thh.plaintext_heavy_hitters(VALUES, CONFIG)
    assert metrics.snapshot()["counters"]["hh.sweep_resumes"] == 1
    assert CheckpointStore(path).load() is None  # deleted on completion
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.raises(CheckpointError):
        CheckpointStore(str(tmp_path / "bad.json")).load()


def test_helper_replay_cache_and_epoch(key_pairs):
    server = _servers(key_pairs, allow_resume=True)[0]
    helper = thh.HeavyHittersHelper(server, epoch=5)
    frontier = np.arange(16, dtype=np.uint64)
    first = thh.decode_eval_response_full(
        helper.handle_wire(thh.encode_eval_request(0, frontier)))
    again = thh.decode_eval_response_full(
        helper.handle_wire(thh.encode_eval_request(0, frontier)))
    assert np.array_equal(first[1], again[1]) and first[4] == again[4] == 5
    with pytest.raises(thh.ProtocolError, match="different frontier"):
        helper.handle_wire(thh.encode_eval_request(0, frontier[:-1]))
    assert helper.set_data_generation(1) != 5
    reset = helper.handle_wire(b"DPHH" + bytes([4, 3]))
    assert reset == b"DPHH" + bytes([4, 4])
