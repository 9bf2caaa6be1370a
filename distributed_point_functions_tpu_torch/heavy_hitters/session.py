"""Leader/Helper deployment of the heavy-hitters sweep.

Same topology as `serving/service.py`: the Leader owns the sweep state
machine (`protocol.FrontierSweep`), sends each round's frontier to the
Helper over any `serving.transport.Transport`, and — in the transport's
`on_sent` window — computes its OWN share while the Helper computes
theirs, so the two halves of every round overlap. Reconstructed counts
(the only values either side learns) drive threshold pruning; the next
frontier ships with the next round.

Wire format (versioned, fixed-width little-endian; rides inside the
4-byte framed messages of `serving.transport`):

    request  = MAGIC "DPHH" | u8 version | u8 kind=1 | u32 round
             | u32 num_prefixes | [v2+: 8-byte trace id]
             | [v3+: u32 crc32] | num_prefixes * u64 frontier
    response = MAGIC "DPHH" | u8 version | u8 kind=2 | u32 round
             | u32 num_prefixes | [v2+: f64 helper_ms]
             | [v3+: u64 epoch] | [v4: f64 recv_ms | f64 send_ms
             | f64 compute_ms] | [v3+: u32 crc32]
             | num_prefixes * u32 shares
    reset    = MAGIC "DPHH" | u8 version | u8 kind=3   (reply: kind=4)

Version 2 adds observability: the Leader's trace id rides in the
request (so one id names both halves of a round in either party's
flight recorder) and the Helper reports its server-side evaluation
milliseconds in the response (so the Leader splits the helper leg into
network vs. remote compute). Version 3 adds robustness: a crc32 over
each message (crc field zeroed during the sum) so a byte flipped in
flight surfaces as `IntegrityError` — never as a silently wrong share
— and a **session epoch** in the response, a random u64 the Helper
draws at construction, so the Leader detects a restarted Helper (new
epoch) instead of silently miscounting against a peer that lost its
cut-state cache. The Helper always answers in the *request's*
version; a Leader talking to an older Helper sees a `ProtocolError`
(in-process) or a closed connection (`TransportError` over TCP) on
its first round, steps its wire version down one, and re-sends the
round — the own-share overlap hook is idempotent, so the resend costs
only the wire leg. `IntegrityError` and `TransportTimeout` never
downgrade: a damaged frame or a slow Helper is not an old Helper.
Version 4 adds the critical-path digest: the Helper's recv/send
perf_counter timestamps and device-compute ms ride each response, so
the Leader skew-corrects the two clocks NTP-style and splits every
round's helper leg into helper_net / helper_queue / helper_compute
(`observability/critical_path.py`, surfaced at `/criticalz`).

Fault recovery (`robustness/`): the Leader optionally persists the
sweep frontier after every completed round into a `CheckpointStore`
and resumes from the last completed round at the next `run()` — even
in a fresh process. Round-level faults (transport errors, corrupt
frames) are retried `round_retries` times per round; a Helper built
with `allow_resume=True` serves a round ahead of its expected one
from the root (bit-identical to the resumed path) and replays its last
answered round idempotently, which is
what makes the Leader's resend-after-fault and resume-after-restart
safe.

Prefixes are u64 on the wire, which is why `HeavyHittersConfig` caps
`domain_bits` at 64; shares are u32 (`count_bits <= 32`).

The port of the JAX package's `heavy_hitters/session.py`, byte-equal on
the wire, so either package's Leader talks to either's Helper. Each
party's server evaluates on its own CUDA stream and counts its own
launches (`HeavyHittersServer.launches`).

Per-round metrics land in a `serving.metrics.MetricsRegistry`:
`hh.keys_live` / `hh.frontier_width` / `hh.prune_ratio` gauges,
`hh.bytes_sent` / `hh.bytes_received` / `hh.wire_downgrades` counters,
and `hh.round_ms` / `hh.helper_remote_ms` / `hh.helper_network_ms`
histograms — the counters the bench and the demo report. Each sweep
roots one observability trace (`hh.sweep`) whose per-round spans carry
frontier width and prune ratio.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Optional

import numpy as np

from ..observability import critical_path
from ..observability import events as events_mod
from ..observability import tracing
from ..observability import phases as phases_mod
from ..robustness.checkpoint import CheckpointStore
from ..serving.metrics import MetricsRegistry
from ..serving.transport import Transport, TransportError, TransportTimeout
from .protocol import (
    FrontierSweep,
    HeavyHittersResult,
    HeavyHittersServer,
    IntegrityError,
    ProtocolError,
    reconstruct_counts,
)

_MAGIC = b"DPHH"
_VERSION = 4
_SUPPORTED_VERSIONS = (1, 2, 3, 4)
_KIND_EVAL_REQUEST = 1
_KIND_EVAL_RESPONSE = 2
_KIND_RESET_REQUEST = 3
_KIND_RESET_RESPONSE = 4

_HEADER = struct.Struct("<4sBB")
_EVAL_HEADER = struct.Struct("<4sBBII")
# Versioned extensions, immediately after the eval header. Each entry
# is the COMPLETE extension block for that version (not a delta).
_REQ_EXTS = {
    2: struct.Struct("<8s"),    # raw trace id (zeros = none)
    3: struct.Struct("<8sI"),   # + u32 crc32 of the whole message
    4: struct.Struct("<8sI"),   # unchanged from v3 (crc stays last)
}
_RESP_EXTS = {
    2: struct.Struct("<d"),     # helper-side eval ms
    3: struct.Struct("<dQI"),   # + u64 helper session epoch + u32 crc32
    # v4: + the Helper's perf_counter-domain recv/send timestamps and
    # device-compute ms (the critical-path digest); crc stays LAST so
    # `_decode_eval`'s crc_offset = ext end - 4 keeps holding.
    4: struct.Struct("<dQdddI"),
}


def _patch_crc(msg: bytes, crc_offset: int) -> bytes:
    """Fill the (zero-encoded) crc field with crc32 over the whole
    message — the receiver verifies by zeroing the field back."""
    crc = zlib.crc32(msg) & 0xFFFFFFFF
    return (
        msg[:crc_offset]
        + struct.pack("<I", crc)
        + msg[crc_offset + 4:]
    )


def encode_eval_request(
    round_index: int,
    frontier: np.ndarray,
    version: int = _VERSION,
    trace_id: Optional[str] = None,
) -> bytes:
    if version not in _SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported wire version {version}")
    frontier = np.ascontiguousarray(frontier, dtype="<u8")
    ext = b""
    if version >= 2:
        raw = bytes.fromhex(trace_id) if trace_id else b"\x00" * 8
        if len(raw) != 8:
            raise ValueError(f"trace id must be 16 hex chars: {trace_id!r}")
        ext = (
            _REQ_EXTS[3].pack(raw, 0) if version >= 3
            else _REQ_EXTS[2].pack(raw)
        )
    msg = (
        _EVAL_HEADER.pack(
            _MAGIC, version, _KIND_EVAL_REQUEST,
            round_index, frontier.shape[0],
        )
        + ext
        + frontier.tobytes()
    )
    if version >= 3:
        msg = _patch_crc(msg, _EVAL_HEADER.size + _REQ_EXTS[3].size - 4)
    return msg


def encode_eval_response(
    round_index: int,
    shares: np.ndarray,
    version: int = _VERSION,
    helper_ms: float = 0.0,
    epoch: int = 0,
    recv_ms: float = 0.0,
    send_ms: float = 0.0,
    compute_ms: float = 0.0,
) -> bytes:
    if version not in _SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported wire version {version}")
    shares = np.ascontiguousarray(shares, dtype="<u4")
    if version >= 4:
        ext = _RESP_EXTS[4].pack(
            float(helper_ms), int(epoch), float(recv_ms),
            float(send_ms), float(compute_ms), 0,
        )
    elif version == 3:
        ext = _RESP_EXTS[3].pack(float(helper_ms), int(epoch), 0)
    elif version == 2:
        ext = _RESP_EXTS[2].pack(float(helper_ms))
    else:
        ext = b""
    msg = (
        _EVAL_HEADER.pack(
            _MAGIC, version, _KIND_EVAL_RESPONSE,
            round_index, shares.shape[0],
        )
        + ext
        + shares.tobytes()
    )
    if version >= 3:
        ext_size = _RESP_EXTS[min(version, max(_RESP_EXTS))].size
        msg = _patch_crc(msg, _EVAL_HEADER.size + ext_size - 4)
    return msg


def _check_header(payload: bytes, expected_kind: int) -> int:
    """Validate magic/version/kind; returns the message's version."""
    if len(payload) < _HEADER.size:
        raise ProtocolError(f"short message ({len(payload)} bytes)")
    magic, version, kind = _HEADER.unpack_from(payload)
    if magic != _MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if version not in _SUPPORTED_VERSIONS:
        raise ProtocolError(f"unsupported wire version {version}")
    if kind != expected_kind:
        raise ProtocolError(
            f"unexpected message kind {kind} (wanted {expected_kind})"
        )
    return version


def _decode_eval(payload: bytes, kind: int, itemsize: int, dtype, ext_structs):
    """-> (round_index, body array, version, ext tuple or None). For
    v3 frames the trailing crc field in the extension is verified over
    the whole message (crc field zeroed) BEFORE any field is trusted;
    a mismatch raises `IntegrityError` — never a silently wrong body."""
    version = _check_header(payload, kind)
    if len(payload) < _EVAL_HEADER.size:
        raise ProtocolError("truncated eval header")
    _, _, _, round_index, count = _EVAL_HEADER.unpack_from(payload)
    offset = _EVAL_HEADER.size
    ext = None
    if version >= 2:
        ext_struct = ext_structs[min(version, max(ext_structs))]
        if len(payload) < offset + ext_struct.size:
            raise ProtocolError(f"truncated v{version} extension")
        ext = ext_struct.unpack_from(payload, offset)
        offset += ext_struct.size
    body = payload[offset:]
    if len(body) != count * itemsize:
        raise ProtocolError(
            f"eval body is {len(body)} bytes, expected {count * itemsize}"
        )
    if version >= 3:
        crc_offset = offset - 4  # crc is the extension's last field
        want = ext[-1]
        zeroed = (
            payload[:crc_offset] + b"\x00\x00\x00\x00"
            + payload[crc_offset + 4:]
        )
        got = zlib.crc32(zeroed) & 0xFFFFFFFF
        if got != want:
            raise IntegrityError(
                f"frame checksum mismatch (crc32 {got:#010x} != "
                f"{want:#010x}): the message changed in flight"
            )
    return round_index, np.frombuffer(body, dtype=dtype), version, ext


def decode_eval_request_full(payload: bytes):
    """-> (round_index, frontier uint64[num_prefixes], version,
    trace_id hex str or None)."""
    round_index, frontier, version, ext = _decode_eval(
        payload, _KIND_EVAL_REQUEST, 8, "<u8", _REQ_EXTS
    )
    raw = ext[0] if ext is not None else None
    trace_id = raw.hex() if raw and raw != b"\x00" * 8 else None
    return round_index, frontier, version, trace_id


def decode_eval_response_full(payload: bytes):
    """-> (round_index, shares uint32[num_prefixes], version,
    helper_ms float or None, helper epoch int or None, timing dict or
    None). The epoch is a random u64 the Helper draws at construction:
    constant across rounds within one process, different after a
    restart — the Leader's restart detector. `timing` (v4+) carries
    the Helper's critical-path digest: `recv_ms`/`send_ms`
    (perf_counter-domain wire timestamps) and `compute_ms` (device
    evaluation time), the inputs to NTP-style skew estimation."""
    round_index, shares, version, ext = _decode_eval(
        payload, _KIND_EVAL_RESPONSE, 4, "<u4", _RESP_EXTS
    )
    helper_ms = ext[0] if ext is not None else None
    epoch = ext[1] if ext is not None and version >= 3 else None
    timing = None
    if ext is not None and version >= 4:
        timing = {
            "recv_ms": float(ext[2]),
            "send_ms": float(ext[3]),
            "compute_ms": float(ext[4]),
        }
    return round_index, shares, version, helper_ms, epoch, timing


def decode_eval_request(payload: bytes):
    """-> (round_index, frontier uint64[num_prefixes])."""
    return decode_eval_request_full(payload)[:2]


def decode_eval_response(payload: bytes):
    """-> (round_index, shares uint32[num_prefixes])."""
    return decode_eval_response_full(payload)[:2]


class HeavyHittersHelper:
    """The Helper role: a `bytes -> bytes` handler around one server.

    Plug it into `serving.transport.FramedTcpServer` (the TCP
    deployment) or `InProcessTransport` (tests) unchanged. Stateful
    across rounds — the cut-state cache lives in the wrapped
    `HeavyHittersServer` — and accepts a reset message so one process
    can serve successive sweeps.

    `epoch` (default: random) identifies THIS helper process in every
    v3 response; a Leader seeing the epoch change knows the Helper
    restarted mid-sweep. A corrupt inbound frame (`IntegrityError`)
    counts into `hh.corrupt_frames` on `metrics` and propagates — the
    Leader retries the round; the share math never sees damaged bytes.
    """

    def __init__(
        self,
        server: HeavyHittersServer,
        metrics: Optional[MetricsRegistry] = None,
        epoch: Optional[int] = None,
    ):
        self._server = server
        self._metrics = metrics
        self._epoch = (
            epoch if epoch is not None
            else int.from_bytes(os.urandom(8), "little") or 1
        )

    @property
    def server(self) -> HeavyHittersServer:
        return self._server

    @property
    def epoch(self) -> int:
        return self._epoch

    def set_data_generation(self, generation: int) -> int:
        """The Helper's report set rotated to a new database snapshot
        generation (`serving/snapshots.py`): redraw the session epoch,
        deterministically derived from the old epoch and the
        generation. Any sweep in flight sees the epoch change on its
        next round and replays from the root (`EpochChanged` -> the
        Leader's from-root replay), exactly as if the Helper had
        restarted — cut-state accumulated against the old data never
        mixes into counts over the new. Returns the new epoch."""
        self._epoch = (
            (self._epoch * 1_000_003 + int(generation) + 1)
            % (1 << 64)
        ) or 1
        return self._epoch

    def handle_wire(self, payload: bytes) -> bytes:
        recv_pc_ms = time.perf_counter() * 1e3
        if len(payload) >= _HEADER.size:
            _, _, kind = _HEADER.unpack_from(payload)
            if kind == _KIND_RESET_REQUEST:
                version = _check_header(payload, _KIND_RESET_REQUEST)
                self._server.reset()
                # Reply in the request's version (v1 Leaders reject v2).
                return _HEADER.pack(
                    _MAGIC, min(version, _VERSION), _KIND_RESET_RESPONSE
                )
        try:
            round_index, frontier, version, trace_id = (
                decode_eval_request_full(payload)
            )
        except IntegrityError:
            if self._metrics is not None:
                self._metrics.counter("hh.corrupt_frames").inc()
            raise
        # A propagated trace id means this round is the server half of a
        # peer's request: root a fresh server-side trace under that id
        # (`fresh` matters in-process, where both roles share a thread).
        t0 = time.perf_counter()
        with tracing.trace_request(
            "hh.helper.round",
            trace_id=trace_id,
            fresh=trace_id is not None,
            role="hh-helper",
            round=round_index,
        ):
            # fresh for the same in-process reason as the trace: the
            # Helper must not merge its phases into the Leader's record.
            with phases_mod.default_phase_recorder().request(
                "hh-helper", fresh=True
            ):
                c0 = time.perf_counter()
                with tracing.span(
                    "helper_evaluate", frontier_width=int(frontier.shape[0])
                ), phases_mod.phase("device_compute"):
                    shares = self._server.evaluate_round(
                        round_index, frontier.tolist()
                    )
                compute_ms = (time.perf_counter() - c0) * 1e3
        helper_ms = (time.perf_counter() - t0) * 1e3
        # v4 piggybacks the critical-path digest; older requesters get
        # their own version back, byte-compatible with before.
        return encode_eval_response(
            round_index, shares, version=version, helper_ms=helper_ms,
            epoch=self._epoch, recv_ms=recv_pc_ms,
            send_ms=time.perf_counter() * 1e3, compute_ms=compute_ms,
        )


class HeavyHittersLeader:
    """The Leader role: drives the sweep over a transport.

    Each round the frontier goes out, the Leader's own share computes in
    the `on_sent` overlap window, the Helper's share comes back, and the
    reconstructed counts prune the frontier. `round_timeout_ms` bounds
    each round trip (`TransportTimeout` surfaces to the caller — a slow
    Helper must not silently stall the sweep).

    Fault recovery knobs:

    * `round_retries` — how many times one round may be re-sent after a
      `TransportError` or a corrupt frame (`IntegrityError`) before the
      sweep fails. The own-share guard plus the Helper's replay cache
      (`HeavyHittersServer(allow_resume=True)`) make resends
      idempotent, so a retry can change latency but never counts.
    * `checkpoint` — a `robustness.CheckpointStore` (or a path string)
      the sweep frontier is persisted into after every completed round.
      `run()` resumes from a matching checkpoint — including in a fresh
      process, where this Leader's own server rebuilds the resumed
      round from the root (bit-identical to resuming) — and
      deletes it on completion.

    A Helper answering with a new session epoch mid-sweep (it
    restarted) counts into `hh.helper_restarts`; with `allow_resume` on
    the Helper's server the sweep simply continues — the restarted
    Helper serves the round from its root.
    """

    def __init__(
        self,
        server: HeavyHittersServer,
        transport: Transport,
        metrics: Optional[MetricsRegistry] = None,
        round_timeout_ms: Optional[float] = None,
        round_retries: int = 0,
        retry_backoff_ms: float = 10.0,
        checkpoint=None,
    ):
        self._server = server
        self._transport = transport
        self._metrics = metrics if metrics is not None else MetricsRegistry()
        self._timeout = (
            round_timeout_ms / 1e3 if round_timeout_ms else None
        )
        self._wire_version = _VERSION
        self._round_retries = round_retries
        self._retry_backoff_s = retry_backoff_ms / 1e3
        self._checkpoint: Optional[CheckpointStore] = (
            CheckpointStore(checkpoint)
            if isinstance(checkpoint, str)
            else checkpoint
        )
        self._helper_epoch: Optional[int] = None
        self._c_downgrades = self._metrics.counter("hh.wire_downgrades")
        self._c_round_retries = self._metrics.counter("hh.round_retries")
        self._c_corrupt = self._metrics.counter("hh.corrupt_frames")
        self._c_restarts = self._metrics.counter("hh.helper_restarts")
        self._c_resumes = self._metrics.counter("hh.sweep_resumes")
        critical_path.install(registry=self._metrics)

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics

    @property
    def helper_epoch(self) -> Optional[int]:
        """The helper process identity last seen in a v3 response."""
        return self._helper_epoch

    @property
    def wire_version(self) -> int:
        """The version this Leader currently speaks (sticky-downgraded
        one step per fault from an older Helper)."""
        return self._wire_version

    def _maybe_downgrade(self, exc: Exception) -> bool:
        """Whether `exc` looks like an older peer rejecting this
        version (an in-process ProtocolError, or a closed connection
        over TCP) and a downgrade is still available; steps down ONE
        version so a v2 Helper is met at v2, not v1. Timeouts never
        downgrade — a slow Helper is not an old Helper — and neither do
        corrupt frames: the peer understood the version fine, the bytes
        were damaged in flight (retry policy owns those)."""
        if self._wire_version <= min(_SUPPORTED_VERSIONS):
            return False
        if isinstance(exc, (TransportTimeout, IntegrityError)):
            return False
        self._wire_version -= 1
        self._c_downgrades.inc()
        return True

    def _observe_epoch(self, epoch: Optional[int]) -> None:
        if epoch is None:
            return
        if self._helper_epoch is not None and epoch != self._helper_epoch:
            self._c_restarts.inc()
        self._helper_epoch = epoch

    def reset_helper(self) -> None:
        """Tell the Helper to start a fresh sweep (and reset locally)."""
        while True:
            try:
                reply = self._transport.roundtrip(
                    _HEADER.pack(
                        _MAGIC, self._wire_version, _KIND_RESET_REQUEST
                    ),
                    timeout=self._timeout,
                )
                _check_header(reply, _KIND_RESET_RESPONSE)
                break
            except (ProtocolError, TransportError) as e:
                if not self._maybe_downgrade(e):
                    raise
        self._server.reset()

    def _round_trip(self, r, frontier, on_sent, trace):
        """One wire exchange at the current version. Returns
        (payload, reply, helper_round, helper_share, helper_ms,
        timing), where `timing` (v4 peers only) adds this side's
        send/recv perf_counter timestamps to the Helper's digest —
        the four stamps of one NTP exchange."""
        version = self._wire_version
        trace_id = trace.trace_id if version >= 2 else None
        payload = encode_eval_request(
            r, frontier, version=version, trace_id=trace_id
        )
        t_send_ms = time.perf_counter() * 1e3
        reply = self._transport.roundtrip(
            payload, timeout=self._timeout, on_sent=on_sent
        )
        t_recv_ms = time.perf_counter() * 1e3
        helper_round, helper_share, _, helper_ms, epoch, timing = (
            decode_eval_response_full(reply)
        )
        self._observe_epoch(epoch)
        if timing is not None:
            timing = {
                "send_ms": t_send_ms,
                "recv_ms": t_recv_ms,
                "helper_recv_ms": timing["recv_ms"],
                "helper_send_ms": timing["send_ms"],
                "helper_compute_ms": timing["compute_ms"],
            }
        return payload, reply, helper_round, helper_share, helper_ms, timing

    def _restore_sweep(self, config) -> Optional[FrontierSweep]:
        """A sweep resumed from the checkpoint store, or None to start
        fresh. A config-mismatched checkpoint raises (resuming a
        different hierarchy would miscount silently)."""
        if self._checkpoint is None:
            return None
        state = self._checkpoint.load()
        if state is None:
            return None
        sweep = FrontierSweep.restore(config, state)
        self._c_resumes.inc()
        events_mod.emit(
            "hh.sweep_resume",
            f"resumed at round {sweep.round_index}",
            severity="info",
            round=sweep.round_index,
        )
        return sweep

    def run(self) -> HeavyHittersResult:
        m = self._metrics
        m.gauge("hh.keys_live").set(self._server.num_keys)
        config = self._server.config
        resumed = self._restore_sweep(config)
        sweep = resumed if resumed is not None else FrontierSweep(config)
        with tracing.trace_request(
            "hh.sweep", role="hh-leader", domain_bits=config.domain_bits
        ) as trace, phases_mod.default_phase_recorder().request(
            "hh-leader"
        ):
            while not sweep.done:
                r = sweep.round_index
                frontier = sweep.frontier
                own_share: list = []
                own_window: list = []

                def compute_own_share():
                    # on_sent may fire twice on a transparent reconnect
                    # (and again on a wire-version downgrade or fault
                    # resend); the share must only be computed once.
                    if not own_share:
                        s0 = time.perf_counter()
                        with tracing.span("leader_own_share", round=r), \
                                phases_mod.phase("device_compute"):
                            own_share.append(
                                self._server.evaluate_round(r, frontier)
                            )
                        own_window.append(
                            (s0 * 1e3, time.perf_counter() * 1e3)
                        )

                t0 = time.perf_counter()
                attempt = 0
                while True:
                    try:
                        payload, reply, helper_round, helper_share, \
                            helper_ms, timing = self._round_trip(
                                r, frontier, compute_own_share, trace
                            )
                        break
                    except (ProtocolError, TransportError) as e:
                        if self._maybe_downgrade(e):
                            # Older Helper: re-send this round one wire
                            # version down. The own-share guard above
                            # makes the overlap hook idempotent, so the
                            # resend pays only the wire leg — and the
                            # probe does not consume a retry.
                            continue
                        if isinstance(e, IntegrityError):
                            self._c_corrupt.inc()
                        elif not isinstance(e, TransportError):
                            # A genuine protocol disagreement (wrong
                            # shape, wrong kind) is not retryable.
                            raise
                        if attempt >= self._round_retries:
                            raise
                        # Transport fault or damaged frame: re-send the
                        # round. Idempotent on both sides — own-share
                        # guard here, replay cache on an allow_resume
                        # Helper — so the retry can never double-count.
                        attempt += 1
                        self._c_round_retries.inc()
                        time.sleep(self._retry_backoff_s)
                round_ms = (time.perf_counter() - t0) * 1e3
                # Out-of-band: overlaps the own-share device_compute
                # above when the transport's on_sent window runs it.
                phases_mod.record("helper_rtt", round_ms)
                if helper_round != r:
                    raise ProtocolError(
                        f"helper answered round {helper_round} during "
                        f"round {r}"
                    )
                with tracing.span("reconstruct", round=r), \
                        phases_mod.phase("respond"):
                    counts = reconstruct_counts(
                        own_share[0], helper_share, config.count_bits
                    )
                stats = sweep.observe_counts(counts)
                stats.wall_ms = round_ms
                stats.bytes_sent = len(payload)
                stats.bytes_received = len(reply)
                skew = None
                if timing is not None:
                    # v4 digest: skew-estimate this round's exchange and
                    # split its helper leg, excluding whatever part of
                    # the own-share window ran inside the round trip.
                    win = own_window[0] if own_window else None
                    overlap_ms = (
                        max(0.0, min(win[1], timing["recv_ms"])
                            - max(win[0], timing["send_ms"]))
                        if win is not None else 0.0
                    )
                    skew = critical_path.estimate_skew(
                        timing["send_ms"], timing["recv_ms"],
                        timing["helper_recv_ms"],
                        timing["helper_send_ms"],
                        overlap_ms=overlap_ms,
                    )
                    decomp = critical_path.decompose_helper_leg(
                        skew,
                        {"device_compute": timing["helper_compute_ms"]},
                    )
                    if decomp is not None:
                        phases_mod.record(
                            "helper_net", decomp["helper_net_ms"]
                        )
                        phases_mod.record(
                            "helper_queue", decomp["helper_queue_ms"]
                        )
                        phases_mod.record(
                            "helper_compute",
                            decomp["helper_compute_ms"],
                        )
                    critical_path.default_analyzer().observe_round(
                        "hh-leader",
                        own_ms=(win[1] - win[0]) if win is not None
                        else 0.0,
                        rtt_ms=timing["recv_ms"] - timing["send_ms"],
                        decomp=decomp,
                        skew=skew,
                    )
                if helper_ms is not None:
                    network_ms = max(0.0, round_ms - helper_ms)
                    m.histogram("hh.helper_remote_ms").observe(helper_ms)
                    m.histogram("hh.helper_network_ms").observe(network_ms)
                    extra = {}
                    if skew is not None:
                        extra["offset_ms_est"] = round(skew.offset_ms, 3)
                        extra["offset_uncertainty_ms"] = round(
                            skew.uncertainty_ms, 3
                        )
                    trace.add_span(
                        "helper_leg", round_ms, round=r,
                        remote_ms=round(helper_ms, 3),
                        network_ms=round(network_ms, 3), **extra,
                    )
                else:
                    trace.add_span("helper_leg", round_ms, round=r)
                trace.add_span(
                    "round", round_ms, round=r,
                    frontier_width=stats.frontier_width,
                    prune_ratio=round(stats.prune_ratio, 4),
                )
                m.gauge("hh.frontier_width").set(stats.frontier_width)
                m.gauge("hh.prune_ratio").set(stats.prune_ratio)
                m.counter("hh.bytes_sent").inc(stats.bytes_sent)
                m.counter("hh.bytes_received").inc(stats.bytes_received)
                m.histogram("hh.round_ms").observe(round_ms)
                m.counter("hh.rounds").inc()
                if self._checkpoint is not None:
                    # Persist AFTER the round is folded into the sweep:
                    # the checkpoint always holds a completed-level
                    # state, so resume re-sends at most the round that
                    # was in flight when the process died.
                    self._checkpoint.save(sweep.snapshot())
        if self._checkpoint is not None:
            self._checkpoint.delete()
        return HeavyHittersResult(
            heavy_hitters=sweep.result, rounds=sweep.rounds
        )
