"""Cross-party trace-context propagation for the serving wire format.

The Leader->Helper leg of `serving/service.py` carries a serialized
`PirRequest` proto inside the 4-byte framed transport. This module
wraps that payload in a versioned envelope so the trace id travels with
the request and the Helper's server-side stage timings travel back —
the Leader can then decompose helper-leg RTT into network time vs.
Helper-reported compute.

Wire layout (all integers big-endian):

    request  = MAGIC(4) | u8 version | u8 kind=1 | 8-byte trace id
             | [v3+: u64 generation+1, 0 = unbound]
             | u32 inner_len | inner proto bytes
    response = MAGIC(4) | u8 version | u8 kind=2 | u32 meta_len
             | meta JSON (trace_id, server_ms, spans; v2 adds the
               Helper's per-request phase digest `phases` plus
               `recv_ms`/`send_ms` monotonic timestamps)
             | u32 inner_len | inner proto bytes
    error    = MAGIC(4) | u8 version | u8 kind=3 | u32 meta_len
             | meta JSON (trace_id, error_type, message, retry_after_s)

The error kind is additive under version 1: it carries typed refusals
(today `overloaded`, with the server's `retry_after_s` drain hint)
instead of the generic dropped-connection transport fault, so a Leader
can distinguish "Helper is shedding load, back off this much" from
"Helper is dead". `try_decode_response` raises it as
`WireErrorResponse`; peers that never send envelopes never see it.

**Version 2 carries the Helper's critical-path digest.** A v2 response
meta adds `phases` (the Helper's `RequestPhases` waterfall for this
request), `recv_ms` and `send_ms` (the Helper's `perf_counter`-domain
receive/send timestamps, ms), and per-span `offset_ms` so the Leader
can reassemble a skew-corrected merged timeline
(`observability/critical_path.py`). A Helper always answers in the
request's version, so a v1 Leader never sees v2 fields; a v2 Leader
talking to a v1-only Helper faults once on the v2 probe, steps down to
v1 (keeping spans and `server_ms`, losing only the digest), and only a
second fault drops it to bare proto — the same sticky probe ladder the
kind-3 error envelope rode in on.

**Version 3 carries the database snapshot generation.** A v3 request
appends a u64 generation field after the trace id (encoded as
`generation + 1`; 0 means "leader did not bind a generation"), and a
v3 response meta adds `"generation"`: the generation the Helper's
share was actually evaluated against. The Leader compares the echo
against the generation its *own* share was computed from and raises a
typed `SnapshotMismatch` (`serving/snapshots.py`) on disagreement —
in the CGKS two-server model, shares from different database
generations XOR to well-formed garbage, so the mismatch must be
refused, never combined. The probe ladder extends one more step:
v3 -> v2 -> v1 -> bare, each step one counted downgrade. Peers below
v3 interoperate with generation checking disabled-but-journaled.

**Old-peer interop is by construction + detection, not negotiation.**
MAGIC starts with byte 0xFF: as a protobuf tag that is field 31 with
wire type 7, which does not exist, so an old Helper fed an enveloped
request fails proto parsing immediately (its connection closes, the
Leader sees a transport fault, downgrades to bare proto, and retries
inside its existing retry budget). Conversely `try_decode_request`
returns the payload untouched when the magic is absent, so a new
Helper serves old bare-proto Leaders unchanged — and replies bare, so
old Leaders never see an envelope.

Response span lists are bounded at `MAX_RESPONSE_SPANS`: a deep trace
must not inflate every reply frame, so the encoder keeps the first N
(chronological) spans and counts the rest in the
`propagation.spans_dropped` runtime counter — truncation is visible,
never silent.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

from . import tracing

__all__ = [
    "EnvelopeError",
    "MAX_RESPONSE_SPANS",
    "PROPAGATION_VERSION",
    "WireErrorResponse",
    "encode_error",
    "encode_request",
    "try_decode_request",
    "try_decode_request_ext",
    "try_decode_request_full",
    "encode_response",
    "try_decode_response",
]

# 0xFF first => guaranteed-invalid protobuf, so old peers fail fast.
_MAGIC = b"\xffDPT"
PROPAGATION_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)
_KIND_REQUEST = 1
_KIND_RESPONSE = 2
_KIND_ERROR = 3

# Cap on spans per response envelope (satellite: no unbounded frames).
MAX_RESPONSE_SPANS = 64


_HEAD = struct.Struct(">4sBB")
_LEN = struct.Struct(">I")
# v3 request generation field: u64 `generation + 1`, 0 = unbound.
_GEN = struct.Struct(">Q")


class EnvelopeError(ValueError):
    """Magic matched but the envelope is malformed or unsupported."""


class WireErrorResponse(RuntimeError):
    """The peer answered with a typed error envelope (kind 3) instead
    of a result. `error_type` is a stable string (`"overloaded"`),
    `retry_after_s` the peer's backoff hint (0 = none given)."""

    def __init__(
        self,
        error_type: str,
        message: str = "",
        retry_after_s: float = 0.0,
        trace_id: Optional[str] = None,
    ):
        super().__init__(message or error_type)
        self.error_type = error_type
        self.retry_after_s = retry_after_s
        self.trace_id = trace_id


def encode_request(
    trace_id: str,
    inner: bytes,
    version: int = PROPAGATION_VERSION,
    generation: Optional[int] = None,
) -> bytes:
    """`generation` (the snapshot generation the Leader's own share is
    bound to) rides only on version >= 3; passing one with a lower
    version silently drops it — the downgrade ladder already journals
    that checking is disabled for that peer."""
    if version not in _SUPPORTED_VERSIONS:
        raise EnvelopeError(f"unsupported envelope version {version}")
    tid = bytes.fromhex(trace_id)[:8].ljust(8, b"\0")
    gen_field = b""
    if version >= 3:
        gen_field = _GEN.pack(
            0 if generation is None else int(generation) + 1
        )
    return (
        _HEAD.pack(_MAGIC, version, _KIND_REQUEST)
        + tid
        + gen_field
        + _LEN.pack(len(inner))
        + inner
    )


def try_decode_request_ext(
    payload: bytes,
) -> Tuple[Optional[str], bytes, int, Optional[int]]:
    """-> (trace_id | None, inner bytes, envelope version,
    generation | None). No magic: the payload is a bare old-version
    proto and comes back untouched (reported as version 0). A server
    answers in the request's version so old Leaders never see fields
    they cannot decode. `generation` is None below v3 and for v3
    requests whose Leader did not bind one."""
    if not payload.startswith(_MAGIC):
        return None, payload, 0, None
    if len(payload) < _HEAD.size + 8 + _LEN.size:
        raise EnvelopeError("truncated envelope header")
    _, version, kind = _HEAD.unpack_from(payload)
    if version not in _SUPPORTED_VERSIONS:
        raise EnvelopeError(f"unsupported envelope version {version}")
    if kind != _KIND_REQUEST:
        raise EnvelopeError(f"unexpected envelope kind {kind}")
    tid = payload[_HEAD.size:_HEAD.size + 8]
    body = _HEAD.size + 8
    generation = None
    if version >= 3:
        if len(payload) < body + _GEN.size + _LEN.size:
            raise EnvelopeError("truncated envelope header")
        (gen_field,) = _GEN.unpack_from(payload, body)
        if gen_field > 0:
            generation = gen_field - 1
        body += _GEN.size
    (inner_len,) = _LEN.unpack_from(payload, body)
    inner = payload[body + _LEN.size:]
    if len(inner) != inner_len:
        raise EnvelopeError(
            f"envelope body is {len(inner)} bytes, expected {inner_len}"
        )
    return tid.hex(), inner, version, generation


def try_decode_request_full(
    payload: bytes,
) -> Tuple[Optional[str], bytes, int]:
    """-> (trace_id | None, inner bytes, envelope version)."""
    trace_id, inner, version, _ = try_decode_request_ext(payload)
    return trace_id, inner, version


def try_decode_request(payload: bytes) -> Tuple[Optional[str], bytes]:
    """-> (trace_id | None, inner bytes). No magic: the payload is a
    bare old-version proto and comes back untouched."""
    trace_id, inner, _, _ = try_decode_request_ext(payload)
    return trace_id, inner


def encode_response(
    inner: bytes,
    trace_id: str,
    server_ms: float,
    spans: Optional[list] = None,
    version: int = PROPAGATION_VERSION,
    phases: Optional[dict] = None,
    recv_ms: Optional[float] = None,
    send_ms: Optional[float] = None,
    generation: Optional[int] = None,
) -> bytes:
    """`phases`/`recv_ms`/`send_ms` (the Helper's critical-path digest)
    ride only on version >= 2 — a v1 reply is byte-compatible with the
    old encoder, so downgrading drops the digest and nothing else.
    `generation` (the snapshot generation the share was evaluated
    against) rides only on version >= 3."""
    if version not in _SUPPORTED_VERSIONS:
        raise EnvelopeError(f"unsupported envelope version {version}")
    span_list = list(spans or [])
    if len(span_list) > MAX_RESPONSE_SPANS:
        tracing.runtime_counters.inc(
            "propagation.spans_dropped",
            len(span_list) - MAX_RESPONSE_SPANS,
        )
        span_list = span_list[:MAX_RESPONSE_SPANS]
    encoded_spans = []
    for s in span_list:
        entry = {
            "name": str(s.get("name", "?")),
            "duration_ms": float(s.get("duration_ms", 0.0)),
        }
        if version >= 2 and "offset_ms" in s:
            entry["offset_ms"] = float(s["offset_ms"])
        encoded_spans.append(entry)
    meta = {
        "trace_id": trace_id,
        "server_ms": round(float(server_ms), 3),
        "spans": encoded_spans,
    }
    if version >= 2:
        if phases:
            meta["phases"] = {
                str(k): round(float(v), 3) for k, v in phases.items()
            }
        if recv_ms is not None:
            meta["recv_ms"] = round(float(recv_ms), 3)
        if send_ms is not None:
            meta["send_ms"] = round(float(send_ms), 3)
    if version >= 3 and generation is not None:
        meta["generation"] = int(generation)
    meta_bytes = json.dumps(meta, separators=(",", ":")).encode()
    return (
        _HEAD.pack(_MAGIC, version, _KIND_RESPONSE)
        + _LEN.pack(len(meta_bytes))
        + meta_bytes
        + _LEN.pack(len(inner))
        + inner
    )


def encode_error(
    error_type: str,
    message: str = "",
    retry_after_s: float = 0.0,
    trace_id: Optional[str] = None,
    version: int = 1,
) -> bytes:
    """Typed refusal reply (kind 3): the peer decodes it back into a
    `WireErrorResponse` via `try_decode_response`. Defaults to version
    1 — the error meta gained no v2 fields, and v1 is decodable by
    every enveloped peer."""
    if version not in _SUPPORTED_VERSIONS:
        raise EnvelopeError(f"unsupported envelope version {version}")
    meta = json.dumps(
        {
            "trace_id": trace_id,
            "error_type": str(error_type),
            "message": str(message)[:512],
            "retry_after_s": round(max(0.0, float(retry_after_s)), 6),
        },
        separators=(",", ":"),
    ).encode()
    return (
        _HEAD.pack(_MAGIC, version, _KIND_ERROR)
        + _LEN.pack(len(meta))
        + meta
    )


def try_decode_response(payload: bytes) -> Tuple[Optional[dict], bytes]:
    """-> (meta | None, inner bytes). No magic: a bare proto reply from
    an old-version Helper, returned untouched. A kind-3 error envelope
    raises `WireErrorResponse`."""
    if not payload.startswith(_MAGIC):
        return None, payload
    if len(payload) < _HEAD.size + _LEN.size:
        raise EnvelopeError("truncated envelope header")
    _, version, kind = _HEAD.unpack_from(payload)
    if version not in _SUPPORTED_VERSIONS:
        raise EnvelopeError(f"unsupported envelope version {version}")
    if kind == _KIND_ERROR:
        (meta_len,) = _LEN.unpack_from(payload, _HEAD.size)
        meta_end = _HEAD.size + _LEN.size + meta_len
        if len(payload) < meta_end:
            raise EnvelopeError("truncated error envelope meta")
        try:
            meta = json.loads(payload[_HEAD.size + _LEN.size:meta_end])
        except ValueError as e:
            raise EnvelopeError(f"bad error envelope meta: {e}") from e
        raise WireErrorResponse(
            str(meta.get("error_type", "unknown")),
            message=str(meta.get("message", "")),
            retry_after_s=float(meta.get("retry_after_s", 0.0)),
            trace_id=meta.get("trace_id"),
        )
    if kind != _KIND_RESPONSE:
        raise EnvelopeError(f"unexpected envelope kind {kind}")
    (meta_len,) = _LEN.unpack_from(payload, _HEAD.size)
    meta_end = _HEAD.size + _LEN.size + meta_len
    if len(payload) < meta_end + _LEN.size:
        raise EnvelopeError("truncated envelope meta")
    try:
        meta = json.loads(payload[_HEAD.size + _LEN.size:meta_end])
    except ValueError as e:
        raise EnvelopeError(f"bad envelope meta: {e}") from e
    (inner_len,) = _LEN.unpack_from(payload, meta_end)
    inner = payload[meta_end + _LEN.size:]
    if len(inner) != inner_len:
        raise EnvelopeError(
            f"envelope body is {len(inner)} bytes, expected {inner_len}"
        )
    return meta, inner
