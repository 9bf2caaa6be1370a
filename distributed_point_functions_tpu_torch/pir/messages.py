"""PIR messages: the port of the JAX package's `pir/messages.py`.

`PirRequest` wraps one of `PlainRequest` (a batch of DPF keys),
`LeaderRequest` (the Leader's plain request and the Helper's encrypted
one) or `EncryptedHelperRequest` (opaque ciphertext); `HelperRequest` is
a plain request and the one-time pad's seed, the message that travels
encrypted from the client to the Helper, so it has a wire form
(`serialize_helper_request`, `parse_helper_request`: the proto3 bytes of
`DpfPirRequest.HelperRequest`, `serialization.py`). `PirResponse`
carries one masked response byte-string per query.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..dpf import DistributedPointFunction, DpfKey


@dataclasses.dataclass
class PlainRequest:
    dpf_keys: List[DpfKey]


@dataclasses.dataclass
class EncryptedHelperRequest:
    encrypted_request: bytes


@dataclasses.dataclass
class LeaderRequest:
    plain_request: PlainRequest
    encrypted_helper_request: EncryptedHelperRequest


@dataclasses.dataclass
class HelperRequest:
    plain_request: PlainRequest
    one_time_pad_seed: bytes


@dataclasses.dataclass
class PirRequest:
    """Exactly one of the fields is set (the proto oneof)."""

    plain_request: Optional[PlainRequest] = None
    leader_request: Optional[LeaderRequest] = None
    encrypted_helper_request: Optional[EncryptedHelperRequest] = None


@dataclasses.dataclass
class DpfPirResponse:
    masked_response: List[bytes]


@dataclasses.dataclass
class PirResponse:
    dpf_pir_response: DpfPirResponse


@dataclasses.dataclass
class DenseDpfPirRequestClientState:
    one_time_pad_seed: bytes


def serialize_helper_request(
    dpf: DistributedPointFunction, request: HelperRequest
) -> bytes:
    """The proto3 bytes of `DpfPirRequest.HelperRequest`, equal to the JAX
    package's and the reference's."""
    from .. import serialization

    return serialization.serialize_helper_request(dpf, request)


def parse_helper_request(
    dpf: DistributedPointFunction, data: bytes
) -> HelperRequest:
    """The inverse of `serialize_helper_request`; empty bytes (an all-default
    message) are no helper request, as in the JAX package."""
    from .. import serialization

    if not data:
        raise ValueError("request does not encrypt a valid HelperRequest")
    return serialization.parse_helper_request(dpf, data)
