"""Dense PIR client: the port of the JAX package's `pir/client.py`.

Per queried index the client generates a two-party DPF key pair with
`alpha = index // 128` and `beta = 1 << (index % 128)`: one selection bit
inside a 128-bit block (the native batched keygen,
`DistributedPointFunction.generate_keys_batch`). `create_request`
assembles a `LeaderRequest`: the Leader's keys in the clear, and the
Helper's keys with a fresh one-time-pad seed, serialized
(`messages.serialize_helper_request`) and encrypted by the injected
`encrypter`. `handle_response` unmasks the Leader's combined response
with the AES-CTR pad of that seed. `create_plain_requests` gives one plain
request per party instead, whose responses XOR to the records.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

from .. import prng
from ..dpf import DistributedPointFunction, DpfParameters
from ..value_types import XorType
from . import messages

# encrypter(plaintext: bytes, context_info: bytes) -> bytes
EncryptHelperRequestFn = Callable[[bytes, bytes], bytes]

ENCRYPTION_CONTEXT_INFO = b"DpfPirServer"
BITS_PER_BLOCK = 128


class DenseDpfPirClient:
    """Client for `DenseDpfPirServer`."""

    def __init__(
        self,
        database_size: int,
        encrypter: EncryptHelperRequestFn,
        encryption_context_info: bytes = ENCRYPTION_CONTEXT_INFO,
    ):
        if database_size <= 0:
            raise ValueError("database_size must be positive")
        if encrypter is None:
            raise ValueError("encrypter must not be None")
        self._database_size = database_size
        self._encrypter = encrypter
        self._encryption_context_info = encryption_context_info
        log_domain_size = max(0, math.ceil(math.log2(database_size)))
        self._dpf = DistributedPointFunction.create(
            DpfParameters(
                log_domain_size=log_domain_size, value_type=XorType(128)
            )
        )

    @classmethod
    def create(
        cls,
        database_size: int,
        encrypter: EncryptHelperRequestFn,
        encryption_context_info: bytes = ENCRYPTION_CONTEXT_INFO,
    ) -> "DenseDpfPirClient":
        return cls(database_size, encrypter, encryption_context_info)

    @property
    def dpf(self) -> DistributedPointFunction:
        return self._dpf

    def _generate_key_pairs(self, query_indices: Sequence[int]):
        alphas, betas = [], []
        for query in query_indices:
            if query < 0:
                raise ValueError("all query_indices must be non-negative")
            if query >= self._database_size:
                raise ValueError("all query_indices must be in bounds")
            alphas.append(query // BITS_PER_BLOCK)
            betas.append(1 << (query % BITS_PER_BLOCK))
        return self._dpf.generate_keys_batch(alphas, betas)

    def create_request(
        self, query_indices: Sequence[int]
    ) -> Tuple["messages.PirRequest", "messages.DenseDpfPirRequestClientState"]:
        """A `LeaderRequest` and the client state that unmasks its response."""
        leader_keys, helper_keys = self._generate_key_pairs(query_indices)
        otp_seed = prng.generate_seed()  # module lookup: tests patch it
        helper_request = messages.HelperRequest(
            plain_request=messages.PlainRequest(dpf_keys=helper_keys),
            one_time_pad_seed=otp_seed,
        )
        ciphertext = self._encrypter(
            messages.serialize_helper_request(self._dpf, helper_request),
            self._encryption_context_info,
        )
        request = messages.PirRequest(
            leader_request=messages.LeaderRequest(
                plain_request=messages.PlainRequest(dpf_keys=leader_keys),
                encrypted_helper_request=messages.EncryptedHelperRequest(
                    encrypted_request=ciphertext
                ),
            )
        )
        return request, messages.DenseDpfPirRequestClientState(
            one_time_pad_seed=otp_seed
        )

    def create_plain_requests(
        self, query_indices: Sequence[int]
    ) -> Tuple["messages.PirRequest", "messages.PirRequest"]:
        """Two plain requests, one per party."""
        keys0, keys1 = self._generate_key_pairs(query_indices)
        return (
            messages.PirRequest(
                plain_request=messages.PlainRequest(dpf_keys=keys0)
            ),
            messages.PirRequest(
                plain_request=messages.PlainRequest(dpf_keys=keys1)
            ),
        )

    def handle_response(
        self,
        response: "messages.PirResponse",
        client_state: "messages.DenseDpfPirRequestClientState",
    ) -> List[bytes]:
        """Unmask the Leader's combined response with the one-time pad."""
        masked = response.dpf_pir_response.masked_response
        if not masked:
            raise ValueError("masked_response must not be empty")
        if not client_state.one_time_pad_seed:
            raise ValueError("one_time_pad_seed must not be empty")
        return prng.mask_all(
            masked, prng.Aes128CtrSeededPrng(client_state.one_time_pad_seed))
