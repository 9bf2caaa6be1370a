"""Builds syntactically-correct PIR requests for tests (the port's copy of
the JAX package's `testing/request_generator.py`).

Mirrors the reference's `pir/testing/request_generator.h:34-62`: a fixed
one-time-pad seed plus helpers that build plain/leader request pairs for an
arbitrary index set, using the same key construction as the real client
(`alpha = index / 128`, `beta = 1 << (index % 128)`,
`dense_dpf_pir_client.cc:92-103` / `request_generator.cc:70-76`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from ..dpf import DistributedPointFunction, DpfParameters
from ..prng import generate_seed
from ..value_types import XorType
from ..pir import messages
from . import encrypt_decrypt

BITS_PER_BLOCK = 128


class RequestGenerator:
    """Generates plain/leader request pairs for a dense PIR database."""

    def __init__(self, database_size: int, encryption_context_info: str | bytes):
        if database_size <= 0:
            raise ValueError("`database_size` must be positive")
        log_domain_size = max(0, math.ceil(math.log2(database_size)))
        self._dpf = DistributedPointFunction.create(
            DpfParameters(
                log_domain_size=log_domain_size,
                value_type=XorType(BITS_PER_BLOCK),
            )
        )
        self._otp_seed = generate_seed()
        if isinstance(encryption_context_info, str):
            encryption_context_info = encryption_context_info.encode()
        self._encryption_context_info = encryption_context_info
        self._database_size = database_size

    @classmethod
    def create(
        cls, database_size: int, encryption_context_info: str | bytes
    ) -> "RequestGenerator":
        return cls(database_size, encryption_context_info)

    @property
    def otp_seed(self) -> bytes:
        """The one-time-pad seed baked into leader requests."""
        return self._otp_seed

    def create_plain_requests(
        self, indices: Sequence[int]
    ) -> Tuple[messages.PlainRequest, messages.PlainRequest]:
        """One DPF key pair per index, as two PlainRequests."""
        keys0, keys1 = [], []
        for index in indices:
            if index < 0:
                raise ValueError("`indices` must be non-negative")
            if index >= self._database_size:
                raise ValueError("`indices` must be less than `database_size`")
            alpha = index // BITS_PER_BLOCK
            beta = 1 << (index % BITS_PER_BLOCK)
            k0, k1 = self._dpf.generate_keys(alpha, beta)
            keys0.append(k0)
            keys1.append(k1)
        return (
            messages.PlainRequest(dpf_keys=keys0),
            messages.PlainRequest(dpf_keys=keys1),
        )

    def create_leader_request(
        self, indices: Sequence[int]
    ) -> messages.LeaderRequest:
        """Leader request with the helper leg encrypted under the test key."""
        plain0, plain1 = self.create_plain_requests(indices)
        helper = messages.HelperRequest(
            plain_request=plain1, one_time_pad_seed=self._otp_seed
        )
        ciphertext = encrypt_decrypt.encrypt(
            messages.serialize_helper_request(self._dpf, helper),
            self._encryption_context_info,
        )
        return messages.LeaderRequest(
            plain_request=plain0,
            encrypted_helper_request=messages.EncryptedHelperRequest(
                encrypted_request=ciphertext
            ),
        )
