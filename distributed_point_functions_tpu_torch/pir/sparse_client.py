"""Sparse PIR client: the port of the JAX package's `pir/sparse_client.py`
(`pir/cuckoo_hashing_sparse_dpf_pir_client.{h,cc}`).

Each queried string is hashed with all of the server's hash functions; the
resulting bucket indices become one dense-PIR request over the bucket space
(`cuckoo_hashing_sparse_dpf_pir_client.cc:108-134`). Response handling gets
`(key, value)` pairs for every candidate bucket and selects the value whose
returned key matches the query (zero-padded prefix check,
`cuckoo_hashing_sparse_dpf_pir_client.cc:136-187`). The client runs on the
host only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..hashing import create_hash_family_from_config
from ..hashing.hash_family import create_hash_functions
from . import messages
from .client import (
    DenseDpfPirClient,
    ENCRYPTION_CONTEXT_INFO,
    EncryptHelperRequestFn,
)
from .cuckoo_database import CuckooHashingParams


@dataclasses.dataclass
class CuckooHashingSparseDpfPirRequestClientState:
    one_time_pad_seed: bytes
    query_strings: List[bytes]


@dataclasses.dataclass(frozen=True)
class KeyNotFound:
    """Typed absent-key result: no candidate bucket's key matched the
    queried string. A lookup never degrades to a wrong value; callers
    branch on this type instead of testing a value against None."""

    key: bytes

    def __bool__(self) -> bool:
        return False


def _is_prefix_padded_with_zeros(data: bytes, prefix: bytes) -> bool:
    if data[: len(prefix)] != prefix[: len(data)]:
        return False
    return all(b == 0 for b in data[len(prefix) :])


def _as_bytes(q) -> bytes:
    return q.encode() if isinstance(q, str) else bytes(q)


class CuckooHashingSparseDpfPirClient:
    """Client for `CuckooHashingSparseDpfPirServer`."""

    def __init__(
        self,
        params: CuckooHashingParams,
        encrypter: EncryptHelperRequestFn,
        encryption_context_info: bytes = ENCRYPTION_CONTEXT_INFO,
    ):
        if params.num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        if params.num_hash_functions <= 0:
            raise ValueError("num_hash_functions must be positive")
        family = create_hash_family_from_config(params.hash_family_config)
        self._hash_functions = create_hash_functions(
            family, params.num_hash_functions
        )
        self._num_buckets = params.num_buckets
        self._wrapped_client = DenseDpfPirClient.create(
            params.num_buckets, encrypter, encryption_context_info
        )

    @classmethod
    def create(cls, params, encrypter,
               encryption_context_info=ENCRYPTION_CONTEXT_INFO):
        return cls(params, encrypter, encryption_context_info)

    @classmethod
    def create_from_public_params(
        cls,
        public_params: bytes,
        encrypter,
        encryption_context_info=ENCRYPTION_CONTEXT_INFO,
    ):
        """Construct from the server's `PirServerPublicParams` bytes
        (`get_public_params()`, or any proto3 encoding of the message;
        `cuckoo_hashing_sparse_dpf_pir_client_test.cc:170`)."""
        from .. import serialization

        params = serialization.parse_public_params(bytes(public_params))
        if params is None:
            raise ValueError(
                "public params do not contain cuckoo hashing parameters"
            )
        return cls(params, encrypter, encryption_context_info)

    def _bucket_indices(self, query: Sequence[bytes]) -> List[int]:
        """Every hash function's bucket of each queried string, query-major."""
        return [fn(_as_bytes(q), self._num_buckets)
                for q in query for fn in self._hash_functions]

    def create_request(
        self, query: Sequence[bytes]
    ) -> Tuple["messages.PirRequest", CuckooHashingSparseDpfPirRequestClientState]:
        qbytes = [_as_bytes(q) for q in query]
        request, dense_state = self._wrapped_client.create_request(
            self._bucket_indices(qbytes)
        )
        return request, CuckooHashingSparseDpfPirRequestClientState(
            one_time_pad_seed=dense_state.one_time_pad_seed,
            query_strings=qbytes,
        )

    def create_plain_requests(self, query: Sequence[bytes]):
        return self._wrapped_client.create_plain_requests(self._bucket_indices(query))

    def handle_response(
        self,
        response: "messages.PirResponse",
        client_state: CuckooHashingSparseDpfPirRequestClientState,
    ) -> List[Optional[bytes]]:
        """Per query: the value if the key was present, else None."""
        num_hashes = len(self._hash_functions)
        masked = response.dpf_pir_response.masked_response
        nq = len(client_state.query_strings)
        if nq * num_hashes * 2 != len(masked):
            raise ValueError(
                "number of responses must be equal to the number of queries "
                "times the number of hash functions times 2"
            )
        raw = self._wrapped_client.handle_response(
            response,
            messages.DenseDpfPirRequestClientState(
                one_time_pad_seed=client_state.one_time_pad_seed
            ),
        )
        return self._match(raw, client_state.query_strings)

    def _match(self, raw: Sequence[bytes], query_strings: Sequence[bytes]
              ) -> List[Optional[bytes]]:
        """Per query, from the unmasked (key, value) responses of its
        buckets: the value of the first bucket whose key is the query
        zero-padded, else None."""
        num_hashes = len(self._hash_functions)
        result: List[Optional[bytes]] = [None] * len(query_strings)
        for i, query in enumerate(query_strings):
            for j in range(num_hashes):
                raw_index = 2 * (num_hashes * i + j)
                if _is_prefix_padded_with_zeros(raw[raw_index], query):
                    result[i] = raw[raw_index + 1]
                    break
        return result

    def resolve(
        self,
        response: "messages.PirResponse",
        client_state: CuckooHashingSparseDpfPirRequestClientState,
    ) -> List:
        """`handle_response` with typed absence: per query, the value
        bytes when the key was present, else `KeyNotFound(key)`."""
        values = self.handle_response(response, client_state)
        return [
            value if value is not None else KeyNotFound(key)
            for key, value in zip(client_state.query_strings, values)
        ]
