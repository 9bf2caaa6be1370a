"""SHA256-based hash family (`pir/hashing/sha256_hash_family.{h,cc}`).

Hashes `SHA256(seed || input)` and reduces the 256-bit digest modulo the
upper bound. The digest is interpreted exactly like the reference's
memcpy-into-uint128 long division (`sha256_hash_family.cc:69-88`): the low
16 digest bytes are the little-endian low 128 bits and the high 16 bytes
the little-endian high 128 bits of a 256-bit integer.
"""

from __future__ import annotations

import hashlib

from .hash_family import HashFunction, _as_bytes


def sha256_hash_function(seed) -> HashFunction:
    seed = _as_bytes(seed)
    base = hashlib.sha256(seed)

    def fn(data, upper_bound: int) -> int:
        if upper_bound <= 0:
            raise ValueError("upper_bound must be positive")
        ctx = base.copy()
        ctx.update(_as_bytes(data))
        digest = ctx.digest()
        lo = int.from_bytes(digest[:16], "little")
        hi = int.from_bytes(digest[16:], "little")
        return ((hi << 128) | lo) % upper_bound

    return fn


def SHA256HashFamily():
    return sha256_hash_function
