"""Hash family configuration + factory
(`pir/hashing/hash_family_config.{proto,h,cc}`).

Like the reference, SHA256 is the only wired-up family
(`hash_family_config.cc:36-44`).
"""

from __future__ import annotations

import dataclasses

from .hash_family import HashFamily, wrap_with_seed
from .sha256_hash_family import SHA256HashFamily

HASH_FAMILY_UNSPECIFIED = 0
HASH_FAMILY_SHA256 = 1

HASH_FUNCTION_SEED_LENGTH_BYTES = 16


@dataclasses.dataclass(frozen=True)
class HashFamilyConfig:
    hash_family: int = HASH_FAMILY_UNSPECIFIED
    seed: bytes = b""


def create_hash_family_from_config(config: HashFamilyConfig) -> HashFamily:
    if not config.seed:
        raise ValueError("seed must not be empty")
    if config.hash_family == HASH_FAMILY_SHA256:
        family = SHA256HashFamily()
    elif config.hash_family == HASH_FAMILY_UNSPECIFIED:
        raise ValueError("hash family unspecified")
    else:
        raise ValueError("unknown hash family specified")
    return wrap_with_seed(family, config.seed)
