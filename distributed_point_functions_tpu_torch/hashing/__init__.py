"""Hashing sublibrary (reference: `pir/hashing/`): the port's copy of the
JAX package's `hashing/`, pure Python, which the port may not import."""

from .hash_family import HashFamily, create_hash_functions, wrap_with_seed
from .farm_hash_family import FarmHashFunction, farm_hash_family
from .sha256_hash_family import SHA256HashFamily, sha256_hash_function
from .hash_family_config import (
    HASH_FAMILY_SHA256,
    HASH_FAMILY_UNSPECIFIED,
    HashFamilyConfig,
    create_hash_family_from_config,
)
from .cuckoo_hash_table import CuckooHashTable
from .multiple_choice_hash_table import MultipleChoiceHashTable
from .simple_hash_table import SimpleHashTable

__all__ = [
    "HashFamily",
    "create_hash_functions",
    "wrap_with_seed",
    "FarmHashFunction",
    "farm_hash_family",
    "SHA256HashFamily",
    "sha256_hash_function",
    "HashFamilyConfig",
    "HASH_FAMILY_SHA256",
    "HASH_FAMILY_UNSPECIFIED",
    "create_hash_family_from_config",
    "CuckooHashTable",
    "MultipleChoiceHashTable",
    "SimpleHashTable",
]
