"""Hash function / family abstractions (`pir/hashing/hash_family.h:37-53`).

A *hash function* maps `(data: bytes, upper_bound: int) -> int` in
`[0, upper_bound)`. A *hash family* maps a seed to a hash function.
`create_hash_functions` derives `n` functions from a family by seeding with
the decimal strings "0".."n-1" (`hash_family.cc:27-40`); `wrap_with_seed`
prepends a fixed family seed to every derivation seed
(`hash_family.h:42-53`).
"""

from __future__ import annotations

from typing import Callable, List

HashFunction = Callable[[bytes, int], int]
HashFamily = Callable[[bytes], HashFunction]


def _as_bytes(s) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


def wrap_with_seed(family: HashFamily, family_seed) -> HashFamily:
    family_seed = _as_bytes(family_seed)

    def wrapped(seed) -> HashFunction:
        return family(family_seed + _as_bytes(seed))

    return wrapped


def create_hash_functions(
    family: HashFamily, num_hash_functions: int
) -> List[HashFunction]:
    if num_hash_functions < 0:
        raise ValueError("num_hash_functions must not be negative")
    return [family(str(i).encode()) for i in range(num_hash_functions)]
