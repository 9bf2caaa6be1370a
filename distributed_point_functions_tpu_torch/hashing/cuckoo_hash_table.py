"""Cuckoo hash table with random eviction (`pir/hashing/cuckoo_hash_table.{h,cc}`).

Insertion picks a random hash function; if the bucket is occupied the
resident element is evicted and re-inserted, up to `max_relocations` times,
after which the element goes to the (optionally bounded) stash
(`cuckoo_hash_table.cc:66-91`). `preseed` pins an element into a bucket
without hashing (the JAX package's addition for delta builds).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from .hash_family import HashFunction


class CuckooHashTable:
    def __init__(
        self,
        hash_functions: Sequence[HashFunction],
        num_buckets: int,
        max_relocations: int,
        max_stash_size: Optional[int] = None,
        rng_seed: int = 5489,  # mt19937's fixed default seed: two builds
        # with the same inputs produce the same layout, like the reference.
    ):
        if num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        if len(hash_functions) < 2:
            raise ValueError("hash_functions must have at least 2 entries")
        if max_relocations < 0:
            raise ValueError("max_relocations must be non-negative")
        if max_stash_size is not None and max_stash_size < 0:
            raise ValueError("max_stash_size must be non-negative")
        self.num_buckets = num_buckets
        self.max_relocations = max_relocations
        self.max_stash_size = max_stash_size
        self.hash_functions = list(hash_functions)
        # Each occupied slot holds (element, its hash buckets) so
        # relocations never rehash; `get_table()` exposes elements only.
        self.table: List[Optional[tuple]] = [None] * num_buckets
        self.stash: List[bytes] = []
        self._rng = random.Random(rng_seed)

    @classmethod
    def create(cls, hash_functions, num_buckets, max_relocations,
               max_stash_size=None):
        return cls(hash_functions, num_buckets, max_relocations,
                   max_stash_size)

    def insert(self, element: bytes, buckets=None) -> None:
        """Insert `element`; `buckets` optionally pre-supplies its hash
        values (one per hash function) so bulk builders can hash in a
        tight loop up front.

        Each element's buckets are computed once and carried through
        evictions — the relocation loop would otherwise recompute a
        hash per hop (SHA256 per relocation adds minutes at the 2^24-key
        benchmark scale).
        """
        current = element.encode() if isinstance(element, str) else bytes(element)
        for _ in range(self.max_relocations):
            if buckets is None:
                # Hashed lazily: a preseeded slot (`preseed`) stores no
                # buckets, so an evicted preseeded element hashes here on
                # its first hop only.
                buckets = tuple(
                    fn(current, self.num_buckets) for fn in self.hash_functions
                )
            h = self._rng.randrange(len(self.hash_functions))
            bucket = buckets[h]
            if self.table[bucket] is not None:
                (current, buckets), self.table[bucket] = (
                    self.table[bucket],
                    (current, buckets),
                )
            else:
                self.table[bucket] = (current, buckets)
                return
        if (
            self.max_stash_size is not None
            and len(self.stash) >= self.max_stash_size
        ):
            raise RuntimeError("cannot insert element: stash is full")
        self.stash.append(current)

    def preseed(self, bucket: int, element: bytes) -> None:
        """Pin `element` into `bucket` without hashing: a delta build
        reproduces a previous build's slots before it inserts only the new
        keys. The slot stores no buckets; if a later insert evicts the
        element, `insert` hashes it on its first hop."""
        if not 0 <= bucket < self.num_buckets:
            raise ValueError(f"bucket {bucket} out of range")
        if self.table[bucket] is not None:
            raise ValueError(f"bucket {bucket} already occupied")
        current = element.encode() if isinstance(element, str) else bytes(element)
        self.table[bucket] = (current, None)

    def get_table(self) -> List[Optional[bytes]]:
        return [
            slot[0] if slot is not None else None for slot in self.table
        ]

    def get_stash(self) -> List[bytes]:
        return self.stash
