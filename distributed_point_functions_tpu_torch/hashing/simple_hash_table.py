"""Simple hashing: every element stored under all hash functions
(`pir/hashing/simple_hash_table.{h,cc}`). Inserts are all-or-nothing when a
bucket bound is set (`simple_hash_table.cc:55-70`)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from .hash_family import HashFunction


class SimpleHashTable:
    def __init__(
        self,
        hash_functions: Sequence[HashFunction],
        num_buckets: int,
        max_bucket_size: Optional[int] = None,
    ):
        if num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        if not hash_functions:
            raise ValueError("hash_functions must not be empty")
        if max_bucket_size is not None and max_bucket_size <= 0:
            raise ValueError("max_bucket_size must be positive")
        self.num_buckets = num_buckets
        self.max_bucket_size = max_bucket_size
        self.hash_functions = list(hash_functions)
        self.table: List[List[bytes]] = [[] for _ in range(num_buckets)]

    def insert(self, element: bytes) -> None:
        element = element.encode() if isinstance(element, str) else bytes(element)
        buckets = [
            fn(element, self.num_buckets) for fn in self.hash_functions
        ]
        if self.max_bucket_size is not None:
            for b in buckets:
                if len(self.table[b]) >= self.max_bucket_size:
                    raise RuntimeError(
                        "cannot insert element: maximum bucket size reached"
                    )
        for b in buckets:
            self.table[b].append(element)

    def get_table(self) -> List[List[bytes]]:
        return self.table
