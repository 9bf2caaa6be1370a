"""d-choice hashing: insert into the least-occupied candidate bucket
(`pir/hashing/multiple_choice_hash_table.{h,cc}`)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from .hash_family import HashFunction


class MultipleChoiceHashTable:
    def __init__(
        self,
        hash_functions: Sequence[HashFunction],
        num_buckets: int,
        max_bucket_size: Optional[int] = None,
    ):
        if num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        if len(hash_functions) < 2:
            raise ValueError("hash_functions must have at least 2 entries")
        if max_bucket_size is not None and max_bucket_size <= 0:
            raise ValueError("max_bucket_size must be positive")
        self.num_buckets = num_buckets
        self.max_bucket_size = max_bucket_size
        self.hash_functions = list(hash_functions)
        self.table: List[List[bytes]] = [[] for _ in range(num_buckets)]

    def insert(self, element: bytes) -> None:
        element = element.encode() if isinstance(element, str) else bytes(element)
        smallest = None
        for fn in self.hash_functions:
            bucket = fn(element, self.num_buckets)
            if smallest is None or len(self.table[bucket]) < len(
                self.table[smallest]
            ):
                smallest = bucket
        if (
            self.max_bucket_size is not None
            and len(self.table[smallest]) >= self.max_bucket_size
        ):
            raise RuntimeError(
                "cannot insert element: maximum bucket size reached"
            )
        self.table[smallest].append(element)

    def get_table(self) -> List[List[bytes]]:
        return self.table
