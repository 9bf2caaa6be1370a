"""Cuckoo-hashed sparse PIR database: the port of the JAX package's
`pir/cuckoo_database.py` (the reference's
`pir/cuckoo_hashed_dpf_pir_database.{h,cc}`).

The builder cuckoo-hashes every string key into a `num_buckets`-slot table
(`cuckoo_hashed_dpf_pir_database.cc:97-146`), so one set of selection
blocks over the bucket space retrieves a `(key, value)` pair per bucket.
The reference and the JAX package keep keys and values in two parallel
dense databases and run two inner products on one selection matrix. The
port stages them as ONE dense database instead: bucket row b is bucket b's
key, zero-padded to `key_words` words, followed by its value, zero-padded
to `value_words` words (each part at least one word, as the JAX package
pads each store; a vacant bucket's row is zero). One expansion and one
inner product a batch then serve both on every serving tier of the dense
server, and `split_row` cuts each response row into the key bytes
(truncated to the longest key) and the value bytes (truncated to the
longest value): the bytes of the JAX package's two stores.

The build runs on the host in bulk:

* the table (`cuckoo_slots`): for the SHA256 hash family the port's native
  build (`native.cuckoo_build`: SHA256 on all cores, then cuckoo insertion
  with random eviction; the slot array equals the JAX package's native
  one), for any other family the Python `CuckooHashTable`. The family
  picks the path; a failed build raises;
* the host image (`pack_buckets`): fixed-width key and value rows gathered
  by slot index with numpy, zeros at the vacant buckets.

Generation rotation (`Builder.build_from`, staging a delta) comes with the
serving runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..hashing import CuckooHashTable, create_hash_family_from_config
from ..hashing.hash_family import create_hash_functions
from ..hashing.hash_family_config import HASH_FAMILY_SHA256, HashFamilyConfig
from .database import DenseDpfPirDatabase, padded_records, place_records, record_lengths


@dataclasses.dataclass(frozen=True)
class CuckooHashingParams:
    """Mirrors `CuckooHashingParams` (`private_information_retrieval.proto:93-100`)."""

    num_buckets: int
    num_hash_functions: int
    hash_family_config: HashFamilyConfig


def _as_bytes(s) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


def cuckoo_slots(params: CuckooHashingParams, keys: Sequence[bytes]) -> np.ndarray:
    """int64[num_buckets]: the index in `keys` of the key in each bucket, or
    -1. SHA256 runs the native build, any other family the Python table
    (`create_hash_family_from_config` refuses the families it lacks)."""
    max_relocations = max(128, len(keys))
    config = params.hash_family_config
    if config.hash_family == HASH_FAMILY_SHA256:
        if not config.seed:
            raise ValueError("seed must not be empty")
        seed = _as_bytes(config.seed)
        seeds = [seed + str(i).encode() for i in range(params.num_hash_functions)]
        return native.cuckoo_build(keys, seeds, params.num_buckets,
                                   max_relocations=max_relocations)
    family = create_hash_family_from_config(config)
    table = CuckooHashTable(
        create_hash_functions(family, params.num_hash_functions),
        params.num_buckets, max_relocations=max_relocations, max_stash_size=0)
    for key in keys:
        table.insert(key)
    index = {key: i for i, key in enumerate(keys)}
    return np.array([-1 if k is None else index[k] for k in table.get_table()],
                    dtype=np.int64)


def _words(size: int) -> int:
    """Words of a store whose longest record has `size` bytes (at least one,
    as the dense database pads)."""
    return max(1, -(-size // 4))


def pack_buckets(slots: np.ndarray, keys: Sequence[bytes], values: Sequence[bytes]):
    """The host image of the bucket rows: (uint32[padded_records(num_buckets),
    key_words + value_words], longest key, longest value). Bucket b holds
    keys[slots[b]] and values[slots[b]], or zeros where slots[b] is -1:
    each key's row is packed once, then gathered by slot."""
    n = len(keys)
    key_lengths, value_lengths = record_lengths(keys), record_lengths(values)
    key_size = int(key_lengths.max(initial=0))
    value_size = int(value_lengths.max(initial=0))
    kw, vw = _words(key_size), _words(value_size)
    # Row n, all zeros, stands for the vacant buckets.
    packed = np.zeros((n + 1, 4 * (kw + vw)), dtype=np.uint8)
    place_records(packed[:, :4 * kw], keys, key_lengths)
    place_records(packed[:, 4 * kw:], values, value_lengths)
    buckets = slots.shape[0]
    words = np.empty((padded_records(buckets), kw + vw), dtype=np.uint32)
    np.take(packed.view("<u4"), np.where(slots < 0, n, slots), axis=0, out=words[:buckets])
    words[buckets:] = 0
    return words, key_size, value_size


class CuckooHashedDpfPirDatabase:
    """Sparse (string-keyed) database on one device; build via `.Builder`."""

    class Builder:
        def __init__(self):
            self._records: Dict[bytes, bytes] = {}
            self._params: Optional[CuckooHashingParams] = None
            self._generation = 0

        def set_params(self, params: CuckooHashingParams):
            self._params = params
            return self

        def set_generation(self, generation: int):
            """The snapshot generation tag stamped on the built database."""
            self._generation = int(generation)
            return self

        def insert(self, key_value: Tuple[bytes, bytes]):
            key, value = key_value
            self._records[_as_bytes(key)] = _as_bytes(value)
            return self

        def clone(self):
            b = CuckooHashedDpfPirDatabase.Builder()
            b._records = dict(self._records)
            b._params = self._params
            b._generation = self._generation
            return b

        def build(self, device=None) -> "CuckooHashedDpfPirDatabase":
            """The database on `device` (None: the CUDA card; "cpu" serves
            through the kernels' plain versions)."""
            if self._params is None:
                raise ValueError("params must be set before build")
            params = self._params
            if params.num_buckets <= 0:
                raise ValueError("num_buckets must be positive")
            if params.num_hash_functions <= 0:
                raise ValueError("num_hash_functions must be positive")
            keys = list(self._records)
            if any(not key for key in keys):
                raise ValueError("key cannot be empty")
            slots = cuckoo_slots(params, keys)
            words, key_size, value_size = pack_buckets(
                slots, keys, list(self._records.values()))
            return CuckooHashedDpfPirDatabase(
                words, key_size, value_size, params=params, slots=slots,
                keys=keys, generation=self._generation, device=device)

    def __init__(self, words: np.ndarray, key_size: int, value_size: int,
                 params: CuckooHashingParams, slots: np.ndarray,
                 keys: Sequence[bytes], generation: int = 0, device=None):
        """`words` is `pack_buckets`' image of `slots` (int64[num_buckets],
        indices into `keys` or -1). The keys are kept as one byte string
        and its offsets, not as a list of objects: a list of 2^24 keys
        slows every full pass of Python's garbage collector."""
        if slots.shape != (params.num_buckets,):
            raise ValueError(
                f"slots must have {params.num_buckets} entries, got {slots.shape}")
        self._key_size = key_size
        self._value_size = value_size
        self._key_words = _words(key_size)
        self._dense = DenseDpfPirDatabase.from_words(
            words, params.num_buckets, 4 * words.shape[1], device=device)
        self._params = params
        self._slot_index = slots
        self._key_blob = b"".join(keys)
        self._key_offsets = np.concatenate(
            [[0], np.cumsum(record_lengths(keys))]).astype(np.int64)
        self._size = int((slots >= 0).sum())
        self._generation = int(generation)

    @property
    def size(self) -> int:
        """Number of real (non-dummy) records."""
        return self._size

    @property
    def generation(self) -> int:
        """Snapshot generation tag (0 = untagged)."""
        return self._generation

    @property
    def num_buckets(self) -> int:
        return self._params.num_buckets

    @property
    def params(self) -> CuckooHashingParams:
        """The cuckoo geometry this database was built under."""
        return self._params

    @property
    def slots(self) -> List[Optional[bytes]]:
        """bucket -> key (or None), built from the slot array at each call."""
        blob, offsets = self._key_blob, self._key_offsets.tolist()
        return [blob[offsets[i]:offsets[i + 1]] if i >= 0 else None
                for i in self._slot_index.tolist()]

    @property
    def slot_index(self) -> np.ndarray:
        """int64[num_buckets]: the index of each bucket's key, or -1."""
        return self._slot_index

    @property
    def num_selection_blocks(self) -> int:
        return self._dense.num_selection_blocks

    @property
    def max_value_size(self) -> int:
        """The longest key or value: the larger packed record of the JAX
        package's two stores."""
        return max(self._key_size, self._value_size)

    @property
    def key_size(self) -> int:
        """The longest key in bytes: the length of every key response."""
        return self._key_size

    @property
    def value_size(self) -> int:
        """The longest value in bytes: the length of every value response."""
        return self._value_size

    @property
    def dense_database(self) -> DenseDpfPirDatabase:
        """The one dense staging of the bucket rows (key words, then value
        words) that the server serves."""
        return self._dense

    @property
    def device(self) -> torch.device:
        return self._dense.device

    def split_row(self, row: bytes) -> Tuple[bytes, bytes]:
        """A response row of the dense staging -> (key bytes, value bytes)."""
        start = 4 * self._key_words
        return row[:self._key_size], row[start:start + self._value_size]

    def inner_product_with(self, selections: torch.Tensor) -> List[Tuple[bytes, bytes]]:
        """(key, value) of the XOR of the selected buckets, per query: one
        inner product over the bucket rows."""
        return [self.split_row(r) for r in self._dense.inner_product_with(selections)]
