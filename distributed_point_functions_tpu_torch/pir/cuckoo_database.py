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

Generation rotation: `Builder.build_from(prev)` upserts its records into
`prev`: a key `prev` holds keeps its bucket, a new key is inserted into a
cuckoo table preseeded with `prev`'s layout (`_insert_into`: the JAX
package's insertion, so the slots equal its), and only the touched bucket
rows (moved by an eviction, or holding a rewritten value) become a delta
of the dense staging (`DenseDpfPirDatabase.Builder.build_from`), which
`prestage` scatters into `prev`'s resident staging. A write whose key or
value outgrows the row's words restages in full. The JAX package's two
stores are `key_database` and `value_database` here: read-only views of
the one staging's key and value words.
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
from .database import (
    DenseDpfPirDatabase,
    padded_records,
    place_records,
    record_lengths,
    records_to_rows,
)


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
            slots = self._build_slots(params, keys)
            words, key_size, value_size = pack_buckets(
                slots, keys, list(self._records.values()))
            return CuckooHashedDpfPirDatabase(
                words, key_size, value_size, params=params, slots=slots,
                keys=keys, generation=self._generation, device=device)

        @staticmethod
        def _build_slots(params: CuckooHashingParams, keys: Sequence[bytes]) -> np.ndarray:
            """The cuckoo assignment of a full build (`cuckoo_slots`)."""
            return cuckoo_slots(params, keys)

        def build_from(self, prev: "CuckooHashedDpfPirDatabase") -> "CuckooHashedDpfPirDatabase":
            """Generation `prev.generation + 1` by upsert: this builder's
            records overwrite or extend `prev`'s (no delete: retire a key
            with a full build). A key `prev` holds keeps its bucket; new
            keys go into `prev`'s layout through `_insert_into` (an
            eviction may move an old key: its bucket counts as touched).
            The touched bucket rows become a delta of `prev`'s dense
            staging on `prev`'s device, staged from its resident staging
            by `prestage`; a key or value wider than the rows' words makes
            a full image instead."""
            params = prev.params
            if self._params is not None and self._params != params:
                raise ValueError(
                    "build_from cannot change cuckoo params; build from "
                    "scratch to change the geometry")
            if any(not key for key in self._records):
                raise ValueError("key cannot be empty")
            fns = create_hash_functions(
                create_hash_family_from_config(params.hash_family_config),
                params.num_hash_functions)
            # A key of `prev` sits in one of its hash buckets (no stash).
            held = {}
            for key in self._records:
                for b in {fn(key, params.num_buckets) for fn in fns}:
                    if prev.key_at(b) == key:
                        held[key] = b
                        break
            new_keys = [k for k in self._records if k not in held]
            moves, origin = self._insert_into(params, prev, new_keys, fns)
            n_prev = len(prev._key_offsets) - 1
            index = {key: n_prev + i for i, key in enumerate(new_keys)}
            index.update({key: int(prev.slot_index[b]) for key, b in origin.items()})
            slots = prev.slot_index.copy()
            touched = {}  # bucket -> key
            for b, key in moves.items():
                slots[b] = index[key]
                if slots[b] != prev.slot_index[b]:
                    touched[b] = key
            # Rewrites in place: an upserted key that kept its bucket and
            # whose value changed.
            kept = [(key, b) for key, b in held.items() if b not in touched]
            old = prev.value_rows([b for _, b in kept])
            width = 4 * prev._value_words
            for (key, b), row in zip(kept, old):
                if self._records[key].ljust(width, b"\0") != row.tobytes():
                    touched[b] = key
            key_size = max([prev.key_size] + [len(k) for k in self._records])
            value_size = max([prev.value_size] + [len(v) for v in self._records.values()])
            kw, vw = _words(key_size), _words(value_size)
            # Each touched row: a moved old key carries its row over from
            # its previous bucket; an upserted key gets its new value.
            buckets = sorted(touched)
            carried = [b for b in buckets if touched[b] not in self._records]
            carried = dict(zip(carried, prev.dense_database.rows_at(
                [origin[touched[b]] for b in carried])))
            rows = []
            for b in buckets:
                key = touched[b]
                value = (self._records[key] if b not in carried
                         else carried[b][prev._key_words:].tobytes())
                rows.append(key.ljust(4 * kw, b"\0") + value.ljust(4 * vw, b"\0")[:4 * vw])
            blob = prev._key_blob + b"".join(new_keys)
            offsets = np.concatenate([prev._key_offsets, prev._key_offsets[-1]
                                      + np.cumsum(record_lengths(new_keys))]).astype(np.int64)
            generation = prev.generation + 1
            if (kw, vw) == (prev._key_words, prev._value_words):
                builder = DenseDpfPirDatabase.Builder()
                for b, row in zip(buckets, rows):
                    builder.update(b, row)
                dense = builder.build_from(prev.dense_database)
            else:
                base = prev.dense_database.host_rows()
                words = np.zeros((base.shape[0], kw + vw), dtype=np.uint32)
                words[:, :prev._key_words] = base[:, :prev._key_words]
                words[:, kw:kw + prev._value_words] = base[:, prev._key_words:]
                if buckets:
                    words[buckets] = records_to_rows(rows, len(rows), 4 * (kw + vw)).view("<u4")
                dense = DenseDpfPirDatabase.from_words(
                    words, params.num_buckets, 4 * (kw + vw), device=prev.device,
                    generation=generation)
            return CuckooHashedDpfPirDatabase._from_dense(
                dense, key_size, value_size, params, slots, blob, offsets, generation)

        @staticmethod
        def _insert_into(params, prev, new_keys, fns):
            """`new_keys` inserted into a cuckoo table preseeded with
            `prev`'s layout: the JAX package's `_insert_into`, on a view
            that reads `prev`'s slot array where it has not written.
            Returns ({bucket: key} of every bucket written, {old key: its
            bucket in prev} of every old key the insertion moved)."""
            table = CuckooHashTable(fns, params.num_buckets,
                                    max_relocations=max(128, len(new_keys)),
                                    max_stash_size=0)
            table.table = _PreseededSlots(prev)
            for key in new_keys:
                table.insert(key)
            moves = {b: slot[0] for b, slot in table.table.written.items()}
            return moves, table.table.origin

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
        dense = DenseDpfPirDatabase.from_words(
            words, params.num_buckets, 4 * words.shape[1], device=device,
            generation=generation)
        offsets = np.concatenate([[0], np.cumsum(record_lengths(keys))]).astype(np.int64)
        self._setup(dense, key_size, value_size, params, slots, b"".join(keys), offsets,
                    generation)

    @classmethod
    def _from_dense(cls, dense, key_size, value_size, params, slots, key_blob,
                    key_offsets, generation) -> "CuckooHashedDpfPirDatabase":
        db = cls.__new__(cls)
        db._setup(dense, key_size, value_size, params, slots, key_blob, key_offsets,
                  generation)
        return db

    def _setup(self, dense, key_size, value_size, params, slots, key_blob,
               key_offsets, generation):
        self._key_size = key_size
        self._value_size = value_size
        self._key_words = _words(key_size)
        self._value_words = dense._record_words - self._key_words
        self._dense = dense
        self._params = params
        self._slot_index = slots
        self._key_blob = key_blob
        self._key_offsets = key_offsets
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

    def key_at(self, bucket: int) -> Optional[bytes]:
        """The key in `bucket`, or None."""
        i = int(self._slot_index[bucket])
        if i < 0:
            return None
        return self._key_blob[self._key_offsets[i]:self._key_offsets[i + 1]]

    def value_rows(self, buckets) -> np.ndarray:
        """uint8[len(buckets), 4 * value words]: the value words of the
        given buckets, zero-padded (`DenseDpfPirDatabase.rows_at`)."""
        rows = self._dense.rows_at(buckets)
        return np.ascontiguousarray(rows[:, self._key_words:]).view(np.uint8)

    def value_at(self, bucket: int) -> bytes:
        """The value in `bucket`, zero-padded to `value_size` bytes (zeros
        for a vacant bucket)."""
        return self.value_rows([bucket])[0, :self._value_size].tobytes()

    @property
    def key_database(self) -> "BucketStore":
        """The bucket keys: a read-only view of the staging's key words
        (the JAX package's parallel key database)."""
        return BucketStore(self, 0, self._key_words, self._key_size)

    @property
    def value_database(self) -> "BucketStore":
        """The bucket values: a read-only view of the staging's value
        words (the JAX package's parallel value database)."""
        return BucketStore(self, self._key_words, self._value_words, self._value_size)

    # -- rotation -----------------------------------------------------------

    def replica(self) -> "CuckooHashedDpfPirDatabase":
        """A second database of this generation that shares this one's
        staging on the device once it stages (no copy): each party of a
        two-server deployment in one process holds its own database, so
        that one party's rotation never frees the other's staging, and a
        delta built from either clones the shared staging."""
        dense = DenseDpfPirDatabase._from_delta(self._dense, {}, self._generation)
        return CuckooHashedDpfPirDatabase._from_dense(
            dense, self._key_size, self._value_size, self._params, self._slot_index,
            self._key_blob, self._key_offsets, self._generation)

    def prestage(self) -> int:
        """Stage the bucket rows now (the double-buffer half of a
        rotation); returns the bytes moved. For a `Builder.build_from`
        generation whose base is staged, only the touched bucket rows
        move (`last_prestage_stats["bytes_saved"] > 0`)."""
        return self._dense.prestage()

    @property
    def last_prestage_stats(self) -> Optional[dict]:
        return self._dense.last_prestage_stats

    def release_stagings(self) -> int:
        """Drop the device stagings; returns how many were dropped."""
        return self._dense.release_stagings()

    def staged_bytes(self) -> int:
        return self._dense.staged_bytes()

    def split_row(self, row: bytes) -> Tuple[bytes, bytes]:
        """A response row of the dense staging -> (key bytes, value bytes)."""
        start = 4 * self._key_words
        return row[:self._key_size], row[start:start + self._value_size]

    def inner_product_with(self, selections: torch.Tensor) -> List[Tuple[bytes, bytes]]:
        """(key, value) of the XOR of the selected buckets, per query: one
        inner product over the bucket rows."""
        return [self.split_row(r) for r in self._dense.inner_product_with(selections)]


class BucketStore:
    """One of the JAX package's two parallel stores over the buckets, as a
    read-only view of the one staging's words `[start, start + words)`:
    `record(b)` is bucket b's bytes, zero-padded to `max_value_size`."""

    def __init__(self, database: CuckooHashedDpfPirDatabase, start: int, words: int,
                 max_value_size: int):
        self._database = database
        self._start = start
        self._words = words
        self.max_value_size = max_value_size

    @property
    def size(self) -> int:
        return self._database.num_buckets

    @property
    def num_selection_blocks(self) -> int:
        return self._database.num_selection_blocks

    def record(self, bucket: int) -> bytes:
        row = self._database.dense_database.rows_at([bucket])[0]
        part = np.ascontiguousarray(row[self._start:self._start + self._words])
        return part.view(np.uint8)[:self.max_value_size].tobytes()


class _PreseededSlots:
    """The table of `Builder._insert_into`: `prev`'s slot array as
    preseeded slots `(key, None)` (`CuckooHashTable.preseed`), overlaid by
    the slots the insertion writes. `written` holds the overlay, `origin`
    the bucket in `prev` of every old key read out of it."""

    def __init__(self, prev: CuckooHashedDpfPirDatabase):
        self._prev = prev
        self.written: Dict[int, tuple] = {}
        self.origin: Dict[bytes, int] = {}

    def __getitem__(self, bucket: int):
        slot = self.written.get(bucket)
        if slot is not None or bucket in self.written:
            return slot
        key = self._prev.key_at(bucket)
        if key is None:
            return None
        self.origin.setdefault(key, bucket)
        return (key, None)

    def __setitem__(self, bucket: int, slot) -> None:
        self.written[bucket] = slot
