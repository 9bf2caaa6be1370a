"""Dense PIR database resident on the device.

The port of the JAX package's `pir/database.py`. Records pack into one
`uint32[num_records_padded, record_words]` host image: every record
zero-padded to the maximum record size, the record count padded to a
multiple of 128 so whole selection blocks line up with rows. The device
holds ONE staging of it, in the bit-major layout K1 and K7 read
(`ops/inner_product_kernels.py:permute_db_bitmajor`), built once under a
lock at first use; the host image is dropped once it is staged.

`inner_product_with` serves a whole query batch in one pass: through K1
(`inner_product="v2"`, the default) or K7's counts and their parity
(`inner_product="v1"`, at most 2^24 records), the counterparts of the JAX
package's `DPF_TPU_INNER_PRODUCT=pallas2 | pallas`. The choice is explicit:
there is no tier chain, a CUDA database runs its kernel or raises, a CPU
database runs the kernel's plain version.

The streaming and chunked serving tiers read the same staging in other
shapes, derived from it on the device: `streaming_chunks` (blocked
bit-reversed block order, bit-major per chunk; one staging of
2^expand_levels * 128 records cached at a time, keyed by the split) and
`chunked_staging` (the staging itself, zero-padded to the chunk granule
only when it does not reach it).
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.inner_product_kernels import (
    MAX_RECORDS_EXACT,
    permute_db_bitmajor,
    rows_from_bitmajor,
    stage_db_chunks_bitmajor,
    xor_inner_product_staged,
    xor_inner_product_staged_v1,
)
from ..ops.words import to_numpy, to_tensor
from .dense_eval_planes_v2 import streaming_block_permute_records

INNER_PRODUCTS = ("v2", "v1")


def words_to_record_bytes(
    out: np.ndarray, num_keys: int, size: int
) -> List[bytes]:
    """uint32[nq, W] inner products -> per-query record byte strings:
    little-endian words, truncated to the database's record size."""
    raw = np.ascontiguousarray(out[:num_keys].astype("<u4")).view(np.uint8)
    return [raw[q, :size].tobytes() for q in range(num_keys)]


def place_records(rows: np.ndarray, records: Sequence[bytes], lengths: np.ndarray) -> None:
    """Write record i's bytes at the start of row i of `rows` (uint8[m, w],
    m >= len(records), a view of any strides; `lengths` their lengths),
    leaving the rest as it is. One join and one scatter: records of one
    length are a reshape, ragged ones are placed by their offsets (no
    per-record Python loop)."""
    n = len(records)
    if not n:
        return
    flat = np.frombuffer(b"".join(records), dtype=np.uint8)
    if (lengths == lengths[0]).all():
        rows[:n, :lengths[0]] = flat.reshape(n, int(lengths[0]))
    else:
        row = np.repeat(np.arange(n), lengths)
        col = np.arange(flat.size) - np.repeat(np.cumsum(lengths) - lengths, lengths)
        rows[row, col] = flat


def record_lengths(records: Sequence[bytes]) -> np.ndarray:
    return np.fromiter(map(len, records), dtype=np.int64, count=len(records))


def records_to_rows(records: Sequence[bytes], num_rows: int, row_bytes: int) -> np.ndarray:
    """uint8[num_rows, row_bytes]: record i's bytes at the start of row i,
    zeros elsewhere (`place_records`)."""
    rows = np.zeros((num_rows, row_bytes), dtype=np.uint8)
    place_records(rows, records, record_lengths(records))
    return rows


def _pack_records(records: Sequence[bytes], num_padded: int, record_bytes: int):
    return records_to_rows(records, num_padded, record_bytes).view("<u4").astype(np.uint32)


def padded_records(size: int) -> int:
    """The staged record count of `size` records: a multiple of 128, at
    least 128."""
    return max(128, ((size + 127) // 128) * 128)


class DenseDpfPirDatabase:
    """Immutable dense database; construct via `DenseDpfPirDatabase.Builder`
    or directly from a list of records.

    `device=None` means the CUDA card; `device="cpu"` keeps the staging
    on the host and serves through the kernels' plain versions.
    `inner_product` picks the materialized tier's kernel: "v2" (K1) or
    "v1" (K7, at most `MAX_RECORDS_EXACT` records once padded to 4,096)."""

    class Builder:
        def __init__(self):
            self._records: List[bytes] = []

        def insert(self, value: bytes) -> "DenseDpfPirDatabase.Builder":
            if isinstance(value, str):
                value = value.encode()
            self._records.append(bytes(value))
            return self

        def build(self, device=None, inner_product: str = "v2") -> "DenseDpfPirDatabase":
            return DenseDpfPirDatabase(self._records, device=device,
                                       inner_product=inner_product)

    def __init__(self, records: Sequence[bytes], device=None,
                 inner_product: str = "v2"):
        records = [bytes(r) for r in records]
        max_value_size = max((len(r) for r in records), default=0)
        self._setup(len(records), max_value_size, device, inner_product)
        self._host_words = _pack_records(
            records, self._num_padded, max(4, ((max_value_size + 3) // 4) * 4))

    @classmethod
    def from_words(cls, words: np.ndarray, size: int, max_value_size: int,
                   device=None, inner_product: str = "v2") -> "DenseDpfPirDatabase":
        """A database over an image already packed on the host: `words`
        uint32[padded_records(size), W] with 4W >= max_value_size, record i
        in row i, zero rows past `size` (taken as is, not copied)."""
        db = cls.__new__(cls)
        db._setup(size, max_value_size, device, inner_product)
        if (words.dtype != np.uint32 or words.ndim != 2
                or words.shape[0] != db._num_padded
                or 4 * words.shape[1] < max(4, max_value_size)):
            raise ValueError(
                f"words must be uint32[{db._num_padded}, W] with 4W >= "
                f"{max_value_size}, got {words.dtype}{list(words.shape)}")
        db._host_words = words
        return db

    def _setup(self, size: int, max_value_size: int, device, inner_product: str):
        if inner_product not in INNER_PRODUCTS:
            raise ValueError(
                f"inner_product must be one of {INNER_PRODUCTS}, got "
                f"{inner_product!r}"
            )
        self._inner_product = inner_product
        self._device = resolve_device(device)
        self._size = size
        self._max_value_size = max_value_size
        self._num_padded = padded_records(size)
        staged_records = -(-self._num_padded // 4096) * 4096
        if inner_product == "v1" and staged_records > MAX_RECORDS_EXACT:
            raise ValueError(
                f"the v1 inner product serves at most {MAX_RECORDS_EXACT} "
                f"records; this database stages {staged_records}"
            )
        self._db_perm = None
        self._streaming = None  # (cut_levels, chunks)
        self._chunked = None  # (granule_blocks, staging)
        self._stage_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def size(self) -> int:
        """Number of records."""
        return self._size

    @property
    def max_value_size(self) -> int:
        return self._max_value_size

    @property
    def num_selection_blocks(self) -> int:
        """128-bit selection blocks a query provides (padded records / 128)."""
        return self._num_padded // 128

    def staged(self) -> torch.Tensor:
        """The bit-major device staging int32[32, G, W], built once."""
        with self._stage_lock:
            return self._staged_locked()

    def _staged_locked(self) -> torch.Tensor:
        if self._db_perm is None:
            rows = to_tensor(self._host_words, self._device)
            self._db_perm = permute_db_bitmajor(rows)
            del rows
            self._host_words = None
        return self._db_perm

    def streaming_chunks(self, cut_levels: int) -> torch.Tensor:
        """The streaming tier's staging: the records of the covering tree's
        2^L blocks (L = ceil(log2(num_selection_blocks))) in streaming block
        order for `cut_levels`, split into 2^cut_levels chunks, each staged
        bit-major: int32[2^cut_levels, 32, Gc, W].

        Built on the device from the bit-major staging under the staging
        lock, and cached, one split at a time: a batch whose plan moves the
        cut restages. Bytes, with R = 2^L * 128 records of 4W bytes: the
        result holds R * 4W, each chunk padded to a multiple of 4,096
        records; building it holds a row-major copy of the staging and the
        permuted rows (about 2 R * 4W) for a moment."""
        with self._stage_lock:
            if self._streaming is not None and self._streaming[0] == cut_levels:
                return self._streaming[1]
            self._streaming = None  # drop the old split before the new one
            levels = max(0, (self.num_selection_blocks - 1).bit_length())
            if not 0 <= cut_levels <= levels:
                raise ValueError(f"cut_levels must be in [0, {levels}]")
            records = 128 << levels
            rows = rows_from_bitmajor(self._staged_locked())
            if rows.shape[0] >= records:
                rows = rows[:records]  # only zero rows lie beyond
            else:
                rows = F.pad(rows, (0, 0, 0, records - rows.shape[0]))
            permuted = streaming_block_permute_records(rows, cut_levels)
            del rows
            chunks = stage_db_chunks_bitmajor(permuted, 1 << cut_levels)
            self._streaming = (cut_levels, chunks)
            return chunks

    def chunked_staging(self, granule_blocks: int) -> torch.Tensor:
        """The chunked tier's staging: the bit-major staging with at least
        ceil(num_selection_blocks / granule_blocks) * granule_blocks * 4
        groups, so that every chunk is a whole group span. It is the
        staging itself when that reaches far enough (no extra bytes), else
        a zero-padded copy, built once under the staging lock."""
        blocks = -(-self.num_selection_blocks // granule_blocks) * granule_blocks
        with self._stage_lock:
            staged = self._staged_locked()
            extra = 4 * blocks - staged.shape[1]
            if extra <= 0:
                return staged
            if self._chunked is None or self._chunked[0] != granule_blocks:
                self._chunked = (granule_blocks,
                                 F.pad(staged, (0, 0, 0, extra)))
            return self._chunked[1]

    @property
    def db_words(self) -> torch.Tensor:
        """int32[num_records_padded, record_words] row-major words on the
        device, derived from the staging (a fresh tensor per call)."""
        return rows_from_bitmajor(self.staged())[: self._num_padded]

    def inner_product_with(self, selections: torch.Tensor) -> List[bytes]:
        """XOR of all records whose selection bit is 1, per query.

        `selections`: int32[num_queries, B, 4] packed blocks on the
        database's device with B * 128 >= size. Returns one byte-string
        of `max_value_size` per query."""
        if selections.ndim != 3 or selections.shape[-1] != 4:
            raise ValueError("selections must be int32[nq, B, 4]")
        if selections.device != self._device:
            raise ValueError(
                f"selections on {selections.device}, database on "
                f"{self._device}"
            )
        if selections.shape[1] * 128 < self.size:
            raise ValueError(
                f"selections contain {selections.shape[1] * 128} bits, "
                f"expected at least {self.size}"
            )
        needed = self.num_selection_blocks
        if selections.shape[1] > needed:
            selections = selections[:, :needed]
        elif selections.shape[1] < needed:
            selections = F.pad(
                selections, (0, 0, 0, needed - selections.shape[1])
            )
        inner_product = (xor_inner_product_staged_v1 if self._inner_product == "v1"
                         else xor_inner_product_staged)
        out = to_numpy(inner_product(self.staged(), selections))
        return words_to_record_bytes(out, out.shape[0], self._max_value_size)
