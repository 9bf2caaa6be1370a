"""Dense PIR database resident on the device.

The port of the JAX package's `pir/database.py`. Records pack into one
`uint32[num_records_padded, record_words]` host image: every record
zero-padded to the maximum record size, the record count padded to a
multiple of 128 so whole selection blocks line up with rows. The device
holds ONE staging of it, in the bit-major layout K1 and K7 read
(`ops/inner_product_kernels.py:permute_db_bitmajor`), built once under a
lock at first use, in slabs that cross the bus while the host fills the
next one (`stage_bitmajor`); the host image is dropped once it is staged. A
staging is published only once the stream that built it has finished
it, so a batch worker on another stream never reads a half-built one.

Every database carries a snapshot **generation** (default 0), which the
serving runtime (`serving/snapshots.py`) binds batches and the wire to.
`Builder().update(i, value).build_from(prev)` derives generation N+1
from N: when the updated values fit N's rows and nothing is appended it
holds only the updated rows, and `prestage` then builds its staging on
the device as a copy of N's with those rows scattered in (mode
"delta": only the rows and their indices cross the bus). Otherwise N's
rows are read back from its staging (or taken from its host image while
it has one) and generation N+1 is packed and staged in full. No host
image is kept for rotation: a served database holds its records on the
card only. `release_stagings` drops the device buffers of a retired
generation.

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
import time
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..observability.device import default_telemetry
from ..ops.inner_product_kernels import (
    MAX_RECORDS_EXACT,
    rows_from_bitmajor,
    stage_db_chunks_bitmajor,
    xor_inner_product_staged,
    xor_inner_product_staged_v1,
)
from ..ops.words import to_numpy, to_tensor
from .dense_eval_planes_v2 import streaming_block_permute_records

INNER_PRODUCTS = ("v2", "v1")


def read_back(out: torch.Tensor) -> np.ndarray:
    """A batch's int32 result words on the host (uint32): the copy and
    the sync that end the batch, counted in the transfer ledger."""
    if out.device.type == "cuda":
        ledger = default_telemetry().transfers
        t0 = time.perf_counter()
        words = to_numpy(out)
        ledger.record_d2h(out.numel() * 4, "result_readback")
        ledger.record_sync("result_readback", (time.perf_counter() - t0) * 1e3)
        return words
    return to_numpy(out)


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


# A staging from the host image moves in at most this many slabs (the
# JAX package's `min(8, rows // 128)`), each a run of whole tiles of
# TILE_RECORDS records, the granule of the bit-major staging.
MAX_STAGING_SLABS = 8
TILE_RECORDS = 4096


def slab_spans(num_records: int, slabs: int = MAX_STAGING_SLABS) -> List[tuple]:
    """The record spans [a, b) of a staging's slabs: the TILE_RECORDS
    tiles covering `num_records`, cut into min(slabs, tiles) runs of
    near-equal length. The last span may reach past `num_records`: its
    rows there are the staging's zero padding."""
    tiles = max(1, -(-num_records // TILE_RECORDS))
    n = min(slabs, tiles)
    edges = [tiles * i // n * TILE_RECORDS for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def stage_bitmajor(host: np.ndarray, device, slabs: int = MAX_STAGING_SLABS) -> torch.Tensor:
    """The bit-major staging int32[32, G, W] of a host image uint32[R, W]
    (R a multiple of 32; G = 128 * ceil(R / 4096)), equal to
    `permute_db_bitmajor(to_tensor(host, device))`, built slab by slab
    (`slab_spans`): the records [a, b) of a slab land at [:, a/32 : b/32].
    The device never holds a row-major image of the whole database: the
    peak is the staging and two slabs.

    On a CUDA device each slab is copied into one of two pinned host
    buffers, then to the card with `copy_(non_blocking=True)` on a copy
    stream of its own, and permuted on the current stream straight into
    its groups of the staging. CUDA events order each permute after its
    copy and each buffer's reuse after the work that last read it; while
    slab s crosses the bus the host fills the other buffer with slab s+1.
    The ledger counts one `db_staging` copy a slab and, as
    `overlapped_ms`, the host's milliseconds from the first copy's issue
    to the return, less the time it waited for a buffer. Returns without
    a sync: the caller's one final sync publishes the staging. On the CPU
    the same slabs are assembled with plain copies."""
    host = np.ascontiguousarray(host, dtype=np.uint32)
    num_records, width = host.shape
    if num_records % 32:
        raise ValueError(f"the host image has {num_records} rows, not a multiple of 32")
    spans = slab_spans(num_records, slabs)
    src = torch.from_numpy(host.view(np.int32))
    staged = torch.empty((32, spans[-1][1] // 32, width), dtype=torch.int32, device=device)

    def permute_into(rows: torch.Tensor, a: int, b: int) -> None:
        have = rows.shape[0]
        staged[:, a // 32:(a + have) // 32] = rows.view(-1, 32, width).permute(1, 0, 2)
        staged[:, (a + have) // 32:b // 32] = 0

    def filled(a: int, b: int) -> int:
        return max(0, min(b, num_records) - a)

    if device.type != "cuda":
        for a, b in spans:
            permute_into(src[a:a + filled(a, b)], a, b)
        return staged
    ledger = default_telemetry().transfers
    rows = max(b - a for a, b in spans)
    pinned = [torch.empty((rows, width), dtype=torch.int32, pin_memory=True)
              for _ in range(2)]
    landed = [torch.empty((rows, width), dtype=torch.int32, device=device)
              for _ in range(2)]
    compute = torch.cuda.current_stream(device)
    copier = torch.cuda.Stream(device)
    copier.wait_stream(compute)  # the buffers' memory may be a freed tensor's
    copied = [None, None]  # the copy out of pinned[i] into landed[i] is done
    permuted = [None, None]  # the permute out of landed[i] is done
    t_first, waited = None, 0.0
    for s, (a, b) in enumerate(spans):
        i, have = s % 2, filled(a, b)
        if copied[i] is not None:
            t0 = time.perf_counter()
            copied[i].synchronize()
            waited += time.perf_counter() - t0
        pinned[i][:have].copy_(src[a:a + have])
        with torch.cuda.stream(copier):
            if permuted[i] is not None:
                copier.wait_event(permuted[i])
            landed[i][:have].copy_(pinned[i][:have], non_blocking=True)
            copied[i] = torch.cuda.Event()
            copied[i].record(copier)
        ledger.record_h2d(have * width * 4, "db_staging")
        if t_first is None:
            t_first = time.perf_counter()
        compute.wait_event(copied[i])
        permute_into(landed[i][:have], a, b)
        permuted[i] = torch.cuda.Event()
        permuted[i].record(compute)
    ledger.record_overlap((time.perf_counter() - t_first - waited) * 1e3, "db_staging")
    return staged


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
            # index -> replacement, applied by build() / build_from()
            self._updates: dict = {}

        def insert(self, value: bytes) -> "DenseDpfPirDatabase.Builder":
            if isinstance(value, str):
                value = value.encode()
            self._records.append(bytes(value))
            return self

        def update(self, i: int, value: bytes) -> "DenseDpfPirDatabase.Builder":
            """Replace record `i`: of this builder's inserted records
            under `build()`, of `prev`'s under `build_from(prev)`."""
            if isinstance(value, str):
                value = value.encode()
            i = int(i)
            if i < 0:
                raise IndexError(f"update index {i} must be >= 0")
            self._updates[i] = bytes(value)
            return self

        def clone(self) -> "DenseDpfPirDatabase.Builder":
            b = DenseDpfPirDatabase.Builder()
            b._records = list(self._records)
            b._updates = dict(self._updates)
            return b

        def build(self, device=None, inner_product: str = "v2") -> "DenseDpfPirDatabase":
            records = list(self._records)
            for i, value in self._updates.items():
                if i >= len(records):
                    raise IndexError(
                        f"update index {i} out of bounds for "
                        f"{len(records)} inserted records"
                    )
                records[i] = value
            return DenseDpfPirDatabase(records, device=device,
                                       inner_product=inner_product)

        def build_from(self, prev: "DenseDpfPirDatabase") -> "DenseDpfPirDatabase":
            """Generation `prev.generation + 1`: `prev`'s records with the
            updates applied and the inserted records appended, on
            `prev`'s device with its inner product. When nothing is
            appended and every update fits `prev`'s record size, the
            result holds only the updated rows (a delta, staged on the
            device from `prev`'s staging); otherwise it is packed from
            `prev`'s rows and staged in full."""
            for i in self._updates:
                if i >= prev.size:
                    raise IndexError(
                        f"update index {i} out of bounds for previous "
                        f"generation of {prev.size} records"
                    )
            generation = prev.generation + 1
            if not self._records and all(
                len(v) <= prev.max_value_size for v in self._updates.values()
            ):
                return DenseDpfPirDatabase._from_delta(prev, self._updates, generation)
            records = [self._updates.get(i) for i in range(prev.size)] + self._records
            size = len(records)
            max_value_size = max([prev.max_value_size]
                                 + [len(r) for r in records if r is not None])
            width = max(4, ((max_value_size + 3) // 4) * 4) // 4
            words = np.zeros((padded_records(size), width), dtype=np.uint32)
            base = prev.host_rows()
            words[: base.shape[0], : base.shape[1]] = base
            new = [i for i, r in enumerate(records) if r is not None]
            rows = words.view(np.uint8).reshape(words.shape[0], 4 * width)
            rows[new] = records_to_rows([records[i] for i in new], len(new), 4 * width)
            return DenseDpfPirDatabase.from_words(
                words, size, max_value_size, device=prev.device,
                inner_product=prev._inner_product, generation=generation)

    def __init__(self, records: Sequence[bytes], device=None,
                 inner_product: str = "v2", generation: int = 0):
        records = [bytes(r) for r in records]
        max_value_size = max((len(r) for r in records), default=0)
        self._setup(len(records), max_value_size, device, inner_product, generation)
        self._host_words = _pack_records(
            records, self._num_padded, self._record_words * 4)

    @classmethod
    def from_words(cls, words: np.ndarray, size: int, max_value_size: int,
                   device=None, inner_product: str = "v2",
                   generation: int = 0) -> "DenseDpfPirDatabase":
        """A database over an image already packed on the host: `words`
        uint32[padded_records(size), W] with 4W >= max_value_size, record i
        in row i, zero rows past `size` (taken as is, not copied)."""
        db = cls.__new__(cls)
        db._setup(size, max_value_size, device, inner_product, generation)
        if (words.dtype != np.uint32 or words.ndim != 2
                or words.shape[0] != db._num_padded
                or 4 * words.shape[1] < max(4, max_value_size)):
            raise ValueError(
                f"words must be uint32[{db._num_padded}, W] with 4W >= "
                f"{max_value_size}, got {words.dtype}{list(words.shape)}")
        db._host_words = words
        db._record_words = words.shape[1]
        return db

    @classmethod
    def _from_delta(cls, prev: "DenseDpfPirDatabase", updates: dict,
                    generation: int) -> "DenseDpfPirDatabase":
        """Generation N+1 from N as its updated rows: the row indices,
        their packed words, and `prev` (see `_setup` for how long it is
        held). Every index is in range and every value fits `prev`'s
        record size (`build_from` checks)."""
        db = cls.__new__(cls)
        db._setup(prev.size, prev.max_value_size, prev.device,
                  prev._inner_product, generation)
        db._record_words = prev._record_words
        rows = np.array(sorted(updates), dtype=np.int64)
        values = [updates[i] for i in rows.tolist()]
        packed = records_to_rows(values, len(values), 4 * db._record_words)
        db._host_words = None
        db._delta_base = prev
        db._delta_rows = rows
        db._delta_words = packed.view("<u4").astype(np.uint32)
        return db

    def _setup(self, size: int, max_value_size: int, device, inner_product: str,
               generation: int):
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
        self._generation = int(generation)
        self._record_words = max(4, ((max_value_size + 3) // 4) * 4) // 4
        self._db_perm = None
        self._streaming = None  # (cut_levels, chunks)
        self._chunked = None  # (granule_blocks, staging)
        self._stage_lock = threading.Lock()
        # A delta build (`_from_delta`): the previous generation, held
        # until this one is staged and serving (`mark_serving`), the next
        # generation stages from this one, or this one stages without the
        # base's staging; and the updated rows.
        self._delta_base = None
        self._serving = False
        self._delta_rows = None
        self._delta_words = None
        # {mode, bytes_staged, bytes_full_image, bytes_saved, generation}
        # of the last prestage() that staged anything.
        self.last_prestage_stats = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def size(self) -> int:
        """Number of records."""
        return self._size

    @property
    def generation(self) -> int:
        """Snapshot generation (0: the initial build)."""
        return self._generation

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
            self._stage_locked()
        return self._db_perm

    def _stage_locked(self) -> int:
        """Build the staging (caller holds the lock): from the base
        generation's staging when this is a delta and the base's is
        resident, else from the host image. Returns the bytes moved to
        the device; publishes the staging once its stream is done. The
        device memory's `db_staging` watermark covers it."""
        with default_telemetry().hbm.phase("db_staging"):
            base = self._delta_base
            base_perm = None
            if base is not None:
                with base._stage_lock:
                    base_perm = base._db_perm
            if base_perm is not None:
                staged = base_perm
                moved = 0
                if len(self._delta_rows):
                    rows = torch.from_numpy(self._delta_rows).to(self._device)
                    values = to_tensor(self._delta_words, self._device)
                    moved = self._delta_rows.nbytes + self._delta_words.nbytes
                    staged = base_perm.clone()
                    staged[rows % 32, rows // 32] = values
                if self._device.type == "cuda":
                    default_telemetry().transfers.record_h2d(moved, "db_staging")
                # Until it serves, this generation keeps its base, so that a
                # staging released before then (an aborted candidate, staged
                # again for a fleet's laggard) stages again from the base's.
                # The base, resident, lets go of its own, so the chain stays
                # one long.
                with base._stage_lock:
                    base._delta_base = None
                if self._serving:
                    self._delta_base = None
            else:
                host = self.host_rows()
                moved = host.nbytes
                staged = stage_bitmajor(host, self._device)
                self._delta_base = None
            self._db_perm = self._publish(staged)
        self._host_words = None
        return moved

    def mark_serving(self) -> None:
        """This generation serves from now on (`swap_database`): its
        staging is released only when it retires, so it lets go of its
        base generation once staged."""
        with self._stage_lock:
            self._serving = True
            if self._db_perm is not None:
                self._delta_base = None

    def host_rows(self) -> np.ndarray:
        """uint32[num_records_padded, W] host image of the rows: the host
        image while there is one, else read back from the staging (one
        device-to-host copy), else the base generation's rows with this
        delta's rows in place."""
        if self._host_words is not None:
            return self._host_words
        if self._db_perm is not None:
            rows = rows_from_bitmajor(self._db_perm)[: self._num_padded]
            if self._device.type == "cuda":
                default_telemetry().transfers.record_d2h(rows.numel() * 4, "db_readback")
            return to_numpy(rows)
        if self._delta_base is not None:
            rows = self._delta_base.host_rows().copy()
            rows[self._delta_rows] = self._delta_words
            return rows
        raise RuntimeError(
            f"generation {self._generation}'s stagings were released and "
            "it keeps no host image: build the next generation from a "
            "database that is still staged"
        )

    def rows_at(self, rows) -> np.ndarray:
        """uint32[len(rows), W]: the given rows of the image without a full
        read-back: from the host image while there is one, else gathered
        from the staging (one small device-to-host copy), else the base
        generation's rows with this delta's in place."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if self._host_words is not None:
            return self._host_words[rows]
        with self._stage_lock:
            perm = self._db_perm
        if perm is not None:
            index = torch.from_numpy(rows).to(self._device)
            return to_numpy(perm[index % 32, index // 32])
        if self._delta_base is not None:
            out = self._delta_base.rows_at(rows).copy()
            if len(self._delta_rows):
                pos = np.minimum(np.searchsorted(self._delta_rows, rows),
                                 len(self._delta_rows) - 1)
                hit = self._delta_rows[pos] == rows
                out[hit] = self._delta_words[pos[hit]]
            return out
        return self.host_rows()[rows]

    def prestage(self) -> int:
        """Stage now what serving would stage at its first batch: the
        staging, and the streaming and chunked stagings at the base
        generation's splits for a delta build. The double-buffer half of
        a rotation: generation N+1 moves to the card while N serves.
        Returns the bytes moved to the device (0 when already staged);
        `last_prestage_stats` gives {mode, bytes_staged,
        bytes_full_image, bytes_saved, generation}."""
        with self._stage_lock:
            if self._db_perm is not None:
                return 0
            base = self._delta_base
            moved = self._stage_locked()
            if base is not None:
                if base._streaming is not None:
                    self._streaming_locked(base._streaming[0])
                if base._chunked is not None:
                    self._chunked_locked(base._chunked[0])
            full = self._num_padded * self._record_words * 4
            saved = max(0, full - moved)
            self.last_prestage_stats = {
                "mode": "delta" if self._delta_rows is not None and saved > 0
                else "full",
                "bytes_staged": int(moved),
                "bytes_full_image": int(full),
                "bytes_saved": int(saved),
                "generation": self._generation,
            }
            return int(moved)

    def release_stagings(self) -> int:
        """Drop every device staging (the staging, the streaming and the
        chunked ones) of a retired generation; returns how many were
        dropped. The database cannot serve again after this unless it
        still has its host image."""
        with self._stage_lock:
            dropped = 0
            for attr in ("_db_perm", "_streaming", "_chunked"):
                if getattr(self, attr) is not None:
                    setattr(self, attr, None)
                    dropped += 1
        default_telemetry().hbm.sample()
        return dropped

    def staged_bytes(self) -> int:
        """Device bytes of the stagings this database holds (a chunked
        staging that is the staging itself counts once)."""
        with self._stage_lock:
            tensors = [t for t in (
                self._db_perm,
                self._streaming[1] if self._streaming is not None else None,
                self._chunked[1] if self._chunked is not None else None,
            ) if t is not None]
        seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
        return sum(seen.values())

    def _publish(self, tensor: torch.Tensor) -> torch.Tensor:
        """`tensor` once the stream that built it has finished it, so that
        a batch worker on another stream never reads it half-built (the
        wait counted as a `db_staging` sync)."""
        default_telemetry().transfers.synchronize(self._device, phase="db_staging")
        return tensor

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
            return self._streaming_locked(cut_levels)

    def _streaming_locked(self, cut_levels: int) -> torch.Tensor:
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
        self._streaming = (cut_levels, self._publish(chunks))
        return chunks

    def chunked_staging(self, granule_blocks: int) -> torch.Tensor:
        """The chunked tier's staging: the bit-major staging with at least
        ceil(num_selection_blocks / granule_blocks) * granule_blocks * 4
        groups, so that every chunk is a whole group span. It is the
        staging itself when that reaches far enough (no extra bytes), else
        a zero-padded copy, built once under the staging lock."""
        with self._stage_lock:
            return self._chunked_locked(granule_blocks)

    def _chunked_locked(self, granule_blocks: int) -> torch.Tensor:
        blocks = -(-self.num_selection_blocks // granule_blocks) * granule_blocks
        staged = self._staged_locked()
        extra = 4 * blocks - staged.shape[1]
        if extra <= 0:
            return staged
        if self._chunked is None or self._chunked[0] != granule_blocks:
            self._chunked = (granule_blocks,
                             self._publish(F.pad(staged, (0, 0, 0, extra))))
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
        out = inner_product(self.staged(), selections)
        return words_to_record_bytes(
            read_back(out), out.shape[0], self._max_value_size)
