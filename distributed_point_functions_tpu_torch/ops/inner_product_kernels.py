"""Kernel K1, the XOR inner product, on a bit-major database staging.

The counterpart of the JAX package's `ops/inner_product_pallas.py`
(serving entry `xor_inner_product_pallas2_staged`, TPU kernel
`_ip_kernel_v2` at `:285`). The database is staged once into bit-major
order, `db_perm[b, g, w] = db_words[32g + b, w]` (`permute_db_bitmajor`),
so the records that bit b of a packed selection word selects are
contiguous; selections arrive packed, one word per 32 records.

`xor_inner_product_packed` is the kernel's wrapper: for a CPU tensor it
runs the plain version (`ops/inner_product.py:xor_inner_product` on the
row-major view), for a CUDA tensor it launches the hand-written kernel
(`csrc/inner_product.cu`) or raises. `xor_inner_product_staged` adds the
selection staging of the serving path, and `xor_inner_product_accumulate`
(the JAX package's `xor_inner_product_pallas2_accumulate`, `:502`) XORs
one record span's product into a running result with the same kernel,
for the streaming and chunked tiers; `stage_db_chunks_bitmajor` stages
a database in such spans.

The module also holds the two other TPU kernels of the JAX package's
`ops/inner_product_pallas.py`:

* K7 `xor_counts` (`_ip_kernel`, `:130`; CUDA in `csrc/inner_product.cu`,
  K1's kernel body with a count epilogue): the v1 inner product's
  per-value-bit selection counts, int32[nq, 32, W];
  `xor_inner_product_staged_v1` (the
  counterpart of `xor_inner_product_pallas_staged`, `:258`, and of
  `xor_inner_product_pallas`, `:543`) takes their parity, as the JAX
  package does outside its kernel, and keeps its cap of
  `MAX_RECORDS_EXACT` records.
* K9 `repeat_tiles` (the probe `_interpret_repeat_tiles`, `:65`; CUDA in
  `csrc/repeat_tiles.cu`): Mosaic's tiling repeat, `[a b] -> [a b a b]`,
  and `interpret_repeat_tiles`, the probe's counterpart.

K1 and K7 are one count product of 0/1 matrices, selections [nq, R] by
database bits [R, 32W], with two epilogues: K7 adds the int32 counts,
K1 XORs their parity packed 32 value bits to a word. The kernel runs it
on the tensor cores' single-bit path (`mma.sync` b1, an AND and a count
per bit pair) on the packed words: the selection words are its A
fragments as they are, and each block transposes the database words 32
x 32 in registers into shared memory once. Bound on the H100: the packed
bytes or the single-bit products, whichever is more. Blocks over record
spans combine with `atomicAdd` or `atomicXor`, exact in any order (K1
keeps only parities, so it needs no count bound).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import cuda_lib
from .inner_product import parity_pack, xor_counts_plain, xor_inner_product

# Records are padded to a multiple of 32 * _TILE_GROUPS (= 4096), as in
# the JAX package, so both packages stage the same bit-major shape.
_TILE_GROUPS = 128
# The v1 inner product's record cap: the TPU kernel's f32 counts are exact
# to 2^24. The port's counts are exact int32, but the v1 entry keeps the
# JAX package's contract.
MAX_RECORDS_EXACT = 1 << 24


def permute_db_bitmajor(db_words: torch.Tensor) -> torch.Tensor:
    """int32[R, W] row-major -> int32[32, G, W] bit-major: row 32g+b lands
    at [b, g, :]. The record count is zero-padded to a multiple of 4096
    (zero rows never contribute to a XOR)."""
    num_records, num_words = db_words.shape
    chunk = 32 * _TILE_GROUPS
    padded = ((num_records + chunk - 1) // chunk) * chunk
    if padded != num_records:
        db_words = F.pad(db_words, (0, 0, 0, padded - num_records))
    return (
        db_words.reshape(padded // 32, 32, num_words)
        .permute(1, 0, 2)
        .contiguous()
    )


def stage_db_chunks_bitmajor(db_words: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """Split a row-major database into `num_chunks` equal record spans and
    stage each bit-major: int32[R, W] -> int32[num_chunks, 32, Gc, W], each
    span zero-padded to a multiple of 4096 records (the JAX package's
    `stage_db_chunks_bitmajor`)."""
    num_records, num_words = db_words.shape
    if num_chunks <= 0 or num_records % num_chunks:
        raise ValueError(
            f"record count {num_records} is not divisible into "
            f"{num_chunks} chunks"
        )
    spans = db_words.reshape(num_chunks, num_records // num_chunks, num_words)
    chunks = None
    for c, span in enumerate(spans):  # one span's temporary at a time
        staged = permute_db_bitmajor(span)
        if chunks is None:
            chunks = staged.new_empty((num_chunks,) + tuple(staged.shape))
        chunks[c] = staged
    return chunks


def rows_from_bitmajor(db_perm: torch.Tensor) -> torch.Tensor:
    """Inverse of `permute_db_bitmajor` (without the padding cut):
    int32[32, G, W] -> int32[32G, W] row-major."""
    _, num_groups, num_words = db_perm.shape
    return db_perm.permute(1, 0, 2).reshape(32 * num_groups, num_words)


def _stage_selections(selections: torch.Tensor, num_groups: int):
    """Flatten packed selection blocks to [nq_pad, num_groups] words.

    Extra words beyond the staged layout's (zero-padded) groups are
    dropped; missing words and the query count's non-multiple-of-8 tail
    are zero-padded (zero selection bits never contribute to a XOR).
    Returns (packed, nq) with nq the caller's true query count.
    """
    nq = selections.shape[0]
    packed = selections.reshape(nq, -1)
    if packed.shape[1] > num_groups:
        packed = packed[:, :num_groups]
    elif packed.shape[1] < num_groups:
        packed = F.pad(packed, (0, num_groups - packed.shape[1]))
    nq_pad = ((nq + 7) // 8) * 8
    if nq_pad != nq:
        packed = F.pad(packed, (0, 0, 0, nq_pad - nq))
    return packed.contiguous(), nq


def xor_inner_product_packed_plain(
    db_perm: torch.Tensor, packed: torch.Tensor
) -> torch.Tensor:
    """Plain version of K1: the row-major mask-and-XOR on the same
    inputs. db_perm: int32[32, G, W]; packed: int32[nq, G]."""
    _, num_groups, _ = db_perm.shape
    rows = rows_from_bitmajor(db_perm)
    pad_groups = (-num_groups) % 4  # whole 128-record selection blocks
    if pad_groups:
        rows = F.pad(rows, (0, 0, 0, 32 * pad_groups))
        packed = F.pad(packed, (0, pad_groups))
    nq = packed.shape[0]
    return xor_inner_product(rows, packed.reshape(nq, -1, 4))


def _check_k1_args(db_perm: torch.Tensor, packed: torch.Tensor):
    """Shapes, types and devices of K1's and K7's operands; returns
    (num_groups, num_words). db_perm's rows (its last two axes) must be
    contiguous; its bit rows may lie apart (a group span of a larger
    staging)."""
    if db_perm.ndim != 3 or db_perm.shape[0] != 32:
        raise ValueError(f"db_perm must be [32, G, W], got {tuple(db_perm.shape)}")
    _, num_groups, num_words = db_perm.shape
    if packed.ndim != 2 or packed.shape[1] != num_groups:
        raise ValueError(
            f"packed selections must be [nq, {num_groups}], got "
            f"{tuple(packed.shape)}"
        )
    for name, t in (("db_perm", db_perm), ("packed", packed)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if not packed.is_contiguous() or db_perm.stride()[1:] != (num_words, 1):
        raise ValueError("packed and the rows of db_perm must be contiguous")
    if packed.device != db_perm.device:
        raise ValueError(
            f"selections on {packed.device}, database on {db_perm.device}"
        )
    if db_perm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {db_perm.device}")
    return num_groups, num_words


def _launch_k1(db_perm, packed, out, nq: int, accumulate: bool) -> None:
    """K1 into out[:nq] (int32[>= nq, W], contiguous), XORed into it when
    `accumulate`, else written."""
    dev = db_perm.device
    _, num_groups, num_words = db_perm.shape
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dpf_xor_inner_product(
            packed.data_ptr(), db_perm.data_ptr(), out.data_ptr(),
            nq, num_groups, num_words, db_perm.stride(0), int(accumulate),
            sms, stream,
        )
    cuda_lib.count("xor_inner_product")
    cuda_lib.check(err, "xor_inner_product")


def xor_inner_product_packed(
    db_perm: torch.Tensor, packed: torch.Tensor
) -> torch.Tensor:
    """K1: out[q, w] = XOR over g, b of (bit b of packed[q, g]) ?
    db_perm[b, g, w] : 0.

    db_perm: int32[32, G, W] bit-major staging; packed: int32[nq, G].
    Returns int32[nq, W]."""
    _, num_words = _check_k1_args(db_perm, packed)
    if db_perm.device.type == "cpu":
        return xor_inner_product_packed_plain(db_perm, packed)
    nq = packed.shape[0]
    out = torch.empty((nq, num_words), dtype=torch.int32, device=db_perm.device)
    _launch_k1(db_perm, packed, out, nq, accumulate=False)
    return out


def xor_inner_product_staged(
    db_perm: torch.Tensor, selections: torch.Tensor
) -> torch.Tensor:
    """Serving entry: bit-major staged database, packed selection blocks.

    db_perm: int32[32, G, W] from `permute_db_bitmajor`; selections:
    int32[nq, B, 4] packed blocks. Returns int32[nq, W]."""
    _, num_groups, _ = db_perm.shape
    packed, nq = _stage_selections(selections, num_groups)
    out = xor_inner_product_packed(db_perm, packed)
    return out[:nq]


def xor_inner_product_accumulate(
    acc: torch.Tensor, db_perm_span: torch.Tensor, selections: torch.Tensor
) -> torch.Tensor:
    """K1's accumulate entry: acc ^= the XOR inner product of one record
    span, in place on acc's device (the JAX package's
    `xor_inner_product_pallas2_accumulate`, which returns a new array).

    acc: int32[nq, W] contiguous running results; db_perm_span:
    int32[32, Gc, W] one bit-major span (a chunk of
    `stage_db_chunks_bitmajor`, or a group range of a larger staging);
    selections: int32[nq, B, 4] covering exactly that span. On the card
    the kernel XORs into acc without zeroing it. Returns acc."""
    _, num_groups, num_words = db_perm_span.shape
    packed, nq = _stage_selections(selections, num_groups)
    _check_k1_args(db_perm_span, packed)
    if acc.shape != (nq, num_words) or acc.dtype != torch.int32:
        raise ValueError(
            f"acc must be int32[{nq}, {num_words}], got {acc.dtype}"
            f"{list(acc.shape)}"
        )
    if not acc.is_contiguous() or acc.device != db_perm_span.device:
        raise ValueError("acc must be contiguous, on the database's device")
    if acc.device.type == "cpu":
        acc ^= xor_inner_product_packed_plain(db_perm_span, packed)[:nq]
        return acc
    _launch_k1(db_perm_span, packed, acc, nq, accumulate=True)
    return acc


def xor_counts(db_perm: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K7: counts[q, j, w] = the number of records 32g + b selected by bit
    b of packed[q, g] whose word w has bit j set.

    db_perm: int32[32, G, W] bit-major staging; packed: int32[nq, G].
    Returns int32[nq, 32, W]."""
    num_groups, num_words = _check_k1_args(db_perm, packed)
    if db_perm.device.type == "cpu":
        return xor_counts_plain(db_perm, packed)
    if not db_perm.is_contiguous():
        raise ValueError("db_perm must be contiguous")
    dev = db_perm.device
    nq = packed.shape[0]
    counts = torch.empty((nq, 32, num_words), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dpf_xor_counts(
            packed.data_ptr(), db_perm.data_ptr(), counts.data_ptr(),
            nq, num_groups, num_words, sms, stream,
        )
    cuda_lib.count("xor_counts")
    cuda_lib.check(err, "xor_counts")
    return counts


def xor_inner_product_staged_v1(
    db_perm: torch.Tensor, selections: torch.Tensor
) -> torch.Tensor:
    """The v1 serving entry: K7's counts, their parity packed into words.

    db_perm: int32[32, G, W] from `permute_db_bitmajor`, at most
    `MAX_RECORDS_EXACT` records (32G); selections: int32[nq, B, 4] packed
    blocks. Returns int32[nq, W], equal to `xor_inner_product_staged`."""
    _, num_groups, _ = db_perm.shape
    if 32 * num_groups > MAX_RECORDS_EXACT:
        raise ValueError(
            f"the v1 inner product supports at most {MAX_RECORDS_EXACT} "
            f"records (the TPU kernel's f32-exact counts); got "
            f"{32 * num_groups}"
        )
    packed, nq = _stage_selections(selections, num_groups)
    return parity_pack(xor_counts(db_perm, packed))[:nq]


def repeat_tiles_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain version of K9: the whole source tiled `factor` times along
    its last axis."""
    return x.repeat(1, factor)


def repeat_tiles(x: torch.Tensor, factor: int) -> torch.Tensor:
    """K9: out[r, k] = x[r, k mod n] for x int32[rows, n], out
    int32[rows, n * factor] (Mosaic's `pltpu.repeat` along axis 1)."""
    if x.ndim != 2 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32[rows, n]")
    if factor < 1:
        raise ValueError(f"factor must be positive, got {factor}")
    dev = x.device
    if dev.type == "cpu":
        return repeat_tiles_plain(x, factor)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, n = x.shape
    out = torch.empty((rows, n * factor), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dpf_repeat_tiles(x.data_ptr(), out.data_ptr(), rows, n, factor,
                                   stream)
    cuda_lib.count("repeat_tiles")
    cuda_lib.check(err, "repeat_tiles")
    return out


def interpret_repeat_tiles(device=None) -> bool:
    """The port's counterpart of the JAX package's probe
    `_interpret_repeat_tiles`: whether K9 tiles `[[0, 1]]` to
    `[[0, 1, 0, 1]]` (Mosaic's semantics) on `device` (default: the CUDA
    card; "cpu" asks the plain version)."""
    dev = resolve_device(device)
    got = repeat_tiles(torch.tensor([[0, 1]], dtype=torch.int32, device=dev), 2)
    return got.cpu().tolist() == [[0, 1, 0, 1]]
