"""Selection-bit packing helpers + scalar reference inner product.

Mirrors the reference's `pir/testing/pir_selection_bits.h:35-80`:
`PackSelectionBits` (bool vector -> packed 128-bit blocks),
`GenerateRandomPackedSelectionBits`, and the unpacked scalar oracle
`InnerProductWithUnpacked` used to differential-test the packed kernel.

The port's copy of the JAX package's `testing/pir_selection_bits.py`; the
packing is the port's own (`ops/inner_product.py`). Packed layout:
`uint32[num_blocks, 4]`, the bit for record `r` is bit `r % 32` of limb
`(r % 128) // 32` of block `r // 128` (the `XorWrapper<uint128>`
little-endian bit order).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.inner_product import pack_selection_bits_np


def pack_selection_bits(selections: Sequence[bool]) -> np.ndarray:
    """bools[n] -> packed uint32[ceil(n/128), 4] selection blocks."""
    return pack_selection_bits_np(np.asarray(selections, dtype=np.uint32))


def generate_random_packed_selection_bits(
    num_bits: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Random packed selection vector covering `num_bits` records."""
    if rng is None:
        rng = np.random.default_rng()
    bits = rng.integers(0, 2, num_bits, dtype=np.uint32)
    return pack_selection_bits_np(bits)


def unpack_selection_bits_np(packed: np.ndarray, num_bits: int) -> np.ndarray:
    """Packed uint32[..., B, 4] blocks -> uint8[..., num_bits] bits."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed[..., None] >> shifts) & 1  # [..., B, 4, 32]
    flat = bits.reshape(packed.shape[:-2] + (packed.shape[-2] * 128,))
    return flat[..., :num_bits].astype(np.uint8)


def inner_product_with_unpacked(
    selections: Sequence[bool], records: Sequence[bytes]
) -> bytes:
    """Scalar oracle: XOR of all records whose selection bit is 1, each
    zero-padded to the longest record (`pir_selection_bits.h:74-80`)."""
    if len(selections) != len(records):
        raise ValueError(
            f"got {len(selections)} selection bits for {len(records)} records"
        )
    max_len = max((len(r) for r in records), default=0)
    acc = bytearray(max_len)
    for bit, record in zip(selections, records):
        if bit:
            for i, b in enumerate(record):
                acc[i] ^= b
    return bytes(acc)
