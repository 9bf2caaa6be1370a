"""Packed-XOR inner product between a dense database and selection bits.

The port of the JAX package's `ops/inner_product.py`. `xor_inner_product`
is the **plain version** of kernel K1 (`ops/inner_product_kernels.py`):
for each query's packed selection bits, XOR together every database
record whose bit is 1, as a mask-and-XOR over record chunks.
`xor_inner_product_accumulate` XORs one record span's product into a
running result (the streaming and chunked tiers). `xor_counts_plain` is
the plain version of kernel K7, the v1 inner product's per-value-bit
selection counts, and `parity_pack` the recombination that turns those
counts into the XOR product. `pack_selection_bits_np` packs bits into
selection blocks on the host (test data).

Layout (all little-endian, words as int32):

* database: `int32[num_records_padded, record_words]`, the record count
  padded to a multiple of 128 (one 128-bit selection block per 128
  records);
* selections: `int32[num_queries, num_blocks, 4]` -- the bit for record
  `r` is bit `r % 32` of limb `(r % 128) // 32` of block `r // 128`,
  i.e. bit `r % 32` of flat word `r // 32`.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_selection_bits_np(bits: np.ndarray) -> np.ndarray:
    """bool/uint [..., n] -> uint32[..., ceil(n/128), 4] packed blocks in
    the layout above."""
    n = bits.shape[-1]
    nb = (n + 127) // 128
    padded = np.zeros(bits.shape[:-1] + (nb * 128,), dtype=np.uint32)
    padded[..., :n] = bits.astype(np.uint32) & 1
    lanes = padded.reshape(bits.shape[:-1] + (nb, 4, 32))
    return (lanes << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce `x` over `dim` by pairwise halving."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        y = x.narrow(dim, 0, h) ^ x.narrow(dim, h, h)
        if n % 2:
            y = torch.cat([y, x.narrow(dim, 2 * h, 1)], dim=dim)
        x = y
    return x.squeeze(dim)


def xor_inner_product(
    db_words: torch.Tensor, selections: torch.Tensor, chunk: int = 256
) -> torch.Tensor:
    """XOR inner product.

    db_words: int32[R, W] with R a multiple of 128 (zero rows beyond the
    real record count); selections: int32[nq, B, 4] with B*128 >= R
    (selection bits beyond R are ignored). Returns int32[nq, W]. The
    masked intermediate is bounded at `[nq, chunk, W]`.
    """
    num_records, num_words = db_words.shape
    if num_records % 128 != 0:
        raise ValueError("record count must be padded to a multiple of 128")
    if chunk <= 0 or chunk % 32:
        raise ValueError("chunk must be a positive multiple of 32")
    nq = selections.shape[0]
    packed = selections.reshape(nq, -1)  # word r // 32, bit r % 32
    if packed.shape[1] * 32 < num_records:
        raise ValueError("selections cover fewer bits than the records")
    shifts = torch.arange(32, dtype=torch.int32, device=db_words.device)
    acc = torch.zeros((nq, num_words), dtype=torch.int32, device=db_words.device)
    for r0 in range(0, num_records, chunk):
        r1 = min(r0 + chunk, num_records)
        words = packed[:, r0 // 32 : r1 // 32]
        bits = ((words[:, :, None] >> shifts) & 1).reshape(nq, r1 - r0)
        masked = (-bits)[:, :, None] & db_words[None, r0:r1, :]
        acc ^= _xor_reduce(masked, dim=1)
    return acc


def xor_inner_product_accumulate(
    acc: torch.Tensor, db_span: torch.Tensor, selections: torch.Tensor,
    chunk: int = 256,
) -> torch.Tensor:
    """The inner product of one record span XORed into running results
    (the JAX package's `xor_inner_product_accumulate`): acc int32[nq, W];
    db_span int32[R, W], R a multiple of 128; selections int32[nq, B, 4]
    covering exactly that span. Returns the new accumulators; XORing in
    every span of a partition of the database equals one whole
    `xor_inner_product`."""
    return acc ^ xor_inner_product(db_span, selections, chunk=chunk)


def xor_counts_plain(
    db_perm: torch.Tensor, packed: torch.Tensor, chunk_groups: int = 2048
) -> torch.Tensor:
    """Plain version of K7: per-value-bit selection counts.

    counts[q, j, w] = the number of records r = 32g + b whose selection
    bit (bit b of packed[q, g]) is 1 and whose word w has bit j set.
    db_perm: int32[32, G, W] bit-major staging (db_perm[b, g] = record
    32g + b); packed: int32[nq, G]. Returns int32[nq, 32, W], exact.

    A float32 product of the unpacked 0/1 operands per span of
    `chunk_groups` groups (at most 2^16 records, so every partial sum is
    an integer below 2^24 and exact in float32), summed in int32."""
    _, num_groups, num_words = db_perm.shape
    nq = packed.shape[0]
    dev = db_perm.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    counts = torch.zeros((nq, 32 * num_words), dtype=torch.int32, device=dev)
    for g0 in range(0, num_groups, chunk_groups):
        g1 = min(g0 + chunk_groups, num_groups)
        # Records in (b, g) order on both sides: [nq, 32(b), Gc] and
        # [32(b), Gc, W] -> [32 * Gc, 32(j) * W].
        sel = ((packed[:, None, g0:g1] >> shifts[None, :, None]) & 1)
        db = db_perm[:, g0:g1, :].reshape(-1, num_words)
        bits = (db[:, None, :] >> shifts[None, :, None]) & 1
        counts += torch.matmul(
            sel.reshape(nq, -1).to(torch.float32),
            bits.reshape(db.shape[0], -1).to(torch.float32),
        ).to(torch.int32)
    return counts.reshape(nq, 32, num_words)


def parity_pack(counts: torch.Tensor) -> torch.Tensor:
    """int32[nq, 32, W] per-value-bit counts -> int32[nq, W] words whose
    bit j is the parity of counts[:, j] (the JAX package's recombination
    after `_ip_kernel`)."""
    out = torch.zeros_like(counts[:, 0])
    for j in range(32):
        out |= (counts[:, j] & 1) << j
    return out


def xor_inner_product_np(
    db_words: np.ndarray, selections: np.ndarray
) -> np.ndarray:
    """Numpy oracle with the scalar reference semantics."""
    num_records, num_words = db_words.shape
    nq = selections.shape[0]
    out = np.zeros((nq, num_words), dtype=np.uint32)
    for q in range(nq):
        for r in range(num_records):
            block = r // 128
            limb_idx = (r % 128) // 32
            bit = (selections[q, block, limb_idx] >> (r % 32)) & 1
            if bit:
                out[q] ^= db_words[r]
    return out
