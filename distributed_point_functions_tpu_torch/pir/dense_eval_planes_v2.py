"""The streaming tier of dense PIR: expansion fused with the inner product,
chunk by chunk.

The port of the streaming half of the JAX package's
`pir/dense_eval_planes_v2.py` (`:221-447`). The covering subtree is
expanded down to `cut_levels` once (K2 per level, no value hash); then each
of the `2**cut_levels` tail subtrees is expanded the last `chunk_levels`
levels in the server's expansion mode (`dense_eval_planes.expand_planned`:
walk, tail or level) and its selection blocks are XORed at once into the
running result against the matching database span through K1's
accumulate entry. The whole selection matrix int32[num_keys, num_blocks,
4] never exists; one chunk's does.

Block order. After `cut` doubling levels the cut state's node position c
holds natural prefix bitrev_cut(c) (the JAX package's order: K2 appends
[all-left; all-right] per level). In the port's node-major layout that
node is the contiguous word columns [c * KG, (c + 1) * KG), so a chunk is a
slice of the cut state. Its expansion leaves its leaves in the plan's
composed order; `leaf_blocks` (one launch per chunk, its node order fixed
per shape by `chunk_block_nodes`) writes them out as selection blocks in
single-subtree doubling order, so that scan step c covers
natural blocks (bitrev_cut(c) << r) | bitrev_r(q), q = 0 .. 2^r - 1, as
in the JAX package. The database is staged once in that blocked
bit-reversed order (`streaming_block_order`, the JAX package's, an
involution), so every step reads one contiguous chunk
(`database.DenseDpfPirDatabase.streaming_chunks`).

The JAX module's key-major XLA expansion (`expand_level_planes_v2`) has no
TPU kernel and is not carried.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.expand_planes import expand_level, leaf_blocks
from ..ops.inner_product_kernels import xor_inner_product_accumulate
from .dense_eval_planes import (
    DEFAULT_EXPANSION,
    exit_permutation,
    expand_planned,
    expansion_plan,
    pack_key_batch,
)


def bitrev_permutation(levels: int) -> np.ndarray:
    """perm[g] = the bit reversal of g over `levels` bits (an involution)."""
    g = np.arange(1 << levels, dtype=np.int64)
    out = np.zeros_like(g)
    for b in range(levels):
        out |= ((g >> b) & 1) << (levels - 1 - b)
    return out


def streaming_block_order(expand_levels: int, cut_levels: int) -> np.ndarray:
    """The natural block held at each staged position of the streaming
    layout: position c * 2^r + q (scan step c, row block q) holds natural
    block (bitrev_cut(c) << r) | bitrev_r(q), r = expand_levels -
    cut_levels."""
    if not 0 <= cut_levels <= expand_levels:
        raise ValueError("cut_levels must be in [0, expand_levels]")
    r = expand_levels - cut_levels
    pre = bitrev_permutation(cut_levels)
    sub = bitrev_permutation(r)
    return ((pre[:, None] << r) | sub[None, :]).reshape(-1)


def streaming_block_permute_records(
    db_words: torch.Tensor, cut_levels: int
) -> torch.Tensor:
    """A row-major database's 128-record blocks in streaming block order
    (a gather on the database's device). The row count must be a
    power-of-two number of blocks covering the tree."""
    num_records, num_words = db_words.shape
    if num_records % 128:
        raise ValueError("record count must be padded to a multiple of 128")
    num_blocks = num_records // 128
    levels = max(0, (num_blocks - 1).bit_length())
    if num_blocks != 1 << levels:
        raise ValueError("block count must be a power of two")
    order = torch.from_numpy(streaming_block_order(levels, cut_levels))
    blocks = db_words.reshape(num_blocks, 128, num_words)
    return blocks[order.to(db_words.device)].reshape(num_records, num_words)


def streaming_cut_state(state, ctrl, cwp, cwl, cwr, *, cut_levels: int):
    """Expand the packed key batch (`dense_eval_planes.pack_key_batch`) the
    first `cut_levels` levels through K2: the state the scan slices, one
    chunk per node. Returns (state int32[16, 8, KG << cut], ctrl
    int32[KG << cut]); node position c holds natural prefix bitrev_cut(c)."""
    for lvl in range(cut_levels):
        state, ctrl = expand_level(state, ctrl, cwp[lvl], cwl[lvl], cwr[lvl])
    return state, ctrl


@functools.lru_cache(maxsize=64)
def chunk_block_nodes(chunk_levels: int, plan: tuple, walk: bool) -> np.ndarray:
    """For each row block q of a streaming chunk, the leaf of the chunk's
    expansion (in `plan`'s order) that holds it, natural sub-leaf
    bitrev_r(q) (`leaf_blocks`' block_node)."""
    perm = exit_permutation(chunk_levels, *plan, walk, 1 << chunk_levels)
    return perm[bitrev_permutation(chunk_levels)].astype(np.int32)


def streaming_tail_selections(state, ctrl, tail_cwp, tail_cwl, tail_cwr, vc,
                              *, mode: str, plan: tuple, block_node: torch.Tensor):
    """Finish one tail subtree from its slice of the cut state and return
    its selection blocks. state int32[16, 8, KG], ctrl int32[KG]; tail_*
    the last r levels' packed corrections; `plan` = expansion_plan(mode, KG,
    r) and `block_node` its `chunk_block_nodes`. Returns int32[32 KG, 2^r,
    4] in single-subtree doubling (bit-reversed) leaf order."""
    kg = ctrl.shape[0]
    values = expand_planned(state, ctrl, tail_cwp, tail_cwl, tail_cwr, vc,
                            mode=mode, plan=plan, node_lanes=kg)[0]
    return leaf_blocks(values, block_node, kg)


def streaming_scan_accumulate(state, ctrl, db_chunks, tail_cwp, tail_cwl,
                              tail_cwr, vc, *, mode: str = DEFAULT_EXPANSION):
    """Scan the cut state's nodes against the streaming-staged database
    chunks, each tail expansion XORed at once into the result (K1's
    accumulate entry). db_chunks: int32[n, 32, Gc, W] bit-major per chunk,
    n the cut state's node count. Returns int32[32 KG, W]."""
    kg = vc.shape[-1]
    num_chunks = db_chunks.shape[0]
    if state.shape[-1] != num_chunks * kg:
        raise ValueError(
            f"db_chunks holds {num_chunks} chunks, the cut state "
            f"{state.shape[-1] // kg} nodes"
        )
    r = tail_cwp.shape[0]
    plan = expansion_plan(mode, kg, r)
    block_node = torch.from_numpy(chunk_block_nodes(r, plan, mode == "walk")).to(state.device)
    acc = torch.zeros((32 * kg, db_chunks.shape[-1]), dtype=torch.int32,
                      device=state.device)
    for c in range(num_chunks):
        cols = slice(c * kg, (c + 1) * kg)
        sel = streaming_tail_selections(
            state[..., cols].contiguous(), ctrl[cols].contiguous(), tail_cwp,
            tail_cwl, tail_cwr, vc, mode=mode, plan=plan, block_node=block_node)
        xor_inner_product_accumulate(acc, db_chunks[c], sel)
        del sel  # the next chunk's leaf values take its place
    return acc


def streaming_pir_inner_products(
    seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, db_chunks, *,
    cut_levels: int, chunk_levels: int, mode: str = DEFAULT_EXPANSION,
) -> torch.Tensor:
    """One streaming batch: the expansion fused with the XOR inner
    product, never materializing the selection matrix (the JAX package's
    `streaming_pir_inner_products_v2`).

    The staged keys (`dense_eval.stage_keys`, the shared prefix walked on
    the host) sit at the root of the covering subtree, with cut_levels +
    chunk_levels correction levels. db_chunks: the database in streaming
    block order for the same `cut_levels`, `2**cut_levels` bit-major chunks
    (`DenseDpfPirDatabase.streaming_chunks`). Returns int32[num_keys, W]
    XOR shares, equal to the materialized tier's."""
    levels = cut_levels + chunk_levels
    if cw_seeds.shape[0] != levels:
        raise ValueError(
            f"keys have {cw_seeds.shape[0]} correction levels; the plan "
            f"needs cut {cut_levels} + chunk {chunk_levels}"
        )
    if db_chunks.shape[0] != 1 << cut_levels:
        raise ValueError(
            f"expected {1 << cut_levels} database chunks, got {db_chunks.shape[0]}"
        )
    nk = seeds0.shape[0]
    state, ctrl, cwp, cwl, cwr, vc = pack_key_batch(
        seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, levels)
    state, ctrl = streaming_cut_state(state, ctrl, cwp, cwl, cwr,
                                      cut_levels=cut_levels)
    acc = streaming_scan_accumulate(
        state, ctrl, db_chunks, cwp[cut_levels:], cwl[cut_levels:],
        cwr[cut_levels:], vc, mode=mode)
    return acc[:nk]
