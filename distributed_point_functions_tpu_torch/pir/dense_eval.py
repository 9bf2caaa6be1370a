"""Key staging and the host zeros-walk for dense PIR.

The client puts a query's block index in `alpha = index / 128`, so every
useful leaf of a key's tree lives under the all-zeros prefix of depth
`log_domain_size - ceil(log2(num_blocks))`. The server walks that shared
prefix on the host while it stages a key batch (`_walk_zeros_host`: the
native host library's seed walk, `native.evaluate_seeds`, with each key's
own corrections), then the device expands only the covering subtree
(`dense_eval_planes.py`).

The port of the JAX package's `pir/dense_eval.py` staging half.
`stage_keys_host` packs a batch's keys into arrays in bulk (one bytes
join per field, no per-key, per-level loop). `_walk_zeros_host_plain`,
the walk in numpy, is the plain version the tests hold the native walk
against. `chunked_pir_inner_products` is the chunked serving tier: one
chunk root at a time walked down its path bits (K8), its subtree expanded
and XORed into the result against its span of the database (K1's
accumulate entry). `selection_blocks_for_keys` stages a batch and expands
its selection blocks in one call (the JAX package's entry of that name).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import keys as fixed_keys
from .. import native
from ..device import resolve_device
from ..dpf import DpfKey
from ..ops import aes
from ..ops.expand_planes import leaf_blocks, path_walk
from ..ops.inner_product_kernels import xor_inner_product_accumulate
from ..ops.words import to_tensors
from .dense_eval_planes import (
    DEFAULT_EXPANSION,
    evaluate_selection_blocks_planes,
    exit_block_nodes,
    expand_planned,
    expansion_plan,
    pack_key_batch,
)

_CLEAR_LSB = np.array(
    [0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32
)


def _walk_zeros_host(seeds0, control0, cw_seeds, cw_left, cw_right, levels):
    """Walk the all-zeros prefix (left child each level) on the host for
    `levels` levels, on the native host library with per-key corrections.
    Numpy in (uint32 limbs), numpy out."""
    sb = aes.limbs_to_bytes_np(seeds0)
    s, c = native.evaluate_seeds(
        sb,
        control0.astype(np.uint8),
        np.zeros_like(sb),
        aes.limbs_to_bytes_np(cw_seeds[:levels]),
        cw_left[:levels].astype(np.uint8),
        cw_right[:levels].astype(np.uint8),
        per_seed_cw=True,
    )
    return aes.bytes_to_limbs_np(s), c.astype(np.uint32)


def _walk_zeros_host_plain(seeds0, control0, cw_seeds, cw_left, cw_right, levels):
    """`_walk_zeros_host` in numpy (one batched numpy MMO hash a level):
    the plain version the tests hold the native walk against."""
    seeds = seeds0.copy()
    control = control0.copy()
    for lvl in range(levels):
        h = aes.mmo_hash_np(fixed_keys.RK_LEFT, seeds)
        h ^= np.where(control[:, None] != 0, cw_seeds[lvl], 0).astype(
            np.uint32
        )
        t_new = h[:, 0] & np.uint32(1)
        h &= _CLEAR_LSB
        control = t_new ^ (control * cw_left[lvl])
        seeds = h
    return seeds, control


def stage_keys_host(keys: Sequence[DpfKey], host_walk_levels: int = 0):
    """Stack a batch of dense-PIR DPF keys into six numpy uint32 arrays:
    seeds0 [nk, 4], control0 [nk], cw_seeds [L, nk, 4], cw_left and
    cw_right [L, nk], last_vc [nk, 4].

    With `host_walk_levels > 0` the shared all-zeros prefix is walked
    here: the returned seeds/control sit at that depth and the
    correction-word arrays drop the walked levels.
    """
    nk = len(keys)
    num_levels = len(keys[0].correction_words)
    for key in keys:
        if len(key.correction_words) != num_levels:
            raise ValueError("all keys must have the same number of levels")
        if len(key.last_level_value_correction) != 1:
            raise ValueError("dense PIR keys carry exactly one leaf value")
    # Key-major: key k's levels are entries k * L ... k * L + L - 1.
    cws = [cw for key in keys for cw in key.correction_words]
    seeds0 = aes.u128s_to_limbs([key.seed for key in keys])
    control0 = np.fromiter((key.party for key in keys), dtype=np.uint32, count=nk)
    last_vc = aes.u128s_to_limbs(
        [int(key.last_level_value_correction[0]) for key in keys])
    cw_seeds = np.ascontiguousarray(aes.u128s_to_limbs(
        [cw.seed for cw in cws]).reshape(nk, num_levels, 4).transpose(1, 0, 2))
    cw_left = np.ascontiguousarray(np.fromiter(
        (cw.control_left for cw in cws), dtype=np.uint32,
        count=nk * num_levels).reshape(nk, num_levels).T)
    cw_right = np.ascontiguousarray(np.fromiter(
        (cw.control_right for cw in cws), dtype=np.uint32,
        count=nk * num_levels).reshape(nk, num_levels).T)
    if host_walk_levels:
        if host_walk_levels > num_levels:
            raise ValueError(
                f"host_walk_levels={host_walk_levels} exceeds the keys' "
                f"{num_levels} correction-word levels"
            )
        seeds0, control0 = _walk_zeros_host(
            seeds0, control0, cw_seeds, cw_left, cw_right, host_walk_levels
        )
        cw_seeds = cw_seeds[host_walk_levels:]
        cw_left = cw_left[host_walk_levels:]
        cw_right = cw_right[host_walk_levels:]
    return seeds0, control0, cw_seeds, cw_left, cw_right, last_vc


def stage_keys(
    keys: Sequence[DpfKey], host_walk_levels: int = 0, device=None
):
    """`stage_keys_host`, placed on `device` as int32 tensors in ONE
    host-to-device copy (the six arrays are views of one flat buffer)."""
    dev = resolve_device(device)
    return tuple(to_tensors(stage_keys_host(keys, host_walk_levels), dev))



def selection_blocks_for_keys(dpf, keys: Sequence[DpfKey], num_blocks: int,
                              device=None, mode: str = DEFAULT_EXPANSION):
    """The first `num_blocks` selection blocks of a batch of one-level
    128-bit XOR DPF keys of `dpf`: int32[nk, num_blocks, 4] on `device`
    (the JAX package's `selection_blocks_for_keys`). The shared all-zeros
    prefix is walked on the host and only the covering subtree expanded,
    in `mode`."""
    total_levels = dpf._tree_levels_needed - 1
    expand_levels = min(max(0, (num_blocks - 1).bit_length()), total_levels)
    staged = stage_keys(keys, total_levels - expand_levels, device=device)
    return evaluate_selection_blocks_planes(
        *staged, expand_levels=expand_levels, num_blocks=num_blocks, mode=mode)


def chunked_pir_inner_products(
    seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, db_perm, *,
    chunk_bits: int, chunk_expand_levels: int, num_chunks: int,
    mode: str = DEFAULT_EXPANSION,
) -> torch.Tensor:
    """Dense-PIR inner products one chunk of 2^chunk_expand_levels blocks
    at a time, so only one chunk's selections are ever live (the JAX
    package's `chunked_pir_inner_products`).

    For chunk c: walk the chunk root's path, bit j of c MSB first, in one
    K8 launch (`path_walk`, every key on the same branch, so its select
    words are all-ones or all-zeros, with each key's own corrections);
    expand its
    subtree `chunk_expand_levels` levels in `mode`
    (`dense_eval_planes.expand_planned`) and write its leaves out as
    selection blocks in natural order (`leaf_blocks`); XOR them into the
    result against the chunk's records
    (K1's accumulate entry on a group span of the staging). The staged
    keys sit at the root of the covering subtree with chunk_bits +
    chunk_expand_levels correction levels. db_perm: int32[32, G, W], the
    natural-order bit-major staging with G >= num_chunks * 2^cel * 4
    groups (`DenseDpfPirDatabase.chunked_staging`). Returns
    int32[num_keys, W], equal to the materialized tier's."""
    cel = chunk_expand_levels
    levels = chunk_bits + cel
    if cw_seeds.shape[0] != levels:
        raise ValueError(
            f"keys have {cw_seeds.shape[0]} correction levels; the plan "
            f"needs {chunk_bits} path bits + {cel} expansion levels"
        )
    span = 4 << cel  # selection words (groups of 32 records) per chunk
    if db_perm.shape[1] < num_chunks * span:
        raise ValueError(
            f"db_perm holds {db_perm.shape[1]} groups, the chunks need "
            f"{num_chunks * span}"
        )
    nk = seeds0.shape[0]
    state, ctrl, cwp, cwl, cwr, vc = pack_key_batch(
        seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, levels)
    kg = ctrl.shape[0]
    dev = state.device
    plan = expansion_plan(mode, kg, cel)
    block_node = torch.from_numpy(
        exit_block_nodes(cel, *plan, mode == "walk", 1 << cel)).to(dev)
    # Chunk c's path select words, level j: bit j of c (MSB first), the
    # same for every key (all-zeros or all-ones words).
    chunks = torch.arange(num_chunks, dtype=torch.int32, device=dev)[:, None]
    shifts = torch.arange(chunk_bits - 1, -1, -1, dtype=torch.int32, device=dev)
    path_sel = (-((chunks >> shifts) & 1))[:, :, None].expand(
        num_chunks, chunk_bits, kg).contiguous()
    acc = torch.zeros((32 * kg, db_perm.shape[2]), dtype=torch.int32, device=dev)
    for c in range(num_chunks):
        s, t = state, ctrl
        if chunk_bits:
            s, t = path_walk(s, t, path_sel[c], cwp[:chunk_bits], cwl[:chunk_bits],
                             cwr[:chunk_bits])
        values = expand_planned(
            s, t, cwp[chunk_bits:], cwl[chunk_bits:], cwr[chunk_bits:], vc,
            mode=mode, plan=plan, node_lanes=kg)[0]
        # Free each buffer once used: a chunk's leaf values and its
        # selections are what the capacity model counts.
        sel = leaf_blocks(values, block_node, kg)
        del values
        xor_inner_product_accumulate(acc, db_perm[:, c * span:(c + 1) * span], sel)
        del sel
    return acc[:nk]
