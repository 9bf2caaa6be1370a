"""Plane-resident dense-PIR expansion and its dispatch over the kernels.

The port of the JAX package's `pir/dense_eval_planes.py`
(`_evaluate_selection_blocks_planes_jit` and the split rules): transpose
the key batch's subtree roots into bit-plane layout once, expand
`expand_levels` levels in up to three phases, hash the leaves, and leave
plane layout once (`leaf_blocks`). `mode` picks the kernels, as the JAX
package's `DPF_TPU_LEVEL_KERNEL` does on a TPU (here a keyword, never an
environment variable, and without self-checks or a fallback: a failing
kernel raises):

* `"walk"` -- a head of K4 `walk_descend` over the narrow entry levels
  and a tail of K4 with the value hash;
* `"tail"` -- a head of K6 `expand_head` and a tail of K5 `expand_tail`
  (the last levels and the value hash, per entry tile);
* `"level"` -- K2 `expand_level` per level and K3 `value_hash` (a K6 head
  only when `head_levels` asks for one).

Levels that neither the head nor the tail covers run on K2. The split
follows the JAX defaults: the head fills levels until its exit width
reaches `HEAD_MAX_LANES` word columns (2,048), at least 2 levels
(`auto_head_count`); the walk tail takes `TAIL_LEVELS` (4) levels; the
fused tail shrinks until its entry tile holds `TAIL_TILE_LANES` (128)
columns (`tail_split`). `expansion_plan` takes other splits, and
`evaluate_planned` runs one. `expand_planned` is the phases of a plan on
planes alone, shared with the DPF's full-domain expansion (`dpf.py`,
one key's corrections at KG = 1).

Each phase leaves its leaves in its own order: doubling phases append
[all-left; all-right] per level (per tile for K5), walk phases emit
natural offsets. The exit gather is the argsort of the composed order
(`exit_permutation`); `ops.expand_planes.leaf_blocks` applies it while it
writes the leaf values out as key-major selection blocks, so the output
is bit-identical in every mode and split, and to the JAX package's
`evaluate_selection_blocks`.

Lane layout: node-major/key-minor (lane = node * nk + key) with nk padded
to a multiple of 32, so each packed word holds 32 keys of one node and
per-key corrections stay packed at [16, 8, nk/32] (`pack_key_planes` /
`pack_key_bits`); the kernels read them at column m % (nk/32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.aes_bitslice import limbs_to_planes, pack_select_bits
from ..ops.expand_planes import (
    expand_head,
    expand_level,
    expand_tail,
    leaf_blocks,
    tail_node_permutation,
    value_hash as hash_values,
    walk_descend,
    walk_leaf_order,
)

EXPANSION_MODES = ("walk", "tail", "level")
# The JAX package's first choice. On the H100 no mode has served the main
# path measurably faster than another (PERF.md: the host's spread is
# wider than their differences); all give the same selections.
DEFAULT_EXPANSION = "walk"
HEAD_MAX_LANES = 2048
TAIL_LEVELS = 4
TAIL_TILE_LANES = 128


def pack_key_planes(cw: torch.Tensor) -> torch.Tensor:
    """int32[nk, 4] per-key 128-bit words -> int32[16, 8, nk/32] planes
    packed over the key axis (word m bit i = key 32m+i's bit).

    Plane (byte j, bit i) of limb l bit b sits at flat index 32l + b, the
    `limbs_to_planes` bit order: packing 128-bit words over the key axis
    IS the plane transpose of the key batch."""
    if cw.shape[0] % 32:
        raise ValueError("key count must be padded to a multiple of 32")
    return limbs_to_planes(cw)


def pack_key_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32[nk] 0/1 -> int32[nk/32] packed (word m bit i = key 32m+i)."""
    if bits.shape[0] % 32:
        raise ValueError("key count must be padded to a multiple of 32")
    return pack_select_bits(bits)


def auto_head_count(cap: int, entry_lanes: int, avail: int) -> int:
    """Levels of the head (the JAX package's `_auto_head_count`): fill
    levels until the exit width reaches `cap` columns; a 1-level head is
    only a worse per-level launch, so the least is 2."""
    if avail <= 0 or entry_lanes <= 0 or cap < 2 * entry_lanes:
        return 0
    head = min(avail, (cap // entry_lanes).bit_length() - 1)
    return head if head >= 2 else 0


def head_split(key_groups: int, a_levels: int, head_levels=None) -> int:
    """How many of the `a_levels` levels above the tail the head covers
    (the JAX package's `_head_split`): `head_levels` when given (at most
    `a_levels`), else `auto_head_count` up to `HEAD_MAX_LANES`."""
    if a_levels <= 0:
        return 0
    if head_levels is not None:
        return max(0, min(head_levels, a_levels))
    return auto_head_count(HEAD_MAX_LANES, key_groups, a_levels)


def tail_split(key_groups: int, expand_levels: int,
               requested_levels: int = TAIL_LEVELS,
               target_lanes: int = TAIL_TILE_LANES) -> tuple:
    """(tail_levels, tile_nodes) of the fused tail (the JAX package's
    `_tail_split`): shrink the tail until its entry tile reaches the width
    floor, min(128 columns, `target_lanes`, what the key-group packing can
    express, the whole tree)."""
    best = 1 << (max(1, target_lanes // key_groups).bit_length() - 1)
    tail = min(requested_levels, expand_levels)
    if tail <= 0:
        return 0, 0
    floor = min(128, target_lanes, best * key_groups,
                key_groups << expand_levels)

    def tile_nodes(a_levels):
        return min(best, 1 << a_levels)

    while tail > 1 and tile_nodes(expand_levels - tail) * key_groups < floor:
        tail -= 1
    return tail, tile_nodes(expand_levels - tail)


def expansion_plan(mode: str, key_groups: int, expand_levels: int, *,
                   head_levels=None, tail_levels=None,
                   tail_tile_lanes=None) -> tuple:
    """(head, tail, tile_nodes) levels of one expansion: `head` levels in
    the head, `tail` in the tail (K5 tiles of `tile_nodes` entry nodes in
    tail mode), K2 for the rest. The keywords default to the JAX
    package's split; `head_levels=None` is the automatic head in walk and
    tail mode and no head in level mode."""
    if mode not in EXPANSION_MODES:
        raise ValueError(f"mode must be one of {EXPANSION_MODES}, got {mode!r}")
    requested = TAIL_LEVELS if tail_levels is None else tail_levels
    if requested < 0 or (head_levels is not None and head_levels < 0):
        raise ValueError("head_levels and tail_levels must not be negative")
    tile_nodes = 0
    if mode == "walk":
        tail = min(requested, expand_levels)
    elif mode == "tail":
        target = TAIL_TILE_LANES if tail_tile_lanes is None else tail_tile_lanes
        tail, tile_nodes = tail_split(key_groups, expand_levels, requested, target)
    else:
        if tail_levels:
            raise ValueError("level mode has no fused tail; use mode='tail' or 'walk'")
        tail = 0
        head_levels = 0 if head_levels is None else head_levels
    head = head_split(key_groups, expand_levels - tail, head_levels)
    return head, tail, tile_nodes


@functools.lru_cache(maxsize=64)
def exit_permutation(expand_levels: int, head: int, tail: int,
                     tile_nodes: int, walk: bool, num_blocks: int) -> np.ndarray:
    """The exit gather of one plan: perm[g] = the position of natural leaf
    g, the argsort of the composed phase orders (head: walk or doubling;
    middle: doubling; tail: walk, or doubling per tile of `tile_nodes`
    entry nodes), cut to `num_blocks`."""
    order = np.zeros(1, dtype=np.int64)
    if head:
        order = (walk_leaf_order(order, head) if walk
                 else tail_node_permutation(order, head, order.size)[0])
    middle = expand_levels - head - tail
    if middle:
        order = tail_node_permutation(order, middle, order.size)[0]
    if tail:
        order = (walk_leaf_order(order, tail) if walk
                 else tail_node_permutation(order, tail, tile_nodes)[0])
    return np.argsort(order)[:num_blocks]


@functools.lru_cache(maxsize=64)
def exit_block_nodes(expand_levels: int, head: int, tail: int, tile_nodes: int,
                     walk: bool, num_blocks: int) -> np.ndarray:
    """A plan's exit gather as `leaf_blocks`' block_node: the leaf position
    that holds each of `num_blocks` blocks (`exit_permutation`), -1 past
    the tree."""
    gather = exit_permutation(expand_levels, head, tail, tile_nodes, walk, num_blocks)
    out = np.full(num_blocks, -1, dtype=np.int32)
    out[:len(gather)] = gather
    return out


def pack_key_batch(seeds0, control0, cw_seeds, cw_left, cw_right, last_vc,
                   levels: int):
    """A staged key batch in plane layout, the key count zero-padded to a
    multiple of 32: (state int32[16, 8, KG], ctrl int32[KG], cwp
    int32[levels, 16, 8, KG], cwl / cwr int32[levels, KG], vc
    int32[16, 8, KG]) from the first `levels` correction levels. Padded keys
    expand to leaves that callers cut off."""
    nk = seeds0.shape[0]
    pad_keys = (-nk) % 32
    if pad_keys:
        seeds0 = F.pad(seeds0, (0, 0, 0, pad_keys))
        control0 = F.pad(control0, (0, pad_keys))
        cw_seeds = F.pad(cw_seeds, (0, 0, 0, pad_keys))
        cw_left = F.pad(cw_left, (0, pad_keys))
        cw_right = F.pad(cw_right, (0, pad_keys))
        last_vc = F.pad(last_vc, (0, 0, 0, pad_keys))
    nkp = nk + pad_keys
    kg = nkp // 32

    # Enter plane space once.
    state = limbs_to_planes(seeds0.contiguous())  # [16, 8, KG]
    ctrl = pack_key_bits(control0)  # [KG]

    # Pack every level's corrections in one pass: key k of level l is
    # block l * nkp + k, i.e. word l * KG + k / 32 of the packing; then one
    # [16, 8, KG] row per level. Per-level packing would cost a few
    # hundred small device ops per level on the host's dispatch path.
    cwp = pack_key_planes(cw_seeds[:levels].reshape(-1, 4).contiguous())
    cwp = cwp.reshape(16, 8, levels, kg).permute(2, 0, 1, 3).contiguous()
    cwl = pack_key_bits(cw_left[:levels].reshape(-1)).reshape(levels, kg)
    cwr = pack_key_bits(cw_right[:levels].reshape(-1)).reshape(levels, kg)
    vc = pack_key_planes(last_vc.contiguous())
    return state, ctrl, cwp, cwl, cwr, vc


def evaluate_selection_blocks_planes(
    seeds0: torch.Tensor,
    control0: torch.Tensor,
    cw_seeds: torch.Tensor,
    cw_left: torch.Tensor,
    cw_right: torch.Tensor,
    last_vc: torch.Tensor,
    *,
    expand_levels: int,
    num_blocks: int,
    mode: str = DEFAULT_EXPANSION,
) -> torch.Tensor:
    """Selection blocks for a batch of single-level 128-bit-XOR DPF keys.

    seeds0: int32[nk, 4] root seeds; control0: int32[nk] (= party);
    cw_seeds: int32[L, nk, 4], cw_left/right: int32[L, nk] with
    L >= expand_levels; last_vc: int32[nk, 4]. All on one device; CUDA
    tensors run the kernels, CPU tensors their plain versions. The keys
    sit at the root of the covering subtree: the shared all-zeros prefix
    above it was walked on the host while staging. `mode` chooses the
    kernels (module docstring), split as the JAX package splits; the
    result is the same for every mode. Returns int32[nk, num_blocks, 4],
    the first `num_blocks` leaves of each key's subtree.
    """
    key_groups = -(-seeds0.shape[0] // 32)
    return evaluate_planned(
        seeds0, control0, cw_seeds, cw_left, cw_right, last_vc,
        expand_levels=expand_levels, num_blocks=num_blocks, mode=mode,
        plan=expansion_plan(mode, key_groups, expand_levels),
    )


def evaluate_planned(seeds0, control0, cw_seeds, cw_left, cw_right, last_vc,
                     *, expand_levels: int, num_blocks: int, mode: str,
                     plan: tuple) -> torch.Tensor:
    """`evaluate_selection_blocks_planes` with the (head, tail,
    tile_nodes) split `plan` that `expansion_plan` gives for `mode` and
    the keys' padded key-group count."""
    nk = seeds0.shape[0]
    levels = expand_levels
    state, ctrl, cwp, cwl, cwr, vc = pack_key_batch(
        seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, levels)
    kg = ctrl.shape[0]

    # Leaf value blocks: output PRG + XOR value correction (party
    # negation is the identity for XOR shares).
    values = expand_planned(state, ctrl, cwp, cwl, cwr, vc, mode=mode,
                            plan=plan, node_lanes=kg)[0]

    # Leave plane space once, into block order: int32[nkp, num_blocks, 4]
    # (blocks beyond the tree's capacity select nothing).
    block_node = torch.from_numpy(
        exit_block_nodes(levels, *plan, mode == "walk", num_blocks)).to(values.device)
    return leaf_blocks(values, block_node, kg)[:nk]


def expand_planned(state, ctrl, cwp, cwl, cwr, vc, *, mode: str, plan: tuple,
                   node_lanes: int, value_hash: bool = True):
    """The phases of one planned expansion in plane layout: the head (K4
    or K6), K2 per middle level, then the tail (K4 or K5) or K3, ending in
    the leaf value hash. state int32[16, 8, G0]; ctrl int32[G0]; cwp
    int32[L, 16, 8, KW]; cwl / cwr int32[L, KW]; vc int32[16, 8, KW] (KW
    divides `node_lanes`, the word columns of one tree node); `plan` from
    `expansion_plan(mode, node_lanes, L)`. Returns (values int32[16, 8, G0
    << L], leaf ctrl int32[G0 << L]) in the plan's leaf order
    (`exit_permutation`). Without `value_hash` the leaf seeds come out
    instead of their values: K4's tail without its hash, no K3, and in
    tail mode a plan without a tail (K5 always hashes)."""
    levels = cwp.shape[0]
    head, tail, tile_nodes = plan
    walk = mode == "walk"
    if tail and not walk and not value_hash:
        raise ValueError("K5 always hashes: plan tail mode without a tail for seeds")
    if head and walk:
        state, ctrl = walk_descend(state, ctrl, cwp[:head], cwl[:head], cwr[:head],
                                   node_lanes=node_lanes)
    elif head:
        state, ctrl = expand_head(state, ctrl, cwp[:head], cwl[:head], cwr[:head])
    for lvl in range(head, levels - tail):
        state, ctrl = expand_level(state, ctrl, cwp[lvl], cwl[lvl], cwr[lvl])
    a = levels - tail
    if tail and walk:
        return walk_descend(state, ctrl, cwp[a:], cwl[a:], cwr[a:], vc,
                            value_hash=value_hash, node_lanes=node_lanes)
    if tail:
        return expand_tail(state, ctrl, cwp[a:], cwl[a:], cwr[a:], vc,
                           tile_nodes * node_lanes)
    if not value_hash:
        return state, ctrl
    return hash_values(state, ctrl, vc), ctrl
