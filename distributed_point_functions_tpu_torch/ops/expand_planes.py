"""Wrappers of the expansion kernels K2 to K6.

The counterpart of the JAX package's `ops/expand_planes_pallas.py`.

* `expand_level` (K2) -- one [all-left; all-right] expansion level: sigma,
  fixed-key AES MMO with both `RK_LEFT` and `RK_RIGHT`, seed correction
  under the parent control bit, the LSB plane out as the child control
  bit (and cleared), then the direction correction. Replaces the TPU
  kernel `_level_kernel` (`ops/expand_planes_pallas.py:134`).
* `value_hash` (K3) -- the leaf MMO hash with `RK_VALUE`, XORed with the
  value correction under the control bit. Replaces `_value_kernel`
  (`ops/expand_planes_pallas.py:333`).
* `walk_descend` (K4) -- r levels below each entry column, leaves in
  natural order, an optional value hash: the function of r levels at the
  constant width G0 << r, each column hashing once with the left or right
  key as its leaf offset says (select-key AES); the kernel walks each
  subtree's top levels that way and doubles its last ones in shared
  memory. Replaces `_walk_kernel` (`ops/expand_planes_pallas.py:649`).
* `expand_tail` (K5) -- the last r doubling levels and the value hash in
  one launch, leaves in the tiled order of `tail_node_permutation`.
  Replaces `_tail_kernel` (`ops/expand_planes_pallas.py:392`).
* `expand_head` (K6) -- the first r doubling levels over the whole
  narrow width in one launch, doubling order. Replaces `_head_kernel`
  (`ops/expand_planes_pallas.py:453`). K4, K5 and K6 are one kernel body
  (`csrc/expand_fused.cu`): a block a subtree, its last levels doubled in
  shared memory, the leaves stored in the order each asks for; no
  scratch beyond the outputs.
* `path_walk` (K8) -- L path-walk levels in one launch: at each level
  each column hashes once with the left or right key as its packed path
  bit says (select-key AES), then the seed correction, the control bit
  out of plane 0, and the direction correction of the path's branch; the
  states at requested stops come out side by side. `path_level` is its
  one-level case. Replaces `_path_kernel`
  (`ops/expand_planes_pallas.py:946`).
* `leaf_blocks` -- leaves plane layout for dense PIR's selection blocks:
  the bit transpose of the leaf values, the exit gather into block order
  and the key-major transpose in one pass (`csrc/leaf_blocks.cu`), driven
  by the block -> node map that callers cache per shape. It has no TPU
  kernel; the JAX package does the same in XLA. One pass keeps the leaf
  values and the selections the only selection-sized buffers alive.

For a CPU tensor each wrapper runs its plain PyTorch version (the
`*_plain` functions, built on `aes_bitslice.py`: K4-K6 are K2's level and
K3's hash composed); for a CUDA tensor it launches the hand-written kernel
(`csrc/expand_planes.cu`, `csrc/expand_fused.cu`, `csrc/path_level.cu`,
`csrc/leaf_blocks.cu`) or raises. There is no
fallback from one to the other.

Bound on the H100: 32-bit integer logic. A child of one 32-lane word
column is a whole bitsliced AES (~32k word ops) against 1.5 KB of state
traffic. K3 keeps the 128-word state in registers, one thread per word
column, compiles the fixed round keys in, and re-reads the input column
for the MMO feed-forward rather than keep sigma live. K2, K4-K6 and K8
split each column's AES over a group of 16 threads
(`csrc/split_aes.cuh`); K2 gives each child its own group, K4-K6 double
a subtree's last levels in shared memory (see the sources for the
designs, registers and spills). `leaf_blocks` is bound by bytes.

Per-key corrections stay packed at [16, 8, KG] planes and [KG] words
(KG = padded keys / 32), one such row per level for K4-K6 ([r, 16, 8,
KG], [r, KG]); lane layout is node-major (lane = node * 32KG + key), so a
lane's correction is at column m % KG.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import keys as fixed_keys
from . import cuda_lib
from .aes_bitslice import (
    aes_rounds_planes,
    aes_rounds_select_planes,
    mmo_hash_planes,
    planes_to_limbs,
    sigma_planes,
)


def tile_keys(words: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Broadcast per-key packed words over the node axis: [..., KG] ->
    [..., num_groups] (group g covers the keys of node g // KG)."""
    reps = num_groups // words.shape[-1]
    return words.repeat((1,) * (words.ndim - 1) + (reps,))


def expand_level_planes(state, ctrl, cw_p, cwl_w, cwr_w):
    """One [all-left; all-right] plane-space expansion level with the
    corrections already tiled (the JAX package's
    `pir/dense_eval_planes.py:expand_level_planes`).

    state: [16, 8, G] planes; ctrl: int32[G] packed parent control bits;
    cw_p: [16, 8, 2G] seed-correction planes; cwl_w / cwr_w: [G] packed
    direction-correction words. Returns (state [16, 8, 2G], ctrl [2G])."""
    sig = sigma_planes(state)
    left = aes_rounds_planes(fixed_keys.RK_LEFT, sig) ^ sig
    right = aes_rounds_planes(fixed_keys.RK_RIGHT, sig) ^ sig
    state = torch.cat([left, right], dim=-1)
    ctrl2 = torch.cat([ctrl, ctrl])  # parent bit, both halves
    state = state ^ (cw_p & ctrl2[None, None, :])
    t_new = state[0, 0].clone()  # LSB plane = control bits
    state[0, 0] = 0
    cw_dir = torch.cat([cwl_w, cwr_w])
    return state, t_new ^ (ctrl2 & cw_dir)


def expand_level_plain(state, ctrl, cwp_kg, cwl_kg, cwr_kg):
    """Plain version of K2 on packed (untiled) corrections."""
    g = state.shape[-1]
    return expand_level_planes(
        state,
        ctrl,
        tile_keys(cwp_kg, 2 * g),
        tile_keys(cwl_kg, g),
        tile_keys(cwr_kg, g),
    )


def value_hash_plain(state, ctrl, vc_kg):
    """Plain version of K3: `mmo_hash_planes(RK_VALUE, state) ^ (vc & ctrl)`."""
    values = mmo_hash_planes(fixed_keys.RK_VALUE, state)
    vc = tile_keys(vc_kg, state.shape[-1])
    return values ^ (vc & ctrl[None, None, :])


def _check_words(t: torch.Tensor, name: str, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_level_args(state, ctrl, cw_planes, cw_words):
    if state.ndim != 3 or tuple(state.shape[:2]) != (16, 8):
        raise ValueError(f"state must be [16, 8, G], got {tuple(state.shape)}")
    g = state.shape[-1]
    kg = cw_planes.shape[-1] if cw_planes.ndim == 3 else -1
    if kg <= 0 or g % kg:
        raise ValueError(
            f"correction width {kg} must divide the state width {g}"
        )
    dev = state.device
    _check_words(state, "state", (16, 8, g), dev)
    _check_words(ctrl, "ctrl", (g,), dev)
    _check_words(cw_planes, "correction planes", (16, 8, kg), dev)
    for i, w in enumerate(cw_words):
        _check_words(w, f"correction words {i}", (kg,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return g, kg


def expand_level(state, ctrl, cwp_kg, cwl_kg, cwr_kg):
    """K2: one expansion level.

    state: int32[16, 8, G]; ctrl: int32[G]; cwp_kg: int32[16, 8, KG]
    per-key seed-correction planes (`pack_key_planes`); cwl_kg / cwr_kg:
    int32[KG] packed direction-correction bits. Returns
    (state int32[16, 8, 2G], ctrl int32[2G]) in [all-left; all-right]
    child order."""
    g, kg = _check_level_args(state, ctrl, cwp_kg, (cwl_kg, cwr_kg))
    if state.device.type == "cpu":
        return expand_level_plain(state, ctrl, cwp_kg, cwl_kg, cwr_kg)
    lib = cuda_lib.library()
    out_state = torch.empty((16, 8, 2 * g), dtype=torch.int32, device=state.device)
    out_ctrl = torch.empty((2 * g,), dtype=torch.int32, device=state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.dpf_expand_level(
            state.data_ptr(), ctrl.data_ptr(), cwp_kg.data_ptr(),
            cwl_kg.data_ptr(), cwr_kg.data_ptr(), out_state.data_ptr(),
            out_ctrl.data_ptr(), g, kg, stream,
        )
    cuda_lib.count("expand_level")
    cuda_lib.check(err, "expand_level")
    return out_state, out_ctrl


def value_hash(state, ctrl, vc_kg):
    """K3: leaf MMO output hash + value correction.

    state: int32[16, 8, G]; ctrl: int32[G]; vc_kg: int32[16, 8, KG]
    per-key value-correction planes. Returns int32[16, 8, G]."""
    g, kg = _check_level_args(state, ctrl, vc_kg, ())
    if state.device.type == "cpu":
        return value_hash_plain(state, ctrl, vc_kg)
    lib = cuda_lib.library()
    out = torch.empty((16, 8, g), dtype=torch.int32, device=state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.dpf_value_hash(
            state.data_ptr(), ctrl.data_ptr(), vc_kg.data_ptr(),
            out.data_ptr(), g, kg, stream,
        )
    cuda_lib.count("value_hash")
    cuda_lib.check(err, "value_hash")
    return out


def tail_node_permutation(
    entry_order: np.ndarray, r: int, tile_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Leaf order after `r` doubling levels (the JAX package's
    `ops/expand_planes_pallas.py:tail_node_permutation`).

    entry_order[pos] = natural node index sitting at plane position `pos`
    when the levels start. Each tile of `tile_nodes` entry nodes expands
    with per-level [all-left; all-right] concatenation. Returns (order,
    perm): order[pos] = natural leaf index at final position pos, and
    perm = argsort(order), the exit-gather index vector."""
    chunks = []
    for lo in range(0, len(entry_order), tile_nodes):
        m = np.asarray(entry_order[lo : lo + tile_nodes], dtype=np.int64)
        for _ in range(r):
            m = np.concatenate([2 * m, 2 * m + 1])
        chunks.append(m)
    order = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    return order, np.argsort(order)


def walk_leaf_order(entry_order: np.ndarray, r: int) -> np.ndarray:
    """Leaf order after a walk descent of `r` levels (the JAX package's
    `pir/dense_eval_planes.py:walk_leaf_order`): each entry node's 2^r
    leaves exit consecutively in offset order, so order[p * 2^r + off] =
    entry_order[p] * 2^r + off."""
    m = np.asarray(entry_order, dtype=np.int64)
    return (
        m[:, None] * (1 << r) + np.arange(1 << r, dtype=np.int64)[None, :]
    ).reshape(-1)


def replicate_entry_planes(state, ctrl, node_lanes: int, times: int):
    """[16, 8, n * node_lanes] entry planes -> [16, 8, n * times *
    node_lanes] with each node's block repeated `times` times in a row
    (and the control words likewise): the walk descent's entry, where
    every column already holds its leaf's ancestor."""
    p, q, g = state.shape
    n = g // node_lanes
    state_r = state.reshape(p, q, n, 1, node_lanes).expand(
        p, q, n, times, node_lanes
    ).reshape(p, q, n * times * node_lanes)
    ctrl_r = ctrl.reshape(n, 1, node_lanes).expand(n, times, node_lanes)
    return state_r, ctrl_r.reshape(-1)


def walk_descend_plain(state, ctrl, cwp, cwl, cwr, vc=None, *,
                       value_hash=False, node_lanes=None):
    """Plain version of K4: replicate the entry 2^r-fold, then at each
    level hash every column once with the key its leaf offset selects
    (bit r-1-i of the offset at level i, most significant first)."""
    r, kg = cwp.shape[0], cwp.shape[-1]
    nl = kg if node_lanes is None else node_lanes
    g0 = state.shape[-1]
    w = g0 << r
    state, ctrl = replicate_entry_planes(state, ctrl, nl, 1 << r)
    off = torch.arange(1 << r, device=state.device).repeat_interleave(nl)
    off = off.repeat(g0 // nl)
    for i in range(r):
        sel = -((off >> (r - 1 - i)) & 1).to(torch.int32)  # 0 or ~0 a column
        sig = sigma_planes(state)
        h = aes_rounds_select_planes(fixed_keys.RK_LEFT, fixed_keys.RK_RIGHT, sel, sig)
        h = h ^ sig ^ (tile_keys(cwp[i], w) & ctrl[None, None, :])
        t_new = h[0, 0].clone()
        h[0, 0] = 0
        cw_dir = (tile_keys(cwl[i], w) & ~sel) | (tile_keys(cwr[i], w) & sel)
        state, ctrl = h, t_new ^ (ctrl & cw_dir)
    if value_hash:
        return value_hash_plain(state, ctrl, vc), ctrl
    return state, ctrl


def expand_head_plain(state, ctrl, cwp, cwl, cwr):
    """Plain version of K6: r levels of `expand_level_plain`."""
    for i in range(cwp.shape[0]):
        state, ctrl = expand_level_plain(state, ctrl, cwp[i], cwl[i], cwr[i])
    return state, ctrl


def expand_tail_plain(state, ctrl, cwp, cwl, cwr, vc, tile_lanes: int):
    """Plain version of K5: each entry tile of `tile_lanes` columns
    through r levels of `expand_level_plain` and `value_hash_plain`, the
    tiles' leaves concatenated in entry order."""
    values, ctrls = [], []
    for lo in range(0, state.shape[-1], tile_lanes):
        s, c = expand_head_plain(
            state[..., lo:lo + tile_lanes], ctrl[lo:lo + tile_lanes],
            cwp, cwl, cwr,
        )
        values.append(value_hash_plain(s, c, vc))
        ctrls.append(c)
    return torch.cat(values, dim=-1), torch.cat(ctrls)


def _check_fused_args(state, ctrl, cwp, cwl, cwr, vc):
    """(G0, KG, r) of a fused launch; raises on what the kernels do not
    take."""
    if state.ndim != 3 or tuple(state.shape[:2]) != (16, 8):
        raise ValueError(f"state must be [16, 8, G], got {tuple(state.shape)}")
    if cwp.ndim != 4 or tuple(cwp.shape[1:3]) != (16, 8):
        raise ValueError(f"correction planes must be [r, 16, 8, KG], got {tuple(cwp.shape)}")
    g0 = state.shape[-1]
    r, kg = cwp.shape[0], cwp.shape[-1]
    if not 1 <= r <= 30:
        raise ValueError(f"level count {r} must be in [1, 30]")
    if kg <= 0 or g0 % kg:
        raise ValueError(f"correction width {kg} must divide the state width {g0}")
    dev = state.device
    _check_words(state, "state", (16, 8, g0), dev)
    _check_words(ctrl, "ctrl", (g0,), dev)
    _check_words(cwp, "correction planes", (r, 16, 8, kg), dev)
    _check_words(cwl, "left correction words", (r, kg), dev)
    _check_words(cwr, "right correction words", (r, kg), dev)
    if vc is not None:
        _check_words(vc, "value correction", (16, 8, kg), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return g0, kg, r


def _ptr(t):
    return None if t is None else t.data_ptr()


def walk_descend(state, ctrl, cwp, cwl, cwr, vc=None, *, value_hash=False,
                 node_lanes=None):
    """K4: an r-level walk descent at constant width.

    state: int32[16, 8, G0]; ctrl: int32[G0]; cwp: int32[r, 16, 8, KG];
    cwl / cwr: int32[r, KG]; vc (with `value_hash`): int32[16, 8, KG].
    `node_lanes` is the column width of one tree node's block (default
    KG). Returns (planes int32[16, 8, G0 << r], ctrl int32[G0 << r]) in
    natural leaf order (leaf = entry node * 2^r + offset); with
    `value_hash` the planes are the leaf values."""
    g0, kg, r = _check_fused_args(state, ctrl, cwp, cwl, cwr, vc)
    nl = kg if node_lanes is None else node_lanes
    if nl <= 0 or nl % kg or g0 % nl:
        raise ValueError(
            f"node lanes {nl} must be a multiple of KG {kg} and divide G0 {g0}"
        )
    if value_hash and vc is None:
        raise ValueError("value_hash needs the value correction vc")
    if state.device.type == "cpu":
        return walk_descend_plain(state, ctrl, cwp, cwl, cwr, vc,
                                  value_hash=value_hash, node_lanes=nl)
    lib = cuda_lib.library()
    w = g0 << r
    out = torch.empty((16, 8, w), dtype=torch.int32, device=state.device)
    out_ctrl = torch.empty((w,), dtype=torch.int32, device=state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.dpf_walk_descend(
            state.data_ptr(), ctrl.data_ptr(), cwp.data_ptr(), cwl.data_ptr(),
            cwr.data_ptr(), _ptr(vc if value_hash else None), out.data_ptr(),
            out_ctrl.data_ptr(), g0, kg, nl, r, int(value_hash), stream,
        )
    cuda_lib.count("walk_descend")
    cuda_lib.check(err, "walk_descend")
    return out, out_ctrl


def _launch_fused(name, tensors, sizes, width):
    """One launch of K6 (`dpf_expand_head`) or K5 (`dpf_expand_tail`) on
    the input `tensors` and the integer arguments `sizes`. Allocates only
    the outputs: (planes int32[16, 8, width], ctrl int32[width])."""
    dev = tensors[0].device
    out = torch.empty((16, 8, width), dtype=torch.int32, device=dev)
    out_ctrl = torch.empty((width,), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"dpf_{name}")(
            *(t.data_ptr() for t in tensors), out.data_ptr(), out_ctrl.data_ptr(),
            *sizes, stream)
    cuda_lib.count(name)
    cuda_lib.check(err, name)
    return out, out_ctrl


def expand_head(state, ctrl, cwp, cwl, cwr):
    """K6: the first r doubling levels in one launch.

    state: int32[16, 8, G0]; ctrl: int32[G0]; cwp: int32[r, 16, 8, KG];
    cwl / cwr: int32[r, KG]. Returns (state int32[16, 8, G0 << r], ctrl
    int32[G0 << r]), equal to r successive `expand_level` calls."""
    g0, kg, r = _check_fused_args(state, ctrl, cwp, cwl, cwr, None)
    if state.device.type == "cpu":
        return expand_head_plain(state, ctrl, cwp, cwl, cwr)
    return _launch_fused("expand_head", (state, ctrl, cwp, cwl, cwr), (g0, kg, r),
                         g0 << r)


def expand_tail(state, ctrl, cwp, cwl, cwr, vc, tile_lanes: int):
    """K5: the last r doubling levels and the leaf value hash in one
    launch.

    Arguments as `expand_head`, plus vc: int32[16, 8, KG] and
    `tile_lanes`, the entry tile width (a positive multiple of KG; the
    last tile may be narrower). Each tile doubles on its own and the
    tiles' leaves concatenate in entry order: compose
    `tail_node_permutation(order, r, tile_lanes // KG)` to recover
    natural order. Returns (values int32[16, 8, G0 << r], leaf ctrl
    int32[G0 << r])."""
    g0, kg, r = _check_fused_args(state, ctrl, cwp, cwl, cwr, vc)
    if vc is None:
        raise ValueError("expand_tail needs the value correction vc")
    if tile_lanes <= 0 or tile_lanes % kg:
        raise ValueError(f"tile_lanes {tile_lanes} must be a positive multiple of KG {kg}")
    if state.device.type == "cpu":
        return expand_tail_plain(state, ctrl, cwp, cwl, cwr, vc, tile_lanes)
    return _launch_fused("expand_tail", (state, ctrl, cwp, cwl, cwr, vc),
                         (g0, kg, tile_lanes, r), g0 << r)


def path_level_plain(state, ctrl, sel, cwp, cwl, cwr):
    """Plain version of one K8 level (the JAX package's
    `dpf._eval_paths_planes` scan body): sigma, the select-key AES MMO hash
    (key `RK_RIGHT` where a lane's `sel` bit is 1), the seed correction
    under the control bit, the control bit out of plane 0 (cleared), then
    the direction correction of the branch each lane took."""
    g = state.shape[-1]
    sig = sigma_planes(state)
    h = aes_rounds_select_planes(fixed_keys.RK_LEFT, fixed_keys.RK_RIGHT, sel, sig)
    h = h ^ sig ^ (tile_keys(cwp, g) & ctrl[None, None, :])
    t_new = h[0, 0].clone()
    h[0, 0] = 0
    cw_dir = (sel & tile_keys(cwr, g)) | (~sel & tile_keys(cwl, g))
    return h, t_new ^ (ctrl & cw_dir)


def path_walk_plain(state, ctrl, sel, cwp, cwl, cwr, stops):
    """Plain version of K8's walk: `path_level_plain` once per level, the
    state and control after `stops[i]` levels side by side."""
    states, ctrls = [], []
    for lvl in range(sel.shape[0] + 1):
        for stop in stops:
            if stop == lvl:
                states.append(state)
                ctrls.append(ctrl)
        if lvl < sel.shape[0]:
            state, ctrl = path_level_plain(state, ctrl, sel[lvl], cwp[lvl],
                                           cwl[lvl], cwr[lvl])
    return torch.cat(states, dim=-1), torch.cat(ctrls)


# Stops one K8 launch takes (`kMaxStops` in csrc/path_level.cu).
MAX_STOPS = 128


def path_walk(state, ctrl, sel, cwp, cwl, cwr, stops=None):
    """K8: an L-level path walk in one launch.

    state: int32[16, 8, G]; ctrl: int32[G] packed control bits; sel:
    int32[L, G] packed path bits of each level (1 -> right child); cwp:
    int32[L, 16, 8, KW] correction planes and cwl / cwr: int32[L, KW]
    packed direction words, read at column m % KW. KW = G is the per-seed
    mode (each lane its own key's corrections, the multi-key engine); KW =
    1 with all-ones/all-zeros words (`broadcast_cw_planes`) is one key's
    shared corrections. `stops`: non-decreasing level counts in [0, L]
    (default: (L,)). Returns (states int32[16, 8, S * G], ctrl int32[S *
    G]): column s * G + m holds column m after `stops[s]` levels."""
    if sel.ndim != 2 or cwp.ndim != 4:
        raise ValueError(
            f"sel must be [L, G] and cwp [L, 16, 8, KW], got {tuple(sel.shape)} "
            f"and {tuple(cwp.shape)}")
    levels = sel.shape[0]
    g = state.shape[-1] if state.ndim == 3 else -1
    kw = cwp.shape[-1]
    stops = (levels,) if stops is None else tuple(int(x) for x in stops)
    if not 1 <= len(stops) <= MAX_STOPS or any(
            b < a for a, b in zip((0,) + stops, stops)) or stops[-1] > levels:
        raise ValueError(
            f"stops {stops} must be 1 to {MAX_STOPS} non-decreasing level counts in [0, {levels}]")
    if state.ndim != 3 or tuple(state.shape[:2]) != (16, 8) or kw <= 0 or g % kw:
        raise ValueError(
            f"state must be [16, 8, G] with KW {kw} dividing G, got {tuple(state.shape)}")
    dev = state.device
    _check_words(state, "state", (16, 8, g), dev)
    _check_words(ctrl, "ctrl", (g,), dev)
    _check_words(sel, "sel", (levels, g), dev)
    _check_words(cwp, "correction planes", (levels, 16, 8, kw), dev)
    _check_words(cwl, "left correction words", (levels, kw), dev)
    _check_words(cwr, "right correction words", (levels, kw), dev)
    if dev.type == "cpu":
        return path_walk_plain(state, ctrl, sel, cwp, cwl, cwr, stops)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = cuda_lib.library()
    out = torch.empty((16, 8, len(stops) * g), dtype=torch.int32, device=dev)
    out_ctrl = torch.empty((len(stops) * g,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dpf_path_walk(
            state.data_ptr(), ctrl.data_ptr(), sel.data_ptr(), cwp.data_ptr(),
            cwl.data_ptr(), cwr.data_ptr(), (ctypes.c_int * len(stops))(*stops),
            len(stops), out.data_ptr(), out_ctrl.data_ptr(), g, kw, levels, stream,
        )
    cuda_lib.count("path_level")
    cuda_lib.check(err, "path_level")
    return out, out_ctrl


def path_level(state, ctrl, sel, cwp, cwl, cwr):
    """K8: one path-walk level, the L = 1 walk (`path_walk`).

    state: int32[16, 8, G]; ctrl: int32[G]; sel: int32[G] packed path
    bits; cwp: int32[16, 8, KW]; cwl / cwr: int32[KW]. Returns (state
    int32[16, 8, G], ctrl int32[G])."""
    return path_walk(state, ctrl, sel[None], cwp[None], cwl[None], cwr[None])


def leaf_blocks_plain(values, node_block, num_blocks: int):
    """Plain version of `leaf_blocks`: the limb transpose, then a scatter
    of each kept node's key-major rows into its block."""
    g = values.shape[-1]
    nodes = node_block.shape[0]
    nkp = 32 * g // nodes
    limbs = planes_to_limbs(values).reshape(nodes, nkp, 4)
    keep = (node_block >= 0) & (node_block < num_blocks)
    out = torch.zeros((nkp, num_blocks, 4), dtype=torch.int32, device=values.device)
    out[:, node_block[keep].long()] = limbs[keep].transpose(0, 1)
    return out


def node_blocks(block_node, nodes: int):
    """The inverse of a block -> node map: the block that each of `nodes`
    nodes holds, -1 where none (`leaf_blocks_plain`'s node_block)."""
    held = (block_node >= 0) & (block_node < nodes)
    out = torch.full((nodes,), -1, dtype=torch.int32, device=block_node.device)
    out[block_node[held].long()] = torch.nonzero(held).flatten().to(torch.int32)
    return out


def leaf_blocks(values, block_node, key_groups: int):
    """Selection blocks of an expansion's leaf values.

    values: int32[16, 8, G] leaf planes, node-major (G = nodes *
    key_groups); block_node: int32[B], the node whose leaves block b
    holds, -1 (or any value outside the nodes) for a block that selects
    nothing, each node at most once: the inverse of the expansion's exit
    order, which callers cache per shape. Returns int32[32 KG, B, 4]
    key-major."""
    if values.ndim != 3 or tuple(values.shape[:2]) != (16, 8):
        raise ValueError(f"values must be [16, 8, G], got {tuple(values.shape)}")
    g = values.shape[-1]
    if key_groups <= 0 or g % key_groups:
        raise ValueError(f"{key_groups} key groups must divide the width {g}")
    num_blocks = block_node.shape[0] if block_node.ndim == 1 else -1
    dev = values.device
    _check_words(values, "values", (16, 8, g), dev)
    _check_words(block_node, "block_node", (num_blocks,), dev)
    if dev.type == "cpu":
        return leaf_blocks_plain(values, node_blocks(block_node, g // key_groups),
                                 num_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((32 * key_groups, num_blocks, 4), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dpf_leaf_blocks(values.data_ptr(), block_node.data_ptr(),
                                  out.data_ptr(), g, key_groups, num_blocks, stream)
    cuda_lib.count("leaf_blocks")
    cuda_lib.check(err, "leaf_blocks")
    return out
