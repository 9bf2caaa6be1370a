"""Incremental Distributed Point Functions on PyTorch and CUDA.

The port of the JAX package's `dpf.py`:

* **Key generation** runs on the host, O(tree depth) per key:
  `generate_keys_incremental` for any hierarchy, with Python-int
  arithmetic and the native host library's AES (`native.mmo_hash_bytes`,
  AES-NI; `_mmo_host_plain`, the numpy oracle of `ops/aes.py`, is its
  plain version), and `generate_keys_batch`: the dense-PIR key shape in
  one native batch (`native.py`; its numpy twin
  `_generate_keys_batch_plain` is the plain version the tests hold it
  against), every other single-level shape pair by pair through
  `generate_keys_incremental`, as the JAX package does. `pack_keys` turns
  many keys into host arrays (`HostKeyBatch`), the host half of staging.
* **Evaluation** runs on the device in bit-plane layout (`[16, 8, G]`,
  32 lanes per word, `ops/aes_bitslice.py`):
  - full-domain and subtree expansion (`evaluate_until`, `evaluate_next`)
    runs its narrow first levels (below whole 32-lane words) on the host
    for one key's root and as a K8 walk for seeds on the device, then the
    dense-PIR expansion (`pir/dense_eval_planes.expand_planned`: K2-K6)
    with one key's shared corrections, and leaves plane layout once, in
    natural domain order;
  - path walks (`evaluate_at`, resumed hierarchical evaluation, the
    multi-key engine behind the DCF, and `evaluate_prefixes_batch`, every
    staged key at every prefix of a level, resumed from a `BatchCutState`)
    run every tree level of a walk in one K8 `path_walk` launch, with
    shared or per-seed corrections;
  - leaf values come from K3 `value_hash`, then limb arithmetic on the
    value types (`value_types.py`). A leaf of one 128-bit block is hashed
    at the expansion's exit (K4's or K5's fused hash, or K3 in level
    mode); a leaf of B > 1 blocks (the sampled `IntModNType` and
    `TupleType` values, or a tuple wider than 128 bits) leaves the
    expansion as a seed, and one K3 launch hashes seed + j for j < B, as
    the JAX package does with `fuse = blocks_needed == 1`. Tail mode's K5
    always hashes, so such a level runs tail mode without its tail: K6
    and K2, then K3.
* **EvaluationContext** is the checkpoint of a partially evaluated DPF
  (prefix -> seed, control bit, kept on the device); hierarchical
  evaluation resumes from it. A call copies what it needs to the device
  in one copy before its first launch and copies nothing back.

The device is the constructor's `device` (None: the CUDA card, raising
without one; "cpu" runs the kernels' plain versions). Differences from the
JAX package: no environment switches, no kernel fallback and no jit or
scan (the levels are a Python loop of kernel launches); point and prefix
counts are padded to a multiple of 32 lanes only (the JAX package's
power-of-two buckets bound its compile cache). Control bits are carried
as separate words; in keys they sit in the seed LSBs, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import keys as fixed_keys
from . import native
from .device import resolve_device
from .ops import aes, limb
from .ops.aes_bitslice import (
    broadcast_cw_planes,
    limbs_to_planes,
    limbs_to_planes_np,
    pack_select_bits,
    pack_select_bits_np,
    planes_to_limbs,
    unpack_select_bits,
)
from .ops.expand_planes import path_walk, value_hash
from .ops.words import to_tensors
from .value_types import (
    ValueType,
    XorType,
    _LimbValueType,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_U128_MASK = (1 << 128) - 1


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DpfParameters:
    """Parameters of one hierarchy level."""

    log_domain_size: int
    value_type: ValueType
    security_parameter: float = 0.0  # 0 => default 40 + log_domain_size


@dataclasses.dataclass
class CorrectionWord:
    """Per-tree-level correction."""

    seed: int  # uint128
    control_left: bool
    control_right: bool
    value_correction: Optional[list] = None


@dataclasses.dataclass
class DpfKey:
    """One party's DPF key."""

    seed: int  # uint128
    party: int
    correction_words: List[CorrectionWord]
    last_level_value_correction: list


@dataclasses.dataclass
class PartialEvaluations:
    """(prefix -> seed, control bit) at one tree level. The prefixes are a
    sorted numpy array on the host (a batch's lookup is one
    `searchsorted`); the seeds and control bits stay on the device where
    the walk left them, row `rows[i]` holding the i-th sorted prefix.
    Prefixes wider than 63 bits use an object array."""

    prefixes: np.ndarray  # sorted; uint64 or object
    rows: np.ndarray  # int64[n]
    seeds: torch.Tensor  # int32[n, 4]
    control: torch.Tensor  # int32[n]

    @classmethod
    def build(cls, prefixes_list, seeds: torch.Tensor, control: torch.Tensor):
        wide = any(p > 0x7FFFFFFFFFFFFFFF for p in prefixes_list)
        prefixes = np.array(prefixes_list, dtype=object if wide else np.uint64)
        order = np.argsort(prefixes, kind="stable")
        return cls(prefixes=prefixes[order], rows=order, seeds=seeds, control=control)

    def lookup(self, wanted_list, where: str = "") -> np.ndarray:
        """Rows of `seeds` / `control` holding the `wanted_list` prefixes;
        raises ValueError naming the first missing prefix (and `where`)."""
        wide = self.prefixes.dtype == object
        too_wide = [p for p in wanted_list if not wide and p > 0xFFFFFFFFFFFFFFFF]
        if too_wide:
            raise ValueError(f"prefix {int(too_wide[0])} not present in "
                             f"ctx.partial_evaluations{where}")
        wanted = np.array(wanted_list, dtype=object if wide else np.uint64)
        pos = np.searchsorted(self.prefixes, wanted)
        pos_clipped = np.minimum(pos, len(self.prefixes) - 1)
        ok = (pos < len(self.prefixes)) & (self.prefixes[pos_clipped] == wanted)
        if not np.all(ok):
            missing = wanted[np.argmin(ok)]
            raise ValueError(f"prefix {int(missing)} not present in "
                             f"ctx.partial_evaluations{where}")
        return self.rows[pos_clipped]


@dataclasses.dataclass
class EvaluationContext:
    """Checkpoint of a partially evaluated DPF."""

    key: DpfKey
    previous_hierarchy_level: int = -1
    # (prefix -> seed, control bit) at tree level
    # hierarchy_to_tree[partial_evaluations_level], or None.
    partial_evaluations: Optional[PartialEvaluations] = None
    partial_evaluations_level: int = 0


@dataclasses.dataclass
class StagedKeyBatch:
    """A batch of keys staged on the device once, in the multi-key engine's
    layout: the keys pad to 32G lanes (G word columns), key k in lane k,
    and every tree level's corrections are packed planes, so the whole walk
    is one K8 launch in per-seed mode. Reusable across evaluations (the DCF
    evaluates one batch at many points)."""

    n: int
    parties: torch.Tensor  # int32[32G] (padding lanes 0)
    state: torch.Tensor  # int32[16, 8, G] root seeds
    ctrl: torch.Tensor  # int32[G] packed parties
    cw_planes: torch.Tensor  # int32[L, 16, 8, G], L = tree levels - 1
    cw_left: torch.Tensor  # int32[L, G] packed
    cw_right: torch.Tensor  # int32[L, G] packed
    value_corrections: list  # per hierarchy level: values [32G, epb]

    @classmethod
    def from_lanes(cls, n: int, rows: torch.Tensor, parties, seeds, cw_seeds,
                   cw_left, cw_right, value_corrections) -> "StagedKeyBatch":
        """The batch whose lane i holds key row `rows[i]` (int64[32G]; the
        padding lanes past `n` must pick an all-zero row) of lane-major
        tensors on one device: parties int32[u], seeds int32[u, 4],
        cw_seeds int32[L, u, 4], cw_left / cw_right int32[L, u] (0/1), and
        per hierarchy level a value of batch shape [u, epb]. The gather and
        the packing into plane layout run on that device."""
        levels, g = cw_seeds.shape[0], rows.shape[0] // 32
        parties = parties[rows]
        cw_planes = limbs_to_planes(cw_seeds[:, rows].reshape(-1, 4).contiguous())

        def words(w):
            return pack_select_bits(w[:, rows].reshape(-1)).reshape(levels, g)

        return cls(n, parties, limbs_to_planes(seeds[rows].contiguous()),
                   pack_select_bits(parties),
                   cw_planes.reshape(16, 8, levels, g).permute(2, 0, 1, 3).contiguous(),
                   words(cw_left), words(cw_right),
                   [tree_map(lambda v: v[rows], vc) for vc in value_corrections])

    def repeat(self, times: int) -> "StagedKeyBatch":
        """Each key `times` times in a row (key k in lanes k * times to
        (k + 1) * times - 1), on the device: the packed planes and words
        are unpacked to lanes and packed again by `from_lanes` (32 keys
        share a packed word, so repeating the words would not repeat
        keys)."""
        if times < 1:
            raise ValueError("times must be at least 1")
        n = self.n * times
        width = self.parties.shape[0]  # its lanes; one zero row after them
        rows = torch.full((_pad32(n),), width, dtype=torch.int64, device=self.parties.device)
        rows[:n] = torch.arange(self.n, device=rows.device).repeat_interleave(times)
        levels, g = self.cw_left.shape

        def zero_row(x):
            return F.pad(x, (0, 0) * (x.ndim - 1) + (0, 1))

        def lanes(w):  # packed words [L, G] -> lanes [L, 32G + 1]
            return F.pad(unpack_select_bits(w.reshape(-1)).reshape(levels, 32 * g), (0, 1))

        cw_limbs = planes_to_limbs(self.cw_planes.permute(1, 2, 0, 3).reshape(16, 8, levels * g))
        return StagedKeyBatch.from_lanes(
            n, rows, zero_row(self.parties), zero_row(planes_to_limbs(self.state)),
            F.pad(cw_limbs.reshape(levels, 32 * g, 4), (0, 0, 0, 1)),
            lanes(self.cw_left), lanes(self.cw_right),
            [tree_map(zero_row, vc) for vc in self.value_corrections])


@dataclasses.dataclass
class HostKeyBatch:
    """Many keys of one DPF as host arrays, the host half of
    `stage_key_batch` (`DistributedPointFunction.pack_keys`): root seeds
    uint32[n, 4], parties uint32[n], cw_seeds uint32[L, n, 4], cw_left /
    cw_right uint32[L, n] (0/1), and per hierarchy level the value
    corrections, a value of batch shape [n, epb] (uint32[n, epb, nlimbs],
    a tuple of them for a tuple type). Numpy arrays pickle in bulk, so
    worker processes that make keys hand them back this way."""

    seeds: np.ndarray
    parties: np.ndarray
    cw_seeds: np.ndarray
    cw_left: np.ndarray
    cw_right: np.ndarray
    value_corrections: list

    def __len__(self) -> int:
        return self.seeds.shape[0]

    @classmethod
    def concat(cls, batches: Sequence["HostKeyBatch"]) -> "HostKeyBatch":
        """The keys of `batches`, in order, as one batch."""
        return cls(
            np.concatenate([b.seeds for b in batches]),
            np.concatenate([b.parties for b in batches]),
            np.concatenate([b.cw_seeds for b in batches], axis=1),
            np.concatenate([b.cw_left for b in batches], axis=1),
            np.concatenate([b.cw_right for b in batches], axis=1),
            [tree_map(lambda *xs: np.concatenate(xs), *[b.value_corrections[hl]
                                                       for b in batches])
             for hl in range(len(batches[0].value_corrections))])


@dataclasses.dataclass
class BatchCutState:
    """The walk states of MANY keys at one hierarchy level: for every
    (key, prefix) pair the seed and control bit before the value hash, at
    the level's tree level (the JAX package's `BatchCutState`).
    `evaluate_prefixes_batch` returns one after every level, so the next
    level walks only the new tree levels, from any subset's children.

    They stay on the device in the layout the walk reads and writes, so a
    resumed level costs no bit transpose: prefix-major planes, the
    batch's Kpad = 32 KW keys in the word columns of each prefix (column
    p * KW + w holds keys 32w to 32w + 31 at prefix p). `seeds` and
    `control` give the JAX package's [num_keys, num_prefixes] view."""

    hierarchy_level: int
    prefixes: np.ndarray  # sorted domain indices; uint64 or object
    state: torch.Tensor  # int32[16, 8, P * KW] seed planes
    ctrl: torch.Tensor  # int32[P * KW] packed control bits
    num_keys: int

    @classmethod
    def build(cls, hierarchy_level: int, prefixes: Sequence[int], state: torch.Tensor,
              ctrl: torch.Tensor, num_keys: int) -> "BatchCutState":
        """The state of ascending int `prefixes`, held as uint64, or as
        objects where one is above 2^63 - 1."""
        wide = prefixes[-1] > 0x7FFFFFFFFFFFFFFF
        return cls(hierarchy_level, np.array(prefixes, dtype=object if wide else np.uint64),
                   state, ctrl, num_keys)

    def __len__(self) -> int:
        return len(self.prefixes)

    @property
    def seeds(self) -> torch.Tensor:
        """int32[num_keys, num_prefixes, 4] limbs."""
        limbs = planes_to_limbs(self.state).reshape(len(self), -1, 4)
        return limbs[:, :self.num_keys].transpose(0, 1)

    @property
    def control(self) -> torch.Tensor:
        """int32[num_keys, num_prefixes] 0/1."""
        bits = unpack_select_bits(self.ctrl).reshape(len(self), -1)
        return bits[:, :self.num_keys].transpose(0, 1)

    @property
    def nbytes(self) -> int:
        """Device bytes the state holds."""
        return (self.state.numel() + self.ctrl.numel()) * 4

    def positions(self, wanted_list) -> np.ndarray:
        """Positions of `wanted_list` prefixes in this state; raises
        ValueError naming the first missing one."""
        wide = self.prefixes.dtype == object
        wanted = np.array(wanted_list, dtype=object if wide else np.uint64)
        pos = np.searchsorted(self.prefixes, wanted)
        pos_clipped = np.minimum(pos, len(self.prefixes) - 1)
        ok = (pos < len(self.prefixes)) & (self.prefixes[pos_clipped] == wanted)
        if not np.all(ok):
            missing = wanted[np.argmin(ok)]
            raise ValueError(
                f"prefix {int(missing)} not present in cut state at "
                f"hierarchy level {self.hierarchy_level}")
        return pos_clipped.astype(np.int64)


# ---------------------------------------------------------------------------
# Host-side AES helpers (numpy oracle)
# ---------------------------------------------------------------------------


# The host MMO's fixed keys, by `native.mmo_hash`'s index.
_HOST_LEFT, _HOST_RIGHT, _HOST_VALUE = 0, 1, 2
_HOST_ROUND_KEYS = (fixed_keys.RK_LEFT, fixed_keys.RK_RIGHT, fixed_keys.RK_VALUE)


def _mmo_host(which: int, xs: Sequence[int]) -> List[int]:
    """MMO hash of 128-bit ints with fixed key `which` (0 left, 1 right,
    2 value) on the native host library (`native.mmo_hash`, AES-NI).
    Key generation's AES; `_mmo_host_plain` is its numpy version."""
    out = native.mmo_hash_bytes(which, b"".join(x.to_bytes(16, "little") for x in xs))
    return [int.from_bytes(out[i:i + 16], "little") for i in range(0, len(out), 16)]


def _mmo_host_plain(which: int, xs: Sequence[int]) -> List[int]:
    """`_mmo_host` with the numpy AES oracle (`ops/aes.py`)."""
    blocks = np.stack([aes.u128_to_limbs(x) for x in xs])
    out = aes.mmo_hash_np(_HOST_ROUND_KEYS[which], blocks)
    return [aes.limbs_to_u128(out[i]) for i in range(out.shape[0])]


def _value_hash_bytes_host(seed: int, num_blocks: int) -> bytes:
    xs = [(seed + j) & _U128_MASK for j in range(num_blocks)]
    outs = _mmo_host(_HOST_VALUE, xs)
    return b"".join(x.to_bytes(16, "little") for x in outs)


_CLEAR_LSB = np.array([0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF],
                      dtype=np.uint32)


def _expand_level_host(seeds, control, cw_seed, cw_left, cw_right):
    """One doubling level on the host (numpy MMO), children interleaved
    (left of seed i at 2i, right at 2i + 1): the JAX package's
    `_expand_level_body`."""
    n = seeds.shape[0]
    left = aes.mmo_hash_np(fixed_keys.RK_LEFT, seeds)
    right = aes.mmo_hash_np(fixed_keys.RK_RIGHT, seeds)
    h = np.stack([left, right], axis=1).reshape(2 * n, 4)
    c2 = np.repeat(control, 2)
    h ^= np.where(c2[:, None] != 0, cw_seed[None, :], 0).astype(np.uint32)
    t = h[:, 0] & np.uint32(1)
    h &= _CLEAR_LSB
    cw_dir = np.tile(np.array([cw_left, cw_right], dtype=np.uint32), n)
    return h, t ^ (c2 & cw_dir)


def _path_bits(paths: np.ndarray, bit_indices: Sequence[int]) -> np.ndarray:
    """uint32[L, n]: bit `bit_indices[j]` of each uint32[n, 4] path (0 past
    bit 127, as the reference's DCF shifted paths need)."""
    out = np.zeros((len(bit_indices), paths.shape[0]), dtype=np.uint32)
    for j, b in enumerate(bit_indices):
        if b < 128:
            out[j] = (paths[:, b >> 5] >> np.uint32(b & 31)) & np.uint32(1)
    return out


def point_bits(points: torch.Tensor, bit_indices: Sequence[int]) -> torch.Tensor:
    """`_path_bits` on the device: int32[L, n] 0/1, bit `bit_indices[j]` of
    each int32[n, 4] point (0 past bit 127). One gather for all levels, so
    a batch's path bits cost the host nothing per point."""
    idx = np.asarray(bit_indices, dtype=np.int64).reshape(-1)
    inside = idx < 128
    cols = torch.from_numpy(np.where(inside, idx >> 5, 0)).to(points.device)
    shifts = torch.from_numpy(np.where(inside, idx & 31, 0).astype(np.int32)).to(points.device)
    keep = torch.from_numpy(inside.astype(np.int32)).to(points.device)
    return ((points[:, cols] >> shifts) & keep).T.contiguous()


def points_to_limbs(points: Sequence[int], rows: int) -> np.ndarray:
    """uint32[rows, 4] limbs of the 128-bit `points` (ints, or a numpy
    uint64 array), zero rows after them."""
    out = np.zeros((rows, 4), dtype=np.uint32)
    if isinstance(points, np.ndarray) and points.dtype == np.uint64:
        out[:len(points), 0] = points & np.uint64(0xFFFFFFFF)
        out[:len(points), 1] = points >> np.uint64(32)
        return out
    data = b"".join(int(p).to_bytes(16, "little") for p in points)
    out[:len(points)] = np.frombuffer(data, dtype="<u4").reshape(-1, 4)
    return out


def distinct_rows(items) -> Tuple[list, np.ndarray]:
    """(the distinct objects of `items` by identity, in first-seen order;
    int64[len(items)] the row of each item among them): a batch that
    repeats a key reads it once."""
    rows: Dict[int, int] = {}
    uniq = []
    index = np.empty(len(items), dtype=np.int64)
    for i, item in enumerate(items):
        row = rows.get(id(item))
        if row is None:
            row = rows[id(item)] = len(uniq)
            uniq.append(item)
        index[i] = row
    return uniq, index


def _pad32(n: int) -> int:
    return max(32, -(-n // 32) * 32)


def _to_device(dev, *groups: dict) -> List[dict]:
    """Groups of named numpy arrays (or tuples of them, a tuple type's
    values) -> the same names as int32 tensors on `dev`, moved in ONE
    host-to-device copy. Every evaluation stages all it needs before its
    first launch: a blocking copy queued behind launches would wait for
    them."""
    tensors = iter(to_tensors(
        [leaf for g in groups for a in g.values() for leaf in tree_leaves(a)], dev))
    return [{name: tree_unflatten(a, tensors) for name, a in g.items()} for g in groups]


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


def _eval_paths(state, ctrl, sel, cwp, cwl, cwr):
    """Walk L tree levels of every lane's path in one K8 launch (none for
    L = 0).

    state int32[16, 8, G] and ctrl int32[G] (packed); sel int32[L, G]
    packed path bits; cwp int32[L, 16, 8, KW] and cwl / cwr int32[L, KW]
    with KW = 1 (one key's shared corrections) or G (per seed). The walk
    stays in plane layout; callers enter and leave it once."""
    if sel.shape[0] == 0:
        return state, ctrl
    return path_walk(state, ctrl, sel, cwp, cwl, cwr)


def _walk_shared(state, ctrl, t: dict):
    """`_eval_paths` with one key's corrections, from the staged `t`:
    "sel" int32[L, G] packed path bits, "cw" int32[L, 4] and "cwl" /
    "cwr" int32[L] (0/1)."""
    return _eval_paths(state, ctrl, t["sel"], broadcast_cw_planes(t["cw"]),
                       -t["cwl"][:, None], -t["cwr"][:, None])


def _hash_planes(state: torch.Tensor) -> torch.Tensor:
    """The MMO value hash of every lane of int32[16, 8, G] planes: K3
    `value_hash` with zero corrections."""
    dev = state.device
    return value_hash(state, torch.zeros((state.shape[-1],), dtype=torch.int32, device=dev),
                      torch.zeros((16, 8, 1), dtype=torch.int32, device=dev))


def _value_hash(seeds: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """H_value(seed + j) for j < num_blocks: int32[..., 4] ->
    int32[..., num_blocks, 4] (the output PRG of the reference's
    `HashExpandedSeeds`), in plane layout through K3."""
    blocks = torch.stack(
        [seeds if j == 0 else limb.add_scalar(seeds, j) for j in range(num_blocks)],
        dim=-2)
    flat = blocks.reshape(-1, 4)
    n = flat.shape[0]
    flat = F.pad(flat, (0, 0, 0, _pad32(n) - n))
    hashed = _hash_planes(limbs_to_planes(flat.contiguous()))
    return planes_to_limbs(hashed)[:n].reshape(blocks.shape)


def _leaf_stage_at(blocks, control, vc, block_indices, vtype, party):
    """Leaf values at given block indices (point evaluation).

    blocks int32[..., B, 4] value-hashed leaf blocks (`_value_hash`);
    control int32[...]; vc a value of batch shape [..., epb] (or [epb],
    shared); block_indices int64[...]. Returns a value of batch shape
    [...]; `party` 1 negates, -1 leaves negation to the caller (per key)."""
    values = vtype.dev_from_value_blocks(blocks)
    picked = vtype.dev_take_element(values, block_indices)
    vc_picked = vtype.dev_take_element(
        tree_map(lambda c, v: c.expand(v.shape), vc, values), block_indices)
    corrected = vtype.dev_where(control != 0, vtype.dev_add(picked, vc_picked), picked)
    if party == 1:
        corrected = vtype.dev_neg(corrected)
    return corrected


def _leaf_stage(blocks, control, vc, vtype, cepb, party):
    """Value-hashed leaf blocks int32[n, B, 4] -> corrected values of batch
    shape [n * cepb] in domain order: the first `cepb` elements of each
    leaf, the value correction (a value of batch shape [epb]) where the
    control bit is set, and party 1's negation."""
    values = tree_map(lambda x: x[:, :cepb], vtype.dev_from_value_blocks(blocks))
    vc = tree_map(lambda c, v: c[:cepb].expand(v.shape), vc, values)
    mask = (control != 0)[:, None].expand(blocks.shape[0], cepb)
    corrected = vtype.dev_where(mask, vtype.dev_add(values, vc), values)
    if party == 1:
        corrected = vtype.dev_neg(corrected)
    return tree_map(lambda x: x.reshape(-1, x.shape[-1]), corrected)


# ---------------------------------------------------------------------------
# The DPF itself
# ---------------------------------------------------------------------------


class DistributedPointFunction:
    """Incremental DPF with hierarchical evaluation.

    Create with `create` (single hierarchy level) or `create_incremental`.
    `device` is where evaluation runs (None: the CUDA card). Value types:
    any of `value_types.py`; a `TupleType` level's values are tuples of
    limb tensors.
    """

    # The kernels of subtree expansion: None is the dense-PIR default
    # (`pir/dense_eval_planes.DEFAULT_EXPANSION`); the tests and
    # chip_smoke.py set another mode on an instance to drive its kernels.
    # Every mode gives the same values.
    _expansion: Optional[str] = None

    def __init__(self, parameters: Sequence[DpfParameters], *, device=None):
        self.device = device
        parameters = list(parameters)
        if not parameters:
            raise ValueError("parameters must not be empty")
        resolved = []
        prev_lds = 0
        for i, p in enumerate(parameters):
            if not isinstance(p.value_type, ValueType):
                raise TypeError(f"value_type must be a ValueType, got {p.value_type!r}")
            if p.log_domain_size < 0 or p.log_domain_size > 128:
                raise ValueError("log_domain_size must be in [0, 128]")
            if i > 0 and p.log_domain_size <= prev_lds:
                raise ValueError("log_domain_size must be strictly ascending")
            prev_lds = p.log_domain_size
            sec = p.security_parameter
            if sec != 0.0 and not (0 <= sec <= 128):
                raise ValueError("security_parameter must be in [0, 128]")
            if sec == 0.0:
                sec = 40 + p.log_domain_size
            resolved.append(DpfParameters(p.log_domain_size, p.value_type, sec))
        self.parameters = resolved

        # Hierarchy -> tree level mapping: packed value types shorten the
        # tree by up to 7 levels.
        self._hierarchy_to_tree: List[int] = []
        self._tree_to_hierarchy: Dict[int, int] = {}
        self._bits_needed: List[int] = []
        tree_levels_needed = 0
        for i, p in enumerate(self.parameters):
            bits = p.value_type.bits_needed(p.security_parameter)
            self._bits_needed.append(bits)
            log_bits = max(0, (bits - 1).bit_length())  # ceil(log2(bits))
            tree_level = max(
                tree_levels_needed, p.log_domain_size - 7 + min(log_bits, 7)
            )
            self._tree_to_hierarchy[tree_level] = i
            self._hierarchy_to_tree.append(tree_level)
            tree_levels_needed = max(tree_levels_needed, tree_level + 1)
        self._tree_levels_needed = tree_levels_needed
        # A sampled type reads 16 bytes plus a refill for every tuple
        # element but the last, which is more than `bits_needed` counts
        # where an IntModN that is not last refills (the JAX package reads
        # past its blocks there): the blocks cover what the sampling reads.
        # The tree level does not move: any IntModN needs 7 levels of bits.
        self._blocks_needed = [
            max((b + 127) // 128,
                0 if p.value_type.can_convert_directly()
                else -(-(16 + p.value_type.refill_bytes(False)) // 16))
            for p, b in zip(self.parameters, self._bits_needed)]

    # -- constructors -------------------------------------------------------

    @classmethod
    def create(cls, parameters: DpfParameters, *, device=None) -> "DistributedPointFunction":
        return cls([parameters], device=device)

    @classmethod
    def create_incremental(cls, parameters: Sequence[DpfParameters], *,
                           device=None) -> "DistributedPointFunction":
        return cls(parameters, device=device)

    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    # -- key generation (host) ---------------------------------------------

    def generate_keys(self, alpha: int, beta) -> Tuple[DpfKey, DpfKey]:
        """Single-hierarchy-level key generation."""
        if len(self.parameters) != 1:
            raise ValueError(
                "generate_keys requires exactly one hierarchy level; use "
                "generate_keys_incremental")
        return self.generate_keys_incremental(alpha, [beta])

    def generate_keys_batch(
        self, alphas: Sequence[int], betas: Sequence, _root_seeds=None
    ) -> Tuple[List[DpfKey], List[DpfKey]]:
        """Generate key pairs for many (alpha, beta) points at once.

        The dense-PIR key shape (one hierarchy level, `XorType(128)`,
        domain <= 2^63) runs on the native host library
        (`native.keygen_batch_dense`: all keys' tree levels in lockstep,
        AES-NI batched over both parties' seeds); every other shape makes
        its pairs one at a time with `generate_keys_incremental`, chosen by
        shape up front, as the JAX package does.

        `_root_seeds` (uint32[2, n, 4]) injects the two parties' root
        seeds, so tests can hold the keys against the JAX package's and
        against the numpy plain version (`_generate_keys_batch_plain`);
        otherwise they are drawn from `secrets`.
        """
        if not self._dense_batch_shape():
            if len(betas) != len(alphas):
                raise ValueError("alphas and betas must have the same length")
            roots = [None] * len(alphas)
            if _root_seeds is not None:
                raw = np.asarray(_root_seeds, dtype=np.uint32)
                roots = [(aes.limbs_to_u128(raw[0, i]), aes.limbs_to_u128(raw[1, i]))
                         for i in range(len(alphas))]
            pairs = [self.generate_keys_incremental(a, [b], _root_seeds=r)
                     for a, b, r in zip(alphas, betas, roots)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        raw, alphas_np, beta_limbs, num_cw = self._batch_inputs(
            alphas, betas, _root_seeds)
        n = alphas_np.shape[0]
        cw8, ctrl8, vc8 = native.keygen_batch_dense(
            raw.view(np.uint8).reshape(2, n, 16), alphas_np,
            beta_limbs.view(np.uint8), num_cw)
        return self._assemble_dense_keys(
            raw, cw8.view("<u4").reshape(num_cw, n, 4), ctrl8[..., 0],
            ctrl8[..., 1], vc8.view("<u4"))

    def _dense_batch_shape(self) -> bool:
        """Whether this DPF has the dense-PIR key shape that the native
        batch generates: one hierarchy level, `XorType(128)`, domain <=
        2^63."""
        vt = self.parameters[0].value_type
        return (len(self.parameters) == 1 and isinstance(vt, XorType)
                and vt.bits == 128 and self._blocks_needed[0] == 1
                and self.parameters[-1].log_domain_size <= 63)

    def _batch_inputs(self, alphas, betas, _root_seeds):
        """Validate a dense-PIR key batch: (root seeds uint32[2, n, 4],
        alphas uint64[n], betas uint32[n, 4], correction levels)."""
        n = len(alphas)
        if len(betas) != n:
            raise ValueError("alphas and betas must have the same length")
        vt = self.parameters[0].value_type
        lds = self.parameters[-1].log_domain_size
        if not self._dense_batch_shape():
            raise NotImplementedError(
                "the native key batch supports the dense-PIR key shape only "
                "(one hierarchy level, XorType(128), domain <= 2^63)")
        for a in alphas:
            if not isinstance(a, (int, np.integer)):
                raise TypeError(f"alpha must be an integer, got {type(a)}")
            if not (0 <= a < (1 << lds)):
                raise ValueError("alpha out of domain range")
        alphas_np = np.asarray([int(a) for a in alphas], dtype=np.uint64)
        for b in betas:
            vt.validate(b)
        if _root_seeds is not None:
            raw = np.ascontiguousarray(_root_seeds, dtype="<u4")
        else:
            raw = np.frombuffer(
                secrets.token_bytes(16 * 2 * n), dtype="<u4"
            ).reshape(2, n, 4).copy()
        beta_limbs = aes.u128s_to_limbs([int(b) for b in betas])
        return raw, alphas_np, beta_limbs, self._tree_levels_needed - 1

    def _generate_keys_batch_plain(
        self, alphas: Sequence[int], betas: Sequence, _root_seeds=None
    ) -> Tuple[List[DpfKey], List[DpfKey]]:
        """`generate_keys_batch` in numpy: one batched numpy AES call per
        (level, PRG key). The plain version the tests hold the native
        keygen against; no serving path calls it."""
        raw, alphas_np, beta_limbs, num_cw = self._batch_inputs(
            alphas, betas, _root_seeds)
        n = alphas_np.shape[0]
        lds = self.parameters[-1].log_domain_size

        seeds = [raw[0], raw[1]]  # per party: uint32[n, 4]
        control = [
            np.zeros(n, dtype=np.uint32),
            np.ones(n, dtype=np.uint32),
        ]
        cw_seeds = np.zeros((num_cw, n, 4), dtype=np.uint32)
        cw_lefts = np.zeros((num_cw, n), dtype=np.uint32)
        cw_rights = np.zeros((num_cw, n), dtype=np.uint32)

        for tree_level in range(1, self._tree_levels_needed):
            both = np.concatenate(seeds, axis=0)  # [2n, 4]
            l = aes.mmo_hash_np(fixed_keys.RK_LEFT, both)
            r = aes.mmo_hash_np(fixed_keys.RK_RIGHT, both)
            t_l = l[:, 0] & 1
            t_r = r[:, 0] & 1
            l[:, 0] &= 0xFFFFFFFE
            r[:, 0] &= 0xFFFFFFFE
            l0, l1 = l[:n], l[n:]
            r0, r1 = r[:n], r[n:]

            bit_pos = lds - tree_level
            bit = ((alphas_np >> np.uint64(bit_pos)) & np.uint64(1)).astype(
                np.uint32
            )
            bitc = bit[:, None]
            # lose = 1 - bit: the branch alpha does NOT take.
            cw_seed = np.where(bitc != 0, l0 ^ l1, r0 ^ r1)
            cw_left = t_l[:n] ^ t_l[n:] ^ bit ^ 1
            cw_right = t_r[:n] ^ t_r[n:] ^ bit
            cw_keep = np.where(bit != 0, cw_right, cw_left)

            new_seeds = []
            new_control = []
            for b in (0, 1):
                keep_seed = np.where(bitc != 0, (r0, r1)[b], (l0, l1)[b])
                keep_t = np.where(
                    bit != 0,
                    t_r[b * n : (b + 1) * n],
                    t_l[b * n : (b + 1) * n],
                )
                new_seeds.append(keep_seed ^ (control[b][:, None] * cw_seed))
                new_control.append(keep_t ^ (control[b] & cw_keep))
            seeds, control = new_seeds, new_control
            lvl = tree_level - 1
            cw_seeds[lvl], cw_lefts[lvl], cw_rights[lvl] = (
                cw_seed, cw_left, cw_right,
            )

        # Last-level value correction: H_value(s1) ^ H_value(s0) ^ beta at
        # alpha's block position (both group ops are XOR for 128-bit XOR
        # shares, and party negation is the identity).
        ha = aes.mmo_hash_np(fixed_keys.RK_VALUE, seeds[0])
        hb = aes.mmo_hash_np(fixed_keys.RK_VALUE, seeds[1])
        vc = ha ^ hb ^ beta_limbs
        return self._assemble_dense_keys(raw, cw_seeds, cw_lefts, cw_rights, vc)

    def _assemble_dense_keys(self, raw, cw_seeds, cw_lefts, cw_rights, vc):
        """Both parties' `DpfKey`s from the batch's arrays: raw uint32[2, n,
        4], cw_seeds uint32[L, n, 4], cw_lefts / cw_rights [L, n] (0/1),
        vc uint32[n, 4]."""
        n = raw.shape[1]
        num_cw = cw_seeds.shape[0]
        roots = [aes.limbs_to_u128s(raw[0]), aes.limbs_to_u128s(raw[1])]
        # Key-major: key i's levels are entries i * L ... i * L + L - 1.
        cw_ints = aes.limbs_to_u128s(np.swapaxes(cw_seeds, 0, 1))
        lefts = np.asarray(cw_lefts).astype(bool).T.ravel().tolist()
        rights = np.asarray(cw_rights).astype(bool).T.ravel().tolist()
        vcs = aes.limbs_to_u128s(vc)
        keys0: List[DpfKey] = []
        keys1: List[DpfKey] = []
        for i in range(n):
            lo = i * num_cw
            for party, out in ((0, keys0), (1, keys1)):
                out.append(DpfKey(
                    seed=roots[party][i],
                    party=party,
                    correction_words=[
                        CorrectionWord(seed=s, control_left=cl, control_right=cr)
                        for s, cl, cr in zip(cw_ints[lo:lo + num_cw],
                                             lefts[lo:lo + num_cw],
                                             rights[lo:lo + num_cw])
                    ],
                    last_level_value_correction=[vcs[i]],
                ))
        return keys0, keys1

    def generate_keys_incremental(
        self, alpha: int, betas: Sequence, _root_seeds=None
    ) -> Tuple[DpfKey, DpfKey]:
        """The two parties' keys for point `alpha` with one value per
        hierarchy level, by the reference's `GenerateNext` recurrence (the
        value correction of an output level comes from the seeds before
        that level's expansion). `_root_seeds` (two uint128 ints) injects
        the parties' root seeds for tests; otherwise they come from
        `secrets.randbits`."""
        if len(betas) != len(self.parameters):
            raise ValueError("betas must have one entry per hierarchy level")
        for p, b in zip(self.parameters, betas):
            p.value_type.validate(b)
        last_lds = self.parameters[-1].log_domain_size
        if not (0 <= alpha < (1 << last_lds)):
            raise ValueError("alpha out of domain range")

        if _root_seeds is not None:
            root_seeds = [int(s) & _U128_MASK for s in _root_seeds]
        else:
            root_seeds = [secrets.randbits(128), secrets.randbits(128)]
        seeds = list(root_seeds)
        control = [0, 1]
        correction_words: List[CorrectionWord] = []

        for tree_level in range(1, self._tree_levels_needed):
            value_correction = None
            if (tree_level - 1) in self._tree_to_hierarchy:
                hl = self._tree_to_hierarchy[tree_level - 1]
                value_correction = self._compute_value_correction(
                    hl, seeds, alpha, betas[hl], invert=bool(control[1]))
            # Expand both parties' seeds left and right.
            l0, l1 = _mmo_host(_HOST_LEFT, seeds)
            r0, r1 = _mmo_host(_HOST_RIGHT, seeds)
            t = [[l0 & 1, l1 & 1], [r0 & 1, r1 & 1]]  # [branch][party]
            expanded = [[l0 & ~1, l1 & ~1], [r0 & ~1, r1 & ~1]]

            bit_pos = last_lds - tree_level
            current_bit = (alpha >> bit_pos) & 1 if bit_pos < 128 else 0
            keep, lose = current_bit, 1 - current_bit

            cw_seed = expanded[lose][0] ^ expanded[lose][1]
            cw_control = [
                t[0][0] ^ t[0][1] ^ current_bit ^ 1,  # left
                t[1][0] ^ t[1][1] ^ current_bit,  # right
            ]
            new_seeds = [expanded[keep][b] ^ (cw_seed if control[b] else 0)
                         for b in (0, 1)]
            new_control = [t[keep][b] ^ (control[b] & cw_control[keep])
                           for b in (0, 1)]
            correction_words.append(CorrectionWord(
                seed=cw_seed,
                control_left=bool(cw_control[0]),
                control_right=bool(cw_control[1]),
                value_correction=value_correction,
            ))
            seeds, control = new_seeds, new_control

        last_vc = self._compute_value_correction(
            len(self.parameters) - 1, seeds, alpha, betas[-1],
            invert=bool(control[1]))
        key0 = DpfKey(seed=root_seeds[0], party=0,
                      correction_words=correction_words,
                      last_level_value_correction=list(last_vc))
        key1 = DpfKey(
            seed=root_seeds[1], party=1,
            correction_words=[
                CorrectionWord(cw.seed, cw.control_left, cw.control_right,
                               None if cw.value_correction is None
                               else list(cw.value_correction))
                for cw in correction_words
            ],
            last_level_value_correction=list(last_vc),
        )
        return key0, key1

    def _compute_value_correction(self, hierarchy_level: int, seeds: Sequence[int],
                                  alpha: int, beta, invert: bool) -> list:
        """Value correction at an output level (the reference's
        `ComputeValueCorrection`)."""
        p = self.parameters[hierarchy_level]
        num_blocks = self._blocks_needed[hierarchy_level]
        bytes_a = _value_hash_bytes_host(seeds[0], num_blocks)
        bytes_b = _value_hash_bytes_host(seeds[1], num_blocks)
        shift = self.parameters[-1].log_domain_size - p.log_domain_size
        alpha_prefix = alpha >> shift if shift < 128 else 0
        index_in_block = self._domain_to_block_index(alpha_prefix, hierarchy_level)
        vt = p.value_type
        if vt.can_convert_directly():
            ebytes = (vt.total_bit_size() + 7) // 8
            ints_a = [vt.parse_direct(bytes_a, i * ebytes)
                      for i in range(vt.elements_per_block())]
            ints_b = [vt.parse_direct(bytes_b, i * ebytes)
                      for i in range(vt.elements_per_block())]
        else:  # sampled: one element from the B blocks
            ints_a, ints_b = [vt.from_bytes(bytes_a)], [vt.from_bytes(bytes_b)]
        ints_b[index_in_block] = vt.add(ints_b[index_in_block], beta)
        out = []
        for a, b in zip(ints_a, ints_b):
            c = vt.sub(b, a)
            out.append(vt.neg(c) if invert else c)
        return out

    # -- staging --------------------------------------------------------------

    def create_evaluation_context(self, key: DpfKey) -> EvaluationContext:
        self._validate_key(key)
        return EvaluationContext(key=key)

    def _validate_key(self, key: DpfKey) -> None:
        if key.party not in (0, 1):
            raise ValueError("key.party must be 0 or 1")
        if len(key.correction_words) != self._tree_levels_needed - 1:
            raise ValueError(
                f"key has {len(key.correction_words)} correction words, "
                f"expected {self._tree_levels_needed - 1}")

    def _stage_correction_words(self, key: DpfKey, start: int, stop: int):
        """Correction words [start, stop) as numpy arrays: seeds
        uint32[L, 4], control_left / control_right uint32[L] (0/1)."""
        cws = key.correction_words[start:stop]
        cw_seeds = np.zeros((len(cws), 4), dtype=np.uint32)
        for i, cw in enumerate(cws):
            cw_seeds[i] = aes.u128_to_limbs(cw.seed)
        cw_left = np.array([cw.control_left for cw in cws], dtype=np.uint32)
        cw_right = np.array([cw.control_right for cw in cws], dtype=np.uint32)
        return cw_seeds, cw_left, cw_right

    def _value_correction_host(self, key: DpfKey, hierarchy_level: int):
        """The hierarchy level's value-correction host values (length epb):
        stored in the correction word at the level's tree level, except for
        the last hierarchy level, which has its own key field."""
        if hierarchy_level < len(self.parameters) - 1:
            return key.correction_words[
                self._hierarchy_to_tree[hierarchy_level]].value_correction
        return key.last_level_value_correction

    def _value_correction_np(self, key: DpfKey, hierarchy_level: int):
        """The level's value correction as limbs uint32[epb, nlimbs] (a
        tuple of them for a tuple type)."""
        vt = self.parameters[hierarchy_level].value_type
        vc = self._value_correction_host(key, hierarchy_level)
        return tree_map(lambda *xs: np.stack(xs), *[vt.host_const(v) for v in vc])

    def pack_keys(self, keys: Sequence[DpfKey]) -> HostKeyBatch:
        """The keys' fields as host arrays, each field of all keys in one
        conversion (a limb value type's corrections included; a tuple
        type's go key by key)."""
        n, num_cw = len(keys), self._tree_levels_needed - 1
        for key in keys:
            self._validate_key(key)
        seeds = aes.u128s_to_limbs([k.seed for k in keys]).reshape(n, 4)
        parties = np.array([k.party for k in keys], dtype=np.uint32)
        cws = [cw for k in keys for cw in k.correction_words]
        cw_seeds = aes.u128s_to_limbs([cw.seed for cw in cws]).reshape(n, num_cw, 4)
        flags = np.array([(cw.control_left, cw.control_right) for cw in cws],
                         dtype=np.uint32).reshape(n, num_cw, 2)
        vcs = []
        for hl, p in enumerate(self.parameters):
            vt = p.value_type
            if isinstance(vt, _LimbValueType):
                nl, mask = vt.nlimbs, (1 << (32 * vt.nlimbs)) - 1
                data = b"".join((int(v) & mask).to_bytes(4 * nl, "little")
                                for k in keys
                                for v in self._value_correction_host(k, hl))
                vcs.append(np.frombuffer(data, dtype="<u4").astype(np.uint32).reshape(
                    n, vt.elements_per_block(), nl))
            else:
                vcs.append(tree_map(lambda *xs: np.stack(xs),
                                    *[self._value_correction_np(k, hl) for k in keys]))
        return HostKeyBatch(seeds, parties,
                            np.ascontiguousarray(cw_seeds.transpose(1, 0, 2)),
                            np.ascontiguousarray(flags[..., 0].T),
                            np.ascontiguousarray(flags[..., 1].T), vcs)

    def stage_key_batch(self, keys) -> StagedKeyBatch:
        """Stage a batch of keys (a sequence of `DpfKey`s, or a
        `HostKeyBatch`) on the device in ONE host-to-device copy: the
        distinct key objects' arrays (`pack_keys`; a key repeated in the
        batch is read once), a zero row for the padding lanes, and each
        lane's row index move together; the gather into lanes and the
        packing into plane layout run on the device
        (`StagedKeyBatch.from_lanes`). Reusable by any number of
        `evaluate_and_apply` / `evaluate_and_accumulate` /
        `evaluate_prefixes_batch` calls."""
        dev = self._dev()
        n = len(keys)
        if n == 0:
            raise ValueError("keys must not be empty")
        if isinstance(keys, HostKeyBatch):
            host, rows = keys, np.arange(n)
        else:
            uniq, rows = distinct_rows(keys)
            host = self.pack_keys(uniq)
        u = len(host)

        def zero_row(a, axis=0):  # row u: the padding lanes
            pad = [(0, 0)] * a.ndim
            pad[axis] = (0, 1)
            return np.pad(a, pad)

        rows = np.concatenate([rows, np.full(_pad32(n) - n, u)])
        vcs = [tree_map(zero_row, vc) for vc in host.value_corrections]
        staged = to_tensors([rows, zero_row(host.parties), zero_row(host.seeds),
                             zero_row(host.cw_seeds, 1), zero_row(host.cw_left, 1),
                             zero_row(host.cw_right, 1),
                             *[leaf for vc in vcs for leaf in tree_leaves(vc)]], dev)
        leaves = iter(staged[6:])
        return StagedKeyBatch.from_lanes(
            n, staged[0].long(), *staged[1:6],
            [tree_unflatten(vc, leaves) for vc in vcs])

    # -- evaluation (device) --------------------------------------------------

    def _walk_arrays(self, key: DpfKey, paths: np.ndarray, start: int,
                     stop: int) -> dict:
        """Host arrays of a walk of `paths` (uint32[lanes, 4], tree indices
        at tree level `stop`) from tree level `start` with the key's
        corrections: level j reads path bit (stop - start - 1 - j)."""
        num = stop - start
        cw, cwl, cwr = self._stage_correction_words(key, start, stop)
        bits = _path_bits(paths, [num - 1 - j for j in range(num)])
        return {"sel": pack_select_bits_np(bits), "cw": cw, "cwl": cwl, "cwr": cwr}

    def _resume_arrays(self, ctx: EvaluationContext, tree_indices: Sequence[int],
                       hierarchy_level: int) -> dict:
        """Host half of `_resume`: where the walk of `tree_indices` to the
        hierarchy level's tree level starts (their ancestors' "rows" in
        `ctx.partial_evaluations`, or the key's root) and its path bits and
        corrections. Raises before any launch if an ancestor is missing."""
        stop = self._hierarchy_to_tree[hierarchy_level]
        start = self._hierarchy_to_tree[ctx.partial_evaluations_level]
        n = len(tree_indices)
        lanes = _pad32(n)
        pe = ctx.partial_evaluations
        if pe is not None and start <= stop:
            shift = stop - start
            prev = [0] * n if shift >= 128 else [ti >> shift for ti in tree_indices]
            arrays = {"rows": pe.lookup(prev, f" at hierarchy level {hierarchy_level}")}
        else:
            # The root's planes, lanes padded to whole words with zero seeds.
            start = 0
            seeds = np.zeros((lanes, 4), dtype=np.uint32)
            seeds[:n] = aes.u128_to_limbs(ctx.key.seed)
            control = np.zeros((lanes,), dtype=np.uint32)
            control[:n] = ctx.key.party
            arrays = {"state": limbs_to_planes_np(seeds),
                      "ctrl": pack_select_bits_np(control)}
        arrays.update(self._walk_arrays(
            ctx.key, points_to_limbs(tree_indices, lanes), start, stop))
        return arrays

    def _resume(self, ctx: EvaluationContext, t: dict, tree_indices: Sequence[int],
                hierarchy_level: int, update_ctx: bool):
        """Device half: seeds / control bits (int32[n, 4] / int32[n]) of
        `tree_indices` at the hierarchy level's tree level, one K8 launch
        for the levels walked. With `update_ctx` they become the context's
        partial evaluations, on the device."""
        n = len(tree_indices)
        if "rows" in t:
            pad = _pad32(n) - n
            pe = ctx.partial_evaluations
            rows = t["rows"].long()
            state = limbs_to_planes(F.pad(pe.seeds[rows], (0, 0, 0, pad)))
            ctrl = pack_select_bits(F.pad(pe.control[rows], (0, pad)))
        else:
            state, ctrl = t["state"], t["ctrl"]
        state, ctrl = _walk_shared(state, ctrl, t)
        seeds, control = planes_to_limbs(state)[:n], unpack_select_bits(ctrl)[:n]
        ctx.partial_evaluations = (
            PartialEvaluations.build(list(tree_indices), seeds, control)
            if update_ctx else None)
        ctx.partial_evaluations_level = hierarchy_level
        return seeds, control

    def _expansion_arrays(self, key: DpfKey, start: int, stop: int, n: int,
                          hashed: bool, root=None):
        """Host half of `_expand` for n seeds from tree level `start` to
        `stop`, the leaves value-hashed at the exit if `hashed`: returns
        (meta, arrays).

        While the width does not fill whole 32-lane words (n << h not a
        multiple of 32 and below 256 lanes) the first h levels run narrow,
        as the JAX package runs them in limb space. One key's root (`root`:
        numpy seeds and control bits) takes them here with the numpy MMO;
        seeds on the device take them as a K8 walk in which each of the
        n << h children walks from its parent along its offset's bits. The
        rest is the dense-PIR expansion with the key's corrections shared
        by every lane (KG = 1), its phases' leaf order undone by one exit
        gather."""
        from .pir import dense_eval_planes as dep  # pir imports this module

        levels = stop - start
        if levels > 62:
            raise ValueError(
                "trying to expand more than 62 tree levels at once; insert "
                "intermediate hierarchy levels")
        h = 0
        while h < levels and (n << h) % 32 and (n << h) < 256:
            h += 1
        cw, cwl, cwr = self._stage_correction_words(key, start, stop)
        n0 = n << h
        pad = _pad32(n0) - n0
        if root is not None:
            seeds, control = root
            for i in range(h):
                seeds, control = _expand_level_host(seeds, control, cw[i], cwl[i], cwr[i])
            arrays = {"state": limbs_to_planes_np(np.pad(seeds, ((0, pad), (0, 0)))),
                      "ctrl": pack_select_bits_np(np.pad(control, (0, pad)))}
        else:
            offsets = np.tile(np.arange(1 << h, dtype=np.uint32), n)
            shifts = np.arange(h - 1, -1, -1, dtype=np.uint32)[:, None]
            bits = np.pad((offsets[None, :] >> shifts) & 1, ((0, 0), (0, pad)))
            arrays = {"sel": pack_select_bits_np(bits),
                      "cw": cw[:h], "cwl": cwl[:h], "cwr": cwr[:h]}
        mode = self._expansion or dep.DEFAULT_EXPANSION
        plane_levels = levels - h
        # K5 always hashes: unhashed leaves run tail mode without its tail.
        tail = {"tail_levels": 0} if mode == "tail" and not hashed else {}
        plan = dep.expansion_plan(mode, (n0 + pad) // 32, plane_levels, **tail)
        arrays.update(
            plane_cw=cw[h:], plane_cwl=cwl[h:], plane_cwr=cwr[h:],
            perm=dep.exit_permutation(plane_levels, *plan, mode == "walk",
                                      1 << plane_levels))
        return (n0, mode, plan, hashed), arrays

    def _expand(self, meta, t: dict, seeds=None, control=None):
        """Device half of the expansion staged by `_expansion_arrays` (for
        device seeds int32[n, 4] / int32[n], or from the staged root):
        returns (value blocks, or the leaf seeds where the plan does not
        hash, int32[n * 2^L, 4]; control int32[n * 2^L]) in natural order
        (leaf i * 2^L + path), L = stop - start."""
        from .pir import dense_eval_planes as dep  # pir imports this module

        n0, mode, plan, hashed = meta
        if seeds is None:
            state, ctrl = t["state"], t["ctrl"]
        else:
            reps = n0 // seeds.shape[0]
            pad = 32 * t["sel"].shape[1] - n0
            state = limbs_to_planes(F.pad(seeds.repeat_interleave(reps, 0), (0, 0, 0, pad)))
            ctrl = pack_select_bits(F.pad(control.repeat_interleave(reps), (0, pad)))
            state, ctrl = _walk_shared(state, ctrl, t)
        g0 = state.shape[-1]
        values, ctrl = dep.expand_planned(
            state, ctrl, broadcast_cw_planes(t["plane_cw"]),
            -t["plane_cwl"][:, None], -t["plane_cwr"][:, None],
            torch.zeros((16, 8, 1), dtype=torch.int32, device=state.device),
            mode=mode, plan=plan, node_lanes=g0, value_hash=hashed)
        perm = t["perm"].long()
        w = perm.shape[0]
        blocks = planes_to_limbs(values).reshape(w, 32 * g0, 4)[perm]
        bits = unpack_select_bits(ctrl).reshape(w, 32 * g0)[perm]
        return (blocks.transpose(0, 1)[:n0].reshape(-1, 4),
                bits.transpose(0, 1)[:n0].reshape(-1))

    def _leaf_values(self, blocks, control, vc, key: DpfKey, hierarchy_level: int):
        """Full-expansion leaf values of batch shape [n * cepb], domain
        order, from `_expand`'s value blocks or, for a level of B > 1
        blocks, its leaf seeds, hashed here in one K3 launch (vc: the
        level's value correction, of batch shape [epb])."""
        vt = self.parameters[hierarchy_level].value_type
        cepb = 1 << (self.parameters[hierarchy_level].log_domain_size
                     - self._hierarchy_to_tree[hierarchy_level])
        num_blocks = self._blocks_needed[hierarchy_level]
        blocks = blocks[:, None, :] if num_blocks == 1 else _value_hash(blocks, num_blocks)
        return _leaf_stage(blocks, control, vc, vt, cepb, key.party)

    def evaluate_next(self, prefixes: Sequence[int], ctx: EvaluationContext):
        """Evaluate the hierarchy level after `ctx.previous_hierarchy_level`:
        on the first call `prefixes` is empty (full expansion of level 0);
        later it holds domain indices of the previous level whose subtrees
        to expand."""
        return self.evaluate_until(ctx.previous_hierarchy_level + 1, prefixes, ctx)

    def evaluate_until(self, hierarchy_level: int, prefixes: Sequence[int],
                       ctx: EvaluationContext):
        """Hierarchical evaluation up to `hierarchy_level`.

        Returns a value of batch shape [len(prefixes) * 2^(lds_level -
        lds_prev)] (int32[..., nlimbs], or a tuple of them for a tuple
        type; the full domain on the first call), in domain order grouped by
        prefix. Everything a call copies to the device moves in one copy
        before its first launch, and nothing comes back to the host."""
        key = ctx.key
        self._validate_key(key)
        if hierarchy_level < 0 or hierarchy_level >= len(self.parameters):
            raise ValueError("hierarchy_level out of range")
        if hierarchy_level <= ctx.previous_hierarchy_level:
            raise ValueError(
                "hierarchy_level must be greater than ctx.previous_hierarchy_level")
        if (ctx.previous_hierarchy_level < 0) != (len(prefixes) == 0):
            raise ValueError("prefixes must be empty iff this is the first call with ctx")
        prev_hl = ctx.previous_hierarchy_level
        prev_lds = self.parameters[prev_hl].log_domain_size if prev_hl >= 0 else 0
        lds = self.parameters[hierarchy_level].log_domain_size
        if lds - prev_lds > 62:
            raise ValueError(
                "output size would exceed 2^62; evaluate fewer hierarchy levels at once")
        for prefix in prefixes:
            if not (0 <= prefix < (1 << prev_lds)):
                raise ValueError(f"prefix {prefix} out of range")
        dev = self._dev()
        stop_level = self._hierarchy_to_tree[hierarchy_level]
        vc = self._value_correction_np(key, hierarchy_level)

        if not prefixes:
            root = (aes.u128_to_limbs(key.seed)[None, :],
                    np.array([key.party], dtype=np.uint32))
            meta, arrays = self._expansion_arrays(
                key, 0, stop_level, 1, self._blocks_needed[hierarchy_level] == 1, root)
            (t,) = _to_device(dev, {"vc": vc, **arrays})
            blocks, control = self._expand(meta, t)
            out = self._leaf_values(blocks, control, t["vc"], key, hierarchy_level)
            ctx.previous_hierarchy_level = hierarchy_level
            return out

        # Unique tree indices and the block index of each prefix (packed
        # value types: several prefixes share a tree node).
        tree_indices: List[int] = []
        tree_pos: Dict[int, int] = {}
        prefix_map: List[Tuple[int, int]] = []
        for prefix in prefixes:
            ti = self._domain_to_tree_index(prefix, prev_hl)
            bi = self._domain_to_block_index(prefix, prev_hl)
            if ti not in tree_pos:
                tree_pos[ti] = len(tree_indices)
                tree_indices.append(ti)
            prefix_map.append((tree_pos[ti], bi))

        start_level = self._hierarchy_to_tree[prev_hl]
        # The per-prefix output spans of the expanded values.
        outputs_per_prefix = 1 << (lds - prev_lds)
        cepb = 1 << (lds - stop_level)
        span = (1 << (stop_level - start_level)) * cepb
        idx = np.empty((len(prefixes), outputs_per_prefix), dtype=np.int64)
        base = np.arange(outputs_per_prefix, dtype=np.int64)
        for i, (tp, bi) in enumerate(prefix_map):
            idx[i] = tp * span + bi * outputs_per_prefix + base
        meta, arrays = self._expansion_arrays(key, start_level, stop_level,
                                              len(tree_indices),
                                              self._blocks_needed[hierarchy_level] == 1)
        walk, t = _to_device(dev, self._resume_arrays(ctx, tree_indices, prev_hl),
                             {"vc": vc, "idx": idx.reshape(-1), **arrays})
        seeds, control = self._resume(ctx, walk, tree_indices, prev_hl,
                                      hierarchy_level < len(self.parameters) - 1)
        blocks, control = self._expand(meta, t, seeds, control)
        values = self._leaf_values(blocks, control, t["vc"], key, hierarchy_level)
        ctx.previous_hierarchy_level = hierarchy_level
        idx = t["idx"].long()
        return tree_map(lambda x: x[idx], values)

    def evaluate_at(self, key: DpfKey, hierarchy_level: int,
                    evaluation_points: Sequence[int],
                    ctx: Optional[EvaluationContext] = None):
        """Evaluate `key` at points of the hierarchy level's domain: returns
        a value of batch shape [len(evaluation_points)]. Without `ctx` every path
        walks from the root with the key's shared corrections (one K8
        launch); with it the walk resumes from, and updates, the context."""
        if ctx is not None and ctx.key is not key:
            raise ValueError("key and ctx.key must be the same object")
        self._validate_key(key)
        if not (0 <= hierarchy_level < len(self.parameters)):
            raise ValueError("hierarchy_level out of range")
        lds = self.parameters[hierarchy_level].log_domain_size
        for pt in evaluation_points:
            if not (0 <= pt < (1 << lds)):
                raise ValueError(f"evaluation point {pt} out of range")
        dev = self._dev()
        vt = self.parameters[hierarchy_level].value_type
        n = len(evaluation_points)
        if n == 0:
            return vt.dev_zeros((0,), dev)

        tree_indices = [self._domain_to_tree_index(pt, hierarchy_level)
                        for pt in evaluation_points]
        walk_ctx = ctx if ctx is not None else EvaluationContext(key=key)
        walk, t = _to_device(
            dev, self._resume_arrays(walk_ctx, tree_indices, hierarchy_level),
            {"vc": self._value_correction_np(key, hierarchy_level),
             "block_indices": [self._domain_to_block_index(pt, hierarchy_level)
                               for pt in evaluation_points]})
        seeds, control = self._resume(walk_ctx, walk, tree_indices, hierarchy_level,
                                      ctx is not None)
        if ctx is not None:
            ctx.previous_hierarchy_level = hierarchy_level
        blocks = _value_hash(seeds, self._blocks_needed[hierarchy_level])
        return _leaf_stage_at(blocks, control, t["vc"], t["block_indices"].long(),
                              vt, key.party)

    def _multi_key_groups(self, staged: StagedKeyBatch,
                          evaluation_points: Sequence[int],
                          evaluation_points_rightshift: int,
                          negate: bool = True) -> list:
        """The multi-key engine: key k of `staged` walks the path of point k
        through every tree level in one K8 launch in per-seed mode, which
        writes out the walk states at each hierarchy level's tree level; one
        K3 launch hashes them all (B blocks each, seed + j for j < B, where
        a level needs B > 1), and one leaf stage per value type corrects
        them. Returns per value type (type, its hierarchy levels in order,
        their values of batch shape [levels, n]), each party-1 key's negated
        (unless `negate` is False: a caller that sums levels negates the sum
        once)."""
        n = staged.n
        if n != len(evaluation_points):
            raise ValueError("keys and evaluation_points size mismatch")
        dev = staged.parties.device
        lanes = staged.parties.shape[0]
        rs = evaluation_points_rightshift
        last_lds = self.parameters[-1].log_domain_size
        # Tree level t reads path bit (last_lds - 1 - t + rightshift), in
        # every hierarchy level alike.
        levels = self._hierarchy_to_tree[-1]
        bits = [last_lds - 1 - t + rs for t in range(levels)]
        # Block indices only where a level packs several values a block;
        # elsewhere they are 0, made on the device rather than copied.
        packed = [hl for hl, p in enumerate(self.parameters)
                  if p.log_domain_size > self._hierarchy_to_tree[hl]]
        block_indices = np.zeros((len(packed), lanes), dtype=np.uint32)
        for row, hl in enumerate(packed):
            drs = rs + last_lds - self.parameters[hl].log_domain_size
            block_indices[row, :n] = [
                self._domain_to_block_index(pt >> drs if drs < 128 else 0, hl)
                for pt in evaluation_points]
        groups: Dict[ValueType, List[int]] = {}
        for hl, p in enumerate(self.parameters):
            groups.setdefault(p.value_type, []).append(hl)
        paths, packed_indices, *group_idx = to_tensors(
            [points_to_limbs(evaluation_points, lanes), block_indices,
             *groups.values()], dev)
        block_indices = torch.zeros((len(self.parameters), lanes), dtype=torch.int32,
                                    device=dev)
        block_indices[packed] = packed_indices
        sel = pack_select_bits(point_bits(paths, bits).reshape(-1)).reshape(levels, lanes // 32)

        # One walk through every tree level, stopping at each hierarchy
        # level's: the stops' states side by side, one K3 launch for all.
        states, ctrls = path_walk(
            staged.state, staged.ctrl, sel, staged.cw_planes[:levels],
            staged.cw_left[:levels], staged.cw_right[:levels],
            stops=self._hierarchy_to_tree)
        num_hl = len(self.parameters)
        num_blocks = max(self._blocks_needed)
        if num_blocks == 1:
            blocks = planes_to_limbs(_hash_planes(states))
        else:
            blocks = _value_hash(planes_to_limbs(states), num_blocks)
        blocks = blocks.reshape(num_hl, lanes, num_blocks, 4)
        control = unpack_select_bits(ctrls).reshape(num_hl, lanes)

        out = []
        party_one = staged.parties != 0
        for (vt, hls), idx in zip(groups.items(), group_idx):
            # One type at every level (the DCF): all rows, no gather.
            idx = slice(None) if len(groups) == 1 else idx.long()
            values = _leaf_stage_at(
                blocks[idx, :, :self._blocks_needed[hls[0]]], control[idx],
                tree_map(lambda *xs: torch.stack(xs),
                         *[staged.value_corrections[hl] for hl in hls]),
                block_indices[idx].long(), vt, -1)
            if negate:
                values = vt.dev_where(party_one, vt.dev_neg(values), values)
            out.append((vt, hls, tree_map(lambda x: x[:, :n], values)))
        return out

    def _multi_key_values(self, staged: StagedKeyBatch,
                          evaluation_points: Sequence[int],
                          evaluation_points_rightshift: int) -> list:
        """`_multi_key_groups` per hierarchy level: the keys' values of
        batch shape [n], each party-1 key's negated."""
        out = [None] * len(self.parameters)
        for _, hls, values in self._multi_key_groups(
                staged, evaluation_points, evaluation_points_rightshift):
            for i, hl in enumerate(hls):
                out[hl] = tree_map(lambda x, i=i: x[i], values)
        return out

    def evaluate_and_accumulate(self, staged: StagedKeyBatch,
                                evaluation_points: Sequence[int],
                                level_masks: np.ndarray,
                                evaluation_points_rightshift: int = 0):
        """Multi-key evaluation with a masked sum over hierarchy levels:
        `out[k] = sum of value_hl[k] over the levels hl with
        level_masks[hl, k]` (the DCF's accumulator; numpy booleans, or a
        bool tensor on the batch's device). Every hierarchy level must
        share one value type. Returns a value of batch shape [n]."""
        if staged.n != len(evaluation_points):
            raise ValueError("keys and evaluation_points size mismatch")
        vt = self.parameters[0].value_type
        if any(p.value_type != vt for p in self.parameters[1:]):
            raise ValueError(
                "evaluate_and_accumulate requires a single value type across "
                "hierarchy levels")
        num_hl = len(self.parameters)
        if not isinstance(level_masks, torch.Tensor):
            level_masks = torch.from_numpy(np.ascontiguousarray(level_masks, dtype=bool))
        if tuple(level_masks.shape) != (num_hl, staged.n) or level_masks.dtype != torch.bool:
            raise ValueError(f"level_masks must be [{num_hl}, {staged.n}] booleans")
        masks = level_masks.to(staged.parties.device)  # before any launch
        # One value type: one group, every level in order.
        ((_, _, values),) = self._multi_key_groups(
            staged, evaluation_points, evaluation_points_rightshift, negate=False)
        values = vt.dev_where(masks, values, tree_map(torch.zeros_like, values))
        # The levels' sum as a tree of pairwise group additions.
        while num_hl > 1:
            if num_hl % 2:
                values = tree_map(lambda x: torch.cat([x, torch.zeros_like(x[:1])]), values)
                num_hl += 1
            values = vt.dev_add(tree_map(lambda x: x[0::2], values),
                                tree_map(lambda x: x[1::2], values))
            num_hl //= 2
        # Party 1's negation distributes over the sum: once, at the end.
        total = tree_map(lambda x: x[0], values)
        return vt.dev_where(staged.parties[:staged.n] != 0, vt.dev_neg(total), total)

    def evaluate_and_apply(self, keys: Sequence[DpfKey],
                           evaluation_points: Sequence[int], op,
                           evaluation_points_rightshift: int = 0,
                           staged: Optional[StagedKeyBatch] = None):
        """Evaluate many keys, each at its own point, at every hierarchy
        level, and call `op(values, hierarchy_level)` per level in order
        (values of batch shape [len(keys)]); a False from `op` stops the
        calls. The walk of all levels
        runs first, in one pass. Pass a
        `staged` batch from `stage_key_batch` to reuse its staging (then
        `keys` may be None)."""
        if staged is None:
            if keys is None:
                raise ValueError("either keys or staged must be provided")
            staged = self.stage_key_batch(keys)
        elif keys is not None and len(keys) != staged.n:
            raise ValueError("keys and staged batch size mismatch")
        values = self._multi_key_values(
            staged, evaluation_points, evaluation_points_rightshift)
        for hl, v in enumerate(values):
            if op(v, hl) is False:
                break

    def evaluate_prefixes_batch(self, staged: StagedKeyBatch, hierarchy_level: int,
                                prefixes: Sequence[int],
                                cuts: Optional[BatchCutState] = None):
        """Evaluate EVERY staged key at EVERY prefix of one hierarchy level,
        from the root or resuming from an earlier level's cut states: the
        batched per-level engine of the heavy-hitters sweep.

        `prefixes` are strictly ascending domain indices at
        `hierarchy_level`. With `cuts` (a `BatchCutState` of an earlier
        level, holding every prefix's ancestor) each lane walks only the
        tree levels between the two levels; without, from the root.

        Lanes are prefix-major (lane = prefix * Kpad + key): each packed
        word holds 32 keys at one prefix, so K8 reads each lane's own key's
        corrections straight from the staged batch (KW = Kpad / 32 word
        columns, read at column m % KW) and every word's path bits are all
        ones or all zeros. The walk is one K8 launch, the value hash one K3
        launch, then the leaf stage. Returns `(values, new_cuts)`: the
        level's values of batch shape [num_keys, len(prefixes)] (party
        negation per key; a view of the prefix-major result), and the
        `BatchCutState` at `hierarchy_level` for the next level."""
        num_keys = staged.n
        num_prefixes = len(prefixes)
        if num_prefixes == 0:
            raise ValueError("prefixes must not be empty")
        if not (0 <= hierarchy_level < len(self.parameters)):
            raise ValueError("hierarchy_level out of range")
        lds = self.parameters[hierarchy_level].log_domain_size
        prefixes = [int(p) for p in prefixes]
        last = -1
        for p in prefixes:
            if not (0 <= p < (1 << lds)):
                raise ValueError(f"prefix {p} out of range")
            if p <= last:
                raise ValueError("prefixes must be strictly ascending")
            last = p
        stop = self._hierarchy_to_tree[hierarchy_level]
        start = 0
        host = {}
        if cuts is not None:
            if cuts.hierarchy_level >= hierarchy_level:
                raise ValueError("cuts.hierarchy_level must precede hierarchy_level")
            if cuts.num_keys != num_keys or cuts.ctrl.shape[0] != len(cuts) * staged.ctrl.shape[0]:
                raise ValueError("cuts/staged key-count mismatch")
            start = self._hierarchy_to_tree[cuts.hierarchy_level]
            shift = lds - self.parameters[cuts.hierarchy_level].log_domain_size
            host["pos"] = cuts.positions([p >> shift for p in prefixes])
        levels = stop - start
        # The domain bits below the tree level are the block index.
        bits, mask = lds - stop, (1 << (lds - stop)) - 1
        if last >> 64:  # past uint64: Python ints
            pref = np.array(prefixes, dtype=object)
        else:
            pref, bits, mask = np.array(prefixes, dtype=np.uint64), np.uint64(bits), np.uint64(mask)
        tree = points_to_limbs(pref >> bits, num_prefixes)
        host["path"] = _path_bits(tree, [levels - 1 - j for j in range(levels)])
        host["block"] = points_to_limbs(pref & mask, num_prefixes)[:, 0]
        (t,) = _to_device(staged.parties.device, host)
        kw = staged.ctrl.shape[0]
        if cuts is None:
            state = staged.state.repeat(1, 1, num_prefixes)
            ctrl = staged.ctrl.repeat(num_prefixes)
        else:
            cols = (t["pos"].long()[:, None] * kw
                    + torch.arange(kw, device=staged.ctrl.device)).reshape(-1)
            state = cuts.state.index_select(2, cols)
            ctrl = cuts.ctrl.index_select(0, cols)
            del cols
        sel = (-t["path"])[:, :, None].expand(levels, num_prefixes, kw).reshape(
            levels, num_prefixes * kw)
        state, ctrl = _eval_paths(state, ctrl, sel, staged.cw_planes[start:stop],
                                  staged.cw_left[start:stop], staged.cw_right[start:stop])
        del sel
        vt = self.parameters[hierarchy_level].value_type
        num_blocks = self._blocks_needed[hierarchy_level]
        if num_blocks == 1:
            blocks = planes_to_limbs(_hash_planes(state))[:, None]
        else:
            blocks = _value_hash(planes_to_limbs(state), num_blocks)
        kpad = 32 * kw
        blocks = blocks.reshape(num_prefixes, kpad, num_blocks, 4)
        control = unpack_select_bits(ctrl).reshape(num_prefixes, kpad)
        values = _leaf_stage_at(
            blocks, control, staged.value_corrections[hierarchy_level],
            t["block"].long()[:, None].expand(num_prefixes, kpad), vt, -1)
        del blocks, control
        party_one = (staged.parties != 0).expand(num_prefixes, kpad)
        values = vt.dev_where(party_one, vt.dev_neg(values), values)
        values = tree_map(lambda x: x[:, :num_keys].transpose(0, 1), values)
        return values, BatchCutState.build(hierarchy_level, prefixes, state, ctrl,
                                           num_keys)

    # -- internals ----------------------------------------------------------

    def _domain_to_tree_index(self, domain_index: int, hierarchy_level: int) -> int:
        bits = (self.parameters[hierarchy_level].log_domain_size
                - self._hierarchy_to_tree[hierarchy_level])
        return domain_index >> bits

    def _domain_to_block_index(self, domain_index: int, hierarchy_level: int) -> int:
        bits = (self.parameters[hierarchy_level].log_domain_size
                - self._hierarchy_to_tree[hierarchy_level])
        return domain_index & ((1 << bits) - 1)
