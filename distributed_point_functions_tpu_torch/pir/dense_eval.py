"""Key staging and the host zeros-walk for dense PIR.

The client puts a query's block index in `alpha = index / 128`, so every
useful leaf of a key's tree lives under the all-zeros prefix of depth
`log_domain_size - ceil(log2(num_blocks))`. The server walks that shared
prefix on the host while it stages a key batch (`_walk_zeros_host`, one
numpy MMO hash per key per level), then the device expands only the
covering subtree (`dense_eval_planes.py`).

The port of the JAX package's `pir/dense_eval.py` staging half; the host
walk always uses the numpy MMO oracle (the port has no native library).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import keys as fixed_keys
from ..device import resolve_device
from ..dpf import DpfKey
from ..ops import aes
from ..ops.words import to_tensors

_CLEAR_LSB = np.array(
    [0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32
)


def _walk_zeros_host(seeds0, control0, cw_seeds, cw_left, cw_right, levels):
    """Walk the all-zeros prefix (left child each level) on the host for
    `levels` levels. Numpy in, numpy out."""
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
    seeds0 = np.zeros((nk, 4), dtype=np.uint32)
    control0 = np.zeros((nk,), dtype=np.uint32)
    cw_seeds = np.zeros((num_levels, nk, 4), dtype=np.uint32)
    cw_left = np.zeros((num_levels, nk), dtype=np.uint32)
    cw_right = np.zeros((num_levels, nk), dtype=np.uint32)
    last_vc = np.zeros((nk, 4), dtype=np.uint32)
    for k, key in enumerate(keys):
        if len(key.correction_words) != num_levels:
            raise ValueError("all keys must have the same number of levels")
        if len(key.last_level_value_correction) != 1:
            raise ValueError("dense PIR keys carry exactly one leaf value")
        seeds0[k] = aes.u128_to_limbs(key.seed)
        control0[k] = key.party
        last_vc[k] = aes.u128_to_limbs(int(key.last_level_value_correction[0]))
        for lvl, cw in enumerate(key.correction_words):
            cw_seeds[lvl, k] = aes.u128_to_limbs(cw.seed)
            cw_left[lvl, k] = cw.control_left
            cw_right[lvl, k] = cw.control_right
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

