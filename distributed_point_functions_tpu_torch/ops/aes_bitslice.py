"""Fully-bitsliced AES-128 in PyTorch: 32 blocks per int32 word.

The port of the JAX package's `ops/aes_bitslice.py` plane ops. These are
the core of the **plain versions** of the expansion kernels (K2-K6,
`ops/expand_planes.py`; `aes_rounds_select_planes` is K4's per-lane key
select): the wrappers run them for CPU tensors, and `chip_smoke.py` holds
the CUDA kernels against them on the card.

* state = `int32[16 bytes, 8 bits, G]` where word `g` of plane (j, i)
  holds bit i of byte j for blocks 32g..32g+31 (one bit per block);
* a 32x32 bit-matrix transpose (Hacker's Delight `transpose32`, five
  masked swap rounds) converts between `int32[N, 4]` little-endian limb
  blocks and plane layout: limb l bit b is plane byte 4l + b//8, bit b%8
  (flat plane index 32l + b);
* SubBytes runs the tower-field circuit (`aes_sbox_tower.py`) over the
  byte axis; ShiftRows is a byte-axis reindex; MixColumns rewires bit
  planes; AddRoundKey with a fixed key XORs all-ones/all-zeros planes.

Words are int32 (`ops/words.py`): every right shift that must bring in
zeros goes through `lsr`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import aes as _aes
from . import aes_sbox_tower as _tower
from .words import i32, lsr

_SHIFT_ROWS = _aes._SHIFT_ROWS

# MixColumns xtime on bit planes: out[0]=in[7], out[b]=in[b-1] (^ in[7]
# for the poly taps b in {1, 3, 4}).
_XTIME_TAPS = (1, 3, 4)

_TRANSPOSE_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _transpose32(x: torch.Tensor) -> torch.Tensor:
    """32x32 bit-matrix transpose over the last axis ([..., 32] int32).

    Result `t` satisfies `(t[..., b] >> i) & 1 == (x[..., i] >> b) & 1`.
    """
    j = 16
    for m in _TRANSPOSE_MASKS:
        r = x.reshape(x.shape[:-1] + (32 // (2 * j), 2, j))
        a = r[..., 0, :]
        b = r[..., 1, :]
        t = (a ^ (b << j)) & i32(~m)
        a2 = a ^ t
        b2 = b ^ lsr(t, j)
        x = torch.stack([a2, b2], dim=-2).reshape(x.shape)
        j >>= 1
    return x


def limbs_to_planes(blocks: torch.Tensor) -> torch.Tensor:
    """int32[G*32, 4] limb blocks -> int32[16, 8, G] bit planes. The four
    limbs transpose in one batch: each transpose step is one small op for
    all of them, not four."""
    n = blocks.shape[0]
    if n % 32:
        raise ValueError("block count must be a multiple of 32")
    g = n // 32
    x = blocks.reshape(g, 32, 4).permute(2, 0, 1).contiguous()  # [limb, g, 32]
    planes = _transpose32(x).movedim(-1, 1)  # [limb, bit, g]
    # limb l bit b -> byte 4l + b//8, bit b%8
    return planes.reshape(16, 8, g).contiguous()


def planes_to_limbs(planes: torch.Tensor) -> torch.Tensor:
    """int32[16, 8, G] bit planes -> int32[G*32, 4] limb blocks."""
    g = planes.shape[-1]
    stacked = planes.reshape(4, 32, g)  # [limb, bit-within-limb, group]
    limbs = _transpose32(stacked.movedim(1, -1).contiguous())  # [limb, g, 32]
    return limbs.permute(1, 2, 0).reshape(g * 32, 4).contiguous()


def _sub_bytes_planes(state: torch.Tensor) -> torch.Tensor:
    """S-box on [16, 8, G] planes via the tower-field circuit, vectorized
    over the byte axis."""
    planes = [state[:, i] for i in range(8)]
    out = _tower.sbox_planes_tower(planes, -1)
    return torch.stack(out, dim=1)


def _mix_columns_planes(state: torch.Tensor) -> torch.Tensor:
    """MixColumns on [16, 8, G]: per column,
    o_r = s_r ^ t ^ xtime(s_r ^ s_{r+1})."""
    s = state.reshape(4, 4, 8, -1)  # [column, row, bit, G]
    t = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3]  # [column, bit, G]
    outs = []
    for r in range(4):
        u = s[:, r] ^ s[:, (r + 1) % 4]  # operand of xtime
        hi = u[:, 7]
        xt = [hi]
        for b in range(1, 8):
            v = u[:, b - 1]
            if b in _XTIME_TAPS:
                v = v ^ hi
            xt.append(v)
        outs.append(s[:, r] ^ t ^ torch.stack(xt, dim=1))
    return torch.stack(outs, dim=1).reshape(16, 8, -1)


def _rk_bits(round_keys: np.ndarray) -> np.ndarray:
    """uint8[11, 16] schedule -> uint8[11, 16, 8] bits."""
    rk = np.asarray(round_keys, dtype=np.uint8)
    return (rk[..., None] >> np.arange(8)) & 1


def _rk_masks(round_keys: np.ndarray, device) -> torch.Tensor:
    """uint8[11, 16] schedule -> int32[11, 16, 8, 1] all-ones/all-zeros
    plane masks (AddRoundKey with a fixed key = XOR with constants)."""
    bits = _rk_bits(round_keys).astype(np.int32)
    return torch.from_numpy(-bits[..., None]).to(device)


def _aes_rounds(state: torch.Tensor, round_key) -> torch.Tensor:
    """AES-128 rounds on [16, 8, G] planes; `round_key(rnd)` gives the
    [16, 8, 1 or G] key planes of round `rnd`."""
    shift_rows = torch.from_numpy(_SHIFT_ROWS.astype(np.int64)).to(
        state.device
    )
    state = state ^ round_key(0)
    for rnd in range(1, 10):
        state = _sub_bytes_planes(state)
        state = state[shift_rows]
        state = _mix_columns_planes(state)
        state = state ^ round_key(rnd)
    state = _sub_bytes_planes(state)
    state = state[shift_rows]
    return state ^ round_key(10)


def aes_rounds_planes(
    round_keys: np.ndarray, state: torch.Tensor
) -> torch.Tensor:
    """The AES-128 round function on plane-layout state [16, 8, G]
    (fixed key)."""
    masks = _rk_masks(round_keys, state.device)
    return _aes_rounds(state, lambda rnd: masks[rnd])


def aes_rounds_select_planes(
    round_keys0: np.ndarray,
    round_keys1: np.ndarray,
    sel: torch.Tensor,
    state: torch.Tensor,
) -> torch.Tensor:
    """AES-128 rounds on plane state [16, 8, G] with a per-block key
    choice from a packed select mask (int32[G]: bit i of word g selects
    the key of block 32g+i; 0 -> round_keys0, 1 -> round_keys1). One AES
    pass: each round-key plane is `k0 & ~sel | k1 & sel`. The plain core
    of K4 `walk_descend` (the JAX package's `aes_rounds_select_planes`)."""
    m0 = _rk_masks(round_keys0, state.device)
    m1 = _rk_masks(round_keys1, state.device)
    nsel = ~sel
    return _aes_rounds(state, lambda rnd: (m0[rnd] & nsel) | (m1[rnd] & sel))


def sigma_planes(state: torch.Tensor) -> torch.Tensor:
    """sigma(x) = (hi ^ lo, hi) on plane layout: bytes 0-7 are limbs 0-1
    (lo), bytes 8-15 limbs 2-3 (hi)."""
    lo = state[:8]
    hi = state[8:]
    return torch.cat([hi, hi ^ lo], dim=0)


def mmo_hash_planes(
    round_keys: np.ndarray, state: torch.Tensor
) -> torch.Tensor:
    """H(x) = AES_k(sigma(x)) ^ sigma(x), entirely in plane layout."""
    s = sigma_planes(state)
    return aes_rounds_planes(round_keys, s) ^ s


def broadcast_cw_planes(cw: torch.Tensor) -> torch.Tensor:
    """int32[..., 4] 128-bit correction words -> all-ones/all-zeros plane
    masks int32[..., 16, 8, 1] (one word column, read by every column):
    limb l bit b is flat plane 32l + b, the `limbs_to_planes` layout."""
    shifts = torch.arange(32, dtype=torch.int32, device=cw.device)
    bits = (cw[..., :, None] >> shifts) & 1  # [..., 4, 32]
    return (-bits).reshape(cw.shape[:-1] + (16, 8, 1))


def limbs_to_planes_np(blocks: np.ndarray) -> np.ndarray:
    """`limbs_to_planes` on the host: uint32[..., N, 4] (N % 32 == 0) ->
    uint32[..., 16, 8, N/32], so that staging moves planes to the device
    in its one copy."""
    b = np.ascontiguousarray(blocks, dtype="<u4")
    n = b.shape[-2]
    if n % 32:
        raise ValueError("block count must be a multiple of 32")
    bits = np.unpackbits(b.view(np.uint8).reshape(b.shape[:-1] + (16,)),
                         axis=-1, bitorder="little")  # [..., N, 128]
    packed = np.packbits(np.swapaxes(bits, -1, -2), axis=-1, bitorder="little")
    planes = np.ascontiguousarray(packed).view("<u4")  # [..., 128, N/32]
    return planes.reshape(b.shape[:-2] + (16, 8, n // 32)).astype(np.uint32)


def pack_select_bits_np(bits: np.ndarray) -> np.ndarray:
    """`pack_select_bits` on the host: [..., N] 0/1 (N % 32 == 0) ->
    uint32[..., N/32]."""
    b = np.asarray(bits).astype(np.uint8) & 1
    if b.shape[-1] % 32:
        raise ValueError("lane count must be a multiple of 32")
    packed = np.packbits(b, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def unpack_select_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[G] packed words -> int32[32G] 0/1 (lane 32g+i = bit i of
    word g), the inverse of `pack_select_bits`."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).reshape(-1)


def pack_select_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32[n] 0/1 (n % 32 == 0) -> packed int32[n/32] (word g bit i =
    bit of lane 32g+i)."""
    lanes = bits.reshape(-1, 32) & 1
    out = torch.zeros(lanes.shape[0], dtype=torch.int32, device=bits.device)
    for i in range(32):
        out |= lanes[:, i] << i
    return out
