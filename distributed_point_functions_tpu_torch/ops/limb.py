"""Limb arithmetic on int32 words: the port of the JAX package's
`ops/limb.py` that the DPF evaluation and the value types need.

Wide integers are little-endian limb tensors `int32[..., n]` (limb 0 least
significant), each limb a 32-bit word carried as `torch.int32`
(`ops/words.py`). Carries go through int64 temporaries, so additions wrap
mod 2^(32n) exactly as the JAX package's uint32 carry chains do.
"""

from __future__ import annotations

import numpy as np
import torch

from .words import i32, lsr

_M32 = 0xFFFFFFFF


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _w32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limbwise add with carry propagation; both int32[..., n], same n."""
    out = []
    carry = 0
    for i in range(a.shape[-1]):
        s = _u64(a[..., i]) + _u64(b[..., i]) + carry
        out.append(_w32(s & _M32))
        carry = s >> 32
    return torch.stack(out, dim=-1)


def add_scalar(a: torch.Tensor, k: int) -> torch.Tensor:
    """Add a non-negative Python int to int32[..., n] limbs (mod 2^(32n))."""
    out = []
    carry = 0
    for i in range(a.shape[-1]):
        s = _u64(a[..., i]) + ((k >> (32 * i)) & _M32) + carry
        out.append(_w32(s & _M32))
        carry = s >> 32
    return torch.stack(out, dim=-1)


def neg(a: torch.Tensor) -> torch.Tensor:
    """Two's complement negation of int32[..., n] limbs."""
    return add_scalar(~a, 1)


def mask_top_bits(a: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep only the low `bits` bits of int32[..., n] limbs (scalar masks
    only: no host-to-device copy, which would wait for the stream)."""
    if bits >= 32 * a.shape[-1]:
        return a
    limbs = []
    for i in range(a.shape[-1]):
        keep = min(32, max(0, bits - 32 * i))
        limbs.append(a[..., i] & i32((1 << keep) - 1))
    return torch.stack(limbs, dim=-1)


def get_bit(a: torch.Tensor, index: int) -> torch.Tensor:
    """Bit `index` of int32[..., n] limbs as int32 0/1; indices past the
    last limb read 0 (the DCF's shifted paths read up to the block width)."""
    if index >= 32 * a.shape[-1]:
        return torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    return lsr(a[..., index >> 5], index & 31) & 1


def to_const(value: int, nlimbs: int) -> np.ndarray:
    """Python int -> uint32[nlimbs] little-endian limbs (mod 2^(32n))."""
    return np.array(
        [(value >> (32 * i)) & _M32 for i in range(nlimbs)], dtype=np.uint32
    )


def to_byte_lanes(limbs: torch.Tensor) -> torch.Tensor:
    """int32[..., n] -> int32[..., 4n] byte values, little-endian."""
    parts = [lsr(limbs, 8 * k) & 0xFF for k in range(4)]
    stacked = torch.stack(parts, dim=-1)  # [..., n, 4]
    return stacked.reshape(limbs.shape[:-1] + (4 * limbs.shape[-1],))
