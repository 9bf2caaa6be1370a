"""32-bit words as `torch.int32`.

`torch.uint32` lacks `>>`, `<<` and `~`, so the port carries every 32-bit
word as `torch.int32`, which is bit-identical. Words cross to and from
`numpy.uint32` only at the edges (`to_tensor` / `to_numpy`), and a right
shift that must bring in zeros goes through `lsr`.
"""

from __future__ import annotations

import numpy as np
import torch


def i32(x: int) -> int:
    """The signed 32-bit value with the same bits as `x mod 2^32`."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant `n` in [0, 31]:
    an arithmetic shift, then the sign-extended bits masked off."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def to_tensor(a, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor on `device`, same bits."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array, same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def to_tensors(arrays, device) -> list:
    """numpy uint32 arrays -> int32 tensors on `device` of the same shapes,
    moved in ONE host-to-device copy (views of one flat buffer)."""
    arrays = [np.asarray(a, dtype=np.uint32) for a in arrays]
    flat = to_tensor(np.concatenate([a.ravel() for a in arrays]), device)
    out, offset = [], 0
    for a in arrays:
        out.append(flat[offset : offset + a.size].view(a.shape))
        offset += a.size
    return out
