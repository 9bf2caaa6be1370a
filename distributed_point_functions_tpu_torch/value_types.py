"""Value types of the DPF: `IntType` and `XorType`, the slice of the JAX
package's `value_types.py` that the evaluation API and the DCF need.

Each type has two faces, as in the JAX package:

* **host face** -- Python-int group arithmetic and byte parsing, used by
  key generation (`add`, `sub`, `neg`, `zero`, `parse_direct`,
  `from_bytes`, `to_python`);
* **device face** -- limb tensors `int32[..., nlimbs]` (little-endian
  32-bit words, `ops/words.py`), used by evaluation (`dev_zeros`,
  `dev_const`, `dev_add`, `dev_neg`, `dev_where`, `dev_parse_direct`,
  `dev_from_value_blocks`, `dev_take_element`).

Packing follows the reference: a type of `b <= 128` bits packs `128 // b`
elements per 128-bit leaf block, which shortens the evaluation tree. The
sampled types of the JAX package (`IntModNType`, `TupleType`) are not
ported yet; the DPF raises `NotImplementedError` for any other type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import limb
from .ops.words import to_numpy, to_tensor


class ValueType:
    """Abstract value type. See the module docstring for the two faces."""

    # --- descriptors -------------------------------------------------------
    def can_convert_directly(self) -> bool:
        raise NotImplementedError

    def total_bit_size(self) -> int:
        raise NotImplementedError

    def bits_needed(self, security_parameter: float) -> int:
        """Pseudorandom bits needed for one uniform element."""
        raise NotImplementedError

    def elements_per_block(self) -> int:
        if self.can_convert_directly() and self.total_bit_size() <= 128:
            return 128 // self.total_bit_size()
        return 1

    # --- host face ---------------------------------------------------------
    def validate(self, v) -> None:
        raise NotImplementedError

    def zero(self):
        raise NotImplementedError

    def add(self, a, b):
        raise NotImplementedError

    def neg(self, a):
        raise NotImplementedError

    def sub(self, a, b):
        return self.add(a, self.neg(b))

    def from_bytes(self, data: bytes):
        """One element from `data` (the reference's ConvertBytesToArrayOf)."""
        if self.can_convert_directly():
            return self.parse_direct(data, 0)
        raise NotImplementedError("sampled value types are not ported")

    def parse_direct(self, data: bytes, offset: int):
        raise NotImplementedError


class _LimbValueType(ValueType):
    """A type whose device value is one limb tensor int32[..., nlimbs] and
    whose elements are `bits` wide (bits in {8, 16, 32, 64, 128})."""

    bits: int

    @property
    def nlimbs(self) -> int:
        return max(1, (self.bits + 31) // 32)

    def can_convert_directly(self) -> bool:
        return True

    def total_bit_size(self) -> int:
        return self.bits

    def bits_needed(self, security_parameter: float) -> int:
        return self.bits

    def zero(self):
        return 0

    def parse_direct(self, data: bytes, offset: int):
        return int.from_bytes(data[offset : offset + self.bits // 8], "little")

    def host_const(self, host_value) -> np.ndarray:
        """Host value -> uint32[nlimbs] limbs (batch staging packs these
        into one host-to-device copy)."""
        return limb.to_const(host_value, self.nlimbs)

    def to_python(self, dev_value: torch.Tensor, index=()):
        """The host value at batch position `index` of a device value."""
        arr = to_numpy(dev_value)[index]
        return sum(int(arr[i]) << (32 * i) for i in range(self.nlimbs))

    # --- device face -------------------------------------------------------
    def dev_zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.nlimbs,), dtype=torch.int32,
                           device=device)

    def dev_const(self, host_value, shape, device) -> torch.Tensor:
        c = to_tensor(self.host_const(host_value), device)
        return c.expand(tuple(shape) + (self.nlimbs,))

    def dev_where(self, mask, a, b) -> torch.Tensor:
        """Per batch element: `a` where `mask` (bool[batch dims]), else `b`."""
        return torch.where(mask[..., None], a, b)

    def dev_parse_direct(self, byte_lanes, offset: int) -> torch.Tensor:
        """The element at byte `offset` of int32[..., nbytes] byte lanes, as
        limbs int32[..., nlimbs]."""
        nbytes = self.bits // 8
        limbs = []
        for li in range(self.nlimbs):
            v = None
            for k in range(min(4, nbytes - 4 * li)):
                term = byte_lanes[..., offset + 4 * li + k] << (8 * k)
                v = term if v is None else v | term
            limbs.append(v)
        return torch.stack(limbs, dim=-1)

    def dev_from_value_blocks(self, blocks: torch.Tensor) -> torch.Tensor:
        """`elements_per_block()` elements from value-hash blocks
        int32[..., B, 4]: int32[..., epb, nlimbs]."""
        lanes = limb.to_byte_lanes(
            blocks.reshape(blocks.shape[:-2] + (blocks.shape[-2] * 4,)))
        ebytes = self.bits // 8
        parts = [self.dev_parse_direct(lanes, e * ebytes)
                 for e in range(self.elements_per_block())]
        return torch.stack(parts, dim=-2)

    def dev_take_element(self, values, indices) -> torch.Tensor:
        """values int32[..., epb, nlimbs], indices int64[...] ->
        int32[..., nlimbs]: element `indices` of each batch position."""
        idx = indices[..., None, None].expand(indices.shape + (1, values.shape[-1]))
        return torch.gather(values, -2, idx)[..., 0, :]


@dataclasses.dataclass(frozen=True)
class IntType(_LimbValueType):
    """Unsigned integer mod 2^bits; bits in {8, 16, 32, 64, 128}."""

    bits: int

    def __post_init__(self):
        if self.bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"unsupported integer bitsize {self.bits}")

    def validate(self, v) -> None:
        if not isinstance(v, int) or not (0 <= v < (1 << self.bits)):
            raise ValueError(f"value {v!r} out of range for uint{self.bits}")

    def add(self, a, b):
        return (a + b) & ((1 << self.bits) - 1)

    def neg(self, a):
        return (-a) & ((1 << self.bits) - 1)

    def dev_add(self, a, b) -> torch.Tensor:
        return limb.mask_top_bits(limb.add(a, b), self.bits)

    def dev_neg(self, a) -> torch.Tensor:
        return limb.mask_top_bits(limb.neg(a), self.bits)


@dataclasses.dataclass(frozen=True)
class XorType(_LimbValueType):
    """Integer whose group operation is XOR (GF(2^n) shares): the block
    type of PIR selection vectors."""

    bits: int

    def __post_init__(self):
        if self.bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"unsupported xor bitsize {self.bits}")

    def validate(self, v) -> None:
        if not isinstance(v, int) or not (0 <= v < (1 << self.bits)):
            raise ValueError(f"value {v!r} out of range for xor{self.bits}")

    def add(self, a, b):
        return a ^ b

    def neg(self, a):
        return a

    def dev_add(self, a, b) -> torch.Tensor:
        return a ^ b

    def dev_neg(self, a) -> torch.Tensor:
        return a
