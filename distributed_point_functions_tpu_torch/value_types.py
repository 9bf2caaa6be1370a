"""Value types of the DPF: `IntType`, `XorType`, `IntModNType` and
`TupleType`, the port of the JAX package's `value_types.py`.

Each type has two faces, as in the JAX package:

* **host face** -- Python-int group arithmetic and byte parsing, used by
  key generation (`add`, `sub`, `neg`, `zero`, `parse_direct`,
  `sample_host`, `from_bytes`, `to_python`);
* **device face** -- limb tensors `int32[..., nlimbs]` (little-endian
  32-bit words, `ops/words.py`), used by evaluation (`dev_zeros`,
  `dev_const`, `dev_add`, `dev_neg`, `dev_where`, `dev_parse_direct`,
  `dev_sample`, `dev_from_value_blocks`, `dev_take_element`).

A device value is one limb tensor, or for a `TupleType` a tuple of device
values (nested for nested tuples) whose leading dimensions are the same
batch dimensions. `tree_map` applies a function to every limb tensor of
one or more such values; code that handles values of any type goes
through it rather than touching `.shape` or `torch.stack` on one tensor.

Packing follows the reference: a type of `b <= 128` bits that converts
directly packs `128 // b` elements per 128-bit leaf block, which shortens
the evaluation tree. Types that do not (`IntModNType`, tuples holding one)
are *sampled* from the value hash's byte stream by the iterated div/mod
chain of the reference's `int_mod_n.h` (`_HostSampleState`,
`_DevSampleState`), one element per leaf over as many 128-bit blocks as
the statistical security needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .ops import limb
from .ops.words import i32, lsr, to_numpy, to_tensor

_U128_MASK = (1 << 128) - 1


def tree_map(fn, *values):
    """`fn` over the limb tensors (or host arrays) of one or more values of
    one type, leaf by leaf: a tuple value maps element by element, anything
    else is a leaf."""
    if isinstance(values[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*values))
    return fn(*values)


def tree_leaves(value) -> list:
    """The leaves of a value in order (see `tree_map`)."""
    if isinstance(value, tuple):
        return [leaf for x in value for leaf in tree_leaves(x)]
    return [value]


def tree_unflatten(like, leaves):
    """A value shaped like `like` whose leaves are taken in order from the
    iterator `leaves`."""
    if isinstance(like, tuple):
        return tuple(tree_unflatten(x, leaves) for x in like)
    return next(leaves)


def _nlimbs(bits: int) -> int:
    return max(1, (bits + 31) // 32)


class _HostSampleState:
    """Sequential sampling state: a 128-bit accumulator and the byte stream
    it refills from."""

    def __init__(self, data: bytes):
        self.block = int.from_bytes(data[:16], "little")
        self.data = data
        self.pos = 16

    def next_bytes(self, n: int) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v


class _DevSampleState:
    """`_HostSampleState` on the device: the accumulator int32[..., 4] and
    int32[..., nbytes] byte lanes, read at static offsets."""

    def __init__(self, byte_lanes: torch.Tensor):
        self.block = limb.from_byte_lanes(byte_lanes[..., :16])
        self.bytes = byte_lanes
        self.pos = 16


def _parse_dev_bytes(byte_lanes, offset: int, nbytes: int, nl: int) -> torch.Tensor:
    """The little-endian integer of `nbytes` byte lanes at `offset` as
    limbs int32[..., nl] (limbs past the bytes are 0)."""
    limbs = []
    for li in range(nl):
        v = None
        for k in range(4):
            b = 4 * li + k
            if b < nbytes:
                term = byte_lanes[..., offset + b] << (8 * k)
                v = term if v is None else v | term
        limbs.append(v if v is not None else
                     torch.zeros(byte_lanes.shape[:-1], dtype=torch.int32,
                                 device=byte_lanes.device))
    return torch.stack(limbs, dim=-1)


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

    def refill_bytes(self, update: bool) -> int:
        """The bytes past the accumulator's first 16 that sampling one
        element reads (`sample_host`, `dev_sample` with `update`)."""
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
        """One element from `data` (the reference's ConvertBytesToArrayOf):
        parsed where the type converts directly, else sampled."""
        if self.can_convert_directly():
            return self.parse_direct(data, 0)
        return self.sample_host(_HostSampleState(data), update=False)

    def parse_direct(self, data: bytes, offset: int):
        raise NotImplementedError

    def sample_host(self, state: _HostSampleState, update: bool):
        raise NotImplementedError

    def host_const(self, host_value):
        """Host value -> uint32 limbs (a tuple of them for a tuple type):
        batch staging packs these into one host-to-device copy."""
        raise NotImplementedError

    def to_python(self, dev_value, index=()):
        """The host value at batch position `index` of a device value."""
        raise NotImplementedError

    # --- device face -------------------------------------------------------
    def dev_zeros(self, shape, device):
        raise NotImplementedError

    def dev_const(self, host_value, shape, device):
        raise NotImplementedError

    def dev_add(self, a, b):
        raise NotImplementedError

    def dev_neg(self, a):
        raise NotImplementedError

    def dev_where(self, mask, a, b):
        """Per batch element: `a` where `mask` (bool[batch dims]), else `b`."""
        return tree_map(lambda x, y: torch.where(mask[..., None], x, y), a, b)

    def dev_parse_direct(self, byte_lanes, offset: int):
        raise NotImplementedError

    def dev_sample(self, state: _DevSampleState, update: bool):
        raise NotImplementedError

    def dev_from_value_blocks(self, blocks: torch.Tensor):
        """`elements_per_block()` elements from value-hash blocks
        int32[..., B, 4]: a device value of batch shape [..., epb]."""
        lanes = limb.to_byte_lanes(
            blocks.reshape(blocks.shape[:-2] + (blocks.shape[-2] * 4,)))
        if self.can_convert_directly():
            ebytes = (self.total_bit_size() + 7) // 8
            parts = [self.dev_parse_direct(lanes, e * ebytes)
                     for e in range(self.elements_per_block())]
            return tree_map(lambda *xs: torch.stack(xs, dim=-2), *parts)
        value = self.dev_sample(_DevSampleState(lanes), update=False)
        return tree_map(lambda x: x[..., None, :], value)

    def dev_take_element(self, values, indices):
        """values of batch shape [..., epb], indices int64[...] -> the value
        of batch shape [...]: element `indices` of each batch position."""
        def take(x):
            if x.shape[-2] == 1:  # one element a block: no gather
                return x[..., 0, :]
            idx = indices[..., None, None].expand(indices.shape + (1, x.shape[-1]))
            return torch.gather(x, -2, idx)[..., 0, :]

        return tree_map(take, values)


class _LimbValueType(ValueType):
    """A type whose device value is one limb tensor int32[..., nlimbs]."""

    @property
    def nlimbs(self) -> int:
        raise NotImplementedError

    def host_const(self, host_value) -> np.ndarray:
        return limb.to_const(host_value, self.nlimbs)

    def to_python(self, dev_value: torch.Tensor, index=()):
        arr = to_numpy(dev_value)[index]
        return sum(int(arr[i]) << (32 * i) for i in range(self.nlimbs))

    def dev_zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.nlimbs,), dtype=torch.int32,
                           device=device)

    def dev_const(self, host_value, shape, device) -> torch.Tensor:
        c = to_tensor(self.host_const(host_value), device)
        return c.expand(tuple(shape) + (self.nlimbs,))


class _IntValueType(_LimbValueType):
    """An integer of `bits` bits, bits in {8, 16, 32, 64, 128}, converted
    directly from its bytes."""

    bits: int

    @property
    def nlimbs(self) -> int:
        return _nlimbs(self.bits)

    def can_convert_directly(self) -> bool:
        return True

    def total_bit_size(self) -> int:
        return self.bits

    def bits_needed(self, security_parameter: float) -> int:
        return self.bits

    def refill_bytes(self, update: bool) -> int:
        return self.bits // 8 if update else 0

    def zero(self):
        return 0

    def parse_direct(self, data: bytes, offset: int):
        return int.from_bytes(data[offset:offset + self.bits // 8], "little")

    def sample_host(self, state: _HostSampleState, update: bool):
        result = state.block & ((1 << self.bits) - 1)
        if update:
            state.block = (state.block >> self.bits) << self.bits
            state.block |= state.next_bytes(self.bits // 8)
        return result

    def dev_parse_direct(self, byte_lanes, offset: int) -> torch.Tensor:
        return _parse_dev_bytes(byte_lanes, offset, self.bits // 8, self.nlimbs)

    def dev_from_value_blocks(self, blocks: torch.Tensor) -> torch.Tensor:
        """Elements of 32 bits or more are whole words of the blocks: sliced,
        without the byte lanes."""
        if self.bits < 32:
            return super().dev_from_value_blocks(blocks)
        epb, nl = self.elements_per_block(), self.nlimbs
        words = blocks.reshape(blocks.shape[:-2] + (blocks.shape[-2] * 4,))
        return words[..., :epb * nl].reshape(blocks.shape[:-2] + (epb, nl))

    def dev_sample(self, state: _DevSampleState, update: bool) -> torch.Tensor:
        result = limb.mask_top_bits(state.block, self.bits)[..., :self.nlimbs]
        if update:
            if self.bits >= 128:
                cleared = torch.zeros_like(state.block)
            elif self.bits % 32 == 0:
                k = self.bits // 32
                cleared = torch.cat([torch.zeros_like(state.block[..., :k]),
                                     state.block[..., k:]], dim=-1)
            else:  # 8 or 16 bits: clear the low bits of limb 0
                cleared = torch.cat([state.block[..., :1] & i32(~((1 << self.bits) - 1)),
                                     state.block[..., 1:]], dim=-1)
            nxt = _parse_dev_bytes(state.bytes, state.pos, self.bits // 8, 4)
            state.block = cleared | nxt
            state.pos += self.bits // 8
        return result


@dataclasses.dataclass(frozen=True)
class IntType(_IntValueType):
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
class XorType(_IntValueType):
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


@dataclasses.dataclass(frozen=True)
class IntModNType(_LimbValueType):
    """Integers modulo a constant N below 2^base_bits, sampled: the
    accumulator draws 128 bits and iterates `value = acc % N; acc = (acc /
    N) << base_bits | fresh base integer` (the reference's `int_mod_n.h`),
    at statistical distance below 2^-sigma with sigma = 128 + 3 - log2(N) -
    log2(n) - log2(n + 1) for n joint samples."""

    base_bits: int
    modulus: int

    def __post_init__(self):
        if self.base_bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"unsupported base bitsize {self.base_bits}")
        if not (0 < self.modulus < (1 << self.base_bits)):
            raise ValueError("modulus out of range for base integer")

    @property
    def nlimbs(self) -> int:
        return _nlimbs(self.base_bits)

    @staticmethod
    def security_level(num_samples: int, modulus: int) -> float:
        return 128 + 3 - (math.log2(modulus) + math.log2(num_samples)
                          + math.log2(num_samples + 1))

    @classmethod
    def bytes_needed_joint(cls, num_samples: int, base_bits: int, modulus: int,
                           security_parameter: float) -> int:
        sigma = cls.security_level(num_samples, modulus)
        if security_parameter > sigma:
            raise ValueError(
                f"IntModN sampling gives only {sigma:.2f} bits of statistical "
                f"security for num_samples={num_samples}, modulus={modulus}")
        return 16 + (base_bits // 8) * (num_samples - 1)

    def can_convert_directly(self) -> bool:
        return False

    def bits_needed(self, security_parameter: float) -> int:
        return 8 * self.bytes_needed_joint(1, self.base_bits, self.modulus,
                                           security_parameter)

    def refill_bytes(self, update: bool) -> int:
        return self.base_bits // 8 if update else 0

    def validate(self, v) -> None:
        if not isinstance(v, int) or not (0 <= v < self.modulus):
            raise ValueError(f"value {v!r} out of range mod {self.modulus}")

    def zero(self):
        return 0

    def add(self, a, b):
        return (a + b) % self.modulus

    def neg(self, a):
        return (-a) % self.modulus

    def sample_host(self, state: _HostSampleState, update: bool):
        result = state.block % self.modulus
        if update:
            q = state.block // self.modulus
            state.block = (((q << self.base_bits) & _U128_MASK)
                           | state.next_bytes(self.base_bits // 8))
        return result

    def dev_add(self, a, b) -> torch.Tensor:
        s = limb.add(a, b)
        # A wrap past 2^base (s < a) or s >= N: subtract N, mod 2^base.
        over = ~limb.ge(s, a) | limb.ge(s, self.modulus)
        return torch.where(over[..., None], limb.sub(s, self.modulus), s)

    def dev_neg(self, a) -> torch.Tensor:
        is_zero = (a == 0).all(dim=-1)
        return torch.where(is_zero[..., None], a,
                           limb.neg(limb.sub(a, self.modulus)))

    def dev_sample(self, state: _DevSampleState, update: bool) -> torch.Tensor:
        q, r = limb.divmod_const(state.block, self.modulus, 4)
        result = r[..., :self.nlimbs]
        if update:
            s = self.base_bits
            # block = (q << base_bits) | the next base integer, mod 2^128.
            if s >= 128:
                shifted = torch.zeros_like(q)
            elif s % 32 == 0:
                k = s // 32
                shifted = torch.cat([torch.zeros_like(q[..., :k]), q[..., :4 - k]], dim=-1)
            else:  # 8- or 16-bit shifts within limbs
                parts = [q[..., 0] << s]
                for i in range(1, 4):
                    parts.append((q[..., i] << s) | lsr(q[..., i - 1], 32 - s))
                shifted = torch.stack(parts, dim=-1)
            nxt = _parse_dev_bytes(state.bytes, state.pos, s // 8, 4)
            state.block = shifted | nxt
            state.pos += s // 8
        return result


@dataclasses.dataclass(frozen=True)
class TupleType(ValueType):
    """A tuple of value types with element-wise group operations (the
    reference's `tuple.h`). Every IntModN element of a tuple must be the
    same type: they are sampled jointly."""

    elements: tuple

    def __init__(self, elements: Sequence[ValueType]):
        object.__setattr__(self, "elements", tuple(elements))
        if not self.elements:
            raise ValueError("tuple must have at least one element")
        mod_n = [e for e in self.elements if isinstance(e, IntModNType)]
        if mod_n and any(e != mod_n[0] for e in mod_n):
            raise ValueError("all IntModN elements in a tuple must be the same type")

    def can_convert_directly(self) -> bool:
        return all(e.can_convert_directly() for e in self.elements)

    def total_bit_size(self) -> int:
        return sum(e.total_bit_size() for e in self.elements)

    def bits_needed(self, security_parameter: float) -> int:
        mod_n = [e for e in self.elements if isinstance(e, IntModNType)]
        others = [e for e in self.elements if not isinstance(e, IntModNType)]
        bits = 0
        if others:
            per_element = security_parameter + math.log2(len(others))
            bits += sum(e.bits_needed(per_element) for e in others)
        if mod_n:
            e = mod_n[0]
            bits += 8 * IntModNType.bytes_needed_joint(
                len(mod_n), e.base_bits, e.modulus, security_parameter)
        return bits

    def refill_bytes(self, update: bool) -> int:
        # Every element but the last refills the accumulator.
        n = len(self.elements)
        return sum(e.refill_bytes(update or i + 1 < n)
                   for i, e in enumerate(self.elements))

    def validate(self, v) -> None:
        if not isinstance(v, tuple) or len(v) != len(self.elements):
            raise ValueError("tuple value arity mismatch")
        for e, x in zip(self.elements, v):
            e.validate(x)

    def zero(self):
        return tuple(e.zero() for e in self.elements)

    def add(self, a, b):
        return tuple(e.add(x, y) for e, x, y in zip(self.elements, a, b))

    def neg(self, a):
        return tuple(e.neg(x) for e, x in zip(self.elements, a))

    def parse_direct(self, data: bytes, offset: int):
        out = []
        for e in self.elements:
            out.append(e.parse_direct(data, offset))
            offset += (e.total_bit_size() + 7) // 8
        return tuple(out)

    def sample_host(self, state: _HostSampleState, update: bool):
        # Every element but the last refills the accumulator.
        n = len(self.elements)
        return tuple(e.sample_host(state, update or i + 1 < n)
                     for i, e in enumerate(self.elements))

    def host_const(self, host_value):
        return tuple(e.host_const(v) for e, v in zip(self.elements, host_value))

    def to_python(self, dev_value, index=()):
        return tuple(e.to_python(x, index) for e, x in zip(self.elements, dev_value))

    def dev_zeros(self, shape, device):
        return tuple(e.dev_zeros(shape, device) for e in self.elements)

    def dev_const(self, host_value, shape, device):
        return tuple(e.dev_const(v, shape, device)
                     for e, v in zip(self.elements, host_value))

    def dev_add(self, a, b):
        return tuple(e.dev_add(x, y) for e, x, y in zip(self.elements, a, b))

    def dev_neg(self, a):
        return tuple(e.dev_neg(x) for e, x in zip(self.elements, a))

    def dev_parse_direct(self, byte_lanes, offset: int):
        out = []
        for e in self.elements:
            out.append(e.dev_parse_direct(byte_lanes, offset))
            offset += (e.total_bit_size() + 7) // 8
        return tuple(out)

    def dev_sample(self, state: _DevSampleState, update: bool):
        n = len(self.elements)
        return tuple(e.dev_sample(state, update or i + 1 < n)
                     for i, e in enumerate(self.elements))
