"""Limb arithmetic on int32 words: the port of the JAX package's
`ops/limb.py`.

Wide integers are little-endian limb tensors `int32[..., n]` (limb 0 least
significant), each limb a 32-bit word carried as `torch.int32`
(`ops/words.py`). Carries and borrows go through int64 temporaries, so
additions and subtractions wrap mod 2^(32n) exactly as the JAX package's
uint32 carry chains do. `divmod_const`, the division of IntModN sampling,
is a long division in int64 on 32- or 16-bit digits where the modulus
allows it (torch has no full unsigned 64-bit arithmetic on CUDA), and a
binary long division on 32-bit digits above that.
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


def _carried(s: torch.Tensor) -> torch.Tensor:
    """int64[..., n] limbwise sums or differences -> int32[..., n] words
    mod 2^(32n): each limb's carry or borrow (its arithmetic shift by 32:
    1, 0 or -1) passes up in turn, in place. A few ops for all limbs, not
    a dozen a limb."""
    for i in range(1, s.shape[-1]):
        s[..., i] += s[..., i - 1] >> 32
    return _w32(s & _M32)


def _scalar_limbs(s: torch.Tensor, k: int, sign: int) -> torch.Tensor:
    """Add sign * (the limbs of a non-negative Python int k) to int64[...,
    n], in place, limb by limb (no host-to-device copy)."""
    for i in range(s.shape[-1]):
        limb = (k >> (32 * i)) & _M32
        if limb:
            s[..., i] += sign * limb
    return s


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limbwise add with carry propagation; both int32[..., n], same n."""
    return _carried(_u64(a) + _u64(b))


def add_scalar(a: torch.Tensor, k: int) -> torch.Tensor:
    """Add a non-negative Python int to int32[..., n] limbs (mod 2^(32n))."""
    return _carried(_scalar_limbs(_u64(a), k, 1))


def _const_limbs(b, n: int):
    """A limb operand: a tensor's limbs as int64 values, or a Python int's
    n limbs as Python ints (no host-to-device copy)."""
    if isinstance(b, int):
        return [(b >> (32 * i)) & _M32 for i in range(n)]
    return [_u64(b[..., i]) for i in range(n)]


def sub(a: torch.Tensor, b) -> torch.Tensor:
    """Limbwise subtract with borrow, mod 2^(32n): a int32[..., n], b the
    same shape or a non-negative Python int."""
    if isinstance(b, int):
        return _carried(_scalar_limbs(_u64(a), b, -1))
    return _carried(_u64(a) - _u64(b))


def ge(a: torch.Tensor, b) -> torch.Tensor:
    """a >= b as unsigned integers over limbs; b a tensor of a's shape or a
    non-negative Python int. Returns bool[...]."""
    n = a.shape[-1]
    bl = _const_limbs(b, n)
    res = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(n):  # low to high: the most significant limb decides last
        ai = _u64(a[..., i])
        res = (ai > bl[i]) | ((ai == bl[i]) & res)
    return res


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


def from_byte_lanes(b: torch.Tensor) -> torch.Tensor:
    """int32[..., 4n] byte values -> int32[..., n] limbs, little-endian."""
    nb = b.shape[-1]
    if nb % 4:
        raise ValueError("byte lane count must be a multiple of 4")
    b = b.reshape(b.shape[:-1] + (nb // 4, 4))
    out = b[..., 0]
    for k in range(1, 4):
        out = out | (b[..., k] << (8 * k))
    return out


def _digits(x: torch.Tensor, bits: int) -> list:
    """int32[..., n] limbs -> int64 digits of `bits` (16 or 32) bits,
    most significant first."""
    out = []
    for i in range(x.shape[-1] - 1, -1, -1):
        w = _u64(x[..., i])
        out += [w] if bits == 32 else [w >> 16, w & 0xFFFF]
    return out


def _from_digits(digits: list, bits: int, q_limbs: int) -> torch.Tensor:
    """int64 digits (most significant first) -> int32[..., q_limbs] limbs
    of their low 32 * q_limbs bits."""
    per = 32 // bits
    limbs = []
    for i in range(q_limbs):
        w = 0
        for k in range(per):
            j = len(digits) - 1 - (i * per + k)
            if j >= 0:
                w = w | (digits[j] << (bits * k))
        limbs.append(_w32(w) if isinstance(w, torch.Tensor) else
                     torch.zeros_like(digits[0], dtype=torch.int32))
    return torch.stack(limbs, dim=-1)


def divmod_const(x: torch.Tensor, n_const: int, q_limbs: int) -> tuple:
    """Division of int32[..., nl] limbs by a constant 0 < n_const <
    2^(32 nl): (quotient int32[..., q_limbs], remainder int32[..., nl]),
    the quotient's low 32 * q_limbs bits; the JAX package's
    `divmod_const`, exactly.

    A modulus below 2^31 divides 32-bit digits and one below 2^47 16-bit
    digits (the running remainder times the digit base stays below 2^63
    in int64); a larger one runs a binary long division on 32-bit digits,
    from the first bit where the remainder can reach the modulus."""
    nl = x.shape[-1]
    if not 0 < n_const < (1 << (32 * nl)):
        raise ValueError("modulus out of range for the limbs")
    if n_const < (1 << 47):
        bits = 32 if n_const < (1 << 31) else 16
        rem = torch.zeros_like(x[..., 0], dtype=torch.int64)
        qd = []
        for d in _digits(x, bits):
            cur = (rem << bits) | d
            q = torch.div(cur, n_const, rounding_mode="floor")
            rem = cur - q * n_const
            qd.append(q)
        r = [rem & _M32, rem >> 32] + [torch.zeros_like(rem)] * (nl - 2)
        return _from_digits(qd, bits, q_limbs), torch.stack(
            [_w32(v) for v in r[:nl]], dim=-1)
    nbits = 32 * nl
    n_limbs = [(n_const >> (32 * i)) & _M32 for i in range(nl)]
    skip = n_const.bit_length() - 1  # the first `skip` prefix bits stay below n
    words = [_u64(x[..., i]) for i in range(nl)]
    # The remainder after `skip` bits: x >> (nbits - skip), no subtraction.
    shift = nbits - skip
    rem = []
    for i in range(nl):
        lo_bit = shift + 32 * i
        w = 0
        if lo_bit // 32 < nl:
            w = words[lo_bit // 32] >> (lo_bit % 32)
            if lo_bit % 32 and lo_bit // 32 + 1 < nl:
                w = w | ((words[lo_bit // 32 + 1] << (32 - lo_bit % 32)) & _M32)
        rem.append(w if isinstance(w, torch.Tensor) else torch.zeros_like(words[0]))
    qbits = []
    for j in range(nbits - skip - 1, -1, -1):
        bit = (words[j >> 5] >> (j & 31)) & 1
        # rem = 2 rem + bit: below 2 n < 2^(nbits + 1), one carry limb.
        carry = bit
        for i in range(nl):
            v = (rem[i] << 1) | carry
            carry = v >> 32
            rem[i] = v & _M32
        geq = carry > 0
        eq = torch.ones_like(geq)
        for i in range(nl - 1, -1, -1):
            geq = geq | (eq & (rem[i] > n_limbs[i]))
            eq = eq & (rem[i] == n_limbs[i])
        geq = geq | eq
        borrow = 0
        for i in range(nl):
            d = rem[i] - n_limbs[i] - borrow
            borrow = (d < 0).to(torch.int64)
            rem[i] = torch.where(geq, d & _M32, rem[i])
        qbits.append(geq.to(torch.int64))
    q_words = []
    for i in range(q_limbs):
        w = torch.zeros_like(words[0])
        for b in range(32):
            j = 32 * i + b
            if j < len(qbits):
                w = w | (qbits[len(qbits) - 1 - j] << b)
        q_words.append(_w32(w))
    return torch.stack(q_words, dim=-1), torch.stack([_w32(v) for v in rem], dim=-1)
