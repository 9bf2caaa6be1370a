"""FarmHash-based hash family.

Mirrors the reference's `pir/hashing/farm_hash_family.h:28-44`: a
`HashFunction` whose seed is `util::Hash128(seed_string)` and whose value is
`util::Hash128WithSeed(input, seed) mod upper_bound` (taking the 128-bit
hash as `MakeUint128(hash.second, hash.first)`,
`farm_hash_family.cc:25-30`).

farmhash's `Hash128` / `Hash128WithSeed` are the farmhashcc variants, i.e.
the CityHash128 algorithm (cityhash v1.1); this module implements that
algorithm in pure Python over 64-bit masked integers. Hashing here is
host-side table-construction work (cuckoo hashing), not a device hot path.
"""

from __future__ import annotations

from typing import Tuple

M64 = (1 << 64) - 1

K0 = 0xC3A5C85C97CB3127
K1 = 0xB492B66FBE98F273
K2 = 0x9AE16A3B2F90404F
K_MUL = 0x9DDFEA08EB382D69


def _fetch64(s: bytes, i: int = 0) -> int:
    return int.from_bytes(s[i : i + 8], "little")


def _fetch32(s: bytes, i: int = 0) -> int:
    return int.from_bytes(s[i : i + 4], "little")


def _rotate(val: int, shift: int) -> int:
    if shift == 0:
        return val
    return ((val >> shift) | (val << (64 - shift))) & M64


def _shift_mix(val: int) -> int:
    return (val ^ (val >> 47)) & M64


def _hash_len_16_mul(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & M64
    a ^= a >> 47
    b = ((v ^ a) * mul) & M64
    b ^= b >> 47
    return (b * mul) & M64


def _hash_len_16(u: int, v: int) -> int:
    return _hash_len_16_mul(u, v, K_MUL)


def _hash_len_0_to_16(s: bytes) -> int:
    n = len(s)
    if n >= 8:
        mul = (K2 + n * 2) & M64
        a = (_fetch64(s) + K2) & M64
        b = _fetch64(s, n - 8)
        c = (_rotate(b, 37) * mul + a) & M64
        d = ((_rotate(a, 25) + b) * mul) & M64
        return _hash_len_16_mul(c, d, mul)
    if n >= 4:
        mul = (K2 + n * 2) & M64
        a = _fetch32(s)
        return _hash_len_16_mul(
            (n + (a << 3)) & M64, _fetch32(s, n - 4), mul
        )
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & 0xFFFFFFFF
        z = (n + (c << 2)) & 0xFFFFFFFF
        return (_shift_mix((y * K2 ^ z * K0) & M64) * K2) & M64
    return K2


def _weak_hash_len_32_with_seeds(
    w: int, x: int, y: int, z: int, a: int, b: int
) -> Tuple[int, int]:
    a = (a + w) & M64
    b = _rotate((b + a + z) & M64, 21)
    c = a
    a = (a + x + y) & M64
    b = (b + _rotate(a, 44)) & M64
    return (a + z) & M64, (b + c) & M64


def _weak_hash_32_seeds_bytes(s: bytes, i: int, a: int, b: int):
    return _weak_hash_len_32_with_seeds(
        _fetch64(s, i),
        _fetch64(s, i + 8),
        _fetch64(s, i + 16),
        _fetch64(s, i + 24),
        a,
        b,
    )


def _city_murmur(s: bytes, seed: Tuple[int, int]) -> Tuple[int, int]:
    """(low, high) seed -> (low, high) hash, for inputs under 128 bytes."""
    a, b = seed
    n = len(s)
    l = n - 16
    if l <= 0:
        a = (_shift_mix((a * K1) & M64) * K1) & M64
        c = (b * K1 + _hash_len_0_to_16(s)) & M64
        d = _shift_mix((a + (_fetch64(s) if n >= 8 else c)) & M64)
    else:
        c = _hash_len_16((_fetch64(s, n - 8) + K1) & M64, a)
        d = _hash_len_16((b + n) & M64, (c + _fetch64(s, n - 16)) & M64)
        a = (a + d) & M64
        i = 0
        while True:
            a ^= (_shift_mix((_fetch64(s, i) * K1) & M64) * K1) & M64
            a = (a * K1) & M64
            b ^= a
            c ^= (_shift_mix((_fetch64(s, i + 8) * K1) & M64) * K1) & M64
            c = (c * K1) & M64
            d ^= c
            i += 16
            l -= 16
            if l <= 0:
                break
    a = _hash_len_16(a, c)
    b = _hash_len_16(d, b)
    return (a ^ b) & M64, _hash_len_16(b, a)


def hash128_with_seed(s: bytes, seed: Tuple[int, int]) -> Tuple[int, int]:
    """CityHash128WithSeed (farmhashcc `Hash128WithSeed`): (low, high)."""
    n = len(s)
    if n < 128:
        return _city_murmur(s, seed)
    x, y = seed
    z = (n * K1) & M64
    v0 = (_rotate(y ^ K1, 49) * K1 + _fetch64(s)) & M64
    v1 = (_rotate(v0, 42) * K1 + _fetch64(s, 8)) & M64
    w0 = (_rotate((y + z) & M64, 35) * K1 + x) & M64
    w1 = (_rotate((x + _fetch64(s, 88)) & M64, 53) * K1) & M64
    i = 0
    while True:
        for _ in range(2):
            x = (_rotate((x + y + v0 + _fetch64(s, i + 8)) & M64, 37) * K1) & M64
            y = (_rotate((y + v1 + _fetch64(s, i + 48)) & M64, 42) * K1) & M64
            x ^= w1
            y = (y + v0 + _fetch64(s, i + 40)) & M64
            z = (_rotate((z + w0) & M64, 33) * K1) & M64
            v0, v1 = _weak_hash_32_seeds_bytes(
                s, i, (v1 * K1) & M64, (x + w0) & M64
            )
            w0, w1 = _weak_hash_32_seeds_bytes(
                s, i + 32, (z + w1) & M64, (y + _fetch64(s, i + 16)) & M64
            )
            z, x = x, z
            i += 64
        n -= 128
        if n < 128:
            break
    x = (x + _rotate((v0 + z) & M64, 49) * K0) & M64
    y = (y * K0 + _rotate(w1, 37)) & M64
    z = (z * K0 + _rotate(w0, 27)) & M64
    w0 = (w0 * 9) & M64
    v0 = (v0 * K0) & M64
    tail_done = 0
    while tail_done < n:
        tail_done += 32
        y = (_rotate((x + y) & M64, 42) * K0 + v1) & M64
        w0 = (w0 + _fetch64(s, i + n - tail_done + 16)) & M64
        x = (x * K0 + w0) & M64
        z = (z + w1 + _fetch64(s, i + n - tail_done)) & M64
        w1 = (w1 + v0) & M64
        v0, v1 = _weak_hash_32_seeds_bytes(
            s, i + n - tail_done, (v0 + z) & M64, v1
        )
        v0 = (v0 * K0) & M64
    x = _hash_len_16(x, v0)
    y = _hash_len_16((y + z) & M64, w0)
    return (
        (_hash_len_16((x + v1) & M64, w1) + y) & M64,
        _hash_len_16((x + w1) & M64, (y + v1) & M64),
    )


def hash128(s: bytes) -> Tuple[int, int]:
    """CityHash128 (farmhashcc `Hash128`): (low, high)."""
    if len(s) >= 16:
        return hash128_with_seed(
            s[16:], (_fetch64(s), (_fetch64(s, 8) + K0) & M64)
        )
    return hash128_with_seed(s, (K0, K1))


class FarmHashFunction:
    """Seeded farmhash -> [0, upper_bound) (`farm_hash_family.h:28-37`)."""

    def __init__(self, seed: str | bytes):
        if isinstance(seed, str):
            seed = seed.encode()
        self._seed = hash128(seed)

    def __call__(self, value: str | bytes, upper_bound: int) -> int:
        if upper_bound <= 0:
            raise ValueError("upper_bound must be positive")
        if isinstance(value, str):
            value = value.encode()
        low, high = hash128_with_seed(value, self._seed)
        # `absl::MakeUint128(hash.second, hash.first)` — high word is the
        # second element (`farm_hash_family.cc:27-29`).
        return ((high << 64) | low) % upper_bound


def farm_hash_family(seed: str | bytes) -> FarmHashFunction:
    """`HashFamily`: seed -> seeded `FarmHashFunction`."""
    return FarmHashFunction(seed)
