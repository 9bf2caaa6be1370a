"""AES-128 on the host: the numpy half of the JAX package's `ops/aes.py`.

A straightforward table-based AES-128 (`aes_encrypt_np`), validated
against the FIPS-197 known-answer vectors, plus the fixed-key MMO hash
`H(x) = AES_k(sigma(x)) ^ sigma(x)` with `sigma(x) = (hi ^ lo, hi)`.
Key generation and the host zeros-walk use it; the device path runs the
bitsliced plane form (`aes_bitslice.py`, and the CUDA kernels).

Block convention throughout the port: a 128-bit block is `uint32[4]`
limbs, little-endian (limb 0 = bits 0..31). Byte j of a block is
`(limbs[j // 4] >> (8 * (j % 4))) & 0xFF`, and AES consumes bytes in
index order b0..b15.
"""

from __future__ import annotations

import numpy as np

_AES_POLY = 0x11B  # x^8 + x^4 + x^3 + x + 1


def _gf_mul(a: int, b: int) -> int:
    """Multiply in GF(2^8) mod x^8+x^4+x^3+x+1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= _AES_POLY
        b >>= 1
    return r


def _make_sbox() -> np.ndarray:
    """Generate the AES S-box: GF(2^8) inverse followed by the affine map."""
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        res = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            res |= bit << i
        sbox[x] = res
    return sbox


SBOX = _make_sbox()

# ShiftRows permutation on flat byte index r + 4*c: row r rotates left by r,
# i.e. output byte position r+4c takes input byte _SHIFT_ROWS[r+4c].
_SHIFT_ROWS = np.array(
    [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)], dtype=np.int32
)

_RCON = np.array(
    [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
    dtype=np.uint8,
)


def key_expansion(key: bytes | np.ndarray) -> np.ndarray:
    """AES-128 key schedule. Returns round keys as uint8[11, 16]."""
    if isinstance(key, (bytes, bytearray)):
        key = np.frombuffer(bytes(key), dtype=np.uint8)
    else:
        key = np.asarray(key, dtype=np.uint8)
    if key.size != 16:
        raise ValueError("AES-128 key must be 16 bytes")
    words = [key[4 * i : 4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)  # RotWord
            temp = SBOX[temp]  # SubWord
            temp[0] ^= _RCON[i // 4 - 1]
        words.append(words[i - 4] ^ temp)
    return np.concatenate(words).reshape(11, 16)


def _xtime_np(b: np.ndarray) -> np.ndarray:
    return (
        ((b.astype(np.uint16) << 1) ^ ((b >> 7).astype(np.uint16) * 0x1B))
        & 0xFF
    ).astype(np.uint8)


def _mix_columns_np(state: np.ndarray) -> np.ndarray:
    """MixColumns on uint8[N, 16] (flat index r + 4c)."""
    s = state.reshape(-1, 4, 4)  # [N, column, row]
    s0, s1, s2, s3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    t = s0 ^ s1 ^ s2 ^ s3
    out = np.empty_like(s)
    out[:, :, 0] = s0 ^ t ^ _xtime_np(s0 ^ s1)
    out[:, :, 1] = s1 ^ t ^ _xtime_np(s1 ^ s2)
    out[:, :, 2] = s2 ^ t ^ _xtime_np(s2 ^ s3)
    out[:, :, 3] = s3 ^ t ^ _xtime_np(s3 ^ s0)
    return out.reshape(-1, 16)


def aes_encrypt_np(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt uint8[N, 16] blocks with uint8[11, 16] round keys (ECB)."""
    state = blocks.astype(np.uint8) ^ round_keys[0]
    for rnd in range(1, 10):
        state = SBOX[state]
        state = state[:, _SHIFT_ROWS]
        state = _mix_columns_np(state)
        state ^= round_keys[rnd]
    state = SBOX[state]
    state = state[:, _SHIFT_ROWS]
    state ^= round_keys[10]
    return state


def limbs_to_bytes_np(limbs: np.ndarray) -> np.ndarray:
    """uint32[..., 4] -> uint8[..., 16] little-endian."""
    return np.ascontiguousarray(limbs.astype("<u4")).view(np.uint8)


def bytes_to_limbs_np(b: np.ndarray) -> np.ndarray:
    """uint8[..., 16] -> uint32[..., 4] little-endian."""
    b = np.ascontiguousarray(b.astype(np.uint8))
    return b.view("<u4").astype(np.uint32)


def u128_to_limbs(x: int) -> np.ndarray:
    """Python int -> uint32[4] little-endian limbs."""
    return np.array(
        [(x >> (32 * i)) & 0xFFFFFFFF for i in range(4)], dtype=np.uint32
    )


def u128s_to_limbs(values) -> np.ndarray:
    """Python ints below 2^128 -> uint32[len(values), 4] little-endian
    limbs, in one bytes join."""
    data = b"".join(v.to_bytes(16, "little") for v in values)
    return np.frombuffer(data, dtype="<u4").astype(np.uint32).reshape(-1, 4)


def limbs_to_u128s(limbs) -> list:
    """uint32[..., 4] little-endian limbs -> a flat list of Python ints."""
    data = np.ascontiguousarray(limbs, dtype="<u4").tobytes()
    return [int.from_bytes(data[i:i + 16], "little") for i in range(0, len(data), 16)]


def limbs_to_u128(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.uint64)
    return int(sum(int(limbs[..., i]) << (32 * i) for i in range(4)))


def sigma_np(blocks: np.ndarray) -> np.ndarray:
    """sigma(x) = (hi ^ lo, hi) on uint32[..., 4] limbs (low 64 = hi)."""
    lo = blocks[..., 0:2]
    hi = blocks[..., 2:4]
    return np.concatenate([hi, hi ^ lo], axis=-1)


def mmo_hash_np(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """H(x) = AES_k(sigma(x)) ^ sigma(x) on uint32[..., 4] limbs."""
    s = sigma_np(np.asarray(blocks, dtype=np.uint32))
    shape = s.shape
    enc = aes_encrypt_np(round_keys, limbs_to_bytes_np(s.reshape(-1, 4)))
    return bytes_to_limbs_np(enc).reshape(shape) ^ s
