"""The numpy backend of the hybrid scheme, for hosts without `cryptography`.

The port's copy of the JAX package's `crypto/_fallback.py`: the three
primitives `hybrid.py` needs, on what the port already has. X25519 is the
RFC 7748 Montgomery ladder over Python ints, HKDF-SHA256 follows RFC 5869
on the standard library's `hmac`, and AES-128-GCM runs on the port's numpy
AES (`ops/aes.py`) with GHASH through per-key byte tables (Shoup's
method: sixteen lookups a block). Outputs are byte-identical to the
`cryptography` primitives, so ciphertexts cross backends and packages, and
the fixed test keyset works with both.

This is the compatibility backend, not a constant-time implementation:
`hybrid.py` takes the `cryptography` package whenever it imports.
"""

from __future__ import annotations

import hashlib
import hmac

import numpy as np

from ..ops import aes

_P = 2**255 - 19
_A24 = 121665


# ---------------------------------------------------------------------------
# X25519 (RFC 7748 §5)
# ---------------------------------------------------------------------------


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("X25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("X25519 u-coordinate must be 32 bytes")
    b = bytearray(u)
    b[31] &= 127
    return int.from_bytes(b, "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """Scalar multiplication on Curve25519; raises on an all-zero
    result (non-contributory exchange), like the hazmat backend."""
    k, x1 = _decode_scalar(scalar), _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    out = x2 * pow(z2, _P - 2, _P) % _P
    if out == 0:
        raise ValueError("X25519 exchange produced the zero point")
    return out.to_bytes(32, "little")


def x25519_public(private_bytes: bytes) -> bytes:
    """Public key for a raw private scalar (base point u=9)."""
    return x25519(private_bytes, (9).to_bytes(32, "little"))


# ---------------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869)
# ---------------------------------------------------------------------------


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    if length > 255 * 32:
        raise ValueError("HKDF output too long")
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm, block = b"", b""
    counter = 1
    while len(okm) < length:
        block = hmac.new(
            prk, block + info + bytes([counter]), hashlib.sha256
        ).digest()
        okm += block
        counter += 1
    return okm[:length]


# ---------------------------------------------------------------------------
# AES-128-GCM (NIST SP 800-38D), AES blocks via the numpy oracle
# ---------------------------------------------------------------------------

_R = 0xE1 << 120


def _ghash_tables(h: int) -> list:
    """tables[j][b] = (b placed at byte j of a block) * h in GF(2^128),
    GCM's reflected-bit convention: a block's product with h is the XOR
    of tables[j][byte j] over its 16 bytes (the product is linear)."""
    # powers[k] = the block with only bit k set (big-endian int) times h:
    # bit 127 is x^0, and each step down multiplies by x.
    powers = [0] * 128
    v = h
    for k in range(127, -1, -1):
        powers[k] = v
        v = (v >> 1) ^ _R if v & 1 else v >> 1
    tables = []
    for j in range(16):
        shift = 8 * (15 - j)
        t = [0] * 256
        for b in range(1, 256):
            low = b & -b
            t[b] = t[b ^ low] ^ powers[shift + low.bit_length() - 1]
        tables.append(t)
    return tables


def _ghash(tables: list, *segments: bytes) -> int:
    """GHASH over zero-padded segments followed by the length block."""
    y = 0
    lens = (len(segments[0]) * 8).to_bytes(8, "big") + (
        len(segments[1]) * 8
    ).to_bytes(8, "big")
    for seg in segments + (lens,):
        for i in range(0, len(seg), 16):
            block = (y ^ int.from_bytes(seg[i:i + 16].ljust(16, b"\x00"), "big")
                     ).to_bytes(16, "big")
            y = 0
            for t, byte in zip(tables, block):
                y ^= t[byte]
    return y


class AesGcm:
    """AES-128-GCM with 12-byte nonces and a full 16-byte tag."""

    def __init__(self, key: bytes):
        if len(key) != 16:
            raise ValueError("AES-128-GCM key must be 16 bytes")
        self._round_keys = aes.key_expansion(key)
        self._tables = _ghash_tables(int.from_bytes(self._ecb(b"\x00" * 16), "big"))

    def _ecb(self, block: bytes) -> bytes:
        arr = np.frombuffer(block, dtype=np.uint8).reshape(1, 16)
        return aes.aes_encrypt_np(self._round_keys, arr).tobytes()

    def _keystream(self, j0: int, nbytes: int) -> np.ndarray:
        """uint8[nbytes] of AES-CTR from inc32(j0): the low 32-bit word of
        the counter wraps on its own."""
        num_blocks = (nbytes + 15) // 16
        low = (np.arange(1, num_blocks + 1, dtype=np.uint64)
               + np.uint64(j0 & 0xFFFFFFFF)) & np.uint64(0xFFFFFFFF)
        ctrs = np.empty((num_blocks, 16), dtype=np.uint8)
        ctrs[:, :12] = np.frombuffer((j0 >> 32).to_bytes(12, "big"), dtype=np.uint8)
        ctrs[:, 12:] = low.astype(">u4").view(np.uint8).reshape(-1, 4)
        return aes.aes_encrypt_np(self._round_keys, ctrs).reshape(-1)[:nbytes]

    def _xor_stream(self, j0: int, data: bytes) -> bytes:
        return (np.frombuffer(data, dtype=np.uint8)
                ^ self._keystream(j0, len(data))).tobytes()

    def _tag(self, j0: int, ciphertext: bytes, aad: bytes) -> bytes:
        s = _ghash(self._tables, aad, ciphertext)
        ek_j0 = self._ecb(
            ((j0 >> 32).to_bytes(12, "big") + (j0 & 0xFFFFFFFF).to_bytes(4, "big"))
        )
        return (s ^ int.from_bytes(ek_j0, "big")).to_bytes(16, "big")

    def encrypt(self, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        if len(nonce) != 12:
            raise ValueError("GCM nonce must be 12 bytes")
        j0 = (int.from_bytes(nonce, "big") << 32) | 1
        ct = self._xor_stream(j0, plaintext)
        return ct + self._tag(j0, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        if len(nonce) != 12:
            raise ValueError("GCM nonce must be 12 bytes")
        if len(data) < 16:
            raise ValueError("ciphertext shorter than the GCM tag")
        ct, tag = data[:-16], data[-16:]
        j0 = (int.from_bytes(nonce, "big") << 32) | 1
        if not hmac.compare_digest(tag, self._tag(j0, ct, aad)):
            raise ValueError("GCM authentication failed")
        return self._xor_stream(j0, ct)
