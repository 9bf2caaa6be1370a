"""Seeded AES-128-CTR PRNG for the PIR one-time-pad masking.

The port of the JAX package's `prng.py`, the equivalent of the reference's
`Aes128CtrSeededPrng`: a deterministic byte stream from a 16-byte seed
(the AES key) and an optional 16-byte nonce (the initial counter). The
counter is the whole 16-byte block read big-endian and incremented once
per block (OpenSSL's `AES_ctr128_encrypt`), and the stream position holds
across `get_random_bytes` calls of any length. It runs on the host, on
the port's numpy AES (`ops/aes.py`): the pad touches response bytes,
which are on the host already.
"""

from __future__ import annotations

import secrets

import numpy as np

from .ops import aes

SEED_SIZE = 16
_U64 = (1 << 64) - 1


def generate_seed() -> bytes:
    """A cryptographically random 16-byte seed."""
    return secrets.token_bytes(SEED_SIZE)


def _counter_blocks(counter: int, num_blocks: int) -> np.ndarray:
    """uint8[num_blocks, 16]: counter, counter + 1, ... mod 2^128, each
    block big-endian."""
    lo = np.arange(num_blocks, dtype=np.uint64) + np.uint64(counter & _U64)
    # A low word that wrapped carries one into the high word.
    hi = np.uint64(counter >> 64) + (lo < np.uint64(counter & _U64)).astype(np.uint64)
    return np.stack([hi, lo], axis=1).astype(">u8").view(np.uint8)


class Aes128CtrSeededPrng:
    """Deterministic AES-128-CTR byte stream from (seed, nonce)."""

    def __init__(self, seed: bytes, nonce: bytes = b"\x00" * SEED_SIZE):
        if len(seed) != SEED_SIZE:
            raise ValueError(f"seed must be {SEED_SIZE} bytes")
        if len(nonce) != SEED_SIZE:
            raise ValueError(f"nonce must be {SEED_SIZE} bytes")
        self._round_keys = aes.key_expansion(seed)
        self._counter = int.from_bytes(nonce, "big")
        self._partial = b""  # unconsumed tail of the last keystream block

    def get_random_bytes(self, length: int) -> bytes:
        """The next `length` pseudorandom bytes of the stream."""
        if length < 0:
            raise ValueError("length must be non-negative")
        out = self._partial[:length]
        self._partial = self._partial[length:]
        remaining = length - len(out)
        if remaining > 0:
            num_blocks = (remaining + 15) // 16
            ctrs = _counter_blocks(self._counter, num_blocks)
            self._counter = (self._counter + num_blocks) % (1 << 128)
            stream = aes.aes_encrypt_np(self._round_keys, ctrs).tobytes()
            out += stream[:remaining]
            self._partial = stream[remaining:]
        return out


def xor_bytes(a: bytes, b: bytes) -> bytes:
    """Elementwise XOR of two equal-length byte strings."""
    if len(a) != len(b):
        raise ValueError("length mismatch")
    return (
        np.frombuffer(a, dtype=np.uint8) ^ np.frombuffer(b, dtype=np.uint8)
    ).tobytes()


def mask_all(responses, prng: Aes128CtrSeededPrng):
    """Each response XOR the next len(response) bytes of `prng`'s stream,
    in order: what one `get_random_bytes` call per response gives, drawn
    in one call (the pad of the Helper, and the client's unmasking)."""
    lengths = [len(r) for r in responses]
    pad = np.frombuffer(prng.get_random_bytes(sum(lengths)), dtype=np.uint8)
    data = np.frombuffer(b"".join(responses), dtype=np.uint8) ^ pad
    out, offset = [], 0
    for n in lengths:
        out.append(data[offset:offset + n].tobytes())
        offset += n
    return out
