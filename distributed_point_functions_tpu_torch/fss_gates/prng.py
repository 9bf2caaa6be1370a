"""Secure PRNGs for FSS gate key generation: the port of the JAX package's
`fss_gates/prng.py` (the reference's `dcf/fss_gates/prng/`).

`SecurePrng` is the sampling interface (8-, 64- and 128-bit draws);
`BasicRng` draws from the operating system's CSPRNG; `CounterPrng` is a
deterministic stream over the port's AES-128-CTR (`prng.py`), so tests
and benchmarks can fix a gate's keys.
"""

from __future__ import annotations

import secrets

from ..prng import Aes128CtrSeededPrng


class SecurePrng:
    """Abstract secure PRNG."""

    def rand8(self) -> int:
        raise NotImplementedError

    def rand64(self) -> int:
        raise NotImplementedError

    def rand128(self) -> int:
        raise NotImplementedError


class BasicRng(SecurePrng):
    """The operating system's CSPRNG (the reference's `BasicRng`, whose
    seed argument is ignored: it always draws fresh randomness)."""

    def __init__(self, seed: bytes = b""):
        del seed

    def rand8(self) -> int:
        return secrets.randbits(8)

    def rand64(self) -> int:
        return secrets.randbits(64)

    def rand128(self) -> int:
        return secrets.randbits(128)


class CounterPrng(SecurePrng):
    """A deterministic PRNG: little-endian draws from the AES-128-CTR stream
    of a 16-byte seed."""

    def __init__(self, seed: bytes = b"\x00" * 16):
        self._prng = Aes128CtrSeededPrng(seed)

    def rand8(self) -> int:
        return self._prng.get_random_bytes(1)[0]

    def rand64(self) -> int:
        return int.from_bytes(self._prng.get_random_bytes(8), "little")

    def rand128(self) -> int:
        return int.from_bytes(self._prng.get_random_bytes(16), "little")
