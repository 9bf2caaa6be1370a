"""Client side of private heavy hitters: value -> incremental key pair.

Each contributing client holds one (string) value. It encodes the value
as a point `alpha` in the `2^domain_bits` domain and secret-shares the
indicator function `f(x) = 1 iff x = alpha` as an incremental DPF key
pair with value `1` at EVERY hierarchy level — so each server, summing
its shares of all clients' keys over a set of candidate prefixes,
obtains an additive share of the *prefix-count histogram* at any level
of the hierarchy (the `t`-heavy-hitters traversal of
arXiv:2012.14884 §5: count queries over an implicit prefix trie).

The encoding is big-endian so that the high bits of `alpha` are the
leading bytes of the value: truncating `alpha` to a hierarchy level's
domain is exactly taking a prefix of the string.

The port of the JAX package's `heavy_hitters/client.py`. Key generation
runs on the host (its AES on the native library); the client's `device`
(None: the CUDA card, raising without one) is its DPF's, as every entry
point of the port has one.
"""

from __future__ import annotations

from typing import Tuple, Union

from ..dpf import DpfKey
from .protocol import HeavyHittersConfig


def encode_value(
    value: Union[bytes, str, int], domain_bits: int
) -> int:
    """Encode a client value as a domain point (big-endian bit packing).

    `bytes`/`str` values must be exactly `domain_bits / 8` bytes (the
    protocol counts fixed-length strings; pad or hash upstream).
    Integers pass through range-checked.
    """
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, bytes):
        if domain_bits % 8 != 0:
            raise ValueError(
                "bytes values need a byte-aligned domain "
                f"(domain_bits={domain_bits})"
            )
        if len(value) != domain_bits // 8:
            raise ValueError(
                f"value is {len(value)} bytes, domain holds "
                f"{domain_bits // 8}"
            )
        return int.from_bytes(value, "big")
    alpha = int(value)
    if not (0 <= alpha < (1 << domain_bits)):
        raise ValueError(f"value {alpha} out of the {domain_bits}-bit domain")
    return alpha


def decode_value(alpha: int, domain_bits: int) -> bytes:
    """Inverse of `encode_value` for byte-aligned domains."""
    if domain_bits % 8 != 0:
        raise ValueError("decode_value needs a byte-aligned domain")
    return int(alpha).to_bytes(domain_bits // 8, "big")


class HeavyHittersClient:
    """Generates one report (an incremental DPF key pair) per value.

    Key generation is the host-side `generate_keys_incremental`
    recurrence — O(tree depth) per report, never a server hot path
    (one native AES call per tree level and branch). The
    two keys go to the two servers; neither key alone reveals anything
    about the value.
    """

    def __init__(self, config: HeavyHittersConfig, device=None):
        self._config = config
        self._dpf = config.make_dpf(device)
        self._dpf._dev()  # the device must exist, though keygen runs on the host
        self._betas = [1] * len(config.level_bit_widths())

    @property
    def config(self) -> HeavyHittersConfig:
        return self._config

    def generate_report(
        self, value: Union[bytes, str, int]
    ) -> Tuple[DpfKey, DpfKey]:
        alpha = encode_value(value, self._config.domain_bits)
        return self._dpf.generate_keys_incremental(alpha, self._betas)
