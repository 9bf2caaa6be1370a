"""Hybrid encryption of the Helper's request (`hybrid.py`)."""

from .hybrid import (  # noqa: F401
    BACKEND,
    HybridDecrypt,
    HybridEncrypt,
    generate_keypair,
    keypair_from_private_bytes,
)
