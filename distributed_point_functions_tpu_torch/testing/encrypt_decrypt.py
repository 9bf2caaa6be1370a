"""Hybrid encryption from a fixed keyset, for protocol tests and smoke runs.

The port's copy of the JAX package's `testing/encrypt_decrypt.py`, the
stand-in for the reference's fixed Tink test keysets: real asymmetric
encryption (`crypto/hybrid.py`) without key management. The keyset lives
in `testing/data/hybrid_test_keyset.json`, a copy of the JAX package's,
so both packages encrypt and decrypt to the same keys. `encrypt` and
`decrypt` have the seam signature ``(data, context_info) -> bytes``:
pass them to `DenseDpfPirClient.create` and `DpfPirServer.make_helper`.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..crypto import HybridDecrypt, HybridEncrypt

_KEYSET_PATH = Path(__file__).resolve().parent / "data" / "hybrid_test_keyset.json"

_keyset = json.loads(_KEYSET_PATH.read_text())

TEST_PRIVATE_KEY = bytes.fromhex(_keyset["private_key_hex"])
TEST_PUBLIC_KEY = bytes.fromhex(_keyset["public_key_hex"])

encrypt = HybridEncrypt(TEST_PUBLIC_KEY)
decrypt = HybridDecrypt(TEST_PRIVATE_KEY)
