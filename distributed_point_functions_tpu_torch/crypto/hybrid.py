"""Public-key hybrid encryption for the client -> Helper request leg.

The port of the JAX package's `crypto/hybrid.py`, the framework's stand-in
for the reference's Tink hybrid encryption. An HPKE-style KEM/DEM scheme:

  KEM:  X25519 ephemeral-static Diffie-Hellman
  KDF:  HKDF-SHA256, salt = enc || pk_receiver, info = suite id || context
  DEM:  AES-128-GCM with the context info as associated data

Ciphertext layout: ``enc (32 bytes) || nonce (12 bytes) || aead_ct``, the
same bytes as the JAX package's, so either package decrypts the other's
ciphertexts. The GCM tag authenticates the payload and the context info,
and the ephemeral public key is bound into the KDF salt.

Backends: the `cryptography` package when it imports, else the
byte-identical numpy backend (`_fallback.py`) -- the JAX package's rule.
`BACKEND` names the one in use; `HybridEncrypt` and `HybridDecrypt` take
another by name (`backend=`), which the tests use to hold the two against
each other.

`HybridEncrypt.__call__` and `HybridDecrypt.__call__` have the seam
signature ``(data: bytes, context_info: bytes) -> bytes``, so instances
plug into `DenseDpfPirClient.create` and `DpfPirServer.make_helper`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from . import _fallback

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    BACKEND = "cryptography"
except ImportError:
    BACKEND = "fallback"

_SUITE_ID = b"dpf-tpu-hybrid-v1:X25519+HKDF-SHA256+AES-128-GCM"
_ENC_LEN = 32  # X25519 public key
_NONCE_LEN = 12
_KEY_LEN = 16  # AES-128


class _FallbackBackend:
    """Raw-bytes X25519, HKDF and AES-GCM on `_fallback.py`."""

    name = "fallback"

    @staticmethod
    def public_key(private_bytes: bytes) -> bytes:
        return _fallback.x25519_public(private_bytes)

    @staticmethod
    def exchange(private_bytes: bytes, public_bytes: bytes) -> bytes:
        return _fallback.x25519(private_bytes, public_bytes)

    @staticmethod
    def hkdf(secret: bytes, salt: bytes, info: bytes) -> bytes:
        return _fallback.hkdf_sha256(secret, salt, info, _KEY_LEN)

    @staticmethod
    def gcm_encrypt(key, nonce, plaintext, aad) -> bytes:
        return _fallback.AesGcm(key).encrypt(nonce, plaintext, aad)

    @staticmethod
    def gcm_decrypt(key, nonce, data, aad) -> bytes:
        return _fallback.AesGcm(key).decrypt(nonce, data, aad)


class _CryptographyBackend:
    """The same primitives from the `cryptography` package."""

    name = "cryptography"

    @staticmethod
    def public_key(private_bytes: bytes) -> bytes:
        pk = X25519PrivateKey.from_private_bytes(private_bytes).public_key()
        return pk.public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )

    @staticmethod
    def exchange(private_bytes: bytes, public_bytes: bytes) -> bytes:
        return X25519PrivateKey.from_private_bytes(private_bytes).exchange(
            X25519PublicKey.from_public_bytes(public_bytes)
        )

    @staticmethod
    def hkdf(secret: bytes, salt: bytes, info: bytes) -> bytes:
        return HKDF(
            algorithm=hashes.SHA256(), length=_KEY_LEN, salt=salt, info=info
        ).derive(secret)

    @staticmethod
    def gcm_encrypt(key, nonce, plaintext, aad) -> bytes:
        return AESGCM(key).encrypt(nonce, plaintext, aad)

    @staticmethod
    def gcm_decrypt(key, nonce, data, aad) -> bytes:
        return AESGCM(key).decrypt(nonce, data, aad)


BACKENDS: Dict[str, type] = {"fallback": _FallbackBackend}
if BACKEND == "cryptography":
    BACKENDS["cryptography"] = _CryptographyBackend


def _backend(name: Optional[str]):
    return BACKENDS[BACKEND if name is None else name]


def generate_keypair() -> Tuple[bytes, bytes]:
    """Returns ``(private_bytes, public_bytes)``, each 32 raw bytes."""
    sk = os.urandom(_ENC_LEN)
    return sk, BACKENDS[BACKEND].public_key(sk)


def keypair_from_private_bytes(private_bytes: bytes) -> Tuple[bytes, bytes]:
    return private_bytes, BACKENDS[BACKEND].public_key(private_bytes)


def _derive_key(be, shared_secret: bytes, enc: bytes, receiver_pk: bytes,
                context_info: bytes) -> bytes:
    return be.hkdf(
        shared_secret,
        salt=enc + receiver_pk,
        info=_SUITE_ID + b"|" + context_info,
    )


class HybridEncrypt:
    """Encrypts to a receiver public key; usable as the client's
    `encrypter`."""

    def __init__(self, receiver_public_bytes: bytes, backend: Optional[str] = None):
        if len(receiver_public_bytes) != _ENC_LEN:
            raise ValueError(
                f"receiver public key must be {_ENC_LEN} raw bytes"
            )
        self._pk_bytes = bytes(receiver_public_bytes)
        self._be = _backend(backend)

    @property
    def backend(self) -> str:
        return self._be.name

    def __call__(self, plaintext: bytes, context_info: bytes = b"") -> bytes:
        be = self._be
        eph_sk = os.urandom(_ENC_LEN)
        enc = be.public_key(eph_sk)
        key = _derive_key(be, be.exchange(eph_sk, self._pk_bytes), enc,
                          self._pk_bytes, context_info)
        nonce = os.urandom(_NONCE_LEN)
        return enc + nonce + be.gcm_encrypt(key, nonce, plaintext, context_info)


class HybridDecrypt:
    """Decrypts with a receiver private key; usable as the Helper's
    `decrypter`."""

    def __init__(self, receiver_private_bytes: bytes, backend: Optional[str] = None):
        if len(receiver_private_bytes) != _ENC_LEN:
            raise ValueError(
                f"receiver private key must be {_ENC_LEN} raw bytes"
            )
        self._be = _backend(backend)
        self._sk_bytes = bytes(receiver_private_bytes)
        self._pk_bytes = self._be.public_key(self._sk_bytes)

    @property
    def backend(self) -> str:
        return self._be.name

    @property
    def public_bytes(self) -> bytes:
        return self._pk_bytes

    def __call__(self, ciphertext: bytes, context_info: bytes = b"") -> bytes:
        if len(ciphertext) < _ENC_LEN + _NONCE_LEN + 16:
            raise ValueError("ciphertext too short")
        be = self._be
        enc = ciphertext[:_ENC_LEN]
        nonce = ciphertext[_ENC_LEN : _ENC_LEN + _NONCE_LEN]
        body = ciphertext[_ENC_LEN + _NONCE_LEN :]
        shared = be.exchange(self._sk_bytes, enc)
        key = _derive_key(be, shared, enc, self._pk_bytes, context_info)
        return be.gcm_decrypt(key, nonce, body, context_info)
