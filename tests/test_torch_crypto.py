"""The port's one-time pad and hybrid encryption against the JAX package's.

`prng.Aes128CtrSeededPrng` must give the JAX package's byte stream for
every seed, nonce and split of the length (the counter is big-endian over
the whole block and carries across its 64-bit halves). The hybrid scheme
(`crypto/hybrid.py`) must decrypt the JAX package's ciphertexts and the
JAX package must decrypt the port's, on both of the port's backends
(`cryptography` and the numpy `_fallback.py`), and reject a wrong context
or a flipped byte. Host code only.
"""

import os

import numpy as np
import pytest

from distributed_point_functions_tpu import prng as jprng
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch import prng
from distributed_point_functions_tpu_torch.crypto import _fallback, hybrid
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NONCES = [bytes(16), bytes(range(16)), b"\xff" * 16,
          bytes(8) + b"\xff" * 7 + b"\xfe", os.urandom(16)]


@pytest.mark.parametrize("nonce", NONCES, ids=range(len(NONCES)))
def test_prng_stream_equals_jax(nonce):
    rng = np.random.default_rng(nonce[0])
    for seed in (bytes(16), rng.bytes(16)):
        for splits in ([0, 1, 15, 16, 17, 33, 0, 100], [256] * 5, [5000], [3] * 40):
            ours = prng.Aes128CtrSeededPrng(seed, nonce)
            theirs = jprng.Aes128CtrSeededPrng(seed, nonce)
            for n in splits:
                assert ours.get_random_bytes(n) == theirs.get_random_bytes(n)


def test_mask_all_equals_one_draw_per_response():
    seed = os.urandom(16)
    responses = [os.urandom(n) for n in (33, 0, 256, 1, 17)]
    want = [jprng.xor_bytes(r, p.get_random_bytes(len(r)))
            for p in [jprng.Aes128CtrSeededPrng(seed)] for r in responses]
    assert prng.mask_all(responses, prng.Aes128CtrSeededPrng(seed)) == want


def test_prng_rejects_bad_arguments():
    with pytest.raises(ValueError):
        prng.Aes128CtrSeededPrng(b"short")
    with pytest.raises(ValueError):
        prng.Aes128CtrSeededPrng(bytes(16), b"short")
    with pytest.raises(ValueError):
        prng.Aes128CtrSeededPrng(bytes(16)).get_random_bytes(-1)
    with pytest.raises(ValueError):
        prng.xor_bytes(b"ab", b"a")
    assert len(prng.generate_seed()) == prng.SEED_SIZE


BACKENDS = sorted(hybrid.BACKENDS)


def test_both_backends_are_available_here():
    assert BACKENDS == ["cryptography", "fallback"]
    assert hybrid.BACKEND == "cryptography"


MESSAGES = [b"", b"x", bytes(range(256)) * 7 + b"tail"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_hybrid_crosses_packages(backend):
    enc = hybrid.HybridEncrypt(encrypt_decrypt.TEST_PUBLIC_KEY, backend=backend)
    dec = hybrid.HybridDecrypt(encrypt_decrypt.TEST_PRIVATE_KEY, backend=backend)
    assert enc.backend == dec.backend == backend
    for msg in MESSAGES:
        for ctx in (b"", b"DpfPirServer"):
            assert jed.decrypt(enc(msg, ctx), ctx) == msg
            assert dec(jed.encrypt(msg, ctx), ctx) == msg
            assert dec(enc(msg, ctx), ctx) == msg


def test_backends_decrypt_each_other():
    sk, pk = hybrid.generate_keypair()
    assert hybrid.keypair_from_private_bytes(sk) == (sk, pk)
    assert hybrid.HybridDecrypt(sk, backend="fallback").public_bytes == pk
    for a in BACKENDS:
        for b in BACKENDS:
            ct = hybrid.HybridEncrypt(pk, backend=a)(MESSAGES[-1], b"ctx")
            assert hybrid.HybridDecrypt(sk, backend=b)(ct, b"ctx") == MESSAGES[-1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_hybrid_rejects_wrong_context_and_flipped_bytes(backend):
    dec = hybrid.HybridDecrypt(encrypt_decrypt.TEST_PRIVATE_KEY, backend=backend)
    ct = jed.encrypt(b"secret helper request", b"DpfPirServer")
    with pytest.raises(Exception):
        dec(ct, b"OtherContext")
    for pos in (0, 33, 44, len(ct) - 17, len(ct) - 1):
        flipped = bytearray(ct)
        flipped[pos] ^= 1
        with pytest.raises(Exception):
            dec(bytes(flipped), b"DpfPirServer")
    with pytest.raises(ValueError, match="too short"):
        dec(b"short", b"DpfPirServer")


def test_fallback_gcm_equals_cryptography():
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    rng = np.random.default_rng(4)
    for n, a in ((0, 0), (1, 1), (16, 15), (17, 16), (1000, 33), (4096, 0)):
        key, nonce = rng.bytes(16), rng.bytes(12)
        pt, aad = rng.bytes(n), rng.bytes(a)
        want = AESGCM(key).encrypt(nonce, pt, aad)
        assert _fallback.AesGcm(key).encrypt(nonce, pt, aad) == want
        assert _fallback.AesGcm(key).decrypt(nonce, want, aad) == pt


def test_fixed_keyset_matches_the_jax_package():
    assert encrypt_decrypt.TEST_PRIVATE_KEY == jed.TEST_PRIVATE_KEY
    assert encrypt_decrypt.TEST_PUBLIC_KEY == jed.TEST_PUBLIC_KEY
    assert encrypt_decrypt.decrypt.public_bytes == encrypt_decrypt.TEST_PUBLIC_KEY
    assert encrypt_decrypt.encrypt.backend == hybrid.BACKEND
