"""The port's native host library against its numpy twins and the JAX package.

`distributed_point_functions_tpu_torch.native` builds `csrc/host/` with g++
at first use. Its batched keygen must equal the port's numpy keygen
(`_generate_keys_batch_plain`) and the JAX package's native engine word for
word; its seed walk must equal the numpy walk; and `stage_keys_host`, with
its bulk packing and the native walk, must give the JAX package's staged
arrays. A failed build raises. Host code only: no XLA program, no kernel.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu import native as jnative
from distributed_point_functions_tpu.dpf import CorrectionWord as JCw
from distributed_point_functions_tpu.dpf import DistributedPointFunction as JDpf
from distributed_point_functions_tpu.dpf import DpfKey as JKey
from distributed_point_functions_tpu.dpf import DpfParameters as JParams
from distributed_point_functions_tpu.pir.dense_eval import stage_keys_host as j_stage
from distributed_point_functions_tpu.value_types import XorType as JXor
from distributed_point_functions_tpu_torch import keys as fixed_keys
from distributed_point_functions_tpu_torch import native
from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
from distributed_point_functions_tpu_torch.ops import aes
from distributed_point_functions_tpu_torch.pir import dense_eval
from distributed_point_functions_tpu_torch.value_types import XorType


def _fields(k):
    return (k.seed, k.party,
            [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
             for cw in k.correction_words],
            [int(v) for v in k.last_level_value_correction])


def _to_jax(k):
    return JKey(k.seed, k.party,
                [JCw(cw.seed, cw.control_left, cw.control_right)
                 for cw in k.correction_words],
                list(k.last_level_value_correction))


def _batch(rng, lds, n):
    roots = rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32)
    alphas = [int(a) for a in rng.integers(0, 1 << lds, n)]
    alphas[0] = (1 << lds) - 1  # the last leaf: every path bit set
    betas = [1 << int(b) for b in rng.integers(0, 128, n)]
    return roots, alphas, betas


@pytest.mark.parametrize("n", [1, 7, 128])
@pytest.mark.parametrize("lds", [1, 13, 20])
def test_native_keygen_equals_numpy_and_jax(lds, n):
    rng = np.random.default_rng(lds * 1000 + n)
    roots, alphas, betas = _batch(rng, lds, n)
    dpf = DistributedPointFunction.create(DpfParameters(lds, XorType(128)), device="cpu")
    ours = dpf.generate_keys_batch(alphas, betas, _root_seeds=roots)
    plain = dpf._generate_keys_batch_plain(alphas, betas, _root_seeds=roots)
    jdpf = JDpf.create(JParams(lds, JXor(128)))
    assert jdpf._keygen_engine() == "native"
    theirs = jdpf.generate_keys_batch(alphas, betas, _root_seeds=roots)
    for party in (0, 1):
        want = [_fields(k) for k in theirs[party]]
        assert [_fields(k) for k in ours[party]] == want
        assert [_fields(k) for k in plain[party]] == want
        assert all(k.party == party for k in ours[party])
    # The parties' keys share correction words but not their objects.
    assert ours[0][0].correction_words[0] is not ours[1][0].correction_words[0]


def test_native_keygen_draws_fresh_root_seeds():
    dpf = DistributedPointFunction.create(DpfParameters(8, XorType(128)), device="cpu")
    k0, k1 = dpf.generate_keys_batch([3, 3], [1, 1])
    assert len({k0[0].seed, k0[1].seed, k1[0].seed, k1[1].seed}) == 4


def test_native_mmo_hash_equals_numpy():
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 256, (37, 16), dtype=np.uint8)
    for which, rk in enumerate((fixed_keys.RK_LEFT, fixed_keys.RK_RIGHT,
                                fixed_keys.RK_VALUE)):
        want = aes.limbs_to_bytes_np(aes.mmo_hash_np(rk, aes.bytes_to_limbs_np(blocks)))
        assert np.array_equal(native.mmo_hash(which, blocks), want)


@pytest.mark.parametrize("levels", [0, 1, 7, 20])
def test_native_walk_equals_numpy_walk(levels):
    rng = np.random.default_rng(levels)
    nk, total = 45, 20
    seeds0 = rng.integers(0, 1 << 32, (nk, 4), dtype=np.uint32)
    seeds0[:, 0] &= 0xFFFFFFFE
    control0 = rng.integers(0, 2, nk, dtype=np.uint32)
    cw_seeds = rng.integers(0, 1 << 32, (total, nk, 4), dtype=np.uint32)
    cw_left = rng.integers(0, 2, (total, nk), dtype=np.uint32)
    cw_right = rng.integers(0, 2, (total, nk), dtype=np.uint32)
    args = (seeds0, control0, cw_seeds, cw_left, cw_right, levels)
    s, c = dense_eval._walk_zeros_host(*args)
    ps, pc = dense_eval._walk_zeros_host_plain(*args)
    assert s.dtype == ps.dtype == np.uint32 and c.dtype == np.uint32
    assert np.array_equal(s, ps) and np.array_equal(c, pc)


@pytest.mark.parametrize("lds", [7, 13])
def test_stage_keys_host_equals_jax(lds):
    rng = np.random.default_rng(lds)
    roots, alphas, betas = _batch(rng, lds, 40)
    dpf = DistributedPointFunction.create(DpfParameters(lds, XorType(128)), device="cpu")
    keys = dpf.generate_keys_batch(alphas, betas, _root_seeds=roots)
    for party in (0, 1):
        jkeys = [_to_jax(k) for k in keys[party]]
        for walk in (0, 1, lds - 3, lds):
            ours = dense_eval.stage_keys_host(keys[party], walk)
            theirs = j_stage(jkeys, walk)
            for a, b in zip(ours, theirs):
                assert a.dtype == np.uint32 and a.shape == b.shape
                assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
                assert a.flags.c_contiguous


def test_stage_keys_host_rejects_ragged_batches():
    dpf = DistributedPointFunction.create(DpfParameters(6, XorType(128)), device="cpu")
    k0, _ = dpf.generate_keys_batch([1, 2], [1, 1])
    k0[1].correction_words.pop()
    with pytest.raises(ValueError, match="same number of levels"):
        dense_eval.stage_keys_host(k0)
    k0, _ = dpf.generate_keys_batch([1], [1])
    with pytest.raises(ValueError, match="exceeds"):
        dense_eval.stage_keys_host(k0, 7)


def test_jax_native_walk_agrees():
    """The JAX package's native walk (its committed library) on the same
    arrays gives the port's bytes."""
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    control = rng.integers(0, 2, 16, dtype=np.uint8)
    cw = rng.integers(0, 256, (5, 16, 16), dtype=np.uint8)
    cl, cr = (rng.integers(0, 2, (5, 16), dtype=np.uint8) for _ in range(2))
    args = (seeds, control, np.zeros_like(seeds), cw, cl, cr)
    ours = native.evaluate_seeds(*args, per_seed_cw=True)
    theirs = jnative.evaluate_seeds(*args, per_seed_cw=True)
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES + native.HEADERS:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "HOST_SRC", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    assert native._lib is None
    # Nothing half-built is left to load.
    assert not list((tmp_path / "build").glob("*/" + native.LIB_NAME))


def test_build_is_keyed_on_the_sources():
    native.get_lib()
    lib = native.build_dir() / native.LIB_NAME
    assert lib.exists() and native.build_dir().parent == native.BUILD_ROOT
    assert native.build() == lib  # reused, not rebuilt
