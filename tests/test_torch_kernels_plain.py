"""Plain versions of the port's kernels against the JAX references.

K2 `expand_level` and K3 `value_hash` on CPU tensors run their plain
PyTorch versions; they are held against the JAX package's XLA level
(`expand_level_planes` with `_tile_keys`) and `mmo_hash_planes`. K1's
plain version is held against the JAX `ops/inner_product.xor_inner_product`.
The CUDA sources' per-column bodies, built for the host with a C++
compiler, are held against the same plain versions. Bit for bit, no
tolerance.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import keys as jkeys
from distributed_point_functions_tpu.ops import inner_product as jip
from distributed_point_functions_tpu.ops import inner_product_pallas as jipp
from distributed_point_functions_tpu.ops.aes_bitslice import mmo_hash_planes as j_mmo
from distributed_point_functions_tpu.pir import dense_eval_planes as jdep
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops import inner_product as tip
from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir import dense_eval_planes as tdep

G, KG = 64, 2


def _level_inputs(seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 1 << 32, (16, 8, G), dtype=np.uint32),
        rng.integers(0, 1 << 32, (G,), dtype=np.uint32),
        rng.integers(0, 1 << 32, (16, 8, KG), dtype=np.uint32),
        rng.integers(0, 1 << 32, (KG,), dtype=np.uint32),
        rng.integers(0, 1 << 32, (KG,), dtype=np.uint32),
    )


def _jax_level(state, ctrl, cwp, cwl, cwr):
    s, c = jdep.expand_level_planes(
        jnp.asarray(state),
        jnp.asarray(ctrl),
        jdep._tile_keys(jnp.asarray(cwp), 2 * G),
        jdep._tile_keys(jnp.asarray(cwl), G),
        jdep._tile_keys(jnp.asarray(cwr), G),
    )
    return np.asarray(s), np.asarray(c)


def _jax_value(state, ctrl, vc):
    values = j_mmo(jkeys.RK_VALUE, jnp.asarray(state))
    vc_t = jdep._tile_keys(jnp.asarray(vc), G)
    return np.asarray(values ^ (vc_t & jnp.asarray(ctrl)[None, None, :]))


@pytest.fixture(scope="module")
def level_case():
    args = _level_inputs(21)
    return args, _jax_level(*args)


@pytest.fixture(scope="module")
def value_case():
    state, ctrl, vc, _, _ = _level_inputs(22)
    return (state, ctrl, vc), _jax_value(state, ctrl, vc)


def test_expand_level_plain_matches_jax(level_case):
    args, (want_s, want_c) = level_case
    s, c = ep.expand_level(*(to_tensor(a, "cpu") for a in args))
    assert s.shape == (16, 8, 2 * G) and c.shape == (2 * G,)
    assert np.array_equal(to_numpy(s), want_s)
    assert np.array_equal(to_numpy(c), want_c)


def test_value_hash_plain_matches_jax(value_case):
    args, want = value_case
    got = ep.value_hash(*(to_tensor(a, "cpu") for a in args))
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("words", [4, 16])
def test_xor_inner_product_plain_matches_jax(words):
    rng = np.random.default_rng(30 + words)
    nq, records = 5, 8192
    db = rng.integers(0, 1 << 32, (records, words), dtype=np.uint32)
    sel = rng.integers(0, 1 << 32, (nq, records // 128, 4), dtype=np.uint32)
    want = np.asarray(jip.xor_inner_product(jnp.asarray(db), jnp.asarray(sel)))
    db_perm = ipk.permute_db_bitmajor(to_tensor(db, "cpu"))
    got = ipk.xor_inner_product_staged(db_perm, to_tensor(sel, "cpu"))
    assert got.shape == (nq, words)
    assert np.array_equal(to_numpy(got), want)
    # The row-major plain version directly.
    direct = tip.xor_inner_product(to_tensor(db, "cpu"), to_tensor(sel, "cpu"))
    assert np.array_equal(to_numpy(direct), want)


def test_xor_inner_product_matches_scalar_oracle():
    rng = np.random.default_rng(5)
    db = rng.integers(0, 1 << 32, (256, 3), dtype=np.uint32)
    sel = rng.integers(0, 1 << 32, (3, 2, 4), dtype=np.uint32)
    got = tip.xor_inner_product(to_tensor(db, "cpu"), to_tensor(sel, "cpu"), chunk=96)
    assert np.array_equal(to_numpy(got), tip.xor_inner_product_np(db, sel))


def test_packed_plain_takes_any_group_count():
    # The K1 wrapper accepts any [32, G, W] staging; G = 6 is not a whole
    # number of 128-record selection blocks.
    rng = np.random.default_rng(12)
    db_perm = rng.integers(0, 1 << 32, (32, 6, 3), dtype=np.uint32)
    packed = rng.integers(0, 1 << 32, (3, 6), dtype=np.uint32)
    want = np.zeros((3, 3), dtype=np.uint32)
    for q in range(3):
        for g in range(6):
            for b in range(32):
                if (packed[q, g] >> b) & 1:
                    want[q] ^= db_perm[b, g]
    got = ipk.xor_inner_product_packed(
        to_tensor(db_perm, "cpu"), to_tensor(packed, "cpu")
    )
    assert np.array_equal(to_numpy(got), want)


def test_permute_db_bitmajor_matches_jax():
    rng = np.random.default_rng(6)
    db = rng.integers(0, 1 << 32, (384, 3), dtype=np.uint32)
    got = ipk.permute_db_bitmajor(to_tensor(db, "cpu"))
    want = np.asarray(jipp.permute_db_bitmajor(jnp.asarray(db)))
    assert got.shape == (32, 128, 3)
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(to_numpy(ipk.rows_from_bitmajor(got))[:384], db)


@pytest.mark.parametrize("nq,blocks", [(5, 2), (8, 40)])
def test_stage_selections_matches_jax(nq, blocks):
    rng = np.random.default_rng(nq)
    sel = rng.integers(0, 1 << 32, (nq, blocks, 4), dtype=np.uint32)
    packed, n = ipk._stage_selections(to_tensor(sel, "cpu"), 128)
    want, wn = jipp._stage_selections(jnp.asarray(sel), 128)
    assert n == wn == nq
    assert np.array_equal(to_numpy(packed), np.asarray(want))


def test_pack_key_planes_and_bits_match_jax():
    rng = np.random.default_rng(8)
    cw = rng.integers(0, 1 << 32, (64, 4), dtype=np.uint32)
    bits = rng.integers(0, 2, 64, dtype=np.uint32)
    assert np.array_equal(
        to_numpy(tdep.pack_key_planes(to_tensor(cw, "cpu"))),
        np.asarray(jdep.pack_key_planes(jnp.asarray(cw))),
    )
    assert np.array_equal(
        to_numpy(tdep.pack_key_bits(to_tensor(bits, "cpu"))),
        np.asarray(jdep.pack_key_bits(jnp.asarray(bits))),
    )


@pytest.mark.parametrize("r,tile", [(3, 1), (2, 2)])
def test_tail_node_permutation_matches_jax(r, tile):
    from distributed_point_functions_tpu.ops.expand_planes_pallas import (
        tail_node_permutation as j_tnp,
    )

    entry = np.arange(4, dtype=np.int64)[::-1]
    for a, b in zip(ep.tail_node_permutation(entry, r, tile), j_tnp(entry, r, tile)):
        assert np.array_equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    args = [to_tensor(a, "cpu") for a in _level_inputs(1)]
    with pytest.raises(TypeError):
        ep.expand_level(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        ep.expand_level(args[0][..., :G - 1], *args[1:])  # KG must divide G
    with pytest.raises(ValueError):
        ep.value_hash(args[0], args[1][:-1], args[2])
    with pytest.raises(ValueError):
        ipk.xor_inner_product_packed(
            torch.zeros((32, 8, 2), dtype=torch.int32),
            torch.zeros((8, 4), dtype=torch.int32),
        )


# -- the CUDA sources, built for the host ------------------------------------


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    out = tmp_path_factory.mktemp("host_kernels") / "libexpand_host.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "expand_planes.cu"),
         "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.dpf_expand_level_host.argtypes = [p] * 7 + [i64, i64]
    lib.dpf_value_hash_host.argtypes = [p] * 4 + [i64, i64]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_cuda_expand_level_source_matches_plain(host_kernels, level_case):
    args, (want_s, want_c) = level_case
    arrs = [np.ascontiguousarray(a) for a in args]
    out_s = np.empty((16, 8, 2 * G), dtype=np.uint32)
    out_c = np.empty((2 * G,), dtype=np.uint32)
    host_kernels.dpf_expand_level_host(
        *(_ptr(a) for a in arrs), _ptr(out_s), _ptr(out_c), G, KG
    )
    assert np.array_equal(out_s, want_s)
    assert np.array_equal(out_c, want_c)


# K2's tiles hold 4 input columns: widths below, at and past one tile.
@pytest.mark.parametrize("g,kg", [(1, 1), (3, 1), (4, 4), (6, 3), (36, 4)])
def test_cuda_expand_level_source_at_ragged_widths(host_kernels, g, kg):
    rng = np.random.default_rng(g)
    args = [rng.integers(0, 1 << 32, s, dtype=np.uint32)
            for s in ((16, 8, g), (g,), (16, 8, kg), (kg,), (kg,))]
    out_s = np.full((16, 8, 2 * g), 0xAAAAAAAA, dtype=np.uint32)
    out_c = np.full((2 * g,), 0xAAAAAAAA, dtype=np.uint32)
    host_kernels.dpf_expand_level_host(
        *(_ptr(a) for a in args), _ptr(out_s), _ptr(out_c), g, kg
    )
    want_s, want_c = ep.expand_level_plain(*(to_tensor(a, "cpu") for a in args))
    assert np.array_equal(out_s, to_numpy(want_s))
    assert np.array_equal(out_c, to_numpy(want_c))


def test_cuda_value_hash_source_matches_plain(host_kernels, value_case):
    (state, ctrl, vc), want = value_case
    arrs = [np.ascontiguousarray(a) for a in (state, ctrl, vc)]
    out = np.empty((16, 8, G), dtype=np.uint32)
    host_kernels.dpf_value_hash_host(*(_ptr(a) for a in arrs), _ptr(out), G, KG)
    assert np.array_equal(out, want)
