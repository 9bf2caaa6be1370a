"""The fused expansion kernels (K4 walk descent, K5 fused tail, K6 fused
head) and the split rules against the JAX package, bit for bit.

The JAX references are its XLA doubling levels (`expand_level_planes` with
`_tile_keys`) and `mmo_hash_planes`, the doubling twin the JAX package's
own walk self-check uses (`_walk_twin_lanes` maps its leaves onto the
walk's natural order), and `tail_node_permutation` for the tiled order of
the fused tail. Each instance is made with numpy from a seed: entry width
8 word columns, KG = 1 or 2 key words, 3 levels (the 1-level cases read
the first level of the same run). The plain PyTorch versions run for CPU
tensors; the CUDA sources, built for the host with a C++ compiler, are
held against the same references. No Pallas interpret mode.
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import keys as jkeys
from distributed_point_functions_tpu.ops import aes_bitslice as jab
from distributed_point_functions_tpu.ops.expand_planes_pallas import (
    tail_node_permutation as j_tail_order,
)
from distributed_point_functions_tpu.pir import dense_eval_planes as jdep
from distributed_point_functions_tpu_torch import keys as tkeys
from distributed_point_functions_tpu_torch.ops import aes_bitslice as tab
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir import dense_eval_planes as tdep

G0 = 8
R = 3


# Every JAX AES call runs on WIDTH columns: both instances side by side,
# then padding lanes (every lane expands on its own). Eager JAX compiles
# each primitive once per shape, so one shape family keeps the references
# to a few seconds.
WIDTH = 2 * (G0 << (R - 1))
KGS = (1, 2)


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _cols(words, width):
    """Per-key words [..., KG] tiled over `width` node-major columns."""
    return np.tile(words, (1,) * (words.ndim - 1) + (width // words.shape[-1],))


def _pad(x, width):
    x = np.asarray(x)
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])


def _jax_mmo_values(leaves, vcs):
    """mmo_hash_planes(RK_VALUE) ^ (vc & ctrl) for a list of (state, ctrl)
    leaf sets, WIDTH columns per JAX call."""
    state = np.concatenate([s for s, _ in leaves], axis=-1)
    n = state.shape[-1]
    hashed = np.concatenate([
        np.asarray(jab.mmo_hash_planes(
            jkeys.RK_VALUE, jnp.asarray(_pad(state[..., lo:lo + WIDTH], WIDTH))))
        for lo in range(0, n, WIDTH)
    ], axis=-1)[..., :n]
    out, lo = [], 0
    for (s, c), vc in zip(leaves, vcs):
        g = s.shape[-1]
        out.append(hashed[..., lo:lo + g] ^ (_cols(vc, g) & c[None, None, :]))
        lo += g
    return out


@functools.lru_cache(maxsize=None)
def _instances():
    """{KG: dict(args=..., want={levels: (leaf state, ctrl, values)})} for
    1 and R levels of the JAX doubling twin (`expand_level_planes`)."""
    rng = np.random.default_rng(700)
    args = {
        kg: dict(state=_words(rng, 16, 8, G0), ctrl=_words(rng, G0),
                 cwp=_words(rng, R, 16, 8, kg), cwl=_words(rng, R, kg),
                 cwr=_words(rng, R, kg), vc=_words(rng, 16, 8, kg))
        for kg in KGS
    }
    states = [args[kg]["state"] for kg in KGS]
    ctrls = [args[kg]["ctrl"] for kg in KGS]
    leaves = {}
    for i in range(R):
        gs = [s.shape[-1] for s in states]
        n = sum(gs)
        cwp = np.concatenate([_cols(args[kg]["cwp"][i], g) for kg, g in zip(KGS, gs)], -1)
        cwl = np.concatenate([_cols(args[kg]["cwl"][i], g) for kg, g in zip(KGS, gs)])
        cwr = np.concatenate([_cols(args[kg]["cwr"][i], g) for kg, g in zip(KGS, gs)])
        # Left children take columns [0, WIDTH), right ones [WIDTH, 2 WIDTH).
        cw2 = np.concatenate([_pad(cwp, WIDTH), _pad(cwp, WIDTH)], axis=-1)
        s2, c2 = (np.asarray(a) for a in jdep.expand_level_planes(
            jnp.asarray(_pad(np.concatenate(states, -1), WIDTH)),
            jnp.asarray(_pad(np.concatenate(ctrls), WIDTH)),
            jnp.asarray(cw2), jnp.asarray(_pad(cwl, WIDTH)),
            jnp.asarray(_pad(cwr, WIDTH)),
        ))
        offs = np.cumsum([0] + gs)
        states = [np.concatenate([s2[..., o:o + g], s2[..., WIDTH + o:WIDTH + o + g]], -1)
                  for o, g in zip(offs, gs)]
        ctrls = [np.concatenate([c2[o:o + g], c2[WIDTH + o:WIDTH + o + g]])
                 for o, g in zip(offs, gs)]
        if i + 1 in (1, R):
            leaves[i + 1] = list(zip(states, ctrls))
    keys = [(r, kg) for r in leaves for kg in KGS]
    values = _jax_mmo_values([leaves[r][KGS.index(kg)] for r, kg in keys],
                             [args[kg]["vc"] for _, kg in keys])
    want = {kg: {} for kg in KGS}
    for (r, kg), v in zip(keys, values):
        want[kg][r] = (*leaves[r][KGS.index(kg)], v)
    return {kg: dict(kg=kg, args=args[kg], want=want[kg]) for kg in KGS}


@pytest.fixture(params=KGS, ids=["kg1", "kg2"])
def inst(request):
    return _instances()[request.param]


def _torch_args(args, r):
    t = {k: to_tensor(v, "cpu") for k, v in args.items()}
    for k in ("cwp", "cwl", "cwr"):
        t[k] = t[k][:r].contiguous()
    return t


def _walk_lanes(r, kg, node_lanes):
    """Columns of the doubling twin in the walk's natural leaf order."""
    n_entry = G0 // node_lanes
    return jdep._walk_twin_lanes(np.arange(n_entry << r), r, n_entry, node_lanes)


def _tile_lanes(r, kg, tile_lanes):
    """Columns of the whole-width doubling twin in the tiled order of a
    fused tail with entry tiles of `tile_lanes` columns."""
    n = G0 // kg
    tiled = j_tail_order(np.arange(n), r, tile_lanes // kg)[0]
    pos_whole = np.argsort(j_tail_order(np.arange(n), r, n)[0])
    src = pos_whole[tiled]
    return (src[:, None] * kg + np.arange(kg)[None, :]).reshape(-1)


# -- plain versions ----------------------------------------------------------


def test_aes_rounds_select_planes_matches_jax():
    rng = np.random.default_rng(71)
    state = rng.integers(0, 1 << 32, (16, 8, WIDTH), dtype=np.uint32)
    sel = rng.integers(0, 1 << 32, (WIDTH,), dtype=np.uint32)
    want = np.asarray(jab.aes_rounds_select_planes(
        jkeys.RK_LEFT, jkeys.RK_RIGHT, jnp.asarray(sel), jnp.asarray(state)))
    st, sl = to_tensor(state, "cpu"), to_tensor(sel, "cpu")
    got = tab.aes_rounds_select_planes(tkeys.RK_LEFT, tkeys.RK_RIGHT, sl, st)
    assert np.array_equal(to_numpy(got), want)
    # All-zero and all-one selects are the two fixed-key AES.
    zeros = torch.zeros(WIDTH, dtype=torch.int32)
    for sel_t, rk in ((zeros, tkeys.RK_LEFT), (~zeros, tkeys.RK_RIGHT)):
        assert torch.equal(
            tab.aes_rounds_select_planes(tkeys.RK_LEFT, tkeys.RK_RIGHT, sel_t, st),
            tab.aes_rounds_planes(rk, st),
        )


@pytest.mark.parametrize("value_hash", [False, True], ids=["state", "values"])
@pytest.mark.parametrize("nodes", [1, 2], ids=["nl=kg", "nl=2kg"])
@pytest.mark.parametrize("r", [1, R])
def test_walk_descend_plain_matches_jax_twin(inst, r, nodes, value_hash):
    kg = inst["kg"]
    t = _torch_args(inst["args"], r)
    out, ctrl = ep.walk_descend(
        t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"], t["vc"],
        value_hash=value_hash, node_lanes=nodes * kg,
    )
    s, c, v = inst["want"][r]
    lanes = _walk_lanes(r, kg, nodes * kg)
    assert np.array_equal(to_numpy(out), (v if value_hash else s)[:, :, lanes])
    assert np.array_equal(to_numpy(ctrl), c[lanes])


@pytest.mark.parametrize("r", [1, R])
def test_expand_head_plain_matches_jax(inst, r):
    t = _torch_args(inst["args"], r)
    out, ctrl = ep.expand_head(t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"])
    s, c, _ = inst["want"][r]
    assert np.array_equal(to_numpy(out), s)
    assert np.array_equal(to_numpy(ctrl), c)


@pytest.mark.parametrize("tile", ["kg", "4kg", "whole"])
def test_expand_tail_plain_matches_jax(inst, tile):
    kg = inst["kg"]
    tile_lanes = {"kg": kg, "4kg": 4 * kg, "whole": G0}[tile]
    t = _torch_args(inst["args"], R)
    values, ctrl = ep.expand_tail(
        t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"], t["vc"], tile_lanes)
    _, c, v = inst["want"][R]
    lanes = _tile_lanes(R, kg, tile_lanes)
    assert np.array_equal(to_numpy(values), v[:, :, lanes])
    assert np.array_equal(to_numpy(ctrl), c[lanes])


def test_fused_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    t = {k: to_tensor(rng.integers(0, 1 << 32, s, dtype=np.uint32), "cpu")
         for k, s in dict(state=(16, 8, 4), ctrl=(4,), cwp=(2, 16, 8, 2),
                          cwl=(2, 2), cwr=(2, 2), vc=(16, 8, 2)).items()}
    base = (t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"])
    with pytest.raises(ValueError):
        ep.walk_descend(*base, value_hash=True)  # no value correction
    with pytest.raises(ValueError):
        ep.walk_descend(*base, node_lanes=3)  # not a multiple of KG
    with pytest.raises(ValueError):
        ep.expand_tail(*base, t["vc"], 3)  # tile not a multiple of KG
    with pytest.raises(ValueError):
        ep.expand_head(t["state"], t["ctrl"], t["cwp"][:0], t["cwl"][:0], t["cwr"][:0])
    with pytest.raises(ValueError):
        ep.expand_head(t["state"], t["ctrl"][:3], *base[2:])
    with pytest.raises(TypeError):
        ep.expand_head(t["state"].to(torch.int64), *base[1:])


# -- the split rules and the exit order ---------------------------------------


@pytest.mark.parametrize("kg", [1, 2, 4, 8])
def test_split_rules_match_jax(kg):
    for levels in range(15):
        for cap in (64, 2048):
            for avail in range(levels + 1):
                assert tdep.auto_head_count(cap, kg, avail) == jdep._auto_head_count(
                    cap, kg, avail)
        for req, target in ((4, 128), (2, 8), (4, 2)):
            assert tdep.tail_split(kg, levels, req, target) == jdep._tail_split(
                kg, levels, req, target)


def test_walk_leaf_order_matches_jax():
    entry = np.array([3, 0, 2, 1])
    for r in (1, 3):
        assert np.array_equal(ep.walk_leaf_order(entry, r), jdep.walk_leaf_order(entry, r))


def test_main_path_plans():
    # 2^20 records of 256 B: 8,192 selection blocks, 13 levels; 128 keys.
    assert tdep.expansion_plan("walk", 4, 13) == (9, 4, 0)
    assert tdep.expansion_plan("tail", 4, 13) == (9, 4, 32)
    assert tdep.expansion_plan("level", 4, 13) == (0, 0, 0)
    with pytest.raises(ValueError):
        tdep.expansion_plan("pallas", 4, 13)
    with pytest.raises(ValueError):
        tdep.expansion_plan("level", 4, 13, tail_levels=2)


# -- the CUDA sources, built for the host ------------------------------------


@pytest.fixture(scope="module")
def host_fused(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    out = tmp_path_factory.mktemp("host_fused") / "libexpand_fused_host.so"
    subprocess.run(
        [cxx, "-O0", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "expand_fused.cu"),
         "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dpf_walk_descend_host.argtypes = [p] * 8 + [i64] * 3 + [i32] * 2
    lib.dpf_expand_levels_host.argtypes = [p] * 12 + [i64] * 3 + [i32] * 2
    return lib


def _host_args(args, r):
    a = {k: np.ascontiguousarray(v) for k, v in args.items()}
    for k in ("cwp", "cwl", "cwr"):
        a[k] = np.ascontiguousarray(a[k][:r])
    return a


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("value_hash", [False, True], ids=["state", "values"])
@pytest.mark.parametrize("nodes", [1, 2], ids=["nl=kg", "nl=2kg"])
@pytest.mark.parametrize("r", [1, R])
def test_cuda_walk_descend_source_matches_jax(host_fused, inst, r, nodes, value_hash):
    kg = inst["kg"]
    a = _host_args(inst["args"], r)
    w = G0 << r
    out = np.empty((16, 8, w), dtype=np.uint32)
    out_c = np.empty((w,), dtype=np.uint32)
    host_fused.dpf_walk_descend_host(
        *(_ptr(a[k]) for k in ("state", "ctrl", "cwp", "cwl", "cwr")),
        _ptr(a["vc"] if value_hash else None), _ptr(out), _ptr(out_c),
        G0, kg, nodes * kg, r, int(value_hash),
    )
    s, c, v = inst["want"][r]
    lanes = _walk_lanes(r, kg, nodes * kg)
    assert np.array_equal(out, (v if value_hash else s)[:, :, lanes])
    assert np.array_equal(out_c, c[lanes])


def _host_doubling(lib, a, kg, r, tile, value_hash):
    w = G0 << r
    half = w if value_hash else w // 2
    bufs = [np.empty(128 * half, dtype=np.uint32) for _ in range(2)]
    cbufs = [np.empty(half, dtype=np.uint32) for _ in range(2)]
    out = np.empty((16, 8, w), dtype=np.uint32)
    out_c = np.empty((w,), dtype=np.uint32)
    lib.dpf_expand_levels_host(
        *(_ptr(a[k]) for k in ("state", "ctrl", "cwp", "cwl", "cwr")),
        _ptr(a["vc"] if value_hash else None), _ptr(bufs[0]), _ptr(cbufs[0]),
        _ptr(bufs[1]), _ptr(cbufs[1]), _ptr(out), _ptr(out_c), G0, kg, tile, r,
        int(value_hash),
    )
    return out, out_c


@pytest.mark.parametrize("r", [1, R])
def test_cuda_expand_head_source_matches_jax(host_fused, inst, r):
    out, out_c = _host_doubling(host_fused, _host_args(inst["args"], r),
                                inst["kg"], r, G0, False)
    s, c, _ = inst["want"][r]
    assert np.array_equal(out, s)
    assert np.array_equal(out_c, c)


@pytest.mark.parametrize("tile", ["kg", "4kg", "whole"])
def test_cuda_expand_tail_source_matches_jax(host_fused, inst, tile):
    kg = inst["kg"]
    tile_lanes = {"kg": kg, "4kg": 4 * kg, "whole": G0}[tile]
    out, out_c = _host_doubling(host_fused, _host_args(inst["args"], R), kg, R,
                                tile_lanes, True)
    _, c, v = inst["want"][R]
    lanes = _tile_lanes(R, kg, tile_lanes)
    assert np.array_equal(out, v[:, :, lanes])
    assert np.array_equal(out_c, c[lanes])
