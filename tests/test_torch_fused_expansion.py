"""The fused expansion kernels (K4 walk descent, K5 fused tail, K6 fused
head) and the split rules against the JAX package, bit for bit.

The JAX references are its XLA doubling levels (`expand_level_planes` with
`_tile_keys`) and `mmo_hash_planes`, the doubling twin the JAX package's
own walk self-check uses (`_walk_twin_lanes` maps its leaves onto the
walk's natural order), and `tail_node_permutation` for the tiled order of
the fused tail. Each instance is made with numpy from a seed: entry width
8 word columns, KG = 1 or 2 key words, 3 levels (the 1-level cases read
the first level of the same run); and 5 levels from 3 or 6 columns, so
that K5 and K6 walk a subtree's root before doubling, with tiles that do
not divide the entry width. The plain PyTorch versions run for CPU
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


def _jax_level(state, ctrl, cwp, cwl, cwr):
    """One JAX doubling level (`expand_level_planes`) of [16, 8, g] planes,
    the per-key corrections [16, 8, KG] / [KG] tiled over the columns, in
    WIDTH-column chunks (every column expands on its own)."""
    g = state.shape[-1]
    cwp, cwl, cwr = _cols(cwp, g), _cols(cwl, g), _cols(cwr, g)
    halves = ([], [], [], [])  # left states, right states, left ctrl, right ctrl
    for lo in range(0, g, WIDTH):
        n = min(WIDTH, g - lo)
        cw = _pad(cwp[..., lo:lo + n], WIDTH)
        s2, c2 = (np.asarray(x) for x in jdep.expand_level_planes(
            jnp.asarray(_pad(state[..., lo:lo + n], WIDTH)),
            jnp.asarray(_pad(ctrl[lo:lo + n], WIDTH)),
            jnp.asarray(np.concatenate([cw, cw], axis=-1)),
            jnp.asarray(_pad(cwl[lo:lo + n], WIDTH)),
            jnp.asarray(_pad(cwr[lo:lo + n], WIDTH)),
        ))
        for half, x in zip(halves, (s2[..., :n], s2[..., WIDTH:WIDTH + n],
                                    c2[:n], c2[WIDTH:WIDTH + n])):
            half.append(x)
    return (np.concatenate(halves[0] + halves[1], axis=-1),
            np.concatenate(halves[2] + halves[3]))


@functools.lru_cache(maxsize=None)
def _instance(kg, g0, r, levels):
    """dict(kg, g0, args, want={level: (leaf state, ctrl, values)}) for
    each of `levels` levels of the JAX doubling twin over r levels of
    corrections, made with numpy from a seed."""
    rng = np.random.default_rng(700 + 16 * kg + g0)
    args = dict(state=_words(rng, 16, 8, g0), ctrl=_words(rng, g0),
                cwp=_words(rng, r, 16, 8, kg), cwl=_words(rng, r, kg),
                cwr=_words(rng, r, kg), vc=_words(rng, 16, 8, kg))
    state, ctrl, leaves = args["state"], args["ctrl"], {}
    for i in range(max(levels)):
        state, ctrl = _jax_level(state, ctrl, args["cwp"][i], args["cwl"][i],
                                 args["cwr"][i])
        if i + 1 in levels:
            leaves[i + 1] = (state, ctrl)
    values = _jax_mmo_values([leaves[lv] for lv in levels], [args["vc"]] * len(levels))
    want = {lv: (*leaves[lv], v) for lv, v in zip(levels, values)}
    return dict(kg=kg, g0=g0, args=args, want=want)


def _instances():
    """{KG: instance} at entry width G0 for 1 and R levels."""
    return {kg: _instance(kg, G0, R, (1, R)) for kg in KGS}


@pytest.fixture(params=KGS, ids=["kg1", "kg2"])
def inst(request):
    return _instances()[request.param]


# Five levels, so that the fused kernels walk a subtree's root one level
# before doubling the last four, at entry widths that the tail's tiles do
# not divide: (KG, G0, tile lanes) with tiles of 2 + 1 and 4 + 2 columns.
DEEP_R = 5
DEEP = ((1, 3, 2), (2, 6, 4))


@pytest.fixture(params=DEEP, ids=["kg1", "kg2"])
def deep(request):
    kg, g0, tile = request.param
    return dict(_instance(kg, g0, DEEP_R, (DEEP_R,)), tile=tile)


def _torch_args(args, r):
    t = {k: to_tensor(v, "cpu") for k, v in args.items()}
    for k in ("cwp", "cwl", "cwr"):
        t[k] = t[k][:r].contiguous()
    return t


def _walk_lanes(r, kg, node_lanes):
    """Columns of the doubling twin in the walk's natural leaf order."""
    n_entry = G0 // node_lanes
    return jdep._walk_twin_lanes(np.arange(n_entry << r), r, n_entry, node_lanes)


def _tile_lanes(r, kg, tile_lanes, g0=G0):
    """Columns of the whole-width doubling twin in the tiled order of a
    fused tail with entry tiles of `tile_lanes` columns."""
    n = g0 // kg
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


# "3kg" leaves a narrower last tile (8 = 3 + 3 + 2 nodes).
TILES = ["kg", "3kg", "4kg", "whole"]


@pytest.mark.parametrize("tile", TILES)
def test_expand_tail_plain_matches_jax(inst, tile):
    kg = inst["kg"]
    tile_lanes = {"kg": kg, "3kg": 3 * kg, "4kg": 4 * kg, "whole": G0}[tile]
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
    lib.dpf_expand_head_host.argtypes = [p] * 7 + [i64] * 2 + [i32]
    lib.dpf_expand_tail_host.argtypes = [p] * 8 + [i64] * 3 + [i32]
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


def _host_head(lib, a, g0, kg, r):
    w = g0 << r
    out = np.empty((16, 8, w), dtype=np.uint32)
    out_c = np.empty((w,), dtype=np.uint32)
    assert lib.dpf_expand_head_host(
        *(_ptr(a[k]) for k in ("state", "ctrl", "cwp", "cwl", "cwr")),
        _ptr(out), _ptr(out_c), g0, kg, r) == 0
    return out, out_c


def _host_tail(lib, a, g0, kg, r, tile):
    w = g0 << r
    out = np.empty((16, 8, w), dtype=np.uint32)
    out_c = np.empty((w,), dtype=np.uint32)
    assert lib.dpf_expand_tail_host(
        *(_ptr(a[k]) for k in ("state", "ctrl", "cwp", "cwl", "cwr", "vc")),
        _ptr(out), _ptr(out_c), g0, kg, tile, r) == 0
    return out, out_c


@pytest.mark.parametrize("r", [1, R])
def test_cuda_expand_head_source_matches_jax(host_fused, inst, r):
    out, out_c = _host_head(host_fused, _host_args(inst["args"], r), G0, inst["kg"], r)
    s, c, _ = inst["want"][r]
    assert np.array_equal(out, s)
    assert np.array_equal(out_c, c)


@pytest.mark.parametrize("tile", TILES)
def test_cuda_expand_tail_source_matches_jax(host_fused, inst, tile):
    kg = inst["kg"]
    tile_lanes = {"kg": kg, "3kg": 3 * kg, "4kg": 4 * kg, "whole": G0}[tile]
    out, out_c = _host_tail(host_fused, _host_args(inst["args"], R), G0, kg, R,
                            tile_lanes)
    _, c, v = inst["want"][R]
    lanes = _tile_lanes(R, kg, tile_lanes)
    assert np.array_equal(out, v[:, :, lanes])
    assert np.array_equal(out_c, c[lanes])


# r = 5: each block walks its subtree's root one level, then doubles four.
def test_cuda_expand_head_source_walks_the_root(host_fused, deep):
    out, out_c = _host_head(host_fused, _host_args(deep["args"], DEEP_R), deep["g0"],
                            deep["kg"], DEEP_R)
    s, c, _ = deep["want"][DEEP_R]
    assert np.array_equal(out, s)
    assert np.array_equal(out_c, c)


@pytest.mark.parametrize("tile", ["narrow", "whole"])
def test_cuda_expand_tail_source_walks_the_root(host_fused, deep, tile):
    kg, g0 = deep["kg"], deep["g0"]
    tile_lanes = deep["tile"] if tile == "narrow" else g0
    out, out_c = _host_tail(host_fused, _host_args(deep["args"], DEEP_R), g0, kg,
                            DEEP_R, tile_lanes)
    _, c, v = deep["want"][DEEP_R]
    lanes = _tile_lanes(DEEP_R, kg, tile_lanes, g0)
    assert np.array_equal(out, v[:, :, lanes])
    assert np.array_equal(out_c, c[lanes])


def test_plain_head_and_tail_walk_the_root(deep):
    kg, g0 = deep["kg"], deep["g0"]
    t = _torch_args(deep["args"], DEEP_R)
    s, c, v = deep["want"][DEEP_R]
    out, ctrl = ep.expand_head(t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"])
    assert np.array_equal(to_numpy(out), s) and np.array_equal(to_numpy(ctrl), c)
    values, ctrl = ep.expand_tail(t["state"], t["ctrl"], t["cwp"], t["cwl"], t["cwr"],
                                  t["vc"], deep["tile"])
    lanes = _tile_lanes(DEEP_R, kg, deep["tile"], g0)
    assert np.array_equal(to_numpy(values), v[:, :, lanes])
    assert np.array_equal(to_numpy(ctrl), c[lanes])
