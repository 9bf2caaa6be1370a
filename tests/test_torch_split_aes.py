"""The split AES of K4 and K8 (`csrc/split_aes.cuh`, 16 threads a word
column), built for the host, bit for bit.

The host twins run a group's slices in lockstep, an array standing in
for `__shfl_sync`, and the blocks' phases in the kernels' barrier order,
so these tests run the split body the card runs:

* the split select-key AES alone (`dpf_split_aes_host`) against the
  port's one-thread plane AES (`ops/aes_bitslice.py`) and the JAX
  package's `aes_rounds_select_planes`;
* the multi-level K8 walk with stops (`dpf_path_walk_host`) against the
  JAX package's path walk chained one level per call (its XLA twin of
  `_path_kernel`, `dpf._eval_paths_planes` with `level_kernel=False`, on
  32 lanes at a time: one compile), in the shared and per-seed modes;
* K4 (`dpf_walk_descend_host`) at r in {1, 4, 6, 9} and KG in {1, 4, 32},
  with and without the value hash, against the port's plain version (held
  against the JAX package in `test_torch_fused_expansion.py`), including
  subtrees of several key words a node.

Inputs are numpy words from a seed.
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import keys as jkeys
from distributed_point_functions_tpu.ops import aes_bitslice as jab
from distributed_point_functions_tpu_torch import keys as tkeys
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.aes_bitslice import (
    aes_rounds_select_planes,
    broadcast_cw_planes,
    limbs_to_planes_np,
    pack_select_bits_np,
    planes_to_limbs,
    unpack_select_bits,
)
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor

def _u32(rng, *shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.uint32)


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    out = tmp_path_factory.mktemp("host_split") / "libsplit_host.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "path_level.cu"),
         str(cuda_lib.CSRC / "expand_fused.cu"), "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dpf_split_aes_host.argtypes = [p] * 3 + [i64]
    lib.dpf_path_walk_host.argtypes = [p] * 7 + [i32] + [p] * 2 + [i64] * 2 + [i32]
    lib.dpf_walk_descend_host.argtypes = [p] * 8 + [i64] * 3 + [i32] * 2
    return lib


# -- the split AES ------------------------------------------------------------


def test_split_aes_matches_the_one_thread_aes_and_jax(host):
    rng = np.random.default_rng(61)
    g = 4
    planes = _u32(rng, 16, 8, g)
    sel = _u32(rng, g)
    sel[0], sel[1] = 0, 0xFFFFFFFF  # all-left and all-right columns
    out = np.empty_like(planes)
    assert host.dpf_split_aes_host(_ptr(planes), _ptr(sel), _ptr(out), g) == 0
    jax = jab.aes_rounds_select_planes(jkeys.RK_LEFT, jkeys.RK_RIGHT, jnp.asarray(sel),
                                       jnp.asarray(planes))
    assert np.array_equal(out, np.asarray(jax))
    port = aes_rounds_select_planes(tkeys.RK_LEFT, tkeys.RK_RIGHT, to_tensor(sel, "cpu"),
                                    to_tensor(planes, "cpu"))
    assert np.array_equal(out, to_numpy(port))


# -- K8: the multi-level walk with stops -----------------------------------------

WALK_COLS = 3   # word columns: one 64-thread block at G = 16 is 4 columns
WALK_BITS = (37, 5, 100, 64, 0)  # the path bit each level reads
STOPS = (0, 1, 1, 3, 5)


@functools.lru_cache(maxsize=None)
def _walk_instance(mode):
    """Inputs of a 5-level walk of 96 lanes and the JAX walk's (seeds,
    control) after each level, chained one level per call on 32 lanes."""
    rng = np.random.default_rng(71 + (mode == "per_seed"))
    n, levels = 32 * WALK_COLS, len(WALK_BITS)
    m = n if mode == "per_seed" else 1
    inp = dict(seeds=_u32(rng, n, 4), control=_u32(rng, n, high=2),
               paths=_u32(rng, n, 4), cw_seeds=_u32(rng, levels, m, 4),
               cw_left=_u32(rng, levels, m, high=2), cw_right=_u32(rng, levels, m, high=2))
    after = [[] for _ in WALK_BITS]
    for lo in range(0, n, 32):
        lanes = slice(lo, lo + 32)
        cws = lanes if mode == "per_seed" else slice(None)
        seeds = jnp.asarray(inp["seeds"][lanes])
        control = jnp.asarray(inp["control"][lanes])
        for j, bit in enumerate(WALK_BITS):
            cw = {k: jnp.asarray(np.broadcast_to(inp[k][j:j + 1, cws],
                                                 (1, 32) + inp[k].shape[2:]))
                  for k in ("cw_seeds", "cw_left", "cw_right")}
            seeds, control = jdpf._eval_paths_planes(
                seeds, control, jnp.asarray(inp["paths"][lanes]),
                cw["cw_seeds"], cw["cw_left"], cw["cw_right"],
                jnp.asarray([bit], dtype=jnp.int32), level_kernel=False)
            after[j].append((np.asarray(seeds), np.asarray(control)))
    after = [tuple(np.concatenate(part) for part in zip(*lv)) for lv in after]
    return inp, [(inp["seeds"], inp["control"])] + after


def _walk_args(inp, mode):
    """The walk's inputs in the port's layout (numpy words)."""
    sel = pack_select_bits_np(np.stack(
        [(inp["paths"][:, b >> 5] >> np.uint32(b & 31)) & 1 for b in WALK_BITS]))
    if mode == "per_seed":
        cwp = limbs_to_planes_np(inp["cw_seeds"])
        cwl, cwr = pack_select_bits_np(inp["cw_left"]), pack_select_bits_np(inp["cw_right"])
    else:
        cwp = to_numpy(broadcast_cw_planes(to_tensor(inp["cw_seeds"][:, 0], "cpu")))
        cwl, cwr = (-inp["cw_left"]).astype(np.uint32), (-inp["cw_right"]).astype(np.uint32)
    return (limbs_to_planes_np(inp["seeds"]), pack_select_bits_np(inp["control"]),
            sel, np.ascontiguousarray(cwp), cwl, cwr)


def _check_stops(states, ctrls, want, stops):
    for s, stop in enumerate(stops):
        cols = slice(s * WALK_COLS, (s + 1) * WALK_COLS)
        seeds = to_numpy(planes_to_limbs(to_tensor(np.ascontiguousarray(states[..., cols]), "cpu")))
        control = to_numpy(unpack_select_bits(to_tensor(ctrls[cols], "cpu")))
        assert np.array_equal(seeds, want[stop][0]), stop
        assert np.array_equal(control, want[stop][1]), stop


@pytest.mark.parametrize("mode", ["shared", "per_seed"])
def test_path_walk_host_with_stops_matches_chained_jax(host, mode):
    inp, want = _walk_instance(mode)
    state, ctrl, sel, cwp, cwl, cwr = _walk_args(inp, mode)
    kw = cwl.shape[-1]
    out = np.empty((16, 8, len(STOPS) * WALK_COLS), dtype=np.uint32)
    out_ctrl = np.empty((len(STOPS) * WALK_COLS,), dtype=np.uint32)
    stops = (ctypes.c_int * len(STOPS))(*STOPS)
    assert host.dpf_path_walk_host(
        *map(_ptr, (state, ctrl, sel, cwp, cwl, cwr)), stops, len(STOPS),
        _ptr(out), _ptr(out_ctrl), WALK_COLS, kw, len(WALK_BITS)) == 0
    _check_stops(out, out_ctrl, want, STOPS)


@pytest.mark.parametrize("mode", ["shared", "per_seed"])
def test_path_walk_plain_with_stops_matches_chained_jax(mode):
    inp, want = _walk_instance(mode)
    args = [to_tensor(a, "cpu") for a in _walk_args(inp, mode)]
    cuda_lib.reset_launch_counts()
    states, ctrls = ep.path_walk(*args, stops=STOPS)
    assert cuda_lib.LAUNCHES["path_level"] == 0
    _check_stops(to_numpy(states), to_numpy(ctrls), want, STOPS)
    # The default stop is the end of the walk; one level is `path_level`.
    last = ep.path_walk(*args)
    assert np.array_equal(to_numpy(last[0]), to_numpy(states[..., -WALK_COLS:]))
    one = ep.path_level(args[0], args[1], args[2][0], args[3][0], args[4][0], args[5][0])
    _check_stops(to_numpy(one[0]), to_numpy(one[1]), want, (1,))


def test_path_walk_rejects_what_the_kernel_does_not_take():
    inp, _ = _walk_instance("shared")
    args = [to_tensor(a, "cpu") for a in _walk_args(inp, "shared")]
    for stops in ((), (2, 1), (6,), (-1,), tuple(range(129))):
        with pytest.raises(ValueError):
            ep.path_walk(*args, stops=stops)
    with pytest.raises(ValueError):
        ep.path_walk(args[0], args[1], args[2][:4], *args[3:])  # levels disagree


# -- K4: the walk descent ---------------------------------------------------------

# (G0, KG, node_lanes, r): one node of KG columns for every r and KG, then
# nodes of several key words (node_lanes = 2 KG, 3 KG) and several nodes.
WALK_SHAPES = [(kg, kg, kg, r) for r in (1, 4, 6, 9) for kg in (1, 4, 32)] + [
    (6, 2, 6, 5), (8, 2, 4, 3), (3, 1, 1, 4), (12, 4, 12, 7)]


@functools.lru_cache(maxsize=None)
def _descent(g0, kg, nl, r):
    rng = np.random.default_rng(g0 * 1000 + kg * 100 + nl * 10 + r)
    words = [_u32(rng, 16, 8, g0), _u32(rng, g0), _u32(rng, r, 16, 8, kg),
             _u32(rng, r, kg), _u32(rng, r, kg), _u32(rng, 16, 8, kg)]
    t = [to_tensor(w, "cpu") for w in words]
    want = {vh: tuple(to_numpy(x) for x in ep.walk_descend_plain(
        *t[:5], t[5], value_hash=vh, node_lanes=nl)) for vh in (False, True)}
    return words, want


@pytest.mark.parametrize("value_hash", [False, True], ids=["state", "values"])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=lambda s: "g0={}-kg={}-nl={}-r={}".format(*s))
def test_walk_descend_host_matches_plain(host, shape, value_hash):
    words, want = _descent(*shape)
    g0, kg, nl, r = shape
    out = np.empty((16, 8, g0 << r), dtype=np.uint32)
    out_ctrl = np.empty((g0 << r,), dtype=np.uint32)
    assert host.dpf_walk_descend_host(
        *map(_ptr, words[:5]), _ptr(words[5] if value_hash else None), _ptr(out),
        _ptr(out_ctrl), g0, kg, nl, r, int(value_hash)) == 0
    assert np.array_equal(out, want[value_hash][0])
    assert np.array_equal(out_ctrl, want[value_hash][1])
