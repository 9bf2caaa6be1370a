"""K8 `path_level` against the JAX package's path walk, bit for bit.

The reference is the JAX package's `dpf._eval_paths_planes` with
`level_kernel=False`: the XLA twin of its Pallas `_path_kernel`, in the
same plane layout. Each instance (numpy, from a seed) has 32 * G lanes
with their own seeds, control bits and 128-bit paths. Lanes walk
independently in both modes, so the JAX walk runs on one 32-lane group
at a time, chained one level per call, and shared corrections enter it
as every lane's own: one compile (the per-seed walk) gives the state of
every group after each of the three levels in both modes. The levels read
path bits 37, 5 and 100 (three different limbs). Modes: shared (one
key's corrections, KW = 1) and per-seed (each lane its own key, KW = G).

The plain PyTorch version runs for CPU tensors; the CUDA source, built
for the host with a C++ compiler, is held against the plain version on
the same instances. No Pallas interpret mode.
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.aes_bitslice import (
    broadcast_cw_planes,
    limbs_to_planes,
    limbs_to_planes_np,
    pack_select_bits,
    pack_select_bits_np,
    planes_to_limbs,
    unpack_select_bits,
)
from distributed_point_functions_tpu_torch.ops.limb import get_bit
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor

BITS = (37, 5, 100)
GROUPS = (1, 4)
MODES = ("shared", "per_seed")


def _u32(rng, *shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _instance(groups, mode):
    """(inputs, [(seeds, control) of the JAX walk after level j + 1])."""
    rng = np.random.default_rng(800 + 10 * groups + MODES.index(mode))
    n = 32 * groups
    m = n if mode == "per_seed" else 1
    inp = dict(
        seeds=_u32(rng, n, 4), control=_u32(rng, n, high=2), paths=_u32(rng, n, 4),
        cw_seeds=_u32(rng, len(BITS), m, 4), cw_left=_u32(rng, len(BITS), m, high=2),
        cw_right=_u32(rng, len(BITS), m, high=2),
    )
    levels = [[] for _ in BITS]
    for lo in range(0, n, 32):
        lanes = slice(lo, lo + 32)
        cws = lanes if mode == "per_seed" else slice(None)
        seeds = jnp.asarray(inp["seeds"][lanes])
        control = jnp.asarray(inp["control"][lanes])
        for j, bit in enumerate(BITS):
            cw = {k: jnp.asarray(np.broadcast_to(inp[k][j:j + 1, cws],
                                                 (1, 32) + inp[k].shape[2:]))
                  for k in ("cw_seeds", "cw_left", "cw_right")}
            seeds, control = jdpf._eval_paths_planes(
                seeds, control, jnp.asarray(inp["paths"][lanes]),
                cw["cw_seeds"], cw["cw_left"], cw["cw_right"],
                jnp.asarray([bit], dtype=jnp.int32), level_kernel=False,
            )
            levels[j].append((np.asarray(seeds), np.asarray(control)))
    want = [tuple(np.concatenate(part) for part in zip(*lv)) for lv in levels]
    return inp, want


def _level_args(inp, j, mode):
    """(sel, cwp, cwl, cwr) of level j in the port's layout (CPU tensors)."""
    t = {k: to_tensor(v, "cpu") for k, v in inp.items()}
    sel = pack_select_bits(get_bit(t["paths"], BITS[j]))
    if mode == "per_seed":
        return (sel, limbs_to_planes(t["cw_seeds"][j].contiguous()),
                pack_select_bits(t["cw_left"][j]), pack_select_bits(t["cw_right"][j]))
    return (sel, broadcast_cw_planes(t["cw_seeds"][j, 0]),
            -t["cw_left"][j], -t["cw_right"][j])


@pytest.fixture(params=[(g, m) for g in GROUPS for m in MODES],
                ids=[f"G{g}-{m}" for g in GROUPS for m in MODES])
def inst(request):
    groups, mode = request.param
    inp, want = _instance(groups, mode)
    return dict(groups=groups, mode=mode, inp=inp, want=want)


def test_path_level_plain_matches_jax_walk(inst):
    inp, mode = inst["inp"], inst["mode"]
    cuda_lib.reset_launch_counts()
    state = limbs_to_planes(to_tensor(inp["seeds"], "cpu"))
    ctrl = pack_select_bits(to_tensor(inp["control"], "cpu"))
    for j, (want_seeds, want_control) in enumerate(inst["want"]):
        state, ctrl = ep.path_level(state, ctrl, *_level_args(inp, j, mode))
        assert np.array_equal(to_numpy(planes_to_limbs(state)), want_seeds), j
        assert np.array_equal(to_numpy(unpack_select_bits(ctrl)), want_control), j
    assert cuda_lib.LAUNCHES["path_level"] == 0


def test_host_packers_match_the_device_layout():
    rng = np.random.default_rng(6)
    blocks = _u32(rng, 3, 64, 4)
    bits = _u32(rng, 3, 96, high=2)
    got = limbs_to_planes_np(blocks)
    for i in range(3):
        assert np.array_equal(got[i], to_numpy(limbs_to_planes(to_tensor(blocks[i], "cpu"))))
        assert np.array_equal(pack_select_bits_np(bits)[i],
                              to_numpy(pack_select_bits(to_tensor(bits[i], "cpu"))))
    words = to_tensor(_u32(rng, 5), "cpu")
    assert torch.equal(pack_select_bits(unpack_select_bits(words)), words)


def test_broadcast_cw_planes_is_the_packing_of_a_repeated_word():
    rng = np.random.default_rng(5)
    cw = to_tensor(_u32(rng, 3, 4), "cpu")
    got = broadcast_cw_planes(cw)
    for i in range(3):
        want = limbs_to_planes(cw[i].expand(32, 4).contiguous())
        assert torch.equal(got[i], want)


def test_path_level_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(9)
    w = lambda *s: to_tensor(_u32(rng, *s), "cpu")  # noqa: E731
    state, ctrl, sel = w(16, 8, 4), w(4), w(4)
    with pytest.raises(ValueError):
        ep.path_level(state, ctrl, sel, w(16, 8, 3), w(3), w(3))  # KW does not divide G
    with pytest.raises(ValueError):
        ep.path_level(state, ctrl, w(3), w(16, 8, 1), w(1), w(1))  # sel width
    with pytest.raises(ValueError):
        ep.path_level(state, ctrl, sel, w(16, 8, 4), w(4), w(2))  # cwr width
    with pytest.raises(TypeError):
        ep.path_level(state.to(torch.int64), ctrl, sel, w(16, 8, 1), w(1), w(1))


# -- the CUDA source, built for the host -------------------------------------


@pytest.fixture(scope="module")
def host_path_level(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA source for the host")
    out = tmp_path_factory.mktemp("host_path_level") / "libpath_level_host.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "path_level.cu"),
         "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.dpf_path_level_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
    return lib


def _host_level(lib, *args):
    """One level through the host twin; args are CPU int32 tensors."""
    a = [np.ascontiguousarray(to_numpy(t)) for t in args]
    g, kw = a[0].shape[-1], a[3].shape[-1]
    out = np.empty((16, 8, g), dtype=np.uint32)
    out_ctrl = np.empty((g,), dtype=np.uint32)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.dpf_path_level_host(*map(ptr, a), ptr(out), ptr(out_ctrl), g, kw)
    return to_tensor(out, "cpu"), to_tensor(out_ctrl, "cpu")


def test_cuda_path_level_source_matches_plain(host_path_level, inst):
    inp, mode = inst["inp"], inst["mode"]
    state = limbs_to_planes(to_tensor(inp["seeds"], "cpu"))
    ctrl = pack_select_bits(to_tensor(inp["control"], "cpu"))
    for j in range(len(BITS)):
        args = _level_args(inp, j, mode)
        got = _host_level(host_path_level, state, ctrl, *args)
        state, ctrl = ep.path_level_plain(state, ctrl, *args)
        assert torch.equal(got[0], state) and torch.equal(got[1], ctrl), j
