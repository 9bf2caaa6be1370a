"""`leaf_blocks` (`csrc/leaf_blocks.cu`), built for the host, bit for bit.

The host twin (`dpf_leaf_blocks_host`) runs a warp's 32 lanes in
lockstep, an array standing in for the shuffles of the butterfly
transpose, and a block's phases in the kernel's barrier order, so these
tests run the code the card runs. Each case writes into a buffer filled
with 0xAAAAAAAA first, so a word the kernel leaves unwritten shows, and
is held against the port's plain version and the JAX package's exit
(`planes_to_limbs`, then the exit gather, `pir/dense_eval_planes.py`).
The orders are the exit orders of the port's expansion plans: the walk
plan's, the level plan's (bit-reversed), the tail plan's (tiled) and a
streaming chunk's; the block counts fall below, at and past a tile (T = 32
blocks at KG = 1, 8 at KG = 4, 2 at KG = 32) and past the tree (zero
blocks). Inputs are numpy words from a seed.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.ops import aes_bitslice as jab
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
    exit_block_nodes,
    exit_permutation,
    expansion_plan,
)
from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
    chunk_block_nodes,
)

POISON = 0xAAAAAAAA
JAX_WIDTH = 1024  # word columns of the widest case


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    out = tmp_path_factory.mktemp("host_leaf") / "libleaf_host.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "leaf_blocks.cu"), "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.dpf_leaf_blocks_host.argtypes = [p] * 3 + [i64] * 3
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


MODES = {"identity": "walk", "bit_reversed": "level", "tail": "tail"}


def _block_node(kg, levels, order, num_blocks):
    """The block -> node map of an order's exit gather (the serving
    paths' cached map)."""
    if order == "chunk":
        return chunk_block_nodes(levels, expansion_plan("walk", kg, levels), True)
    mode = MODES[order]
    return exit_block_nodes(levels, *expansion_plan(mode, kg, levels), mode == "walk",
                            num_blocks)


def _jax_exit(values, block_node, kg):
    """The JAX package's exit: `planes_to_limbs`, key-major, then the
    gather of each block's node and zeros where none holds it."""
    g = values.shape[-1]
    nodes = g // kg
    # One padded width for every case: eager JAX compiles once a shape.
    padded = np.pad(values, ((0, 0), (0, 0), (0, JAX_WIDTH - g)))
    limbs = np.asarray(jab.planes_to_limbs(jnp.asarray(padded)))[:32 * g]
    out = np.moveaxis(limbs.reshape(nodes, 32 * kg, 4), 0, 1)
    held = block_node >= 0
    want = np.zeros((32 * kg, len(block_node), 4), dtype=np.uint32)
    want[:, held] = out[:, block_node[held]]
    return want


# (KG, levels, order, blocks): below, at and past one tile, past the tree.
CASES = [
    (1, 6, "identity", 64),
    (1, 6, "bit_reversed", 45),
    (1, 5, "tail", 40),
    (4, 5, "identity", 13),
    (4, 5, "bit_reversed", 8),
    (4, 6, "tail", 64),
    (4, 4, "bit_reversed", 20),
    (4, 3, "identity", 5),
    (32, 4, "bit_reversed", 16),
    (32, 4, "tail", 7),
    (32, 3, "identity", 1),
    (32, 5, "chunk", 32),
]


@pytest.mark.parametrize("kg,levels,order,num_blocks", CASES,
                         ids=lambda c: str(c))
def test_leaf_blocks_host_matches_plain_and_jax(host, kg, levels, order, num_blocks):
    rng = np.random.default_rng(kg * 100 + levels)
    nodes = 1 << levels
    values = rng.integers(0, 1 << 32, (16, 8, kg * nodes), dtype=np.uint32)
    block_node = _block_node(kg, levels, order, num_blocks)
    assert block_node.shape == (num_blocks,)
    out = np.full((32 * kg, num_blocks, 4), POISON, dtype=np.uint32)
    assert host.dpf_leaf_blocks_host(_ptr(values), _ptr(block_node), _ptr(out),
                                     kg * nodes, kg, num_blocks) == 0
    node_block = ep.node_blocks(torch.from_numpy(block_node), nodes)
    plain = to_numpy(ep.leaf_blocks_plain(to_tensor(values, "cpu"), node_block, num_blocks))
    assert np.array_equal(out, plain)
    assert np.array_equal(out, _jax_exit(values, block_node, kg))
    # The wrapper on a CPU tensor: the plain version on the inverse map.
    got = ep.leaf_blocks(to_tensor(values, "cpu"), torch.from_numpy(block_node), kg)
    assert np.array_equal(to_numpy(got), out)


def test_block_maps_are_the_exit_gathers_and_invert():
    for kg, levels, order, num_blocks in CASES:
        block_node = _block_node(kg, levels, order, num_blocks)
        nodes = 1 << levels
        node_block = ep.node_blocks(torch.from_numpy(block_node), nodes).numpy()
        held = block_node >= 0
        assert np.array_equal(node_block[block_node[held]], np.flatnonzero(held))
        assert (node_block >= 0).sum() == held.sum()
        if order != "chunk":
            mode = MODES[order]
            gather = exit_permutation(levels, *expansion_plan(mode, kg, levels),
                                      mode == "walk", num_blocks)
            assert np.array_equal(block_node[:len(gather)], gather)
            assert (block_node[len(gather):] == -1).all()


def test_leaf_blocks_rejects_what_the_kernel_does_not_take():
    values = torch.zeros((16, 8, 12), dtype=torch.int32)
    block_node = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ep.leaf_blocks(values, block_node, 5)  # KG must divide G
    with pytest.raises(ValueError):
        ep.leaf_blocks(values, block_node[None], 3)
    with pytest.raises(TypeError):
        ep.leaf_blocks(values, block_node.long(), 3)
