"""K4 and the multi-level K8 on the split AES, against their plain versions,
on the card, at ragged and extreme shapes.

Marked `cuda`; each test skips without a CUDA device. K4: odd entry
widths, one level (r = 1: a block of one warp, no walk above the
doubling), levels walked above the doubling (r up to 11), one key word
(KG = 1) and nodes of several key words. K8: one and 31 levels, KW = 1
and KW = G, widths that are not a multiple of a block's columns, a stop
at every level (S = L + 1), repeated stops and a stop before any level.
This file imports no JAX, so on a machine with a card and without JAX it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_split_aes.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.words import to_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, shape, device):
    return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


# (G0, KG, node_lanes, r)
WALK_SHAPES = [(1, 1, 1, 1), (3, 1, 1, 1), (5, 1, 1, 4), (3, 3, 3, 9), (6, 2, 6, 5),
               (12, 4, 12, 7), (7, 1, 7, 6), (33, 1, 1, 3), (2, 2, 2, 11)]


@pytest.mark.parametrize("value_hash", [False, True], ids=["state", "values"])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=lambda s: "g0={}-kg={}-nl={}-r={}".format(*s))
def test_walk_descend_matches_plain(dev, shape, value_hash):
    g0, kg, nl, r = shape
    rng = np.random.default_rng(g0 * 100 + r)
    args = [_words(rng, s, dev) for s in ((16, 8, g0), (g0,), (r, 16, 8, kg), (r, kg),
                                          (r, kg), (16, 8, kg))]
    before = cuda_lib.LAUNCHES["walk_descend"]
    got = ep.walk_descend(*args, value_hash=value_hash, node_lanes=nl)
    assert cuda_lib.LAUNCHES["walk_descend"] == before + 1
    want = ep.walk_descend_plain(*args, value_hash=value_hash, node_lanes=nl)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (G, KW, levels, stops)
PATH_SHAPES = [(1, 1, 1, (1,)), (5, 5, 1, (1,)), (5, 1, 3, (0, 1, 2, 3)),
               (32, 32, 31, tuple(range(32))), (33, 1, 4, (2, 2, 4)),
               (70, 70, 5, (0, 5)), (2048, 1, 2, (2,))]


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "g={}-kw={}-l={}-s={}".format(
    s[0], s[1], s[2], len(s[3])))
def test_path_walk_matches_plain(dev, shape):
    g, kw, levels, stops = shape
    rng = np.random.default_rng(g * 10 + levels)
    args = [_words(rng, s, dev) for s in ((16, 8, g), (g,), (levels, g),
                                          (levels, 16, 8, kw), (levels, kw), (levels, kw))]
    before = cuda_lib.LAUNCHES["path_level"]
    got = ep.path_walk(*args, stops=stops)
    assert cuda_lib.LAUNCHES["path_level"] == before + 1
    want = ep.path_walk_plain(*args, stops)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_path_level_is_one_launch_of_the_walk(dev):
    rng = np.random.default_rng(3)
    args = [_words(rng, s, dev) for s in ((16, 8, 9), (9,), (9,), (16, 8, 9), (9,), (9,))]
    got = ep.path_level(*args)
    want = ep.path_level_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

