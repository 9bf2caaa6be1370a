"""K1, its accumulate entry and K7 on the card: the tensor-core count
product against the plain versions, bit for bit.

Marked `cuda`; each test skips without a CUDA device. The shapes are
ragged on every axis the kernel tiles (queries per 128-row tile, record
groups per 32-group stage, words per 8-word tile), and the extremes check
the top of the count range and the bit packing of value bits 0 and 31 at
the first and the last record. This file imports no JAX, so on a machine
with a card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_inner_product_tc.py
"""

import pytest
import torch

from distributed_point_functions_tpu_torch.ops import count_product_cases as cases
from distributed_point_functions_tpu_torch.ops import cuda_lib

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launched(name, fn):
    before = cuda_lib.LAUNCHES[name]
    out = fn()
    assert cuda_lib.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("nq,groups,words", cases.EDGE_SHAPES)
def test_ragged_shapes_match_plain(dev, nq, groups, words):
    cases.check_shape(nq, groups, words, dev, _launched)


@pytest.mark.parametrize("nq,groups,words", cases.EXTREME_SHAPES)
def test_all_ones_and_all_zeros(dev, nq, groups, words):
    cases.check_extremes(nq, groups, words, dev, _launched)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("bit", [0, 31])
def test_single_bit_of_the_first_and_last_record(dev, last, bit):
    cases.check_single_bit(bit, last, dev, _launched)


def test_two_strided_spans_accumulate_into_nonzero_acc(dev):
    cases.check_strided_spans(dev, _launched)
