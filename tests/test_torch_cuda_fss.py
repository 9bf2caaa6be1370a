"""The FSS layer on the card against the plain versions on the host.

Marked `cuda`; each test skips without a CUDA device. The MIC gate and the
sampled value types (`IntModNType`, `TupleType`) at small shapes: every
value the card computes must equal the same call's on a `device="cpu"`
twin (the kernels' plain versions), and the card's calls must launch the
kernels their paths name. This file imports no JAX, so on a machine with a
card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_fss.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.dcf import DistributedComparisonFunction
from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
from distributed_point_functions_tpu_torch.fss_gates import (
    Interval,
    MicParameters,
    MultipleIntervalContainmentGate,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.value_types import (
    IntModNType,
    IntType,
    TupleType,
    tree_leaves,
)

pytestmark = pytest.mark.cuda

P32 = 4294967291


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(card, host) -> bool:
    card, host = tree_leaves(card), tree_leaves(host)
    return len(card) == len(host) and all(
        torch.equal(a.cpu(), b) for a, b in zip(card, host))


@pytest.mark.parametrize("lgs", [8, 64, 127])
def test_mic_gate_on_the_card_equals_plain(dev, lgs):
    n = 1 << lgs
    params = MicParameters(lgs, [Interval(0, 3), Interval(n // 2, n - 1), Interval(5, 5)])
    gate = MultipleIntervalContainmentGate.create(params)
    cpu = MultipleIntervalContainmentGate.create(params, device="cpu")
    rng = np.random.default_rng(lgs)
    r_in = int.from_bytes(rng.bytes(16), "little") % n
    r_out = [int.from_bytes(rng.bytes(16), "little") % n for _ in range(3)]
    k0, k1 = gate.gen(r_in, r_out)
    plain = [0, 3, 4, 5, n // 2 - 1, n // 2, n - 1] + [
        int.from_bytes(rng.bytes(16), "little") % n for _ in range(33)]
    xs = [(x + r_in) % n for x in plain]
    shares = []
    for key in (k0, k1):
        keys = [key] * len(xs)
        cuda_lib.reset_launch_counts()
        got = gate.batch_eval_device(keys, xs)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["path_level"] == 1 and cuda_lib.LAUNCHES["value_hash"] == 1
        assert torch.equal(got.cpu(), cpu.batch_eval_device(keys, xs))
        shares.append(gate.batch_eval(keys, xs))
    for i, x in enumerate(plain):
        got = [(a + b - r) % n for a, b, r in zip(shares[0][i], shares[1][i], r_out)]
        assert got == [int(iv.lower_bound <= x <= iv.upper_bound) for iv in params.intervals]


TYPES = [IntModNType(32, P32), TupleType([IntType(32), IntModNType(32, P32)]),
         TupleType([IntModNType(16, 65521)] * 2)]


@pytest.mark.parametrize("vt", TYPES, ids=str)
@pytest.mark.parametrize("mode", ["walk", "tail", "level"])
def test_sampled_types_dpf_on_the_card_equals_plain(dev, vt, mode):
    params = DpfParameters(12, vt)
    dpf = DistributedPointFunction.create(params)
    cpu = DistributedPointFunction.create(params, device="cpu")
    dpf._expansion = cpu._expansion = mode
    beta = tuple(range(3, 3 + len(vt.elements))) if isinstance(vt, TupleType) else 7
    keys = dpf.generate_keys(1234, beta)
    points = [0, 1233, 1234, 1235, 4095, 77]
    for key in keys:
        cuda_lib.reset_launch_counts()
        full = dpf.evaluate_until(0, [], dpf.create_evaluation_context(key))
        torch.cuda.synchronize()
        assert sum(cuda_lib.LAUNCHES.values()) > 0
        if dpf._blocks_needed[0] > 1:  # the leaf seeds' hash, after the expansion
            assert cuda_lib.LAUNCHES["value_hash"] == 1
        assert _equal(full, cpu.evaluate_until(0, [], cpu.create_evaluation_context(key)))
        at = dpf.evaluate_at(key, 0, points)
        assert _equal(at, cpu.evaluate_at(key, 0, points))
        idx = torch.tensor(points, device=dev)
        assert _equal(at, tuple(x[idx].cpu() for x in tree_leaves(full)))


@pytest.mark.parametrize("vt", TYPES[:2], ids=str)
def test_sampled_types_dcf_on_the_card_equals_plain(dev, vt):
    dcf = DistributedComparisonFunction.create(20, vt)
    cpu = DistributedComparisonFunction.create(20, vt, device="cpu")
    beta = 9 if not isinstance(vt, TupleType) else (4, 5)
    k0, k1 = dcf.generate_keys(70000, beta)
    xs = [0, 69999, 70000, 70001, (1 << 20) - 1] * 8
    keys = [k0, k1] * 20
    staged = dcf.stage_keys(keys[:2]).repeat(20)
    assert _equal(dcf.batch_evaluate(None, xs[::2] * 2, staged=staged),
                  cpu.batch_evaluate([k0] * 20 + [k1] * 20, xs[::2] * 2))
    assert _equal(dcf.batch_evaluate(keys, xs), cpu.batch_evaluate(keys, xs))
