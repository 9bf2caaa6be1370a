"""The port's DCF and multi-key DPF engine against the JAX package.

32 keys (16 key pairs from the JAX package's key generation, root seeds
from a numpy seed, the parties interleaved) are evaluated at 2^16 and 2^40
(paths that cross a 32-bit limb), each pair at one point; the points
include each alpha, its neighbours and the domain's ends. The JAX
reference is its generic engine (`evaluate_and_apply` per hierarchy level,
`DPF_TPU_DCF_FUSED=0`), whose two programs compile once for both domains;
the port runs its one engine (`evaluate_and_accumulate`, K8 per tree level
in per-seed mode) on the CPU. Both parties' shares must equal the JAX
package's exactly, and each pair must reconstruct beta * [x < alpha] mod
2^64.
"""

import functools
from unittest import mock

import numpy as np
import pytest

from distributed_point_functions_tpu import dcf as jdcf
from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu_torch import dcf as tdcf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch import value_types as tvt
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops.words import to_numpy

PAIRS = 16
BETA = (1 << 64) - 5


def _u64(limbs):
    limbs = np.asarray(limbs, dtype=np.uint64)
    return limbs[:, 0] | (limbs[:, 1] << np.uint64(32))


def _port_key(k):
    return interop.dcf_key_from_fields(
        k.seed, k.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in k.correction_words],
        k.last_level_value_correction,
    )


@functools.lru_cache(maxsize=None)
def _setup(lds):
    """(JAX DCF, JAX keys, port DCF, port keys, alphas, points)."""
    jc = jdcf.DistributedComparisonFunction.create(lds, jvt.IntType(64))
    rng = np.random.default_rng(300 + lds)
    randbits = lambda k: int.from_bytes(rng.bytes(k // 8), "little")  # noqa: E731
    top = (1 << lds) - 1
    alphas = [int(x) for x in rng.integers(1, top, PAIRS, dtype=np.uint64)]
    alphas[:2] = [0, top]
    jkeys, points = [], []
    with mock.patch.object(jdpf.secrets, "randbits", randbits):
        for i, alpha in enumerate(alphas):
            jkeys += [k.key for k in jc.generate_keys(alpha, BETA)]
            x = [alpha, alpha - 1, alpha + 1, 0, top][i % 5] if 0 < alpha < top else i
            points += [x, x]
    tc = tdcf.DistributedComparisonFunction.create(lds, tvt.IntType(64), device="cpu")
    return jc, jkeys, tc, [_port_key(k) for k in jkeys], alphas, points


def _jax_batch(monkeypatch, lds, points=None):
    jc, jkeys, *_, pts = _setup(lds)
    monkeypatch.setenv("DPF_TPU_DCF_FUSED", "0")
    return np.asarray(jc.batch_evaluate([jdcf.DcfKey(k) for k in jkeys],
                                        points or pts))


def _check_reconstructs(shares, alphas, points):
    v = _u64(shares)
    total = v[0::2] + v[1::2]
    want = [BETA if x < a else 0 for a, x in zip(alphas, points[0::2])]
    assert [int(t) for t in total] == want


@pytest.mark.parametrize("lds", [16, 40])
def test_batch_evaluate_matches_jax(monkeypatch, lds):
    *_, tc, tkeys, alphas, points = _setup(lds)
    cuda_lib.reset_launch_counts()
    got = to_numpy(tc.batch_evaluate(tkeys, points))
    assert not any(cuda_lib.LAUNCHES.values())
    assert np.array_equal(got, _jax_batch(monkeypatch, lds))
    _check_reconstructs(got, alphas, points)


def test_staged_batch_serves_several_point_sets(monkeypatch):
    *_, tc, tkeys, alphas, points = _setup(16)
    staged = tc.stage_keys(tkeys)
    rng = np.random.default_rng(17)
    for _ in range(2):
        xs = [int(x) for x in rng.integers(0, 1 << 16, len(points) // 2)]
        xs = [x for x in xs for _ in range(2)]
        got = to_numpy(tc.batch_evaluate(None, xs, staged=staged))
        assert np.array_equal(got, _jax_batch(monkeypatch, 16, xs))
        _check_reconstructs(got, alphas, xs)
    assert tc.evaluate(tkeys[3], xs[3]) == int(_u64(got[3:4])[0])


@pytest.mark.parametrize("lds,stop_at", [(40, None), (16, 2)])
def test_evaluate_and_apply_matches_jax(monkeypatch, lds, stop_at):
    jc, jkeys, tc, tkeys, _, points = _setup(lds)
    seen = {"jax": [], "port": []}

    def collect(name):
        def op(values, hl):
            seen[name].append((hl, np.asarray(to_numpy(values) if name == "port" else values)))
            return hl != stop_at
        return op

    jc.dpf.evaluate_and_apply(jkeys, points, collect("jax"), evaluation_points_rightshift=1)
    tc.dpf.evaluate_and_apply([k.key for k in tkeys], points, collect("port"),
                              evaluation_points_rightshift=1)
    assert len(seen["port"]) == (lds if stop_at is None else stop_at + 1)
    assert [hl for hl, _ in seen["port"]] == [hl for hl, _ in seen["jax"]]
    for (_, got), (_, want) in zip(seen["port"], seen["jax"]):
        assert np.array_equal(got, want)


def test_dcf_rejects_bad_arguments():
    *_, tc, tkeys, _, points = _setup(16)
    with pytest.raises(ValueError):
        tc.batch_evaluate(tkeys, points[:-1])
    with pytest.raises(ValueError):
        tc.batch_evaluate(tkeys[:1], [1 << 16])
    with pytest.raises(ValueError):
        tc.generate_keys(1 << 16, 1)
    with pytest.raises(ValueError):
        tdcf.DistributedComparisonFunction.create(0, tvt.IntType(64), device="cpu")
