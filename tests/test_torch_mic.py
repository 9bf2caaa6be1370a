"""The port's Multiple Interval Containment gate against the JAX package's.

Gate keys come from the JAX package's `gen` with a fixed `CounterPrng` and
DCF root seeds from a seeded numpy generator (patched into the JAX DPF's
`secrets.randbits`), and cross to the port through
`interop.mic_key_from_fields`; the port's own `gen` with the same PRNG and
seeds must give the same keys and mask shares. The port evaluates on the
CPU (`device="cpu"`, the kernels' plain versions). Party 0's shares must
equal the JAX package's `batch_eval` (its generic DCF engine,
`DPF_TPU_DCF_FUSED=0`) at log_group_size 4 over every masked input, and at
64 and 127 on a few points; party 1's are then pinned exactly by
reconstruction: both parties' shares must sum to [p_j <= x <= q_j] +
r_out_j mod 2^log_group_size.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu.fss_gates import multiple_interval_containment as jmic
from distributed_point_functions_tpu.fss_gates import prng as jprng
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch.fss_gates import multiple_interval_containment as tmic
from distributed_point_functions_tpu_torch.fss_gates import prng as tprng
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops.words import to_numpy

# (log_group_size, intervals, r_in, r_out): the JAX package's brute-force
# shape, then the Z_2^64 ring with intervals that wrap, then the widest group.
SHAPES = {
    4: ([(2, 5), (0, 0), (7, 15)], 11, [3, 9, 14]),
    64: ([(100, 150), (0, (1 << 64) - 1), ((1 << 63) - 5, (1 << 63) + 5)],
         (1 << 64) - 17, [5, (1 << 64) - 1, 1 << 40]),
    127: ([(0, 0), (1 << 100, (1 << 126) + 3), ((1 << 127) - 9, (1 << 127) - 1)],
          (1 << 126) + 12345, [0, 7, (1 << 127) - 2]),
}


def _seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda k: int.from_bytes(rng.bytes(k // 8), "little")


def _port_key(k):
    d = k.dcf_key.key
    return interop.mic_key_from_fields(
        d.seed, d.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in d.correction_words],
        d.last_level_value_correction, k.output_mask_share)


@functools.lru_cache(maxsize=None)
def _gates(lgs):
    """(JAX gate, port gate, JAX keys, port keys from the port's gen)."""
    intervals, r_in, r_out = SHAPES[lgs]
    jg = jmic.MultipleIntervalContainmentGate.create(
        jmic.MicParameters(lgs, [jmic.Interval(a, b) for a, b in intervals]))
    tg = tmic.MultipleIntervalContainmentGate.create(
        interop.mic_parameters_from_fields(lgs, intervals), device="cpu")
    seed = lgs.to_bytes(16, "little")
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(lgs)):
        jkeys = jg.gen(r_in, r_out, jprng.CounterPrng(seed))
    with mock.patch.object(tdpf.secrets, "randbits", _seeded(lgs)):
        tkeys = tg.gen(r_in, r_out, tprng.CounterPrng(seed))
    return jg, tg, jkeys, tkeys


def _points(lgs):
    """16 masked inputs (every JAX batch holds 16 x 3 keys, so the JAX
    package compiles its programs once for all groups): every input at 4,
    else the intervals' edges and random inputs."""
    n = 1 << lgs
    if lgs == 4:
        return list(range(n))
    r_in = SHAPES[lgs][1]
    edges = [0, 1, n - 1, 100, 150, 151, (1 << 63) - 5, 1 << 100, (1 << 126) + 3]
    rng = np.random.default_rng(lgs)
    plain = [x for x in edges if x < n]
    plain += [int.from_bytes(rng.bytes(16), "little") % n for _ in range(16 - len(plain))]
    return [(x + r_in) % n for x in plain]


def _contained(lgs, x):
    return [int(a <= x <= b) for a, b in SHAPES[lgs][0]]


@pytest.mark.parametrize("lgs", [4, 64, 127])
def test_gen_matches_jax(lgs):
    _, _, jkeys, tkeys = _gates(lgs)
    fields = lambda k: (k.dcf_key.key, k.output_mask_share)  # noqa: E731
    assert [fields(_port_key(k)) for k in jkeys] == [fields(k) for k in tkeys]
    assert tkeys[0].output_mask_share != tkeys[1].output_mask_share


@pytest.mark.parametrize("lgs", [4, 64, 127])
def test_batch_eval_matches_jax_and_reconstructs(monkeypatch, lgs):
    jg, tg, jkeys, tkeys = _gates(lgs)
    n = 1 << lgs
    points = _points(lgs)
    monkeypatch.setenv("DPF_TPU_DCF_FUSED", "0")
    cuda_lib.reset_launch_counts()
    # Party 0 against the JAX package; party 1 (its points as a uint64
    # array where the group allows) is then pinned by reconstruction.
    shares = [tg.batch_eval([tkeys[0]] * len(points), points)]
    assert shares[0] == jg.batch_eval([jkeys[0]] * len(points), points)
    xs = np.array(points, dtype=np.uint64) if lgs <= 64 else points
    shares.append(tg.batch_eval([tkeys[1]] * len(points), xs))
    assert not any(cuda_lib.LAUNCHES.values())
    r_in, r_out = SHAPES[lgs][1], SHAPES[lgs][2]
    for i, masked in enumerate(points):
        got = [(a + b - r) % n for a, b, r in zip(shares[0][i], shares[1][i], r_out)]
        assert got == _contained(lgs, (masked - r_in) % n), masked


@pytest.mark.parametrize("lgs", [4])
def test_batch_equals_single_and_device_shape(lgs):
    _, tg, _, tkeys = _gates(lgs)
    points = _points(lgs)[:5]
    # Mixed parties in one batch; the points as a uint64 array.
    keys = [tkeys[i % 2] for i in range(len(points))]
    batch = tg.batch_eval(keys, np.array(points, dtype=np.uint64))
    assert batch == [tg.eval(k, x) for k, x in zip(keys, points)]
    staged = tg.stage_keys(keys)
    dev = tg.batch_eval_device(None, points, staged=staged)
    assert dev.shape == (len(points), len(SHAPES[lgs][0]), 4) and dev.dtype == torch.int32
    u64 = to_numpy(dev).astype(np.uint64)
    assert (u64[..., 0] | (u64[..., 1] << np.uint64(32))).tolist() == batch
    assert not to_numpy(dev)[..., 2:].any()


def _error_cases(module, device_kw):
    mic = module
    params = mic.MicParameters(4, [mic.Interval(0, 3)])
    gate = mic.MultipleIntervalContainmentGate.create(params, **device_kw)
    return [
        lambda: gate.gen(16, [0]),
        lambda: gate.gen(0, [0, 1]),
        lambda: gate.gen(0, [16]),
        lambda: mic.MultipleIntervalContainmentGate.create(
            mic.MicParameters(4, [mic.Interval(5, 3)]), **device_kw),
        lambda: mic.MultipleIntervalContainmentGate.create(
            mic.MicParameters(4, [mic.Interval(0, 16)]), **device_kw),
        lambda: mic.MultipleIntervalContainmentGate.create(mic.MicParameters(4, []), **device_kw),
        lambda: mic.MultipleIntervalContainmentGate.create(
            mic.MicParameters(128, [mic.Interval(0, 1)]), **device_kw),
        lambda: gate.batch_eval([gate.gen(0, [0])[0]], [99]),
        lambda: gate.batch_eval([gate.gen(0, [0])[0]], [1, 2]),
    ]


def test_rejects_what_jax_rejects_with_the_same_messages():
    for j, t in zip(_error_cases(jmic, {}), _error_cases(tmic, {"device": "cpu"})):
        with pytest.raises(ValueError) as want:
            j()
        with pytest.raises(ValueError) as got:
            t()
        assert str(got.value) == str(want.value)
