"""The port's sampled value types (`IntModNType`, `TupleType`) against the
JAX package: their host and device faces, the DPF over the JAX package's
type zoo, and the DCF with sampled betas and with `IntType(128)` over
domains above 2^64.

The JAX reference of a DPF's values is the JAX package's own pieces at
fixed shapes, so that each compiles once for the whole file: its path walk
(`_walk_paths`) chained one tree level per call over `POINTS` padded
points, its value hash (`_value_hash`, one program for each block count),
and its value types' device faces run eagerly on the hashed blocks (value
parse or sampling, the value correction under the control bit, party 1's
negation: `_leaf_stage_at`'s steps without the jit that would compile an
AES for every type). The DCF's reference is the JAX package's generic
engine (`DPF_TPU_DCF_FUSED=0`). Keys come from the JAX package's key
generation, root seeds from seeded numpy generators, and cross to the
port through `interop`; the port runs on the CPU (`device="cpu"`).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import dcf as jdcf
from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu.ops import aes as jaes
from distributed_point_functions_tpu.ops import limb as jlimb
from distributed_point_functions_tpu_torch import dcf as tdcf
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch import value_types as tvt
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import limb as tlimb
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor

POINTS = 64  # every JAX walk pads to this many points
LDS = 5
P32 = 4294967291  # the largest 32-bit prime

# The JAX package's type zoo (its tests/test_dpf.py), as (JAX, port) pairs.
ZOO = [
    (jvt.XorType(32), tvt.XorType(32)),
    (jvt.XorType(128), tvt.XorType(128)),
    (jvt.IntModNType(32, P32), tvt.IntModNType(32, P32)),
    (jvt.IntModNType(8, 251), tvt.IntModNType(8, 251)),
    (jvt.TupleType([jvt.IntType(32), jvt.IntType(32)]),
     tvt.TupleType([tvt.IntType(32), tvt.IntType(32)])),
    (jvt.TupleType([jvt.IntType(8), jvt.IntType(16)]),
     tvt.TupleType([tvt.IntType(8), tvt.IntType(16)])),
    (jvt.TupleType([jvt.IntType(64)] * 3), tvt.TupleType([tvt.IntType(64)] * 3)),
    (jvt.TupleType([jvt.IntType(32), jvt.IntModNType(32, P32)]),
     tvt.TupleType([tvt.IntType(32), tvt.IntModNType(32, P32)])),
    (jvt.TupleType([jvt.IntModNType(16, 65521)] * 2),
     tvt.TupleType([tvt.IntModNType(16, 65521)] * 2)),
]
ZOO_IDS = [str(t) for t, _ in ZOO]


def _leaves_equal(got, want) -> bool:
    got, want = tvt.tree_leaves(got), jax.tree_util.tree_leaves(want)
    return len(got) == len(want) and all(
        np.array_equal(to_numpy(g.contiguous()), np.asarray(w)) for g, w in zip(got, want))


def _limbs(values, nl):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(nl)] for v in values],
                    dtype=np.uint32)


def _beta(t, rng):
    if isinstance(t, jvt.TupleType):
        return tuple(_beta(e, rng) for e in t.elements)
    top = t.modulus if isinstance(t, jvt.IntModNType) else 1 << t.bits
    return int(rng.integers(1, min(top, 1 << 62)))


def _port_key(k):
    return interop.dpf_key_from_fields(
        k.seed, k.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in k.correction_words],
        k.last_level_value_correction)


def _seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda k: int.from_bytes(rng.bytes(k // 8), "little")


@functools.lru_cache(maxsize=None)
def _hash(num_blocks):
    return jax.jit(functools.partial(jdpf._value_hash, num_blocks=num_blocks))


def _jax_at(dpf, key, hl, points):
    """The JAX package's shares of `key` at `points` of hierarchy level
    `hl` (module docstring), as numpy leaves."""
    pts = list(points) + [points[0]] * (POINTS - len(points))
    tree = [dpf._domain_to_tree_index(p, hl) for p in pts]
    stop = dpf._hierarchy_to_tree[hl]
    seeds = jnp.asarray(np.tile(jaes.u128_to_limbs(key.seed), (POINTS, 1)))
    control = jnp.full((POINTS,), key.party, dtype=jnp.uint32)
    for j in range(stop):
        paths = np.stack([jaes.u128_to_limbs(t >> (stop - 1 - j)) for t in tree])
        seeds, control = dpf._walk_paths(seeds, control, paths, key, j, j + 1, 0)
    vt = dpf.parameters[hl].value_type
    blocks = _hash(dpf._blocks_needed[hl])(seeds)
    idx = jnp.asarray([dpf._domain_to_block_index(p, hl) for p in pts], dtype=jnp.int32)
    values = vt.dev_from_value_blocks(blocks)
    vc = jax.tree_util.tree_map(
        lambda c, v: jnp.broadcast_to(c[None], v.shape),
        dpf._stage_value_correction(key, hl), values)
    picked = vt.dev_take_element(values, idx)
    out = vt.dev_where(control != 0, vt.dev_add(picked, vt.dev_take_element(vc, idx)), picked)
    if key.party:
        out = vt.dev_neg(out)
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[:len(points)], out)


# -- limbs and the two faces -------------------------------------------------------

EDGE_MODULI = [1, 2, 3, 251, 65521, (1 << 16) - 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
               P32, 1000003, (1 << 47) - 1, 1 << 47, (1 << 64) - 1, (1 << 64) - 59,
               (1 << 96) + 7, (1 << 127) + 1, (1 << 128) - 1]
# One modulus of each division path and the extremes.
JAX_MODULI = {(1 << 31) - 1, (1 << 47) - 1, (1 << 128) - 1}


def test_divmod_const_matches_jax_and_python_at_edge_moduli():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, (48, 4), dtype=np.uint32)
    x[0], x[1], x[2, 3] = 0xFFFFFFFF, 0, 0  # all ones, zero, a short block
    ints = [sum(int(r[i]) << (32 * i) for i in range(4)) for r in x]
    for n in EDGE_MODULI:
        q, r = tlimb.divmod_const(to_tensor(x, "cpu"), n, 4)
        if n in JAX_MODULI:  # each modulus traces the JAX package's scan anew
            jq, jr = jlimb.divmod_const(jnp.asarray(x), n, 4)
            assert np.array_equal(to_numpy(q), np.asarray(jq)), n
            assert np.array_equal(to_numpy(r), np.asarray(jr)), n
        assert np.array_equal(to_numpy(q), _limbs([v // n for v in ints], 4)), n
        assert np.array_equal(to_numpy(r), _limbs([v % n for v in ints], 4)), n
    with pytest.raises(ValueError):
        tlimb.divmod_const(to_tensor(x, "cpu"), 0, 4)


def test_limb_helpers_match_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, (40, 3), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (40, 3), dtype=np.uint32)
    b[:4] = a[:4]  # equal operands
    b[4, 2] = a[4, 2]  # equal top limbs
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    assert np.array_equal(to_numpy(tlimb.sub(ta, tb)), np.asarray(jlimb.sub(a, b)))
    assert np.array_equal(tlimb.ge(ta, tb).numpy(), np.asarray(jlimb.ge(a, b)))
    c = 0xFFFFFFFF_00000001_7FFFFFFF
    cl = np.broadcast_to(jlimb.to_const(c, 3), a.shape)
    assert np.array_equal(to_numpy(tlimb.sub(ta, c)), np.asarray(jlimb.sub(a, cl)))
    assert np.array_equal(tlimb.ge(ta, c).numpy(), np.asarray(jlimb.ge(a, cl)))
    lanes = rng.integers(0, 256, (5, 16), dtype=np.uint32)
    assert np.array_equal(to_numpy(tlimb.from_byte_lanes(to_tensor(lanes, "cpu"))),
                          np.asarray(jlimb.from_byte_lanes(jnp.asarray(lanes))))


@pytest.mark.parametrize("base,modulus", [(8, 251), (16, 65521), (32, P32), (32, 1),
                                          (64, (1 << 64) - 59), (128, (1 << 128) - 159)])
def test_int_mod_n_device_face_matches_jax(base, modulus):
    jt, tt = jvt.IntModNType(base, modulus), tvt.IntModNType(base, modulus)
    rng = np.random.default_rng(base)
    vals = [int.from_bytes(rng.bytes(16), "little") % modulus for _ in range(30)]
    vals[:3] = [0, modulus - 1, modulus // 2]
    a = _limbs(vals, tt.nlimbs)
    b = _limbs(vals[::-1], tt.nlimbs)
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    assert np.array_equal(to_numpy(tt.dev_add(ta, tb)), np.asarray(jt.dev_add(a, b)))
    assert np.array_equal(to_numpy(tt.dev_neg(ta)), np.asarray(jt.dev_neg(a)))
    assert [tt.to_python(tt.dev_add(ta, tb), (i,)) for i in range(30)] == [
        (x + y) % modulus for x, y in zip(vals, vals[::-1])]
    assert [tt.to_python(tt.dev_neg(ta), (i,)) for i in range(30)] == [
        (-x) % modulus for x in vals]
    for x, y in zip(vals[:5], vals[5:10]):
        assert tt.add(x, y) == jt.add(x, y) and tt.sub(x, y) == jt.sub(x, y)
        assert tt.neg(x) == jt.neg(x)
    assert tt.security_level(3, modulus) == jt.security_level(3, modulus)
    assert tt.bits_needed(2.0) == jt.bits_needed(2.0)
    with pytest.raises(ValueError):
        tvt.IntModNType(base, 1 << base)
    with pytest.raises(ValueError):
        tt.validate(modulus)


@pytest.mark.parametrize("pair", ZOO, ids=ZOO_IDS)
def test_value_blocks_and_sampling_match_jax(pair):
    jt, tt = pair
    rng = np.random.default_rng(len(str(jt)))
    sec = 40 + LDS
    assert tt.bits_needed(sec) == jt.bits_needed(sec)
    assert tt.elements_per_block() == jt.elements_per_block()
    assert tt.can_convert_directly() == jt.can_convert_directly()
    num_blocks = (tt.bits_needed(sec) + 127) // 128
    blocks = rng.integers(0, 1 << 32, (33, num_blocks, 4), dtype=np.uint32)
    blocks[0] = 0xFFFFFFFF
    got = tt.dev_from_value_blocks(to_tensor(blocks, "cpu"))
    assert _leaves_equal(got, jt.dev_from_value_blocks(jnp.asarray(blocks)))
    idx = np.arange(33) % tt.elements_per_block()
    assert _leaves_equal(tt.dev_take_element(got, torch.from_numpy(idx)),
                         jt.dev_take_element(jt.dev_from_value_blocks(jnp.asarray(blocks)),
                                             jnp.asarray(idx, dtype=jnp.int32)))
    for i in range(4):
        data = blocks[i].tobytes()
        assert tt.from_bytes(data) == jt.from_bytes(data)
    x, y = _beta(jt, rng), _beta(jt, rng)
    assert tt.add(x, y) == jt.add(x, y) and tt.neg(x) == jt.neg(x)
    assert tt.zero() == jt.zero()
    # The device sum of two host constants equals the host sum.
    s = tt.dev_add(tt.dev_const(x, (3,), "cpu"), tt.dev_const(y, (3,), "cpu"))
    assert tt.to_python(s, (1,)) == jt.add(x, y)
    assert tt.to_python(tt.dev_neg(tt.dev_const(x, (2,), "cpu")), (0,)) == jt.neg(x)
    assert _leaves_equal(tt.dev_zeros((5,), "cpu"), jt.dev_zeros((5,)))


def test_dev_sample_with_update_matches_jax():
    """A tuple samples its elements jointly: every element but the last
    refills the accumulator (`update or i + 1 < n`), at the byte offsets
    the JAX package reads."""
    jt = jvt.TupleType([jvt.IntModNType(16, 65521), jvt.IntType(8),
                        jvt.IntModNType(16, 65521), jvt.XorType(32)])
    tt = tvt.TupleType([tvt.IntModNType(16, 65521), tvt.IntType(8),
                        tvt.IntModNType(16, 65521), tvt.XorType(32)])
    lanes = np.random.default_rng(4).integers(0, 256, (20, 48), dtype=np.uint32)
    js = jvt._DevSampleState(jnp.asarray(lanes))
    ts = tvt._DevSampleState(to_tensor(lanes, "cpu"))
    assert _leaves_equal(tt.dev_sample(ts, True), jt.dev_sample(js, True))
    assert ts.pos == js.pos
    assert np.array_equal(to_numpy(ts.block), np.asarray(js.block))
    hs_j, hs_t = jvt._HostSampleState(lanes[0].astype(np.uint8).tobytes()), \
        tvt._HostSampleState(lanes[0].astype(np.uint8).tobytes())
    assert tt.sample_host(hs_t, True) == jt.sample_host(hs_j, True)
    assert (hs_t.pos, hs_t.block) == (hs_j.pos, hs_j.block)


def test_tuple_type_rules():
    with pytest.raises(ValueError):
        tvt.TupleType([])
    with pytest.raises(ValueError):
        tvt.TupleType([tvt.IntModNType(16, 65521), tvt.IntModNType(16, 251)])
    t = tvt.TupleType([tvt.IntType(8), tvt.TupleType([tvt.IntType(16), tvt.XorType(8)])])
    assert t == tvt.TupleType([tvt.IntType(8), tvt.TupleType([tvt.IntType(16), tvt.XorType(8)])])
    assert hash(t) == hash(tvt.TupleType(t.elements))
    with pytest.raises(ValueError):
        t.validate((1, 2))
    t.validate((255, (65535, 1)))


# -- the DPF over the type zoo ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zoo_keys(i):
    jt, tt = ZOO[i]
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(LDS, jt))
    td = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(LDS, tt), device="cpu")
    beta = _beta(jt, np.random.default_rng(i))
    alpha = 9 + i
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(i)):
        jk = jd.generate_keys(alpha, beta)
    with mock.patch.object(tdpf.secrets, "randbits", _seeded(i)):
        tk = td.generate_keys(alpha, beta)
    return jd, jk, td, tk, alpha, beta


@pytest.mark.parametrize("i", range(len(ZOO)), ids=ZOO_IDS)
def test_zoo_keygen_and_full_domain_match_jax(i):
    jd, jk, td, tk, alpha, beta = _zoo_keys(i)
    jt, tt = ZOO[i]
    # The port's keygen equals the JAX package's on the same root seeds.
    assert [_port_key(k) for k in jk] == list(tk)
    # 2^5 runs no level in plane layout, so every expansion mode takes
    # the same path here (test_full_domain_with_plane_levels_matches_jax
    # holds the modes apart).
    domain = list(range(1 << LDS))
    full = [td.evaluate_until(0, [], td.create_evaluation_context(k)) for k in tk]
    want = _jax_at(jd, jk[0], 0, domain)
    assert _leaves_equal(full[0], want)
    assert _leaves_equal(td.evaluate_at(tk[0], 0, domain[::-1]),
                         jax.tree_util.tree_map(lambda x: x[::-1], want))
    assert _leaves_equal(td.evaluate_at(tk[1], 0, domain), tvt.tree_map(
        lambda x: x.numpy().view(np.uint32), full[1]))
    # Party 1 is pinned by reconstruction, element by element in each
    # element's group: beta at alpha, 0 elsewhere.
    for x in domain:
        got = tt.add(tt.to_python(full[0], (x,)), tt.to_python(full[1], (x,)))
        assert got == (beta if x == alpha else tt.zero()), x


@pytest.mark.parametrize("i", [2, 7], ids=[ZOO_IDS[2], ZOO_IDS[7]])
def test_full_domain_with_plane_levels_matches_jax(i):
    """At 2^12 the expansion runs 7 levels in plane layout after the host's
    5: the one-block IntModN leaves are hashed at the exit (K4's or K5's
    hash, or K3), the two-block tuple leaves leave as seeds (K4's tail
    without its hash; tail mode without K5) and K3 hashes both blocks."""
    jt, tt = ZOO[i]
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(12, jt))
    td = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(12, tt), device="cpu")
    alpha, beta = 3001, _beta(jt, np.random.default_rng(12))
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(12)):
        jk = jd.generate_keys(alpha, beta)
    tk = [_port_key(k) for k in jk]
    points = [alpha, 0, 4095] + [int(x) for x in np.random.default_rng(3).integers(0, 4096, 61)]
    idx = torch.tensor(points)
    want = _jax_at(jd, jk[0], 0, points)
    full = {}
    for mode in ("walk", "tail", "level"):
        td._expansion = mode
        full[mode] = [td.evaluate_until(0, [], td.create_evaluation_context(k)) for k in tk]
        assert _leaves_equal(tvt.tree_map(lambda x: x[idx], full[mode][0]), want), mode
        assert _leaves_equal(full[mode][1], jax.tree_util.tree_map(
            lambda x: x.numpy().view(np.uint32), full["walk"][1])), mode
    total = tt.dev_add(*full["walk"])
    for got, b in zip(tvt.tree_leaves(total), tvt.tree_leaves(tt.dev_const(beta, (), "cpu"))):
        assert (got != 0).any(dim=-1).nonzero().flatten().tolist() == [alpha]
        assert torch.equal(got[alpha], b)


HIERARCHY_TYPES = [
    (jvt.IntModNType(32, P32), tvt.IntModNType(32, P32)),
    (jvt.TupleType([jvt.IntType(32), jvt.IntModNType(32, P32)]),
     tvt.TupleType([tvt.IntType(32), tvt.IntModNType(32, P32)])),
]


@pytest.mark.parametrize("mode", ["walk", "tail", "level"])
def test_evaluate_next_with_sampled_levels_matches_jax(mode):
    """(5, 9) with an IntModN level then a tuple level of two blocks: the
    first call expands level 0, the second resumes from the context at all
    32 prefixes, whose 4 levels run in plane layout (the tuple's leaves
    leave as seeds for K3). Party 0 against the JAX package at 64 of the
    points; party 1 pinned by reconstruction."""
    jd = jdpf.DistributedPointFunction.create_incremental(
        [jdpf.DpfParameters(5, HIERARCHY_TYPES[0][0]), jdpf.DpfParameters(9, HIERARCHY_TYPES[1][0])])
    td = tdpf.DistributedPointFunction.create_incremental(
        [tdpf.DpfParameters(5, HIERARCHY_TYPES[0][1]), tdpf.DpfParameters(9, HIERARCHY_TYPES[1][1])],
        device="cpu")
    td._expansion = mode
    alpha, betas = 0x15B, [12345, (7, P32 - 2)]
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(7)):
        jk = jd.generate_keys_incremental(alpha, betas)
    tk = [_port_key(k) for k in jk]
    prefixes = [(7 * i + 3) % 32 for i in range(32)]
    points = [p * 16 + j for p in prefixes for j in range(16)]
    picked = [0, 511] + list(range(prefixes.index(alpha >> 4) * 16, prefixes.index(alpha >> 4) * 16 + 16)) \
        + list(range(37, 37 + 46 * 10, 10))
    totals = []
    for p in (0, 1):
        ctx = td.create_evaluation_context(tk[p])
        first = td.evaluate_next([], ctx)
        second = td.evaluate_next(prefixes, ctx)
        if p == 0:
            assert _leaves_equal(first, _jax_at(jd, jk[0], 0, list(range(32))))
            idx = torch.tensor(picked)
            assert _leaves_equal(tvt.tree_map(lambda x: x[idx], second),
                                 _jax_at(jd, jk[0], 1, [points[i] for i in picked]))
        totals.append([td.parameters[1].value_type.to_python(second, (k,))
                       for k in range(len(points))])
    vt = td.parameters[1].value_type
    assert [vt.add(a, b) for a, b in zip(*totals)] == [
        betas[1] if x == alpha else vt.zero() for x in points]


def test_evaluate_and_apply_with_mixed_types_equals_evaluate_at():
    """The multi-key engine groups levels by type: an IntModN level, an
    IntType level and a two-block tuple level, each key at its own point."""
    params = [tdpf.DpfParameters(2, tvt.IntModNType(16, 65521)),
              tdpf.DpfParameters(4, tvt.IntType(32)),
              tdpf.DpfParameters(6, HIERARCHY_TYPES[1][1])]
    td = tdpf.DistributedPointFunction.create_incremental(params, device="cpu")
    keys = []
    for a in (5, 40, 63):
        keys += td.generate_keys_incremental(a, [7, 9, (1, 2)])
    pts = [5, 5, 41, 41, 0, 63]
    seen = []
    td.evaluate_and_apply(keys, pts, lambda v, hl: seen.append(v))
    for hl, values in enumerate(seen):
        shift = 6 - params[hl].log_domain_size
        for k, (key, x) in enumerate(zip(keys, pts)):
            want = td.evaluate_at(key, hl, [x >> shift])
            vt = params[hl].value_type
            assert vt.to_python(values, (k,)) == vt.to_python(want, (0,)), (hl, k)


# -- the DCF with sampled betas and above 2^64 ------------------------------------------


DCF_CASES = [
    # The IntModN beta's shares are pinned by the keys (equal to the JAX
    # package's) and reconstruction; the tuple, which samples an IntModN
    # element beside an integer, is held against the JAX package's engine.
    (6, jvt.IntModNType(32, P32), tvt.IntModNType(32, P32), 77),
    (6, HIERARCHY_TYPES[1][0], HIERARCHY_TYPES[1][1], (5, P32 - 1)),
    # The gate's DCF type above 2^64 (test_torch_mic.py holds the gate, and
    # so this DCF, at 64 and 127).
    (100, jvt.IntType(128), tvt.IntType(128), (1 << 128) - 3),
]


@pytest.mark.parametrize("case", DCF_CASES, ids=[f"{c[0]}-{c[1]}" for c in DCF_CASES])
def test_dcf_matches_jax(monkeypatch, case):
    lds, jt, tt, beta = case
    jc = jdcf.DistributedComparisonFunction.create(lds, jt)
    tc = tdcf.DistributedComparisonFunction.create(lds, tt, device="cpu")
    top = (1 << lds) - 1
    rng = np.random.default_rng(lds)
    alphas = [int.from_bytes(rng.bytes(16), "little") & top, 0, top]
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(lds)):
        jkeys = [k for a in alphas for k in jc.generate_keys(a, beta)]
    tkeys = [tdcf.DcfKey(_port_key(k.key)) for k in jkeys]
    with mock.patch.object(tdpf.secrets, "randbits", _seeded(lds)):
        own = [k.key for a in alphas for k in tc.generate_keys(a, beta)]
    assert own == [k.key for k in tkeys]
    points = []
    for a in alphas:
        x = [a, max(a - 1, 0), min(a + 1, top)][len(points) // 2 % 3]
        points += [x, x]
    points[-2:] = [top, top]
    cuda_lib.reset_launch_counts()
    got = tc.batch_evaluate(tkeys, points)
    assert not any(cuda_lib.LAUNCHES.values())
    if not isinstance(jt, jvt.IntModNType):
        monkeypatch.setenv("DPF_TPU_DCF_FUSED", "0")
        assert _leaves_equal(got, jc.batch_evaluate(jkeys, points))
    for i, a in enumerate(alphas):
        x = points[2 * i]
        total = tt.add(tt.to_python(got, (2 * i,)), tt.to_python(got, (2 * i + 1,)))
        assert total == (beta if x < a else tt.zero()), (a, x)
    # A staged batch repeated on the device equals the repeated key list
    # staged on the host.
    staged = tc.stage_keys(tkeys[:3]).repeat(4)
    host = tc.stage_keys([k for k in tkeys[:3] for _ in range(4)])
    assert staged.n == host.n == 12
    for a, b in zip(_staged_tensors(staged), _staged_tensors(host)):
        assert torch.equal(a, b)


def _staged_tensors(staged):
    return tvt.tree_leaves((staged.parties, staged.state, staged.ctrl, staged.cw_planes,
                            staged.cw_left, staged.cw_right, *staged.value_corrections))


def test_dcf_points_as_uint64_array_and_range_checks():
    tc = tdcf.DistributedComparisonFunction.create(64, tvt.IntType(128), device="cpu")
    k0, k1 = tc.generate_keys((1 << 63) + 5, 3)
    xs = np.array([(1 << 64) - 1, (1 << 63) + 4, (1 << 63) + 5, 0], dtype=np.uint64)
    a = tc.batch_evaluate([k0] * 4, xs)
    b = tc.batch_evaluate([k1] * 4, [int(x) for x in xs])
    assert [tvt.IntType(128).add(tc.value_type.to_python(a, (i,)),
                                 tc.value_type.to_python(b, (i,))) for i in range(4)] == [0, 3, 0, 3]
    small = tdcf.DistributedComparisonFunction.create(10, tvt.IntType(32), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        small.batch_evaluate(list(small.generate_keys(3, 1)), np.array([1, 1 << 10], dtype=np.uint64))
