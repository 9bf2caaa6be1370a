"""The port's DPF evaluation API against the JAX package, bit for bit.

Keys come from the JAX package's key generation (host code) and cross to
the port through `interop.dpf_key_from_fields`; the port evaluates on the
CPU (`device="cpu"`, the kernels' plain versions). Every comparison is
exact: outputs are uint64 shares as two 32-bit limbs.

The JAX reference values are the JAX package's `evaluate_at` at the same
points (its XLA path walk and leaf stage), also for the port's full-domain
and hierarchical evaluation: each distinct JAX program costs seconds of
tracing and compile on a CPU (the unrolled 9-level full expansion of
`evaluate_until` about ten times as long), so `_jax_at` walks one tree
level per call and pads to 1,024 points: every reference, at every
depth, runs the same two compiled programs. Party 0's shares are held
against the JAX package's; party 1's are then pinned exactly by share
reconstruction (the two shares sum to beta at alpha and to 0 elsewhere,
mod 2^64).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu.ops import aes as jaes
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch import value_types as tvt
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor

POINTS = 1024  # every JAX reference call pads to this many points
HIERARCHY = (4, 8, 10)


def _port_key(k):
    return interop.dpf_key_from_fields(
        k.seed, k.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in k.correction_words],
        k.last_level_value_correction,
    )


def _u64(limbs: np.ndarray) -> np.ndarray:
    """uint32[n, 2] limbs -> uint64[n]."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    return limbs[:, 0] | (limbs[:, 1] << np.uint64(32))


def _jax_at(dpf, key, hl, points):
    """The JAX package's `evaluate_at` (its path walk `_walk_paths`, then
    its leaf stage `_leaf_stage_at`), with the walk chained one tree level
    per call: level j walks from j to j + 1 on the paths shifted to put its
    bit at bit 0. One compiled walk serves every depth, and with the
    points padded to POINTS one compiled leaf stage serves every call."""
    pts = list(points) + [points[0]] * (POINTS - len(points))
    tree = [dpf._domain_to_tree_index(p, hl) for p in pts]
    stop = dpf._hierarchy_to_tree[hl]
    seeds = jnp.asarray(np.tile(jaes.u128_to_limbs(key.seed), (POINTS, 1)))
    control = jnp.full((POINTS,), key.party, dtype=jnp.uint32)
    for j in range(stop):
        paths = np.stack([jaes.u128_to_limbs(t >> (stop - 1 - j)) for t in tree])
        seeds, control = dpf._walk_paths(seeds, control, paths, key, j, j + 1, 0)
    vc = jax.tree_util.tree_map(lambda x: x[None], dpf._stage_value_correction(key, hl))
    blocks = jnp.asarray([dpf._domain_to_block_index(p, hl) for p in pts], dtype=jnp.int32)
    out = jdpf._leaf_stage_at(seeds, control, vc, blocks, dpf.parameters[hl].value_type,
                              dpf._blocks_needed[hl], key.party)
    return np.asarray(out)[:len(points)]


def _jax_keys(dpf, alpha, betas, seed):
    """The JAX package's incremental key pair, its root seeds drawn from a
    numpy generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    randbits = lambda k: int.from_bytes(rng.bytes(k // 8), "little")  # noqa: E731
    with mock.patch.object(jdpf.secrets, "randbits", randbits):
        return dpf.generate_keys_incremental(alpha, betas)


def _check_shares(got0, got1, want0, points, alpha_at, beta):
    """Party 0 equals the JAX package's; the shares reconstruct `beta`
    exactly where `alpha_at(point)` holds, and 0 elsewhere."""
    got0, got1 = to_numpy(got0), to_numpy(got1)
    assert np.array_equal(got0, want0)
    total = _u64(got0) + _u64(got1)
    want = np.array([beta if alpha_at(p) else 0 for p in points], dtype=np.uint64)
    assert np.array_equal(total, want)


# -- value types ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "xor"])
@pytest.mark.parametrize("bits", [8, 16, 32, 64, 128])
def test_value_types_match_jax(kind, bits):
    jt = (jvt.IntType if kind == "int" else jvt.XorType)(bits)
    tt = (tvt.IntType if kind == "int" else tvt.XorType)(bits)
    rng = np.random.default_rng(bits)
    nl = tt.nlimbs
    assert nl == jt.nlimbs
    assert tt.elements_per_block() == jt.elements_per_block()
    a = rng.integers(0, 1 << 32, (6, nl), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (6, nl), dtype=np.uint32)
    a = np.array(jt.dev_add(jnp.asarray(a), jt.dev_zeros((6,))))  # in range
    b = np.array(jt.dev_add(jnp.asarray(b), jt.dev_zeros((6,))))
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    mask = np.array([1, 0, 1, 1, 0, 0], dtype=bool)
    blocks = rng.integers(0, 1 << 32, (6, 1, 4), dtype=np.uint32)
    idx = np.arange(6) % jt.elements_per_block()
    lanes = np.asarray(rng.integers(0, 256, (6, 16)), dtype=np.uint32)
    pairs = [
        (tt.dev_add(ta, tb), jt.dev_add(jnp.asarray(a), jnp.asarray(b))),
        (tt.dev_neg(ta), jt.dev_neg(jnp.asarray(a))),
        (tt.dev_where(torch.from_numpy(mask), ta, tb),
         jt.dev_where(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))),
        (tt.dev_from_value_blocks(to_tensor(blocks, "cpu")),
         jt.dev_from_value_blocks(jnp.asarray(blocks))),
        (tt.dev_take_element(tt.dev_from_value_blocks(to_tensor(blocks, "cpu")),
                             torch.from_numpy(idx)),
         jt.dev_take_element(jt.dev_from_value_blocks(jnp.asarray(blocks)),
                             jnp.asarray(idx))),
        (tt.dev_parse_direct(to_tensor(lanes, "cpu"), 16 - bits // 8),
         jt.dev_parse_direct(jnp.asarray(lanes), 16 - bits // 8)),
        (tt.dev_const(7 << (bits - 8), (2, 3), "cpu"), jt.dev_const(7 << (bits - 8), (2, 3))),
        (tt.dev_zeros((4,), "cpu"), jt.dev_zeros((4,))),
    ]
    for i, (got, want) in enumerate(pairs):
        assert np.array_equal(to_numpy(got.contiguous()), np.asarray(want)), i
    # Host face.
    data = rng.bytes(16)
    x, y = int(rng.integers(0, 1 << 62)) % (1 << bits), (1 << bits) - 3
    assert tt.from_bytes(data) == jt.from_bytes(data)
    assert tt.parse_direct(data, 1) == jt.parse_direct(data, 1)
    for op in ("add", "sub"):
        assert getattr(tt, op)(x, y) == getattr(jt, op)(x, y)
    assert tt.neg(x) == jt.neg(x) and tt.zero() == jt.zero()
    assert tt.to_python(ta, (2,)) == jt.to_python(jnp.asarray(a), (2,))


def test_unported_value_types_raise():
    with pytest.raises(NotImplementedError):
        tdpf.DistributedPointFunction.create(
            tdpf.DpfParameters(8, tvt.ValueType()), device="cpu")


# -- key generation -------------------------------------------------------------


@pytest.mark.parametrize("hierarchy,bits", [(HIERARCHY, 64), ((3, 40), 32), ((7,), 128)])
def test_generate_keys_incremental_matches_jax(monkeypatch, hierarchy, bits):
    jd = jdpf.DistributedPointFunction.create_incremental(
        [jdpf.DpfParameters(l, jvt.IntType(bits)) for l in hierarchy])
    td = tdpf.DistributedPointFunction.create_incremental(
        [tdpf.DpfParameters(l, tvt.IntType(bits)) for l in hierarchy], device="cpu")
    alpha = (0x5A5A5A5A5A5A5A5A5A5A >> (80 - hierarchy[-1])) | 1
    betas = [(1 << bits) - 1 - i for i in range(len(hierarchy))]
    rng = np.random.default_rng(11)
    drawn = []

    def randbits(k):
        drawn.append(int.from_bytes(rng.bytes(k // 8), "little"))
        return drawn[-1]

    monkeypatch.setattr(jdpf.secrets, "randbits", randbits)
    want = jd.generate_keys_incremental(alpha, betas)
    got = td.generate_keys_incremental(alpha, betas, _root_seeds=drawn)
    for g, w in zip(got, want):
        assert (g.seed, g.party) == (w.seed, w.party)
        assert g.last_level_value_correction == list(w.last_level_value_correction)
        assert len(g.correction_words) == len(w.correction_words)
        for gc, wc in zip(g.correction_words, w.correction_words):
            assert (gc.seed, gc.control_left, gc.control_right, gc.value_correction) == (
                wc.seed, wc.control_left, wc.control_right, wc.value_correction)


# -- evaluation ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _single(lds):
    """A JAX DPF over 2^lds with IntType(64), its key pair (seeded), and
    the port's DPF and keys."""
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(lds, jvt.IntType(64)))
    rng = np.random.default_rng(lds)
    alpha = int(rng.integers(0, 1 << min(lds, 62))) % (1 << lds)
    beta = int(rng.integers(1, 1 << 62))
    jk = _jax_keys(jd, alpha, [beta], lds)
    td = tdpf.DistributedPointFunction.create(
        tdpf.DpfParameters(lds, tvt.IntType(64)), device="cpu")
    return jd, jk, td, [_port_key(k) for k in jk], alpha, beta


@functools.lru_cache(maxsize=None)
def _full_domain_reference():
    jd, jk, *_ = _single(10)
    return _jax_at(jd, jk[0], 0, list(range(1 << 10)))


@pytest.mark.parametrize("expansion", ["walk", "tail", "level"])
def test_evaluate_until_full_domain_matches_jax(expansion):
    _, _, td, tk, alpha, beta = _single(10)
    td = tdpf.DistributedPointFunction.create(td.parameters[0], device="cpu")
    td._expansion = expansion
    got = [td.evaluate_until(0, [], td.create_evaluation_context(k)) for k in tk]
    assert got[0].shape == (1 << 10, 2)
    _check_shares(*got, _full_domain_reference(), range(1 << 10),
                  lambda p: p == alpha, beta)


@pytest.mark.parametrize("with_ctx", [False, True], ids=["no_ctx", "ctx"])
@pytest.mark.parametrize("lds", [10, 40])
def test_evaluate_at_matches_jax(lds, with_ctx):
    jd, jk, td, tk, alpha, beta = _single(lds)
    rng = np.random.default_rng(100 + lds)
    points = [int(x) for x in rng.integers(0, 1 << lds, 37, dtype=np.uint64)]
    points += [alpha, alpha ^ 1, alpha, 0, (1 << lds) - 1]
    if lds == 10:
        want0 = _full_domain_reference()[points]
    else:
        want0 = _jax_at(jd, jk[0], 0, points)
    got = []
    for k in tk:
        ctx = td.create_evaluation_context(k) if with_ctx else None
        got.append(td.evaluate_at(k, 0, points, ctx))
        if with_ctx:
            assert ctx.previous_hierarchy_level == 0
    _check_shares(*got, want0, points, lambda p: p == alpha, beta)


@functools.lru_cache(maxsize=None)
def _incremental():
    params = [(l, 64) for l in HIERARCHY]
    jd = jdpf.DistributedPointFunction.create_incremental(
        [jdpf.DpfParameters(l, jvt.IntType(b)) for l, b in params])
    td = tdpf.DistributedPointFunction.create_incremental(
        [tdpf.DpfParameters(l, tvt.IntType(b)) for l, b in params], device="cpu")
    alpha, betas = 700, [11, (1 << 64) - 2, 1 << 40]
    jk = _jax_keys(jd, alpha, betas, 7)
    return jd, jk, td, [_port_key(k) for k in jk], alpha, betas


def _prefix_domain(hl, prefixes):
    """Domain indices of level hl below `prefixes` of level hl - 1, in the
    order evaluate_next returns them."""
    if hl == 0:
        return list(range(1 << HIERARCHY[0]))
    span = 1 << (HIERARCHY[hl] - HIERARCHY[hl - 1])
    return [p * span + j for p in prefixes for j in range(span)]


@functools.lru_cache(maxsize=None)
def _incremental_reference(hl, prefixes):
    jd, jk, *_ = _incremental()
    return _jax_at(jd, jk[0], hl, _prefix_domain(hl, prefixes))


def _steps(alpha):
    """Level 1 expands four level-0 prefixes (alpha's among them) in a
    scrambled order; level 2 expands level-1 prefixes below them. Neither
    count is a multiple of 32, so the expansions' narrow levels walk on
    the device."""
    return [(), (11, alpha >> 6, 0, 3), (alpha >> 2, 1 << 4, (3 << 4) + 7, 183, 0)]


def _check_steps(got, alpha, betas):
    for hl, prefixes in enumerate(_steps(alpha)):
        shift = HIERARCHY[-1] - HIERARCHY[hl]
        _check_shares(*got[hl], _incremental_reference(hl, prefixes),
                      _prefix_domain(hl, prefixes), lambda p: p == alpha >> shift,
                      betas[hl])


def test_evaluate_next_matches_jax():
    _, _, td, tk, alpha, betas = _incremental()
    ctxs = [td.create_evaluation_context(k) for k in tk]
    got = [[td.evaluate_next(list(prefixes), ctx) for ctx in ctxs]
           for prefixes in _steps(alpha)]
    _check_steps(got, alpha, betas)
    # A level-2 prefix whose level-1 ancestor (5) was never expanded.
    ctx = td.create_evaluation_context(tk[0])
    td.evaluate_next([], ctx)
    td.evaluate_next([3], ctx)
    with pytest.raises(ValueError, match="not present"):
        td.evaluate_next([5 << 4], ctx)


def test_evaluate_at_resumes_from_a_context():
    _, _, td, tk, alpha, betas = _incremental()
    level0 = [alpha >> 6, 0, 3, 15]
    level1 = [(alpha >> 2) ^ j for j in range(16)]  # all below alpha >> 6
    got = {0: [], 1: []}
    for k in tk:
        ctx = td.create_evaluation_context(k)
        got[0].append(td.evaluate_at(k, 0, level0, ctx))
        got[1].append(td.evaluate_at(k, 1, level1, ctx))
        assert ctx.partial_evaluations_level == 1
    _check_shares(*got[0], _incremental_reference(0, ())[level0], level0,
                  lambda p: p == alpha >> 6, betas[0])
    want1 = _incremental_reference(1, (alpha >> 6,))
    _check_shares(*got[1], want1[[p & 15 for p in level1]], level1,
                  lambda p: p == alpha >> 2, betas[1])


def _logged(events, what, fn):
    def run(*args, **kwargs):
        events.append(what)
        return fn(*args, **kwargs)
    return run


def test_resumed_evaluation_copies_once_and_nothing_back(monkeypatch):
    """Every evaluate_next and evaluate_at call copies to the device once,
    before its first kernel (here the kernels' plain versions), and copies
    nothing back to the host: the context keeps its seeds on the device,
    and the narrow levels of a resumed expansion walk there."""
    _, _, td, tk, alpha, betas = _incremental()
    events = []
    monkeypatch.setattr(tdpf, "to_tensors", _logged(events, "copy", tdpf.to_tensors))
    for name in ("path_level_plain", "expand_level_plain", "value_hash_plain",
                 "walk_descend_plain", "expand_head_plain", "expand_tail_plain"):
        monkeypatch.setattr(ep, name, _logged(events, "kernel", getattr(ep, name)))
    for name in ("numpy", "tolist", "item", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            _logged(events, "to_host", getattr(torch.Tensor, name)))
    calls = []
    points = [alpha, alpha ^ 3, alpha ^ 1]  # all below level-1 prefix alpha >> 2
    got = [[] for _ in _steps(alpha)]
    at = []
    for k in tk:
        ctx = td.create_evaluation_context(k)
        for hl, prefixes in enumerate(_steps(alpha)):
            got[hl].append(td.evaluate_next(list(prefixes), ctx))
            calls.append(events[:])
            events.clear()
        at.append(td.evaluate_at(k, 2, points, ctx))
        calls.append(events[:])
        events.clear()
    monkeypatch.undo()
    for call in calls:
        assert call[0] == "copy" and call.count("copy") == 1, call
        assert "kernel" in call and "to_host" not in call, call
    _check_steps(got, alpha, betas)
    want = _incremental_reference(2, (alpha >> 2,))
    _check_shares(*at, want[[p & 3 for p in points]], points, lambda p: p == alpha,
                  betas[2])
