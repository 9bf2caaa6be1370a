"""Tuples whose sampling reads past the JAX package's block count.

Sampling reads 16 bytes of the value hash, plus a refill for every tuple
element but the last (an IntModN refills with its base integer's width).
Where an IntModN before the last element refills, that is more than
`TupleType.bits_needed` counts. The port counts its blocks from the bytes
that sampling reads; the JAX package does not: its device face clamps the
byte lanes past its blocks to the last one, and its key generation reads
zeros there. Where the over-read bytes fall in bits the last element
ignores, the JAX package's shares still reconstruct, and the port's are
equal to them (block j is H(seed + j), so the port's extra block leaves
the JAX package's blocks as they are). Where they are the last element's
own bytes, the JAX package's shares do not reconstruct, and the port's
reconstruct exactly.

The JAX reference walks its paths and hashes its blocks on its native
oracle (no XLA program), then runs its value types' device faces eagerly;
the port runs on the CPU.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import native as jnative
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu_torch import dcf as tdcf
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch import value_types as tvt

LDS = 2
N64 = (1 << 64) - 59
N128 = 3 ** 50


def _types(lib, spec):
    make = {"i8": lambda: lib.IntType(8), "i64": lambda: lib.IntType(64),
            "m64": lambda: lib.IntModNType(64, N64),
            "m128": lambda: lib.IntModNType(128, N128)}
    return lib.TupleType([make[s]() for s in spec])


# (elements, whether the over-read bytes miss the last element's bits, so
# that the JAX package's shares reconstruct).
SHAPES = [
    (("i8", "m128", "i64"), True),
    (("i64", "m128", "i8"), True),
    (("i8", "i64", "m64", "i8"), True),
    (("m128", "i8", "i8"), False),
    (("m128", "i64", "i8"), False),
    (("i64", "m64", "i8", "i8"), False),
]
IDS = ["-".join(s) for s, _ in SHAPES]


def _seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda k: int.from_bytes(rng.bytes(k // 8), "little")


def _beta(spec, rng):
    tops = {"i8": 1 << 8, "i64": 1 << 62, "m64": 1 << 62, "m128": 1 << 62}
    return tuple(int(rng.integers(1, tops[s])) for s in spec)


def _u128_bytes(values):
    return np.frombuffer(b"".join(int(v).to_bytes(16, "little") for v in values),
                         dtype=np.uint8).reshape(-1, 16)


def _jax_values(dpf, key):
    """The JAX package's shares of `key` at every point of the domain, as
    Python tuples: its native oracle's path walk and value hash, then its
    value type's device face (where it clamps the byte lanes past its
    blocks), the value correction under the control bit and party 1's
    negation."""
    pts = list(range(1 << LDS))
    stop = dpf._hierarchy_to_tree[0]
    cws = key.correction_words[:stop]
    seeds, control = jnative.evaluate_seeds(
        _u128_bytes([key.seed] * len(pts)), np.full(len(pts), key.party, np.uint8),
        _u128_bytes([dpf._domain_to_tree_index(p, 0) for p in pts]),
        _u128_bytes([cw.seed for cw in cws]).reshape(stop, 1, 16),
        np.array([[cw.control_left] for cw in cws], np.uint8),
        np.array([[cw.control_right] for cw in cws], np.uint8), per_seed_cw=False)
    blocks = jnp.asarray(jnative.value_hash(seeds, dpf._blocks_needed[0])
                         .view("<u4").astype(np.uint32))
    vt = dpf.parameters[0].value_type
    idx = jnp.asarray([dpf._domain_to_block_index(p, 0) for p in pts], dtype=jnp.int32)
    values = vt.dev_from_value_blocks(blocks)
    vc = jax.tree_util.tree_map(
        lambda c, v: jnp.broadcast_to(c[None], v.shape),
        dpf._stage_value_correction(key, 0), values)
    picked = vt.dev_take_element(values, idx)
    out = vt.dev_where(jnp.asarray(control) != 0,
                       vt.dev_add(picked, vt.dev_take_element(vc, idx)), picked)
    if key.party:
        out = vt.dev_neg(out)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]
    return [tuple(sum(int(leaf[p, i]) << (32 * i) for i in range(leaf.shape[1]))
                  for leaf in leaves) for p in pts]


def _port_values(dpf, key):
    vt = dpf.parameters[0].value_type
    out = dpf.evaluate_at(key, 0, list(range(1 << LDS)))
    return [vt.to_python(out, (p,)) for p in range(1 << LDS)]


def _sum(vt, a, b):
    return [vt.add(x, y) for x, y in zip(a, b)]


def _jax_keys(spec, seed, alpha, beta):
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(LDS, _types(jvt, spec)))
    with mock.patch.object(jdpf.secrets, "randbits", _seeded(seed)):
        return jd, jd.generate_keys(alpha, beta)


def _port_key(k):
    return interop.dpf_key_from_fields(
        k.seed, k.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in k.correction_words],
        k.last_level_value_correction)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_port_counts_the_bytes_sampling_reads(shape):
    spec, _ = shape
    tt, jt = _types(tvt, spec), _types(jvt, spec)
    td = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(LDS, tt), device="cpu")
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(LDS, jt))
    assert td._tree_levels_needed == jd._tree_levels_needed
    assert td._blocks_needed[0] == -(-(16 + tt.refill_bytes(False)) // 16)
    assert td._blocks_needed[0] == jd._blocks_needed[0] + 1


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_shares_equal_jax_or_reconstruct_exactly(shape):
    spec, jax_reconstructs = shape
    rng = np.random.default_rng(len(IDS[SHAPES.index(shape)]))
    alpha, beta = int(rng.integers(0, 1 << LDS)), _beta(spec, rng)
    tt = _types(tvt, spec)
    jd, jkeys = _jax_keys(spec, 20261018 + SHAPES.index(shape), alpha, beta)
    jshares = [_jax_values(jd, k) for k in jkeys]
    want = [beta if p == alpha else tt.zero() for p in range(1 << LDS)]
    assert (_sum(tt, *jshares) == want) == jax_reconstructs
    td = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(LDS, tt), device="cpu")
    if jax_reconstructs:
        # Keys cross packages: the port's shares are the JAX package's.
        assert [_port_values(td, _port_key(k)) for k in jkeys] == jshares
    # The port's own keys reconstruct exactly, at points and over the domain.
    keys = td.generate_keys(alpha, beta)
    assert _sum(tt, *[_port_values(td, k) for k in keys]) == want
    full = [td.evaluate_until(0, [], td.create_evaluation_context(k)) for k in keys]
    assert _sum(tt, *[[tt.to_python(f, (p,)) for p in range(1 << LDS)]
                      for f in full]) == want


def test_the_example_of_the_fault():
    """`TupleType([IntModNType(128, 3**50), IntType(8), IntType(8)])` at log
    domain 2, alpha 1, beta (7, 5, 9), root seeds from
    np.random.default_rng(20261018): the JAX package reconstructs (7, 5, 113),
    the port (7, 5, 9); and the tuple that raised in the port evaluates."""
    spec = ("m128", "i8", "i8")
    tt = _types(tvt, spec)
    jd, jkeys = _jax_keys(spec, 20261018, 1, (7, 5, 9))
    assert _sum(tt, *[_jax_values(jd, k) for k in jkeys])[1] == (7, 5, 113)
    td = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(LDS, tt), device="cpu")
    with mock.patch.object(tdpf.secrets, "randbits", _seeded(20261018)):
        keys = td.generate_keys(1, (7, 5, 9))
    assert _sum(tt, *[_port_values(td, k) for k in keys])[1] == (7, 5, 9)
    raised = _types(tvt, ("i8", "m128", "i64"))
    d = tdpf.DistributedPointFunction.create(tdpf.DpfParameters(2, raised), device="cpu")
    k0, _ = d.generate_keys(1, (1, 2, 3))
    d.evaluate_at(k0, 0, [1])


@pytest.mark.parametrize("spec", [s for s, ok in SHAPES if not ok],
                         ids=[i for i, (_, ok) in zip(IDS, SHAPES) if not ok])
def test_dcf_reconstructs(spec):
    tt = _types(tvt, spec)
    dcf = tdcf.DistributedComparisonFunction.create(LDS, tt, device="cpu")
    rng = np.random.default_rng(9)
    alpha, beta = 2, _beta(spec, rng)
    k0, k1 = dcf.generate_keys(alpha, beta)
    xs = list(range(1 << LDS))
    s0 = dcf.batch_evaluate([k0] * len(xs), xs)
    s1 = dcf.batch_evaluate([k1] * len(xs), xs)
    got = [tt.add(tt.to_python(s0, (i,)), tt.to_python(s1, (i,))) for i in range(len(xs))]
    assert got == [beta if x < alpha else tt.zero() for x in xs]
