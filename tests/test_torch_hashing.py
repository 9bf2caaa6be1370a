"""The port's hashing sublibrary (`distributed_point_functions_tpu_torch/
hashing/`) against the JAX package's: hash values on random inputs, the
tables' layouts for the same inserts, and the validation errors. Pure
Python on both sides, no JAX program."""

import numpy as np
import pytest

from distributed_point_functions_tpu import hashing as jh
from distributed_point_functions_tpu_torch import hashing as th

RNG_SEED = 20261018


def _inputs(rng, n, max_len=70):
    return [rng.bytes(int(rng.integers(0, max_len))) for _ in range(n)]


BOUNDS = [1, 2, 7, 90, 4500, 1000003, 25165824, (1 << 64) - 59, (1 << 127) + 1,
          (1 << 200) + 3]


@pytest.mark.parametrize("family", ["sha256", "farm"])
def test_hash_values_equal_jax(family):
    rng = np.random.default_rng(RNG_SEED)
    make = {"sha256": (jh.sha256_hash_function, th.sha256_hash_function),
            "farm": (jh.farm_hash_family, th.farm_hash_family)}[family]
    for seed in [b"", b"s", "text seed"] + _inputs(rng, 4, 40):
        jf, tf = make[0](seed), make[1](seed)
        for data in _inputs(rng, 40):
            for ub in BOUNDS:
                assert tf(data, ub) == jf(data, ub)
        with pytest.raises(ValueError, match="upper_bound must be positive"):
            tf(b"x", 0)


def test_families_derive_the_jax_functions():
    rng = np.random.default_rng(RNG_SEED + 1)
    data = _inputs(rng, 20)
    config = (jh.HashFamilyConfig(jh.HASH_FAMILY_SHA256, b"0123456789abcdef"),
              th.HashFamilyConfig(th.HASH_FAMILY_SHA256, b"0123456789abcdef"))
    jfns = jh.create_hash_functions(jh.create_hash_family_from_config(config[0]), 3)
    tfns = th.create_hash_functions(th.create_hash_family_from_config(config[1]), 3)
    assert [[f(d, 4500) for d in data] for f in tfns] == \
        [[f(d, 4500) for d in data] for f in jfns]
    wrapped = (jh.wrap_with_seed(jh.farm_hash_family, "fam"),
               th.wrap_with_seed(th.farm_hash_family, "fam"))
    assert [wrapped[1](b"7")(d, 1 << 40) for d in data] == \
        [wrapped[0](b"7")(d, 1 << 40) for d in data]
    assert th.SHA256HashFamily()(b"k")(b"v", 99) == jh.SHA256HashFamily()(b"k")(b"v", 99)


def _both(kind, num_funcs, num_buckets, **kw):
    out = []
    for lib in (jh, th):
        fns = lib.create_hash_functions(
            lib.wrap_with_seed(lib.SHA256HashFamily(), b"tables"), num_funcs)
        out.append(getattr(lib, kind)(fns, num_buckets, **kw))
    return out


# (buckets, elements, max stash): a roomy table, a full one with an
# unbounded stash, one whose stash holds what does not fit.
CUCKOO_CASES = [(150, 100, None), (40, 60, None), (30, 45, 20)]


@pytest.mark.parametrize("buckets,elements,stash", CUCKOO_CASES)
def test_cuckoo_table_and_stash_equal_jax(buckets, elements, stash):
    rng = np.random.default_rng(RNG_SEED + buckets)
    jt, tt = _both("CuckooHashTable", 3, buckets, max_relocations=64,
                   max_stash_size=stash)
    for e in _inputs(rng, elements, 20):
        jt.insert(e)
        tt.insert(e)
    assert tt.get_table() == jt.get_table()
    assert tt.get_stash() == jt.get_stash()
    assert elements - len(tt.get_stash()) == sum(s is not None for s in tt.get_table())


def test_cuckoo_table_full_stash_raises_as_jax():
    jt, tt = _both("CuckooHashTable", 2, 4, max_relocations=4, max_stash_size=1)
    errors = []
    for table in (jt, tt):
        with pytest.raises(RuntimeError) as e:
            for x in _inputs(np.random.default_rng(RNG_SEED + 2), 30, 8):
                table.insert(x)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "cannot insert element: stash is full"
    assert tt.get_table() == jt.get_table() and tt.get_stash() == jt.get_stash()


@pytest.mark.parametrize("kind,bound", [("MultipleChoiceHashTable", None),
                                        ("MultipleChoiceHashTable", 3),
                                        ("SimpleHashTable", None),
                                        ("SimpleHashTable", 4)])
def test_multiple_choice_and_simple_tables_equal_jax(kind, bound):
    jt, tt = _both(kind, 3, 17, max_bucket_size=bound)
    outcomes = []
    for table in (jt, tt):
        seen = []
        r = np.random.default_rng(RNG_SEED + 4)
        for x in _inputs(r, 30, 12):
            try:
                table.insert(x)
                seen.append(None)
            except RuntimeError as e:
                seen.append(str(e))
        outcomes.append(seen)
    assert outcomes[1] == outcomes[0]
    assert tt.get_table() == jt.get_table()


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", [
    "config_no_seed", "config_unspecified", "config_unknown", "negative_functions",
    "cuckoo_buckets", "cuckoo_functions", "cuckoo_relocations", "cuckoo_stash",
    "multiple_buckets", "multiple_functions", "multiple_bound",
    "simple_buckets", "simple_functions", "simple_bound",
])
def test_validation_errors_equal_jax(case):
    def build(lib):
        fn = lib.sha256_hash_function(b"v")
        return {
            "config_no_seed": lambda: lib.create_hash_family_from_config(
                lib.HashFamilyConfig(lib.HASH_FAMILY_SHA256, b"")),
            "config_unspecified": lambda: lib.create_hash_family_from_config(
                lib.HashFamilyConfig(lib.HASH_FAMILY_UNSPECIFIED, b"s")),
            "config_unknown": lambda: lib.create_hash_family_from_config(
                lib.HashFamilyConfig(9, b"s")),
            "negative_functions": lambda: lib.create_hash_functions(
                lib.SHA256HashFamily(), -1),
            "cuckoo_buckets": lambda: lib.CuckooHashTable([fn, fn], 0, 1),
            "cuckoo_functions": lambda: lib.CuckooHashTable([fn], 4, 1),
            "cuckoo_relocations": lambda: lib.CuckooHashTable([fn, fn], 4, -1),
            "cuckoo_stash": lambda: lib.CuckooHashTable([fn, fn], 4, 1, -1),
            "multiple_buckets": lambda: lib.MultipleChoiceHashTable([fn, fn], 0),
            "multiple_functions": lambda: lib.MultipleChoiceHashTable([fn], 4),
            "multiple_bound": lambda: lib.MultipleChoiceHashTable([fn, fn], 4, 0),
            "simple_buckets": lambda: lib.SimpleHashTable([fn], 0),
            "simple_functions": lambda: lib.SimpleHashTable([], 4),
            "simple_bound": lambda: lib.SimpleHashTable([fn], 4, 0),
        }[case]

    want = _error(build(jh))
    assert want is not None
    assert _error(build(th)) == want
