"""Carry state across from the JAX package, through plain numpy and bytes.

The port never touches a JAX object. A caller holding JAX-package keys
hands over their plain fields (Python ints, bools, lists of ints, numpy
arrays): staged dense-PIR key arrays (`keys_from_arrays`), or one DPF or
DCF key field by field, value corrections of incremental keys included,
of any value type (`dpf_key_from_fields`, `dcf_key_from_fields`), or a
MIC gate's key and public parameters (`mic_key_from_fields`,
`mic_parameters_from_fields`). Records are plain bytes, and a cuckoo-hashed
database crosses as its parameters' fields, its slot list and its records
(`cuckoo_database_from_fields`), so that the port serves the JAX
package's exact bucket layout.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .dcf import DcfKey
from .dpf import CorrectionWord, DpfKey
from .fss_gates import Interval, MicKey, MicParameters
from .hashing import HashFamilyConfig
from .ops.aes import limbs_to_u128
from .pir.cuckoo_database import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingParams,
    pack_buckets,
)
from .pir.database import DenseDpfPirDatabase


def keys_from_arrays(
    seeds0, control0, cw_seeds, cw_left, cw_right, last_vc, party: int
) -> List[DpfKey]:
    """The port's `DpfKey`s from staged key arrays: seeds0 uint32[nk, 4],
    control0 uint32[nk] (the party of each key), cw_seeds uint32[L, nk, 4],
    cw_left / cw_right uint32[L, nk], last_vc uint32[nk, 4]."""
    seeds0 = np.asarray(seeds0, dtype=np.uint32)
    control0 = np.asarray(control0, dtype=np.uint32)
    cw_seeds = np.asarray(cw_seeds, dtype=np.uint32)
    cw_left = np.asarray(cw_left, dtype=np.uint32)
    cw_right = np.asarray(cw_right, dtype=np.uint32)
    last_vc = np.asarray(last_vc, dtype=np.uint32)
    if party not in (0, 1):
        raise ValueError("party must be 0 or 1")
    if (control0 != party).any():
        raise ValueError(
            "control0 must equal the party for root-level staged keys"
        )
    nk = seeds0.shape[0]
    levels = cw_seeds.shape[0]
    keys = []
    for k in range(nk):
        cws = [
            CorrectionWord(
                seed=limbs_to_u128(cw_seeds[lvl, k]),
                control_left=bool(cw_left[lvl, k]),
                control_right=bool(cw_right[lvl, k]),
            )
            for lvl in range(levels)
        ]
        keys.append(
            DpfKey(
                seed=limbs_to_u128(seeds0[k]),
                party=party,
                correction_words=cws,
                last_level_value_correction=[limbs_to_u128(last_vc[k])],
            )
        )
    return keys


def _host_value(v):
    """A host value of any value type: an int, or a tuple of host values."""
    return tuple(_host_value(x) for x in v) if isinstance(v, tuple) else int(v)


def dpf_key_from_fields(seed, party, correction_words,
                        last_level_value_correction) -> DpfKey:
    """The port's `DpfKey` from a key's plain fields: `seed` and `party`
    ints; `correction_words` a sequence of (seed, control_left,
    control_right, value_correction) with value_correction None or a
    sequence of host values; `last_level_value_correction` a sequence of
    host values. A host value is an int (`IntType`, `XorType`,
    `IntModNType`) or a tuple of host values (`TupleType`)."""
    if party not in (0, 1):
        raise ValueError("party must be 0 or 1")
    cws = [
        CorrectionWord(
            seed=int(cw_seed),
            control_left=bool(left),
            control_right=bool(right),
            value_correction=None if vc is None else [_host_value(v) for v in vc],
        )
        for cw_seed, left, right, vc in correction_words
    ]
    return DpfKey(
        seed=int(seed), party=int(party), correction_words=cws,
        last_level_value_correction=[_host_value(v) for v in last_level_value_correction],
    )


def dcf_key_from_fields(seed, party, correction_words,
                        last_level_value_correction) -> DcfKey:
    """The port's `DcfKey` from the plain fields of its DPF key (as
    `dpf_key_from_fields`)."""
    return DcfKey(dpf_key_from_fields(seed, party, correction_words,
                                      last_level_value_correction))


def mic_key_from_fields(seed, party, correction_words, last_level_value_correction,
                        output_mask_share) -> MicKey:
    """The port's `MicKey` from a gate key's plain fields: its DCF key's
    DPF key fields (as `dpf_key_from_fields`) and the output mask shares,
    a sequence of ints."""
    return MicKey(
        dcf_key=dcf_key_from_fields(seed, party, correction_words,
                                    last_level_value_correction),
        output_mask_share=[int(v) for v in output_mask_share])


def mic_parameters_from_fields(log_group_size, intervals) -> MicParameters:
    """The port's `MicParameters` from the public parameters' plain fields:
    `log_group_size` and a sequence of (lower_bound, upper_bound) ints."""
    return MicParameters(int(log_group_size),
                         [Interval(int(lo), int(hi)) for lo, hi in intervals])


def database_from_records(
    records: Sequence[bytes], device=None
) -> DenseDpfPirDatabase:
    """The port's dense database holding `records` in order."""
    builder = DenseDpfPirDatabase.Builder()
    for r in records:
        builder.insert(r)
    return builder.build(device=device)


def cuckoo_database_from_fields(
    num_buckets: int, num_hash_functions: int, hash_family: int, seed: bytes,
    slots: Sequence, records: dict, device=None,
) -> CuckooHashedDpfPirDatabase:
    """The port's sparse database with a given bucket layout: the cuckoo
    parameters' fields, `slots` (bucket -> key bytes or None, as the JAX
    package's `CuckooHashedDpfPirDatabase.slots`) and `records` (key ->
    value bytes)."""
    params = CuckooHashingParams(
        num_buckets=int(num_buckets), num_hash_functions=int(num_hash_functions),
        hash_family_config=HashFamilyConfig(hash_family=int(hash_family),
                                            seed=bytes(seed)))
    keys = [bytes(k) for k in records]
    index = {k: i for i, k in enumerate(keys)}
    slot_index = np.array([-1 if k is None else index[bytes(k)] for k in slots],
                          dtype=np.int64)
    words, key_size, value_size = pack_buckets(
        slot_index, keys, [bytes(records[k]) for k in records])
    return CuckooHashedDpfPirDatabase(words, key_size, value_size, params=params,
                                      slots=slot_index, keys=keys, device=device)
