"""The count product's edge cases (K1, its accumulate entry and K7),
held against the plain versions bit for bit.

One list of cases for the card's tests (`tests/test_torch_inner_product_tc.py`)
and for `chip_smoke.py`'s `count_product_edges` phase. The shapes are
ragged on every axis the kernel tiles (queries per 128-row tile, record
groups per 32-group stage, words per 8-word tile); the extremes check the
top of the count range and the bit packing of value bits 0 and 31 at the
first and the last record; two strided group spans check the accumulate
entry's bit-row stride. Each check raises `AssertionError` on a
difference. `launched(name, fn)` wraps every kernel call: it returns
`fn()`, and a test uses it to check that the call launched once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.ops.inner_product import xor_counts_plain
from distributed_point_functions_tpu_torch.ops.words import to_tensor

Launched = Callable[[str, Callable[[], torch.Tensor]], torch.Tensor]

# (queries, record groups, words): every nq in {1, 5, 12, 33, 136, 1,024},
# G in {1, 7, 136, 200, 4,096} and W in {1, 5, 8, 33, 64} at least twice.
EDGE_SHAPES = [
    (1, 1, 1), (1, 4096, 64), (5, 7, 5), (5, 200, 33), (12, 136, 8),
    (12, 1, 64), (33, 200, 1), (33, 7, 8), (136, 4096, 5), (136, 136, 33),
    (1024, 7, 64), (1024, 200, 1), (1024, 4096, 8),
]
# (queries, record groups, words) of the all-ones and all-zeros cases.
EXTREME_SHAPES = [(136, 200, 33), (5, 4096, 8)]


def _call(name: str, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    return fn()


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"count product: {what}")


def random_words(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


def check_all(db: torch.Tensor, packed: torch.Tensor,
              launched: Launched = _call) -> tuple[torch.Tensor, torch.Tensor]:
    """K1, K7 and the accumulate entry on (db [32, G, W], packed [nq, G])
    against the plain versions; returns (K1's words, K7's counts)."""
    nq, groups = packed.shape
    what = f"at {nq} x {groups} x {db.shape[2]}"
    want_xor = ipk.xor_inner_product_packed_plain(db, packed)
    got_xor = launched("xor_inner_product", lambda: ipk.xor_inner_product_packed(db, packed))
    _require(torch.equal(got_xor, want_xor), f"xor_inner_product differs {what}")
    got_counts = launched("xor_counts", lambda: ipk.xor_counts(db, packed))
    _require(torch.equal(got_counts, xor_counts_plain(db, packed)),
             f"xor_counts differs {what}")
    # The accumulate entry takes whole selection blocks of 4 words; the
    # words past the span's groups are dropped.
    blocks = F.pad(packed, (0, (-groups) % 4)).reshape(nq, -1, 4)
    acc0 = random_words(np.random.default_rng(nq + groups), (nq, db.shape[2]), db.device)
    acc = acc0.clone()
    launched("xor_inner_product", lambda: ipk.xor_inner_product_accumulate(acc, db, blocks))
    _require(torch.equal(acc, acc0 ^ want_xor), f"xor_inner_product_accumulate differs {what}")
    return got_xor, got_counts


def check_shape(nq: int, groups: int, words: int, device,
                launched: Launched = _call) -> None:
    """Random operands of one ragged shape."""
    rng = np.random.default_rng(nq * 7919 + groups * 31 + words)
    check_all(random_words(rng, (32, groups, words), device),
              random_words(rng, (nq, groups), device), launched)


def check_extremes(nq: int, groups: int, words: int, device,
                   launched: Launched = _call) -> None:
    """All ones (counts of 32G, parity 32G mod 2 = 0), no selection and a
    zero database (nothing counted)."""
    ones = torch.full((32, groups, words), -1, dtype=torch.int32, device=device)
    sel = torch.full((nq, groups), -1, dtype=torch.int32, device=device)
    xor, counts = check_all(ones, sel, launched)
    _require(bool((counts == 32 * groups).all()), "all ones do not count 32G")
    _require(not xor.any(), "all ones give a parity")
    for db, packed in ((ones, torch.zeros_like(sel)), (torch.zeros_like(ones), sel)):
        xor, counts = check_all(db, packed, launched)
        _require(not counts.any() and not xor.any(), "a zero operand counts")


def check_single_bit(bit: int, last: bool, device, launched: Launched = _call) -> None:
    """One set bit at value bit `bit` of the first or the last record, in
    the first and in the last word, selected by the odd queries; beside it
    a distinct pattern in value bit 31 - bit of another word, whose record
    no query selects."""
    nq, groups, words = 33, 200, 9
    record = 32 * groups - 1 if last else 0
    b, g = record % 32, record // 32
    for w in (0, words - 1):
        db = torch.zeros((32, groups, words), dtype=torch.int32, device=device)
        db[b, g, w] = (1 << bit) if bit < 31 else -(1 << 31)
        sel = torch.zeros((nq, groups), dtype=torch.int32, device=device)
        sel[1::2, g] = (1 << b) if b < 31 else -(1 << 31)
        db[(b + 1) % 32, g, (w + 1) % words] = 1 << (31 - bit) if bit else -(1 << 31)
        xor, counts = check_all(db, sel, launched)
        want = torch.zeros((nq, 32, words), dtype=torch.int32, device=device)
        want[1::2, bit, w] = 1
        what = f"bit {bit} of record {record}, word {w}"
        _require(torch.equal(counts, want), f"{what} miscounted")
        _require(torch.equal(xor.ne(0), want.sum(1).ne(0)), f"{what} in the wrong word")
        _require(int(xor[1, w]) == int(db[b, g, w]), f"{what} packed wrong")


def check_strided_spans(device, launched: Launched = _call) -> None:
    """Two group spans of one staging (bit rows G W words apart) XORed
    into a non-zero result equal it XORed with one call over both."""
    rng = np.random.default_rng(5)
    nq, groups, words = 136, 400, 33
    db = random_words(rng, (32, groups, words), device)
    sel = random_words(rng, (nq, groups // 4, 4), device)
    acc0 = random_words(rng, (nq, words), device)
    acc = acc0.clone()
    for lo, hi in ((0, 136), (136, groups)):
        span = db[:, lo:hi]
        _require(not span.is_contiguous(), "a span is contiguous")
        launched("xor_inner_product", lambda: ipk.xor_inner_product_accumulate(
            acc, span, sel[:, lo // 4:hi // 4]))
    one_call = launched("xor_inner_product", lambda: ipk.xor_inner_product_staged(db, sel))
    _require(torch.equal(acc, acc0 ^ one_call), "strided spans differ from one call")
    _require(torch.equal(acc.cpu(), acc0.cpu() ^ ipk.xor_inner_product_staged(db.cpu(),
                                                                              sel.cpu())),
             "strided spans differ from the plain version")
