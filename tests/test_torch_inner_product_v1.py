"""The v1 inner product (K7), Mosaic's tiling repeat (K9) and K1's
accumulate entry: the port's plain versions against numpy and the JAX
package, bit for bit.

The JAX side runs its XLA twins only: `xor_inner_product_bitplane` (the
same f32 bit-plane count formulation as `_ip_kernel`, in jnp), the plain
`_tile_repeat` and `xor_inner_product_accumulate`. Every output is a count
or a packed word, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.ops.inner_product import (
    xor_inner_product_accumulate as j_accumulate,
)
from distributed_point_functions_tpu.ops.inner_product import (
    xor_inner_product_bitplane as j_bitplane,
)
from distributed_point_functions_tpu.ops.inner_product_pallas import _tile_repeat as j_tile
from distributed_point_functions_tpu.ops.inner_product_pallas import (
    stage_db_chunks_bitmajor as j_stage_chunks,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.ops.inner_product import (
    parity_pack,
    xor_counts_plain,
)
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor

NQ = 12  # not a multiple of 8
GROUPS = 128  # 4,096 records, one staged tile


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _numpy_counts(db_perm, packed):
    """counts[q, j, w] from a matmul of the unpacked bits, in numpy."""
    nq, g = packed.shape
    sel = (packed[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    bits = (db_perm[:, :, None, :] >> np.arange(32, dtype=np.uint32)[None, None, :, None]) & 1
    return (sel.reshape(nq, 32 * g).astype(np.int64)
            @ bits.reshape(32 * g, -1).astype(np.int64)).reshape(nq, 32, -1)


@pytest.mark.parametrize("words", [1, 8, 64])
def test_counts_and_v1_product_match_numpy_jax_and_v2(words):
    rng = np.random.default_rng(words)
    db_perm = _words(rng, (32, GROUPS, words))
    sel = _words(rng, (NQ, GROUPS // 4, 4))
    db_t, sel_t = to_tensor(db_perm, "cpu"), to_tensor(sel, "cpu")
    counts = ipk.xor_counts(db_t, sel_t.reshape(NQ, -1))
    assert counts.dtype == torch.int32 and counts.shape == (NQ, 32, words)
    assert np.array_equal(counts.numpy(), _numpy_counts(db_perm, sel.reshape(NQ, -1)))
    v1 = to_numpy(ipk.xor_inner_product_staged_v1(db_t, sel_t))
    assert np.array_equal(v1, np.asarray(j_bitplane(jnp.asarray(db_perm), jnp.asarray(sel))))
    assert np.array_equal(v1, to_numpy(ipk.xor_inner_product_staged(db_t, sel_t)))


def test_counts_span_several_chunks_and_parity_packs_bit_31():
    rng = np.random.default_rng(7)
    db_perm = _words(rng, (32, 40, 3))
    packed = _words(rng, (5, 40))
    got = xor_counts_plain(to_tensor(db_perm, "cpu"), to_tensor(packed, "cpu"), chunk_groups=16)
    assert np.array_equal(got.numpy(), _numpy_counts(db_perm, packed))
    counts = torch.zeros((1, 32, 1), dtype=torch.int32)
    counts[0, 31, 0] = 3
    counts[0, 0, 0] = 2
    assert parity_pack(counts).tolist() == [[-(1 << 31)]]


def test_v1_record_cap_raises_on_the_shape_alone():
    meta = dict(dtype=torch.int32, device="meta")
    too_many = torch.empty((32, ((1 << 24) + 4096) // 32, 1), **meta)
    with pytest.raises(ValueError, match="at most 16777216 records"):
        ipk.xor_inner_product_staged_v1(too_many, torch.empty((8, 4, 4), **meta))
    at_cap = torch.empty((32, (1 << 24) // 32, 1), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ipk.xor_inner_product_staged_v1(at_cap, torch.empty((8, 4, 4), **meta))


@pytest.mark.parametrize("rows,n,factor", [(1, 2, 2), (3, 5, 7), (256, 128, 32)])
def test_repeat_tiles_plain_matches_jax_and_numpy(rows, n, factor):
    x = _words(np.random.default_rng(rows), (rows, n))
    got = to_numpy(ipk.repeat_tiles(to_tensor(x, "cpu"), factor))
    assert np.array_equal(got, np.tile(x, (1, factor)))
    assert np.array_equal(got, np.asarray(j_tile(jnp.asarray(x), factor, axis=1)))


def test_interpret_repeat_tiles_probe_on_cpu():
    cuda_lib.reset_launch_counts()
    assert ipk.interpret_repeat_tiles("cpu") is True
    assert not any(cuda_lib.LAUNCHES.values())
    with pytest.raises(ValueError):
        ipk.repeat_tiles(torch.zeros((1, 2), dtype=torch.int32), 0)


def test_accumulate_halves_equal_one_call_and_jax():
    rng = np.random.default_rng(11)
    rows = _words(rng, (2 * 4096, 8))
    sel = _words(rng, (NQ, 64, 4))
    acc0 = _words(rng, (NQ, 8))
    staged = ipk.permute_db_bitmajor(to_tensor(rows, "cpu"))  # [32, 256, 8]
    sel_t = to_tensor(sel, "cpu")
    acc = to_tensor(acc0, "cpu").clone()  # updated in place
    # Two group spans of one staging (strided views), one after the other.
    for h in (0, 1):
        span = staged[:, 128 * h:128 * (h + 1)]
        got = ipk.xor_inner_product_accumulate(acc, span, sel_t[:, 32 * h:32 * (h + 1)])
        assert got is acc
    full = ipk.xor_inner_product_staged(staged, sel_t)
    assert torch.equal(acc, to_tensor(acc0, "cpu") ^ full)
    # The JAX package's entry on the row-major spans.
    want = jnp.asarray(acc0)
    for h in (0, 1):
        want = j_accumulate(want, jnp.asarray(rows[4096 * h:4096 * (h + 1)]),
                            jnp.asarray(sel[:, 32 * h:32 * (h + 1)]))
    assert np.array_equal(to_numpy(acc), np.asarray(want))
    with pytest.raises(ValueError):
        ipk.xor_inner_product_accumulate(torch.zeros((NQ + 1, 8), dtype=torch.int32),
                                         staged, sel_t)


def test_stage_db_chunks_bitmajor_matches_jax():
    rows = _words(np.random.default_rng(5), (4 * 384, 3))  # chunks of 384 records
    got = to_numpy(ipk.stage_db_chunks_bitmajor(to_tensor(rows, "cpu"), 4))
    want = np.asarray(j_stage_chunks(jnp.asarray(rows), 4))
    assert got.shape == want.shape == (4, 32, 128, 3)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        ipk.stage_db_chunks_bitmajor(to_tensor(rows, "cpu"), 5)
