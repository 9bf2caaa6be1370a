"""The Leader/Helper deployment on the card, against the plain versions.

Marked `cuda`; each test skips without a CUDA device. A Leader and a
Helper `DenseDpfPirServer` on the card serve the port's client through an
in-process sender at a small size; every record must come back through
`handle_response`, the round trip must launch the walk path's kernels for
both parties, and the Helper's masked bytes must equal the CPU plain
server's share XOR the one-time pad. This file imports no JAX, so on a
machine with a card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_two_party.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch import prng
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
    messages,
)
from distributed_point_functions_tpu_torch.pir.client import ENCRYPTION_CONTEXT_INFO
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("num_records,record_bytes", [(1 << 12, 32), (3000, 33)])
def test_leader_helper_round_trip_on_the_card(dev, num_records, record_bytes):
    rng = np.random.default_rng(num_records)
    records = [rng.bytes(record_bytes) for _ in range(num_records)]
    helper = DenseDpfPirServer.create_helper(
        DenseDpfPirDatabase(records), encrypt_decrypt.decrypt, device=dev)
    seen = []

    def sender(helper_request, while_waiting):
        while_waiting()
        seen.append(helper.handle_request(helper_request))
        return seen[-1]

    leader = DenseDpfPirServer.create_leader(DenseDpfPirDatabase(records), sender, device=dev)
    client = DenseDpfPirClient.create(num_records, encrypt_decrypt.encrypt)
    idx = [int(i) for i in rng.integers(0, num_records, 40)]
    request, state = client.create_request(idx)
    cuda_lib.reset_launch_counts()
    response = leader.handle_request(request)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["xor_inner_product"] == 2
    assert cuda_lib.LAUNCHES["leaf_blocks"] == 2
    assert cuda_lib.LAUNCHES["walk_descend"] >= 2
    assert client.handle_response(response, state) == [records[i] for i in idx]

    inner = messages.parse_helper_request(client.dpf, encrypt_decrypt.decrypt(
        request.leader_request.encrypted_helper_request.encrypted_request,
        ENCRYPTION_CONTEXT_INFO))
    cpu = DenseDpfPirServer.create_plain(DenseDpfPirDatabase(records, device="cpu"),
                                         device="cpu")
    share = cpu.handle_plain_request(messages.PirRequest(
        plain_request=inner.plain_request)).dpf_pir_response.masked_response
    pad = prng.Aes128CtrSeededPrng(inner.one_time_pad_seed)
    assert seen[-1].dpf_pir_response.masked_response == [
        prng.xor_bytes(s, pad.get_random_bytes(len(s))) for s in share]
