"""Private heavy hitters on the card, against the plain versions.

Marked `cuda`; each test skips without a CUDA device. A 16-bit config of
96 clients (four hot values and a uniform tail): the card's
`evaluate_prefixes_batch` values and cut states equal `device="cpu"`'s
from the root and resumed; the card's aggregator gives the CPU's shares
at every level, unchunked and chunked, with one K8 walk and one K3 hash
a chunk (none other), counted on the aggregator's own stream; and two
parties, each on its own stream, sweep as Leader and Helper to the
oracle's heavy hitters. This file imports no JAX, so on a machine with a
card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_hh.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch import heavy_hitters as hh
from distributed_point_functions_tpu_torch.capacity.model import padded_keys
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.serving.transport import InProcessTransport

pytestmark = pytest.mark.cuda

CONFIG = hh.HeavyHittersConfig(domain_bits=16, level_bits=4, threshold=6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def population():
    rng = np.random.default_rng(96)
    values = [0x1234, 0x5678, 0x9ABC, 0xDEF0] * 8 + [
        int(v) for v in rng.integers(0, 1 << 16, 64)]
    client = hh.HeavyHittersClient(CONFIG, device="cpu")
    pairs = [client.generate_report(v) for v in values]
    return values, [[p[party] for p in pairs] for party in (0, 1)]


def _frontiers(values):
    out, front = [], list(range(16))
    for w in CONFIG.level_bit_widths():
        out.append(front)
        counts = {}
        for v in values:
            counts[v >> (16 - w)] = counts.get(v >> (16 - w), 0) + 1
        front = [(p << 4) | c for p in front if counts.get(p, 0) >= CONFIG.threshold
                 for c in range(16)]
    return out


def test_evaluate_prefixes_batch_card_equals_cpu(dev, population):
    values, keys = population
    card, cpu = CONFIG.make_dpf(dev), CONFIG.make_dpf("cpu")
    for party in (0, 1):
        staged = card.stage_key_batch(keys[party])
        staged_cpu = cpu.stage_key_batch(keys[party])
        cut = cut_cpu = None
        for level, frontier in enumerate(_frontiers(values)):
            got, cut = card.evaluate_prefixes_batch(staged, level, frontier, cuts=cut)
            want, cut_cpu = cpu.evaluate_prefixes_batch(staged_cpu, level, frontier,
                                                        cuts=cut_cpu)
            assert torch.equal(got.cpu(), want), (party, level)
            assert torch.equal(cut.state.cpu(), cut_cpu.state)
            assert torch.equal(cut.ctrl.cpu(), cut_cpu.ctrl)
            root, _ = card.evaluate_prefixes_batch(staged, level, frontier)
            assert torch.equal(root.cpu(), want)


def test_aggregator_card_equals_cpu_and_counts_its_launches(dev, population):
    values, keys = population
    kpad = padded_keys(len(values))
    for budget in (None, kpad * 8 * hh.lane_bytes(4, 1)):
        cuda_lib.reset_launch_counts()
        card = hh.LevelAggregator(CONFIG.make_dpf(dev), keys[1], budget_bytes=budget)
        cpu = hh.LevelAggregator(CONFIG.make_dpf("cpu"), keys[1], budget_bytes=budget)
        for level, frontier in enumerate(_frontiers(values)):
            before = card.launches
            got = card.evaluate_level(level, frontier)
            assert np.array_equal(got, cpu.evaluate_level(level, frontier)), level
            chunks = card.plans[-1].num_chunks
            assert chunks == (1 if budget is None else -(-len(frontier) // 8))
            after = card.launches
            assert {k: after.get(k, 0) - before.get(k, 0) for k in after} == {
                "path_level": chunks, "value_hash": chunks}
        torch.cuda.synchronize()
        assert dict(cuda_lib.LAUNCHES) == {**{k: 0 for k in cuda_lib.LAUNCHES},
                                           **card.launches}


def test_two_parties_on_two_streams_give_the_oracle(dev, population):
    values, keys = population
    servers = [hh.HeavyHittersServer(CONFIG, k, device=dev) for k in keys]
    streams = [s.aggregator._stream for s in servers]
    assert all(isinstance(s, torch.cuda.Stream) for s in streams)
    assert streams[0] != streams[1]
    helper = hh.HeavyHittersHelper(servers[1])
    leader = hh.HeavyHittersLeader(servers[0], InProcessTransport(helper.handle_wire))
    result = leader.run()
    assert result.as_dict() == hh.plaintext_heavy_hitters(values, CONFIG)
    want = {"path_level": len(result.rounds), "value_hash": len(result.rounds)}
    assert servers[0].launches == servers[1].launches == want
