"""The port's private heavy hitters against the JAX package, on the CPU.

Keys are made by the port's client (native host AES) and carried across
as JAX `DpfKey`s field by field, so both packages evaluate the same keys.
Two populations of 64 clients: the JAX test's 8-bit config with its
values eight times over, and a 16-bit config of four hot values and a
uniform tail. Every JAX evaluation in this file runs at one of two
shapes (64 keys x 16 prefixes from the root, 64 keys x 64 padded
prefixes resumed over 4 tree levels), so XLA compiles two programs; the
JAX references take the XLA path.
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import heavy_hitters as jhh
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu.capacity import model as jmodel
from distributed_point_functions_tpu.observability import costmodel as jcost
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import heavy_hitters as thh
from distributed_point_functions_tpu_torch.capacity import model as tcapacity
from distributed_point_functions_tpu_torch.capacity.model import CapacityModel, padded_keys
from distributed_point_functions_tpu_torch.observability import costmodel as tcost
from distributed_point_functions_tpu_torch.ops import aes
from distributed_point_functions_tpu_torch.ops.words import to_numpy
from distributed_point_functions_tpu_torch.serving.transport import InProcessTransport
from distributed_point_functions_tpu_torch.value_types import IntType

CONFIG8 = dict(domain_bits=8, level_bits=4, threshold=2)
VALUES8 = [3, 3, 3, 77, 77, 9, 9, 200] * 8
CONFIG16 = dict(domain_bits=16, level_bits=4, threshold=8)


def _values16():
    rng = np.random.default_rng(16)
    hot = [0x1234, 0x5678, 0x9ABC, 0xDEF0]
    values = hot * 8 + [int(v) for v in rng.integers(0, 1 << 16, 32)]
    return [values[i] for i in rng.permutation(len(values))]


def _widths(values, config):
    """The plaintext sweep's frontier widths."""
    widths, front = [], list(range(16))
    for w in range(4, config["domain_bits"] + 1, 4):
        cnt = collections.Counter(v >> (config["domain_bits"] - w) for v in values)
        widths.append(len(front))
        front = [(p << 4) | c for p in front if cnt[p] >= config["threshold"]
                 for c in range(16)]
    return widths


def _jkey(k):
    return jdpf.DpfKey(
        seed=k.seed, party=k.party,
        correction_words=[jdpf.CorrectionWord(cw.seed, cw.control_left, cw.control_right,
                                              cw.value_correction)
                          for cw in k.correction_words],
        last_level_value_correction=list(k.last_level_value_correction))


@dataclasses.dataclass
class Population:
    name: str
    values: list
    tconfig: thh.HeavyHittersConfig
    jconfig: jhh.HeavyHittersConfig
    tkeys: list  # per party
    jkeys: list


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of ops on tensors of a few KiB,
    where intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _population(name):
    fields, values = ((CONFIG8, VALUES8) if name == "config8" else (CONFIG16, _values16()))
    # Every resumed frontier pads to 64 prefixes: the two JAX shapes.
    assert all(16 < w <= 64 for w in _widths(values, fields)[1:])
    tconfig = thh.HeavyHittersConfig(**fields)
    client = thh.HeavyHittersClient(tconfig, device="cpu")
    pairs = [client.generate_report(v) for v in values]
    tkeys = [[p[party] for p in pairs] for party in (0, 1)]
    return Population(name, values, tconfig, jhh.HeavyHittersConfig(**fields),
                      tkeys, [[_jkey(k) for k in ks] for ks in tkeys])


@pytest.fixture(scope="module", params=["config8", "config16"])
def pop(request):
    return _population(request.param)


def _sweep_frontiers(pop):
    """The frontiers of each round of the sweep (from the oracle)."""
    values, bits = pop.values, pop.tconfig.domain_bits
    out, front = [], list(range(16))
    for r, w in enumerate(pop.tconfig.level_bit_widths()):
        out.append(front)
        cnt = collections.Counter(v >> (bits - w) for v in values)
        front = [(p << 4) | c for p in front if cnt[p] >= pop.tconfig.threshold
                 for c in range(16)]
    return out


# -- key generation -----------------------------------------------------------


def test_generate_keys_batch_single_level_incremental(monkeypatch):
    """A one-level IntType(32) DPF: the native batch covers only the
    dense-PIR shape (it raises here, as the whole batch did before), and
    `generate_keys_batch` makes the pairs of `generate_keys_incremental`:
    they reconstruct beta at alpha and 0 elsewhere, and with the root
    seeds injected equal the JAX package's keys."""
    params = tdpf.DpfParameters(10, IntType(32))
    dpf = tdpf.DistributedPointFunction.create(params, device="cpu")
    rng = np.random.default_rng(7)
    alphas = [5, 1023, 0, 640]
    betas = [int(b) for b in rng.integers(1, 1 << 32, len(alphas), dtype=np.uint64)]
    roots = rng.integers(0, 1 << 32, (2, len(alphas), 4), dtype=np.uint32)
    with pytest.raises(NotImplementedError):
        dpf._generate_keys_batch_plain(alphas, betas, _root_seeds=roots)
    keys0, keys1 = dpf.generate_keys_batch(alphas, betas, _root_seeds=roots)
    for k0, k1, a, b in zip(keys0, keys1, alphas, betas):
        shares = [to_numpy(dpf.evaluate_until(0, [], dpf.create_evaluation_context(k)))
                  for k in (k0, k1)]
        total = (shares[0][:, 0].astype(np.uint64) + shares[1][:, 0]) & 0xFFFFFFFF
        want = np.zeros(1 << 10, dtype=np.uint64)
        want[a] = b
        assert np.array_equal(total, want)
    seeds = iter([aes.limbs_to_u128(roots[party, i])
                  for i in range(len(alphas)) for party in (0, 1)])
    monkeypatch.setattr(jdpf.secrets, "randbits", lambda bits: next(seeds))
    jd = jdpf.DistributedPointFunction.create(jdpf.DpfParameters(10, jvt.IntType(32)))
    for i, (a, b) in enumerate(zip(alphas, betas)):
        j0, j1 = jd.generate_keys_incremental(a, [b])
        assert dataclasses.asdict(_jkey(keys0[i])) == dataclasses.asdict(j0)
        assert dataclasses.asdict(_jkey(keys1[i])) == dataclasses.asdict(j1)
    monkeypatch.undo()
    # Random roots take the same path.
    r0, r1 = dpf.generate_keys_batch([7, 8], [1, 2])
    assert len(r0) == len(r1) == 2 and r0[0].party == 0 and r1[1].party == 1


def test_host_aes_native_matches_numpy(monkeypatch):
    """Key generation's AES on the native library equals the numpy plain
    version, block by block and in whole keys; the port's client makes
    the JAX client's reports from the same root seeds."""
    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(16), "little") for _ in range(37)]
    for which in (0, 1, 2):
        assert tdpf._mmo_host(which, xs) == tdpf._mmo_host_plain(which, xs)
    config = thh.HeavyHittersConfig(domain_bits=16, level_bits=4)
    dpf = config.make_dpf("cpu")
    roots = (int.from_bytes(rng.bytes(16), "little"), int.from_bytes(rng.bytes(16), "little"))
    native = dpf.generate_keys_incremental(0xBEEF, [1] * 4, _root_seeds=roots)
    monkeypatch.setattr(tdpf, "_mmo_host", tdpf._mmo_host_plain)
    plain = dpf.generate_keys_incremental(0xBEEF, [1] * 4, _root_seeds=roots)
    assert [dataclasses.asdict(k) for k in native] == [dataclasses.asdict(k) for k in plain]
    monkeypatch.undo()
    it = iter(roots)
    monkeypatch.setattr(tdpf.secrets, "randbits", lambda bits: next(it))
    ours = thh.HeavyHittersClient(config, device="cpu").generate_report(0xBEEF)
    it = iter(roots)
    monkeypatch.setattr(jdpf.secrets, "randbits", lambda bits: next(it))
    theirs = jhh.HeavyHittersClient(jhh.HeavyHittersConfig(domain_bits=16)).generate_report(
        0xBEEF)
    assert [dataclasses.asdict(_jkey(k)) for k in ours] == [
        dataclasses.asdict(k) for k in theirs]


# -- evaluation ---------------------------------------------------------------


def test_evaluate_prefixes_batch_matches_jax(pop):
    """Values and cut states from the root and resumed level by level,
    both parties, equal the JAX package's bit for bit; a level evaluated
    from the root equals the same level resumed."""
    tdpf_ = pop.tconfig.make_dpf("cpu")
    jdpf_ = pop.jconfig.make_dpf()
    frontiers = _sweep_frontiers(pop)
    for party in (0, 1):
        ts = tdpf_.stage_key_batch(pop.tkeys[party])
        js = jdpf_.stage_key_batch(pop.jkeys[party])
        tcut = jcut = None
        for level, frontier in enumerate(frontiers):
            tv, tcut = tdpf_.evaluate_prefixes_batch(ts, level, frontier, cuts=tcut)
            jv, jcut = jdpf_.evaluate_prefixes_batch(js, level, frontier, cuts=jcut)
            assert np.array_equal(to_numpy(tv.contiguous()), np.asarray(jv)), level
            assert np.array_equal(to_numpy(tcut.seeds.contiguous()), np.asarray(jcut.seeds))
            assert np.array_equal(to_numpy(tcut.control.contiguous()),
                                  np.asarray(jcut.control))
            assert np.array_equal(tcut.prefixes, jcut.prefixes)
            if level == 1:
                root, _ = tdpf_.evaluate_prefixes_batch(ts, level, frontier)
                assert torch.equal(root, tv)


def test_evaluate_prefixes_batch_validates():
    dpf = thh.HeavyHittersConfig(domain_bits=8).make_dpf("cpu")
    client = thh.HeavyHittersClient(thh.HeavyHittersConfig(domain_bits=8), device="cpu")
    staged = dpf.stage_key_batch([client.generate_report(v)[0] for v in (1, 2)])
    with pytest.raises(ValueError, match="empty"):
        dpf.evaluate_prefixes_batch(staged, 0, [])
    with pytest.raises(ValueError, match="ascending"):
        dpf.evaluate_prefixes_batch(staged, 0, [3, 3])
    with pytest.raises(ValueError, match="out of range"):
        dpf.evaluate_prefixes_batch(staged, 0, [16])
    _, cut = dpf.evaluate_prefixes_batch(staged, 0, [1, 2])
    with pytest.raises(ValueError, match="not present"):
        dpf.evaluate_prefixes_batch(staged, 1, [0x30], cuts=cut)
    with pytest.raises(ValueError, match="precede"):
        dpf.evaluate_prefixes_batch(staged, 0, [1], cuts=cut)


def test_level_aggregator_matches_jax_chunked_and_unchunked(pop):
    """Each level's shares of the JAX aggregator equal the port's, both
    parties; party 0's also chunked at 16 prefixes a chunk, whose cut
    states equal the unchunked ones."""
    kpad = padded_keys(len(pop.values))
    for party in (0, 1):
        jagg = jhh.LevelAggregator(pop.jconfig.make_dpf(), pop.jkeys[party])
        tdpf_ = pop.tconfig.make_dpf("cpu")
        aggs = [thh.LevelAggregator(tdpf_, pop.tkeys[party])]
        if party == 0:
            aggs.append(thh.LevelAggregator(tdpf_, pop.tkeys[party],
                                            budget_bytes=kpad * 16 * thh.lane_bytes(4, 1)))
        for level, frontier in enumerate(_sweep_frontiers(pop)):
            want = jagg.evaluate_level(level, frontier)
            for agg in aggs:
                got = agg.evaluate_level(level, frontier)
                assert got.dtype == np.uint32 and np.array_equal(got, want), level
            assert [a.plans[-1].num_chunks for a in aggs] == [
                1, -(-len(frontier) // 16)][:len(aggs)]
            for agg in aggs[1:]:
                assert torch.equal(agg.cuts.state, aggs[0].cuts.state)
                assert torch.equal(agg.cuts.ctrl, aggs[0].cuts.ctrl)
        assert aggs[0].launches == {}  # plain versions: no kernel launch


def test_plan_hh_level_follows_the_jax_logic():
    """The port's plan is the JAX model's rule on the port's lane bytes
    (keys padded to 32 lanes)."""

    class Ported(jmodel.CapacityModel):
        def hh_lane_bytes(self, walk_levels, value_blocks):
            return CapacityModel().hh_lane_bytes(walk_levels, value_blocks)

    jm = Ported()
    tm = CapacityModel(frontier_budget=1 << 30)
    assert tm.frontier_budget_bytes() == 1 << 30
    assert CapacityModel().frontier_budget_bytes() == 1 << 28  # the CPU's default
    for keys in (1, 64, 100, 65536):
        for prefixes in (1, 16, 48, 4096):
            for walk, blocks in ((2, 1), (4, 1), (62, 1), (4, 3)):
                for budget in (1, 1 << 20, 1 << 30):
                    got = tm.plan_hh_level(keys, prefixes, walk, blocks, budget)
                    want = jm.plan_hh_level(padded_keys(keys), prefixes, walk, blocks, budget)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    plan = thh.plan_level(65536, 4096, 4, 1, budget_bytes=(80 << 30) // 64)
    assert (plan.chunk_prefixes, plan.num_chunks, plan.lane_bytes) == (128, 32, 89)


def test_run_protocol_matches_jax_and_oracle(pop):
    """The port's in-process sweep gives the JAX sweep's heavy hitters
    and round stats, equal to the plaintext oracle; a snapshot of the
    sweep restores to the same state in either package."""
    servers = [thh.HeavyHittersServer(pop.tconfig, k, device="cpu") for k in pop.tkeys]
    ours = thh.run_protocol(*servers)
    theirs = jhh.run_protocol(*[jhh.HeavyHittersServer(pop.jconfig, k) for k in pop.jkeys])
    oracle = thh.plaintext_heavy_hitters(pop.values, pop.tconfig)
    assert ours.as_dict() == theirs.as_dict() == oracle
    assert oracle == jhh.plaintext_heavy_hitters(pop.values, pop.jconfig)
    assert [dataclasses.asdict(r) for r in ours.rounds] == [
        dataclasses.asdict(r) for r in theirs.rounds]
    assert thh.config_fingerprint(pop.tconfig) == jhh.config_fingerprint(pop.jconfig)
    sweep = thh.FrontierSweep(pop.tconfig)
    jsweep = jhh.FrontierSweep(pop.jconfig)
    counts = np.zeros(16, dtype=np.uint64)
    counts[[0, 5]] = 99
    sweep.observe_counts(counts)
    jsweep.observe_counts(counts)
    assert sweep.snapshot() == jsweep.snapshot()
    restored = thh.FrontierSweep.restore(pop.tconfig, jsweep.snapshot())
    assert restored.snapshot() == sweep.snapshot()
    with pytest.raises(thh.ProtocolError, match="does not match"):
        thh.FrontierSweep.restore(thh.HeavyHittersConfig(domain_bits=12), sweep.snapshot())


def test_leader_against_a_jax_helper():
    """The port's Leader sweeps with the JAX package's Helper over the
    wire (each party's share from its own package) to the oracle's
    heavy hitters."""
    pop = _population("config8")
    server = thh.HeavyHittersServer(pop.tconfig, pop.tkeys[0], device="cpu")
    helper = jhh.HeavyHittersHelper(jhh.HeavyHittersServer(pop.jconfig, pop.jkeys[1]))
    leader = thh.HeavyHittersLeader(server, InProcessTransport(helper.handle_wire))
    result = leader.run()
    assert result.as_dict() == thh.plaintext_heavy_hitters(pop.values, pop.tconfig)
    assert leader.wire_version == 4 and leader.helper_epoch == helper.epoch


def test_cost_ledger_matches_jax():
    """The same observations give the JAX ledger's export, drift windows
    and drift events included; the aggregator feeds the process ledger a
    sample a level."""
    ours = tcost.CostLedger(window_size=4, drift_band=0.2, drift_windows=2)
    theirs = jcost.CostLedger(window_size=4, drift_band=0.2, drift_windows=2)
    rng = np.random.default_rng(5)
    for i in range(40):
        tier = ("root", "resume")[i % 2]
        bucket = tcost.shape_bucket(int(rng.integers(1, 1 << 20)))
        assert bucket == jcost.shape_bucket(int(bucket))
        pred = float(rng.uniform(1, 10))
        actual = pred * (1.5 if i > 20 else float(rng.uniform(0.9, 1.1)))
        args = ("hh", tier, "1024", pred, actual, 100, int(rng.integers(50, 150)))
        assert ours.observe(*args) == theirs.observe(*args)
    assert ours.observe("hh", "root", "1", 0.0, 1.0) is None
    theirs.observe("hh", "root", "1", 0.0, 1.0)
    assert ours.export() == theirs.export()
    assert ours.drifting_cells() == theirs.drifting_cells() != []
    assert tcost.drift_objective().metric == jcost.drift_objective().metric

    ledger = tcost.CostLedger()
    previous = tcost.set_default_cost_ledger(ledger)
    try:
        config = thh.HeavyHittersConfig(domain_bits=8)
        client = thh.HeavyHittersClient(config, device="cpu")
        server = thh.HeavyHittersServer(
            config, [client.generate_report(v)[0] for v in (1, 2, 3)], device="cpu")
        server.evaluate_round(0, list(range(16)))
        server.evaluate_round(1, [0x10, 0x11])
    finally:
        tcost.set_default_cost_ledger(previous)
    cells = ledger.export()["cells"]
    # Cells are "workload/tier/bucket"; buckets count unpadded lanes.
    assert sorted(tuple(k.split("/")) for k in cells) == [("hh", "resume", "8"),
                                                          ("hh", "root", "64")]
    assert all(c["samples"] == 1 for c in cells.values())


def test_calibration_prices_hh_levels_from_a_history_file(tmp_path):
    """The newest clean record of a metric wins, as in the JAX package's
    calibration; without one a level is priced at the card's measured
    rate."""
    path = tmp_path / "history.jsonl"
    path.write_text("\n".join([
        '{"metric": "heavy_hitters_sweep_lanes_per_sec", "value": 2e8, "status": "ok"}',
        '{"metric": "heavy_hitters_sweep_lanes_per_sec", "value": 5e8, "status": "ok"}',
        '{"metric": "heavy_hitters_sweep_lanes_per_sec", "value": 9e9, "status": "infra_error"}',
        'not json', '[1, 2]', '',
        '{"metric": "serving_closed_loop_queries_per_sec", "value": -1, "status": "ok"}',
    ]) + "\n")
    ours = tcapacity.ThroughputCalibration(str(path))
    theirs = jmodel.ThroughputCalibration(history_path=str(path))
    for metric in ("heavy_hitters_sweep_lanes_per_sec", "serving_closed_loop_queries_per_sec",
                   "absent"):
        assert ours.lookup(metric) == theirs.lookup(metric)
    model = CapacityModel(calibration=ours)
    price = model.price_hh_level(65536, 4096, 4, 1)
    assert (price.quantity, price.unit) == (65536 * 4096, "hh_lanes")
    assert price.device_ms == pytest.approx(65536 * 4096 * 1e3 / 5e8)
    assert price.bytes_peak == model.plan_hh_level(65536, 4096, 4, 1).bytes_peak
    fallback = CapacityModel().price_hh_level(64, 16, 2, 1)
    assert fallback.device_ms == pytest.approx(64 * 16 * 1e3 / tcapacity.HH_LANES_PER_SEC_FALLBACK)


def test_drift_objective_grades_the_ledger(tmp_path):
    """A drifting cost ledger breaches its SLO objective in the port's
    tracker as in the JAX package's."""
    from distributed_point_functions_tpu.observability import slo as jslo
    from distributed_point_functions_tpu.serving.metrics import MetricsRegistry as JRegistry
    from distributed_point_functions_tpu_torch.observability import slo as tslo
    from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry

    verdicts = []
    for ledger_mod, slo_mod, registry in ((tcost, tslo, MetricsRegistry()),
                                          (jcost, jslo, JRegistry())):
        ledger = ledger_mod.CostLedger(window_size=2, drift_band=0.1, drift_windows=1)
        ledger.bind_registry(registry)
        tracker = slo_mod.SloTracker([ledger_mod.drift_objective()], registry)
        before = tracker.healthy()
        for _ in range(2):
            ledger.observe("hh", "resume", "64", 10.0, 30.0)
        verdicts.append((before, tracker.healthy(), tracker.burn_summary()["objectives"]))
    assert verdicts[0] == verdicts[1] == (True, False, ["capacity-cost-drift"])
