"""The port's admission control against the JAX package's, on the CPU.

The same calls go to both packages under one fake clock, from a numpy
seed, and the results must be equal bit for bit:

* `TokenBucket`'s takes, hints and rescaling;
* `WeightedFairQueue`'s dequeue order, a single tenant's FIFO included;
* `AdmissionController.admit` decisions, reasons, hints and drain
  estimates across quota, doomed-deadline, queued-cost and priority
  sheds, with releases between, and its export;
* `PredictiveGovernor.scale_for` and its ticks (a raising forecast fails
  open);
* the brownout ladder's levels and transition log (wall times aside);
* the recalibrator's factors over the same ledger windows, and its kill
  switch (the JAX package's environment variable, the port's
  `set_enabled`);
* `price_pir_keys` / `price_sparse_pir_keys` from the same history file:
  device-ms equal to the JAX package's, and the byte peak equal to the
  JAX formula applied to the port's counts (keys padded to 32, the leaf
  values of the covering tree beside the selections).

No XLA program runs here.
"""

import dataclasses
import json

import numpy as np
import pytest

from distributed_point_functions_tpu.capacity import admission as jadmission
from distributed_point_functions_tpu.capacity import brownout as jbrownout
from distributed_point_functions_tpu.capacity import model as jmodel
from distributed_point_functions_tpu.capacity import recalibrate as jrecalibrate
from distributed_point_functions_tpu.observability import costmodel as jcostmodel
from distributed_point_functions_tpu_torch.capacity import admission, brownout, model
from distributed_point_functions_tpu_torch.capacity import recalibrate
from distributed_point_functions_tpu_torch.capacity.calibration import ThroughputCalibration
from distributed_point_functions_tpu_torch.observability import costmodel

SEED = 1414
QPS = 640.0


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture
def history(tmp_path):
    path = tmp_path / "history.jsonl"
    path.write_text(json.dumps(
        {"metric": "serving_closed_loop_queries_per_sec", "value": QPS}) + "\n")
    return str(path)


def _models(history, **kw):
    jm = jmodel.CapacityModel(device_memory_bytes=16 << 30,
                              calibration=jmodel.ThroughputCalibration(history), **kw)
    pm = model.CapacityModel(device_memory_bytes=16 << 30,
                             calibration=ThroughputCalibration(history), **kw)
    return jm, pm


def test_token_bucket_hints_equal_jax():
    rng = np.random.default_rng(SEED)
    logs = []
    for mod in (jadmission, admission):
        clock = Clock()
        bucket = mod.TokenBucket(rate=37.5, burst=12.0, clock=clock)
        log = []
        for op, x in zip(rng.integers(0, 4, 500).tolist(), rng.random(500).tolist()):
            if op == 0:
                log.append(("take", bucket.try_take(1 + int(x * 8))))
            elif op == 1:
                log.append(("hint", bucket.time_until(1 + int(x * 20))))
            elif op == 2:
                bucket.set_scale(0.25 + 2 * x)
                log.append(("rate", bucket.rate))
            else:
                clock.t += x * 0.2
            log.append(("tokens", bucket.tokens))
        logs.append(log)
        rng = np.random.default_rng(SEED)
    assert logs[0] == logs[1]
    with pytest.raises(ValueError):
        admission.TokenBucket(rate=0)


@pytest.mark.parametrize("tenants", [1, 3])
def test_wfq_dequeue_order_equals_jax(tenants):
    rng = np.random.default_rng(SEED + tenants)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, tenants)),
            float(rng.integers(1, 9))) for _ in range(400)]
    weights = {0: 3.0, 1: 2.0, 2: 1.0}
    orders = []
    for mod in (jadmission, admission):
        q = mod.WeightedFairQueue()
        out, seq = [], 0
        for op, tenant, cost in ops:
            if op < 2 or not q:
                q.push(seq, tenant=f"t{tenant}", weight=weights[tenant], cost=cost)
                seq += 1
            else:
                out.append((q.peek(), q.pop(), q.backlog_by_tenant()))
        out.append(q.drain())
        orders.append(out)
    assert orders[0] == orders[1]
    if tenants == 1:
        popped = [x[1] for x in orders[1][:-1]] + orders[1][-1]
        assert popped == sorted(popped)  # one tenant: exact FIFO


def _decision(d):
    return (d.admitted, None if d.reason is None else d.reason.value, d.retry_after_s,
            d.drain_ms, None if d.cost is None else (d.cost.device_ms, d.cost.bytes_peak,
                                                     d.cost.quantity, d.cost.unit))


def test_admit_decisions_equal_jax(history):
    rng = np.random.default_rng(SEED)
    script = [(int(rng.integers(0, 6)), int(rng.integers(1, 9)), int(rng.integers(0, 4)),
               float(rng.random())) for _ in range(600)]
    results = []
    for mod, m in zip((jadmission, admission), _models(history)):
        clock = Clock()
        adm = mod.AdmissionController(m, queue_budget_ms=30.0, clock=clock)
        adm.set_tenant("gold", mod.TenantPolicy(weight=3.0, priority=2))
        adm.set_tenant("quota", mod.TenantPolicy(rate_qps=40.0, burst=8.0))
        adm.set_tenant("batch", mod.TenantPolicy(priority=0))
        tenants = ["default", "gold", "quota", "batch"]
        held, log = [], []
        for op, keys, tenant, x in script:
            if op <= 2:
                deadline = None if op == 0 else clock.t + x * 0.2
                d = adm.admit(keys, tenant=tenants[tenant], deadline=deadline)
                log.append(_decision(d))
                if d.admitted:
                    held.append(d.cost)
            elif op == 3 and held:
                adm.release(held.pop(int(x * len(held))))
            elif op == 4:
                adm.set_min_priority(int(x * 3))
            else:
                clock.t += x * 0.02
            log.append(adm.outstanding_ms)
        log.append(adm.export())
        results.append(log)
    assert results[0] == results[1]
    reasons = {entry[1] for entry in results[1] if isinstance(entry, tuple)}
    assert reasons == {None, "quota", "drain_deadline", "queue_cost", "priority"}


def test_admit_prices_with_the_installed_pricer_as_jax(history):
    results = []
    for mod, m in zip((jadmission, admission), _models(history)):
        adm = mod.AdmissionController(m, queue_budget_ms=10_000.0, clock=Clock())
        adm.set_pricer(lambda n, m=m: m.price_sparse_pir_keys(n))
        results.append([_decision(adm.admit(n)) for n in (1, 3, 8)])
    assert results[0] == results[1]
    assert results[1][0][4][3] == "sparse_keys"


def test_governor_equals_jax():
    ttbs = [None, 0.0, -3.0, 1.0, 59.9, 60.0, 119.99, 120.0, 500.0, 7.5]
    logs = []
    for mod in (jadmission, admission):
        adm = mod.AdmissionController(queue_budget_ms=10.0, clock=Clock())
        adm.set_tenant("t", mod.TenantPolicy(rate_qps=100.0))
        source = iter(ttbs + ["raise"])

        def forecast():
            v = next(source)
            if v == "raise":
                raise RuntimeError("forecast down")
            return v

        gov = mod.PredictiveGovernor(adm, forecast, horizon_s=120.0, floor=0.2)
        log = [gov.scale_for(t) for t in ttbs]
        log += [(gov.update(), adm.rate_scale) for _ in range(len(ttbs) + 1)]
        log.append(gov.export())
        log.append(adm.export()["tenants"]["t"]["effective_rate_qps"])
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-2]["tightenings"] > 0


def _strip_wall(export):
    export = dict(export)
    export["transitions"] = [{k: v for k, v in t.items() if k != "wall_time"}
                             for t in export["transitions"]]
    return export


def test_brownout_ladder_equals_jax():
    rng = np.random.default_rng(SEED)
    pattern = (rng.random(120) < 0.6).tolist()
    logs = []
    for mod in (jbrownout, brownout):
        clock = Clock()
        breaching = [False]
        knobs = []
        ladder = mod.BrownoutController(
            signal=lambda: breaching[0], engage_after_s=0.5, escalate_after_s=1.0,
            revert_after_s=2.0, clock=clock)
        for step in mod.BROWNOUT_STEPS:
            ladder.add_step_action(step, lambda s=step: knobs.append(("on", s)),
                                   lambda s=step: knobs.append(("off", s)))

        def broken():
            raise RuntimeError("knob stuck")

        ladder.add_step_action("cap_batches", broken, broken)
        log = []
        for b in pattern:
            breaching[0] = b
            clock.t += 0.4
            log.append(ladder.evaluate())
        log.append(ladder.force_level(4))
        log.append(ladder.force_level(0))
        log += [list(ladder.active_steps()), knobs, _strip_wall(ladder.export())]
        logs.append(log)
    assert logs[0] == logs[1]
    assert max(logs[1][:len(pattern)]) >= 2
    with pytest.raises(ValueError):
        brownout.BrownoutController().force_level(5)


def test_recalibrator_factors_equal_jax(history, monkeypatch):
    rng = np.random.default_rng(SEED)
    samples = [(["pir", "sparse"][int(rng.integers(0, 2))],
                ["materialized", "streaming"][int(rng.integers(0, 2))],
                str(1 << int(rng.integers(0, 4))), float(rng.random() * 3 + 0.2))
               for _ in range(900)]
    monkeypatch.delenv("DPF_TPU_COSTMODEL_RECALIBRATE", raising=False)
    exports = []
    models = _models(history)
    for mod, led_mod, m in zip((jrecalibrate, recalibrate), (jcostmodel, costmodel), models):
        ledger = led_mod.CostLedger(window_size=8, drift_band=0.35, drift_windows=3)
        rec = mod.Recalibrator(model=m, ledger=ledger, alpha=0.5, clamp=(0.25, 4.0),
                               min_samples=16).install()
        log = []
        for workload, tier, bucket, truth in samples:
            price = (m.price_pir_keys(int(bucket)) if workload == "pir"
                     else m.price_sparse_pir_keys(int(bucket)))
            ledger.observe(workload, tier, bucket, predicted_device_ms=price.device_ms,
                           actual_device_ms=truth * int(bucket))
            log.append((rec.factor("pir"), rec.factor("sparse")))
        export = rec.export()
        export.pop("kill_switch_env", None)
        log.append(export)
        log.append(ledger.export())
        exports.append(log)
    assert exports[0] == exports[1]
    final = exports[1][-2]["factors"]
    assert final and all(0.25 <= f <= 4.0 for f in final.values())
    # The kill switch: raw prices at once, the learned factors kept.
    jm, pm = models
    corrected = pm.price_pir_keys(8).device_ms
    monkeypatch.setenv("DPF_TPU_COSTMODEL_RECALIBRATE", "0")
    pm_rec = pm._correction.__self__
    pm_rec.set_enabled(False)
    assert pm.price_pir_keys(8).device_ms == jm.price_pir_keys(8).device_ms == 8 * 1e3 / QPS
    pm_rec.set_enabled(True)
    assert pm.price_pir_keys(8).device_ms == corrected
    assert pm_rec.export()["reverted"] is False


@pytest.mark.parametrize("num_blocks", [None, 1, 36, 8192, 196_608])
def test_prices_equal_jax_on_the_port_counts(history, num_blocks):
    class JaxOnPortCounts(jmodel.CapacityModel):
        """The JAX pricing with the port's materialized selection bytes:
        keys padded to 32, the covering tree's leaf values beside the
        selections."""

        def materialized_selection_bytes(self, num_keys, eff_blocks):
            leaves = max(eff_blocks, 1 << max(0, (eff_blocks - 1).bit_length()))
            return model.padded_keys(num_keys) * (leaves + eff_blocks) * 16

    jm = JaxOnPortCounts(device_memory_bytes=16 << 30,
                         calibration=jmodel.ThroughputCalibration(history))
    pm = model.CapacityModel(device_memory_bytes=16 << 30,
                             calibration=ThroughputCalibration(history))
    for n in (1, 5, 32, 33, 128):
        for name in ("price_pir_keys", "price_sparse_pir_keys"):
            assert (dataclasses.astuple(getattr(pm, name)(n, num_blocks))
                    == dataclasses.astuple(getattr(jm, name)(n, num_blocks)))
    assert pm.serving_queries_per_sec() == jm.serving_queries_per_sec() == QPS
    assert pm.price_export(8, num_blocks) == {
        k: v for k, v in jm.price_export(8, num_blocks).items()}


def test_misprice_and_fallback(tmp_path):
    m = model.CapacityModel(calibration=ThroughputCalibration(str(tmp_path / "none")),
                            misprice={"sparse": 3.0})
    assert m.serving_queries_per_sec() == model.SERVING_QPS_FALLBACK
    assert m.price_pir_keys(4).device_ms == 4 * 1e3 / model.SERVING_QPS_FALLBACK
    assert m.price_sparse_pir_keys(4).device_ms == (
        2.0 * 4 * 1e3 / model.SERVING_QPS_FALLBACK * 3.0)
    m.set_correction_provider(lambda workload, n: 0.5)
    assert m.price_pir_keys(4).device_ms == 4 * 1e3 / model.SERVING_QPS_FALLBACK * 0.5
    m.set_replica("r1")
    assert m.export()["replica"] == m.price_export()["replica"] == "r1"
