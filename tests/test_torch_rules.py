"""The port's rules: no JAX, CUDA by default, no fallback.

* Importing every module of the port loads neither `jax`, the JAX
  package nor `google.protobuf` (checked in a fresh interpreter).
* Without a CUDA device, the default device raises; nothing falls back
  to the CPU on its own.
* CPU tensors go through the plain versions and leave the kernel launch
  counters at 0; a tensor on any other device raises.
* No `try` on the port's serving path or in its DPF/DCF evaluation gives
  way to a plain version; the sparse database's cuckoo build has no `try`
  and reads no environment variable (SHA256 runs the native build); the
  serving runtime (`serving/`, `observability/`, `robustness/`, `utils/`,
  the prober, the operator's admin surface, the fleet's `fleet/` and
  `observability/federation.py` included) reads none either, and its
  sessions default to the card.
* The launch counters lose no count when threads launch at once.
* Heavy hitters (`heavy_hitters/`, and the `capacity/model.py`,
  `capacity/calibration.py`,
  `observability/costmodel.py`, `observability/slo.py` and
  `robustness/checkpoint.py` it brings) load no JAX and read no
  environment variable; its aggregator, protocol and client have no
  `try`, and the session's handlers catch only protocol and transport
  errors; its server, aggregator and client default to the card.
"""

import ast
import pkgutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.dcf import DistributedComparisonFunction
from distributed_point_functions_tpu_torch.device import resolve_device
from distributed_point_functions_tpu_torch.dpf import (
    DistributedPointFunction,
    DpfParameters,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt
from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
from distributed_point_functions_tpu_torch.ops.words import to_numpy
from distributed_point_functions_tpu_torch.value_types import IntType

PORT_DIR = Path(port.__file__).resolve().parent
REPO = PORT_DIR.parent
# The serving runtime's modules, the replica fleet's included (dotted,
# under the port).
SERVING_MODULES = (
    "serving", "serving.batcher", "serving.metrics", "serving.service",
    "serving.snapshots", "serving.transport", "observability",
    "observability.critical_path", "observability.device",
    "observability.events", "observability.phases",
    "observability.propagation", "observability.tracing", "robustness",
    "robustness.breaker", "robustness.failpoints", "utils",
    "utils.profiling", "utils.runtime", "serving.prober", "observability.admin",
    "observability.autoprofile", "observability.bundle",
    "observability.exposition", "observability.forecast",
    "observability.timeseries", "observability.federation", "fleet",
    "fleet.registry", "fleet.router", "fleet.rotation", "fleet.telemetry",
)
# Private heavy hitters and the modules it brings (dotted, under the port).
HH_MODULES = (
    "heavy_hitters", "heavy_hitters.aggregator", "heavy_hitters.client",
    "heavy_hitters.protocol", "heavy_hitters.session", "capacity.model",
    "capacity.calibration",
    "observability.costmodel", "observability.slo", "robustness.checkpoint",
)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + ".")
    )


def test_import_loads_no_jax():
    assert {"distributed_point_functions_tpu_torch.dpf",
            "distributed_point_functions_tpu_torch.dcf",
            "distributed_point_functions_tpu_torch.proto_validator",
            "distributed_point_functions_tpu_torch.fss_gates",
            "distributed_point_functions_tpu_torch.fss_gates.prng",
            "distributed_point_functions_tpu_torch.fss_gates.multiple_interval_containment",
            "distributed_point_functions_tpu_torch.hashing",
            "distributed_point_functions_tpu_torch.hashing.cuckoo_hash_table",
            "distributed_point_functions_tpu_torch.hashing.farm_hash_family",
            "distributed_point_functions_tpu_torch.hashing.hash_family",
            "distributed_point_functions_tpu_torch.hashing.hash_family_config",
            "distributed_point_functions_tpu_torch.hashing.multiple_choice_hash_table",
            "distributed_point_functions_tpu_torch.hashing.sha256_hash_family",
            "distributed_point_functions_tpu_torch.hashing.simple_hash_table",
            "distributed_point_functions_tpu_torch.pir.cuckoo_database",
            "distributed_point_functions_tpu_torch.pir.sparse_client",
            "distributed_point_functions_tpu_torch.pir.sparse_server",
            "distributed_point_functions_tpu_torch.testing.pir_generators",
            "distributed_point_functions_tpu_torch.testing.pir_selection_bits",
            "distributed_point_functions_tpu_torch.testing.request_generator",
            } | {f"distributed_point_functions_tpu_torch.{m}"
                 for m in SERVING_MODULES + HH_MODULES} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributed_point_functions_tpu') "
        "or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('distributed_point_functions_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(_port_modules())


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU path")


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseDpfPirDatabase([b"x"] * 10)


def test_server_default_device_does_not_fall_back(no_cuda):
    db = DenseDpfPirDatabase([b"x"] * 10, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseDpfPirServer.create_plain(db)
    keys, _ = DenseDpfPirClient.create(10, encrypt_decrypt.encrypt).create_plain_requests([3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_keys(keys.plain_request.dpf_keys)


def test_dpf_and_dcf_default_device_does_not_fall_back(no_cuda):
    dpf = DistributedPointFunction.create(DpfParameters(6, IntType(64)))
    k0, _ = dpf.generate_keys(5, 9)  # key generation runs on the host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dpf.evaluate_at(k0, 0, [5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dpf.evaluate_until(0, [], dpf.create_evaluation_context(k0))
    dcf = DistributedComparisonFunction.create(8, IntType(64))
    keys = dcf.generate_keys(100, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcf.batch_evaluate(list(keys), [7, 7])


@pytest.mark.parametrize("expansion", ["walk", "tail", "level"])
def test_dpf_and_dcf_on_cpu_count_no_launch(expansion):
    cuda_lib.reset_launch_counts()
    dpf = DistributedPointFunction.create(DpfParameters(12, IntType(64)), device="cpu")
    dpf._expansion = expansion
    k0, k1 = dpf.generate_keys(3000, 9)
    shares = [dpf.evaluate_until(0, [], dpf.create_evaluation_context(k))
              for k in (k0, k1)]
    u64 = [to_numpy(t).astype(np.uint64) for t in shares]
    total = sum(u[:, 0] | (u[:, 1] << np.uint64(32)) for u in u64)
    assert np.flatnonzero(total).tolist() == [3000] and int(total[3000]) == 9
    assert dpf.evaluate_at(k0, 0, [3000]).tolist() == shares[0][3000:3001].tolist()
    dcf = DistributedComparisonFunction.create(8, IntType(64), device="cpu")
    dcf.batch_evaluate(list(dcf.generate_keys(100, 3)), [7, 7])
    assert not any(cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
    dpf._expansion = "pallas"
    with pytest.raises(ValueError):
        dpf.evaluate_until(0, [], dpf.create_evaluation_context(k0))


def test_server_rejects_a_database_on_another_device():
    db = DenseDpfPirDatabase([b"x"] * 10, device="cpu")
    with pytest.raises(ValueError):
        DenseDpfPirServer(db, device="meta")


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    cuda_lib.reset_launch_counts()
    rng = np.random.default_rng(0)
    recs = [rng.bytes(16) for _ in range(300)]
    server = DenseDpfPirServer.create_plain(
        DenseDpfPirDatabase(recs, device="cpu"), device="cpu"
    )
    r0, r1 = DenseDpfPirClient.create(300, encrypt_decrypt.encrypt).create_plain_requests([0, 299])
    s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
    s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
    assert [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(s0, s1)] == [
        recs[0], recs[299]
    ]
    assert cuda_lib.LAUNCHES == {
        "expand_level": 0, "value_hash": 0, "xor_inner_product": 0,
        "walk_descend": 0, "expand_head": 0, "expand_tail": 0, "path_level": 0,
        "xor_counts": 0, "repeat_tiles": 0, "leaf_blocks": 0,
    }


@pytest.mark.parametrize("expansion", ["walk", "tail", "level"])
def test_every_expansion_mode_counts_no_launch_on_cpu(expansion):
    # 2^13 records: 6 levels, so walk and tail mode both run a head and a
    # tail (K4 x2; K6 + K5) in their plain versions.
    cuda_lib.reset_launch_counts()
    recs = [bytes([i % 251]) * 4 for i in range(1 << 13)]
    server = DenseDpfPirServer.create_plain(
        DenseDpfPirDatabase(recs, device="cpu"), device="cpu", expansion=expansion
    )
    r0, r1 = DenseDpfPirClient.create(len(recs), encrypt_decrypt.encrypt).create_plain_requests([7, 5000])
    s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
    s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
    assert [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(s0, s1)] == [
        recs[7], recs[5000]
    ]
    assert not any(cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
    with pytest.raises(ValueError):
        DenseDpfPirServer.create_plain(
            DenseDpfPirDatabase(recs[:3], device="cpu"), device="cpu",
            expansion="pallas",
        )


def test_wrappers_raise_for_other_devices():
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ep.expand_level(
            torch.empty((16, 8, 4), **meta), torch.empty((4,), **meta),
            torch.empty((16, 8, 1), **meta), torch.empty((1,), **meta),
            torch.empty((1,), **meta),
        )
    fused = (
        torch.empty((16, 8, 4), **meta), torch.empty((4,), **meta),
        torch.empty((2, 16, 8, 1), **meta), torch.empty((2, 1), **meta),
        torch.empty((2, 1), **meta),
    )
    with pytest.raises(ValueError, match="unsupported device"):
        ep.walk_descend(*fused)
    with pytest.raises(ValueError, match="unsupported device"):
        ep.expand_head(*fused)
    with pytest.raises(ValueError, match="unsupported device"):
        ep.expand_tail(*fused, torch.empty((16, 8, 1), **meta), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        ep.path_level(
            torch.empty((16, 8, 4), **meta), torch.empty((4,), **meta),
            torch.empty((4,), **meta), torch.empty((16, 8, 1), **meta),
            torch.empty((1,), **meta), torch.empty((1,), **meta),
        )
    with pytest.raises(ValueError, match="unsupported device"):
        ipk.xor_inner_product_packed(
            torch.empty((32, 8, 2), **meta), torch.empty((8, 8), **meta)
        )


@pytest.mark.parametrize(
    "module",
    ["ops/expand_planes.py", "ops/aes_bitslice.py", "ops/inner_product_kernels.py",
     "pir/dense_eval_planes.py", "pir/database.py", "pir/server.py", "dpf.py",
     "dcf.py", "value_types.py", "ops/limb.py", "pir/dense_eval.py",
     "pir/client.py", "pir/messages.py", "prng.py", "serialization.py",
     "proto_validator.py", "interop.py", "fss_gates/multiple_interval_containment.py",
     "fss_gates/prng.py", "pir/cuckoo_database.py", "pir/sparse_server.py",
     "pir/sparse_client.py", "hashing/cuckoo_hash_table.py",
     "hashing/hash_family_config.py", "hashing/sha256_hash_family.py",
     "heavy_hitters/aggregator.py", "heavy_hitters/protocol.py",
     "heavy_hitters/client.py"],
)
def test_serving_path_has_no_try(module):
    tree = ast.parse((PORT_DIR / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_launch_counts_lose_nothing_across_threads():
    cuda_lib.reset_launch_counts()
    barrier = threading.Barrier(8)

    def launch():
        barrier.wait()
        for _ in range(10_000):
            cuda_lib.count("leaf_blocks")

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cuda_lib.LAUNCHES["leaf_blocks"] == 80_000
    cuda_lib.reset_launch_counts()
    assert not any(cuda_lib.LAUNCHES.values())


def test_launch_counts_per_thread_scope():
    """Each thread's `counting_into` dict gets its own launches only (a
    serving session's batch worker), and the global count gets them all."""
    cuda_lib.reset_launch_counts()
    barrier = threading.Barrier(8)
    scopes = [{} for _ in range(8)]

    def launch(t):
        barrier.wait()
        with cuda_lib.counting_into(scopes[t]):
            for _ in range(1_000 * (t + 1)):
                cuda_lib.count("walk_descend")
        cuda_lib.count("walk_descend")  # outside the scope

    threads = [threading.Thread(target=launch, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [cuda_lib.read_counts(s) for s in scopes] == [
        {"walk_descend": 1_000 * (t + 1)} for t in range(8)]
    assert cuda_lib.LAUNCHES["walk_descend"] == 36_000 + 8
    cuda_lib.reset_launch_counts()


def test_sessions_default_device_does_not_fall_back(no_cuda):
    from distributed_point_functions_tpu_torch.serving import (
        HelperSession,
        InProcessTransport,
        LeaderSession,
        PlainSession,
    )

    db = DenseDpfPirDatabase([b"x"] * 10, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlainSession(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HelperSession(db, encrypt_decrypt.decrypt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeaderSession(db, InProcessTransport(lambda b: b))


@pytest.mark.parametrize(
    "module", ["native.py", "dpf.py", "pir/dense_eval.py", "pir/server.py",
               "pir/client.py", "prng.py", "serialization.py", "pir/cuckoo_database.py",
               "pir/sparse_server.py", "pir/sparse_client.py", "pir/database.py"]
    # The serving runtime takes its settings from `ServingConfig` and its
    # failpoints from code.
    + [m.replace(".", "/") + ".py" for m in SERVING_MODULES if "." in m]
    + ["heavy_hitters/__init__.py"]
    + [m.replace(".", "/") + ".py" for m in HH_MODULES if "." in m])
def test_host_path_reads_no_environment(module):
    """No environment variable selects the host library's numpy twins or
    anything else on the host side of the main path."""
    text = (PORT_DIR / module).read_text()
    assert "os.environ" not in text and "getenv" not in text


def test_hh_session_catches_only_protocol_and_transport_errors():
    """The sweep's session retries a round or steps its wire version down
    on protocol and transport errors only: a kernel's error reaches the
    caller, and nothing gives way to a plain version."""
    tree = ast.parse((PORT_DIR / "heavy_hitters/session.py").read_text())
    caught = set()
    for handler in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
        assert handler.type is not None
        names = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
        caught |= {n.id for n in names}
    assert caught == {"ProtocolError", "TransportError", "IntegrityError"}


def test_hh_default_device_does_not_fall_back(no_cuda):
    from distributed_point_functions_tpu_torch import heavy_hitters as hh

    config = hh.HeavyHittersConfig(domain_bits=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hh.HeavyHittersClient(config)
    keys = [hh.HeavyHittersClient(config, device="cpu").generate_report(3)[0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hh.HeavyHittersServer(config, keys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hh.LevelAggregator(config.make_dpf(), keys)
    cuda_lib.reset_launch_counts()
    server = hh.HeavyHittersServer(config, keys, device="cpu")
    server.evaluate_round(0, list(range(16)))
    assert not any(cuda_lib.LAUNCHES.values()) and server.launches == {}
