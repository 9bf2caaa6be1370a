"""The serving runtime: batched Leader / Helper / Plain sessions.

* `batcher.DynamicBatcher` coalesces concurrent requests into
  power-of-two key buckets, one device step a bucket, on its own CUDA
  stream;
* `service` -- `ServingConfig`, `PlainSession`, `HelperSession`,
  `LeaderSession`: deadlines, the Helper leg's timeout, retries,
  backoff and retry budget, the circuit breaker and degraded mode, the
  enveloped wire with its version downgrade;
* `snapshots` -- `SnapshotManager` and `RotationCoordinator`: a new
  database generation staged beside the serving one (a delta when it
  can be), flipped at a batch boundary, the old one freed after it
  drains;
* `transport` -- length-prefixed frames over TCP (`FramedTcpServer`,
  `TcpTransport`, and `TcpTransportPool` for concurrent Helper legs)
  and an in-process transport;
* `metrics` -- the sessions' counters, gauges and histograms;
* `sparse` -- `SparsePlainSession`, `SparseHelperSession`,
  `SparseLeaderSession`: cuckoo-hashed key-value lookups through the
  same sessions, and `sparse_lookup` / `sparse_lookup_plain`.
* `prober` -- the blackbox `Prober` of one pair and the fleet's
  `CrossReplicaProbe` (one golden pair through every replica). The
  prober sits above `serving/` and `heavy_hitters/`: import it from
  `serving.prober`. `serving.CrossReplicaProbe` resolves on first access,
  and is left out of `__all__`, so that neither `import serving` nor
  `from serving import *` loads `heavy_hitters/`.

Ported from the JAX package's `serving/`; see each module for what it
leaves out.
"""

from .batcher import DeadlineExceeded, DynamicBatcher, Overloaded, bucket_size
from .metrics import MetricsRegistry
from .service import (
    HelperSession,
    HelperUnavailable,
    LeaderSession,
    PlainSession,
    ServingConfig,
    TenantPolicy,
)
from .snapshots import RotationCoordinator, SnapshotManager, SnapshotMismatch
from .sparse import (
    SparseHelperSession,
    SparseLeaderSession,
    SparsePlainSession,
    make_sparse_client,
    sparse_lookup,
    sparse_lookup_plain,
)
from .transport import (
    FramedTcpServer,
    InProcessTransport,
    TcpTransport,
    TcpTransportPool,
    Transport,
    TransportError,
    TransportTimeout,
)

__all__ = [
    "DeadlineExceeded",
    "DynamicBatcher",
    "FramedTcpServer",
    "HelperSession",
    "HelperUnavailable",
    "InProcessTransport",
    "LeaderSession",
    "MetricsRegistry",
    "Overloaded",
    "PlainSession",
    "RotationCoordinator",
    "ServingConfig",
    "SnapshotManager",
    "SnapshotMismatch",
    "SparseHelperSession",
    "SparseLeaderSession",
    "SparsePlainSession",
    "TcpTransport",
    "TcpTransportPool",
    "Transport",
    "TransportError",
    "TenantPolicy",
    "TransportTimeout",
    "bucket_size",
    "make_sparse_client",
    "sparse_lookup",
    "sparse_lookup_plain",
]


def __getattr__(name):
    # The prober imports heavy_hitters/, which `import serving` must not load.
    if name == "CrossReplicaProbe":
        from .prober import CrossReplicaProbe

        return CrossReplicaProbe
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
