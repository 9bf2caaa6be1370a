"""Two-server private heavy hitters over incremental DPF keys.

The hierarchical prefix-count traversal of arXiv:2012.14884 as a
subsystem: `client` encodes values into incremental key pairs,
`aggregator` batch-evaluates every live key over the candidate-prefix
frontier level by level (resuming from cached cut states), `protocol`
owns the frontier state machine and threshold pruning, and `session`
deploys the sweep Leader/Helper over `serving.transport`.

The port of the JAX package's `heavy_hitters/`, on the card: servers,
aggregators and clients take a `device` (None: the CUDA card).
"""

from .aggregator import (
    LevelAggregator,
    LevelPlan,
    frontier_budget_bytes,
    lane_bytes,
    plan_level,
)
from .client import HeavyHittersClient, decode_value, encode_value
from .protocol import (
    FrontierSweep,
    HeavyHittersConfig,
    HeavyHittersResult,
    HeavyHittersServer,
    IntegrityError,
    ProtocolError,
    RoundStats,
    config_fingerprint,
    plaintext_heavy_hitters,
    reconstruct_counts,
    run_protocol,
)
from .session import (
    HeavyHittersHelper,
    HeavyHittersLeader,
    decode_eval_request,
    decode_eval_request_full,
    decode_eval_response,
    decode_eval_response_full,
    encode_eval_request,
    encode_eval_response,
)

__all__ = [
    "FrontierSweep",
    "HeavyHittersClient",
    "HeavyHittersConfig",
    "HeavyHittersHelper",
    "HeavyHittersLeader",
    "HeavyHittersResult",
    "HeavyHittersServer",
    "IntegrityError",
    "LevelAggregator",
    "LevelPlan",
    "ProtocolError",
    "RoundStats",
    "config_fingerprint",
    "decode_eval_request",
    "decode_eval_request_full",
    "decode_eval_response",
    "decode_eval_response_full",
    "decode_value",
    "encode_eval_request",
    "encode_eval_response",
    "encode_value",
    "frontier_budget_bytes",
    "lane_bytes",
    "plaintext_heavy_hitters",
    "plan_level",
    "reconstruct_counts",
    "run_protocol",
]
