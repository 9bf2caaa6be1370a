#!/usr/bin/env python3
"""One dense-PIR batch's peak device memory against the planner's model.

Serves `BASELINE.json` configs[2] (2^22 records of 256 B, 1,024 queries)
on one card at the default budget (the materialized tier) in the given
expansion mode, with the port of the checkout at `--root` (default: this
one), and prints the card's `nvidia-smi` name and power limit, then one
JSON line: the plan, the modeled selection bytes and the peak
`torch.cuda.max_memory_allocated` over one party's batch above what was
allocated before it. It uses only the serving API that every slice of the
port has, so it reads an earlier tree as well:

    python3 tools/torch_tier_peak_probe.py --expansion tail
    python3 tools/torch_tier_peak_probe.py --root path/to/checkout --expansion tail
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RECORDS = 1 << 22
RECORD_BYTES = 256
QUERIES = 1024
SEED = 20260


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--expansion", default="tail")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_tier_peak_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirDatabase,
        DenseDpfPirServer,
        messages,
    )
    from distributed_point_functions_tpu_torch.value_types import XorType

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    data = rng.bytes(RECORDS * RECORD_BYTES)
    records = [data[i * RECORD_BYTES:(i + 1) * RECORD_BYTES] for i in range(RECORDS)]
    db = DenseDpfPirDatabase(records)
    db.staged()
    idx = [int(i) for i in rng.integers(0, RECORDS, QUERIES)]
    # The client's plain requests, built from the DPF's batched keygen, an
    # API every tree of the port has (the client's constructor changed).
    dpf = DistributedPointFunction.create(
        DpfParameters((RECORDS - 1).bit_length(), XorType(128)))
    r0, r1 = (messages.PirRequest(plain_request=messages.PlainRequest(keys))
              for keys in dpf.generate_keys_batch([i // 128 for i in idx],
                                                  [1 << (i % 128) for i in idx]))
    server = DenseDpfPirServer.create_plain(db, expansion=args.expansion)
    plan = server._plan_serving(QUERIES)
    s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
    s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
    if any(bytes(x ^ y for x, y in zip(a, b)) != records[i] for a, b, i in zip(s0, s1, idx)):
        raise AssertionError("a record does not reconstruct")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    server.handle_plain_request(r0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(json.dumps({"root": args.root, "expansion": args.expansion,
                      "tier": plan.mode, "expand_levels": plan.expand_levels,
                      "reconstructed": QUERIES,
                      "modeled_selection_bytes": plan.selection_bytes_peak,
                      "measured_peak_bytes_one_party": peak,
                      "peak_over_model_bytes": peak - plan.selection_bytes_peak}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
