#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports only the port (`distributed_point_functions_tpu_torch`),
never JAX or the JAX package, and catches nothing: any failure exits
non-zero. Without a CUDA device, or without the port beside it, it exits
non-zero before printing a result. Phases, one JSON line each:

1. `device`: the card (`nvidia-smi` name and power limit, SMs, max SM
   clock); the raw `nvidia-smi --query-gpu=name,power.limit` line is
   printed on its own line too, and `backend` before it:
   `utils.get_backend_mode_string()`.
2. `build`: the kernels built from `csrc/` (seconds, and the registers
   and spills `nvcc -Xptxas -v` reports), then the host library built
   from `csrc/host/` with g++ (`host_library_seconds`). Then `split_aes`: the latency
   of one level of the split AES (csrc/split_aes.cuh) at one group, read
   from a one-column K8 walk of 256 levels that equals its plain version
   (a level: the select-key AES, sigma, the corrections and the control,
   what a caller's walk pays a level).
3. `kernel`: every kernel at the main path's shapes (2^20 x 256 B
   records, 128 queries, 13 expansion levels): K2 `expand_level` (one
   line per level, `level` and `G`, then the 13 summed; `level_ms` and
   `level_bound_ms` give each; every K2 line with its registers and
   spills), K3
   `value_hash`, K1 `xor_inner_product`, K4 `walk_descend` (one line per
   phase of walk mode: head 4 -> 2,048 word columns over 9 levels, tail
   2,048 -> 32,768 over 4 levels with the value hash), K6 `expand_head`
   (4 -> 2,048) and K5 `expand_tail` (2,048 -> 32,768, 128-column
   tiles), both also at tail mode's shapes of the materialized tier
   (KG = 32: 32 -> 2,048 and 65,536 -> 2^20) and of the DPF full domain
   (KG = 1: 1 -> 1,024 and 1,024 -> 16,384), with their registers and
   spills; K8 `path_level` (one path-walk level: per seed at 32 word
   columns, the DCF's 1,024 keys, and at 2,048; shared corrections at
   2,048, at 32, `evaluate_at`'s 1,024 points, and at 2, `evaluate_next`'s
   64 prefixes; then the walks of one launch its callers make: the DCF's
   31 levels with 32 stops at 32 word columns, and a chunk's 5 path bits
   at 32); and K3 at the DCF's 1,024 columns (32 levels' states of 1,024
   keys hashed in one launch). K4's and K8's lines also give the group
   size of their split AES (16 threads a word column), their registers
   and spills, and that level latency. Kernel and plain PyTorch version
   on the same seeded inputs
   must be `torch.equal`; `ms`, one call timed alone between CUDA
   events (the card also waits on the wrapper's host dispatch),
   `device_ms`, the device time of one launch (20 launches queued
   behind a device-side sleep), launches per party batch, and the bound
   reckoned from this run's shapes and the card's rates (for K4-K6 the
   doubling work: each tree node's children hashed once). One AES
   counts the fewer of the published two-input gate count and the LOP3
   instructions `cuobjdump -sass` finds in the port's AES with its ten
   rounds written out (`aes_sass_ops`, for each fixed key and for the
   select-key AddRoundKey of K4 and K8; the `build` line gives both).
4. `small_path`: a 2^12 x 32 B database served on the card and by the
   plain versions on the host must give the same bytes per party, in
   each expansion mode.
5. `main_path`, once per expansion mode (`walk`, `tail`, `level`): a
   2^20 x 256 B database on the card (built once), 128 queries from
   `DenseDpfPirClient.create_plain_requests`, both parties served by
   `DenseDpfPirServer.create_plain(db, expansion=mode)
   .handle_plain_request`; the XOR of the shares must equal every queried
   record, and the launch counters (zeroed just before each mode's run)
   must read walk K4 = 4, K1 = 2; tail K6 = 2, K5 = 2, K1 = 2; level
   K2 = 2 x 13, K3 = 2, K1 = 2, and `leaf_blocks` = 2 in every mode, and
   nothing else. Queries per second
   come from 16 batches per mode, the modes served in turns;
   `round_wins` is the share of rounds each mode's batch beat each other
   mode's, and `fastest` (in the breakdown lines) the mode that won nine
   rounds in ten against every other, or null. Then
   `main_path_breakdown` for each mode: one party's batch split into key
   staging, expansion and inner product (host clock, synchronized), and
   the device's busy share from a `torch.profiler` trace of one request;
   `stage_keys_ms` is the staging with the native host walk, and
   `stage_keys_numpy_ms` beside it the same staging with the numpy walk
   (the plain version), whose arrays must be equal.
   Then `two_party`: the same configuration (the main path's database, 128
   new queries) served the way the reference is deployed. The port's
   client makes a `LeaderRequest` (`create_request`: native keygen, the
   Helper's keys and a one-time-pad seed serialized to proto3 bytes and
   hybrid-encrypted to the fixed test keyset); a Leader and a Helper
   `DenseDpfPirServer` on the card, walk mode, an in-process sender that
   calls `while_waiting` and then the Helper. Every record must come back
   through `handle_response`; the Leader's share (the combined response
   XOR the Helper's) must equal a plain server's for the Leader's keys;
   the Helper's bytes its plain share XOR the pad of the client's seed;
   the launches walk K4 = 4, `leaf_blocks` = 2, K1 = 2 and nothing else;
   native keygen and the native walk must equal their numpy plain
   versions; `google.protobuf` must not be loaded. The line gives the
   crypto backend, the host ms of each step (median of 7 rounds: keygen
   native and numpy, serializing and encrypting the Helper's request,
   the whole `create_request`, serializing and parsing the
   `LeaderRequest`, the Helper's decrypt and parse, staging with the
   native and the numpy walk, each role's serve, the mask, the combine,
   the whole `handle_request` and the unmask), the round trip's q/s over
   14 rounds with its spread, and the device's idle share.
   Then `serving` (the serving runtime at the same configuration): a
   Helper and a Leader session, each over its own database on the card
   and behind a `FramedTcpServer` on loopback, the Leader reaching the
   Helper through a `TcpTransportPool`; 4 client processes of 16
   threads send 4,096 framed requests of one query each, closed loop
   (`ServingConfig(max_batch_size=128, max_wait_ms=2.0)`). First the
   kernels of every bucket from 1 to 128 keys at this size (K4 x 2,
   `leaf_blocks`, K1) against their plain versions on the card; then
   every answer through `handle_response`, and each party's own
   counted launches (its session's, counted on its batch worker) equal
   to the sum over its batches formed of each bucket's plan
   (`tier_launches`), the process's counts to the two parties' sum. The line gives q/s, p50 and p99 latency, batches
   and keys a batch per party, the pad-waste share, each party's
   evaluation ms, the device's idle share (the union of kernel
   intervals in a `torch.profiler` trace of 128 requests) and one
   sequential client's 256 requests. Then `serving_rotation`: both
   parties rotate to generation 1, a delta of 64 rows
   (`Builder.update(...).build_from(prev)`), under a 1,024-request wave
   that queries the updated rows half the time; every answer must be
   its record's value in the generation its Leader share bound to, every
   request sent after the rotation generation 1's, both stagings a
   delta (`bytes_saved > 0`), generation 0's staging freed and
   `torch.cuda.memory_allocated` back within 2 MiB; staleness ms, bytes
   staged, saved and freed, mismatch retries. Then `overload` (
   `overload_phase`): new sessions over generation 1, the Leader with
   cost-aware admission calibrated from `serving`'s q/s through a history
   file, tenants on Leader ports of their own; the saturation just under
   the admission budget, twice it open loop for 10 s (goodput at least
   0.70 of it, sheds at admission only with hints and reasons, tenant
   shares within 15% of 3:1), the brownout ladder's levels with each
   party's launches against the plan, a recalibration drill; every
   answer its record's. Before `overload`, on the same TCP Leader and
   Helper at generation 1 (`prober_phase`): `prober` (one probe of every
   dense kind, `leader_e2e` and `hh_sweep`, each `ok` and launching its
   tier's plan), `prober_drill` (a word XORed into a golden row of the
   Leader's stagings: every dense kind `mismatch`, `/healthz` 503, one
   debug bundle; undone: `recovered`, 200), `prober_loop` (the
   background loop during a wave of the 64 clients: the duty cycle of a
   complete period at most 0.05, no probe failed) and `admin` (every route of an `AdminServer` over the
   Leader's registry, the prober, bundles, snapshots, a time-series
   sampler, a workload observatory and a forecaster: status and content
   type as `ADMIN_ROUTES`, `/metrics` parsing as Prometheus text, a
   forecast time-to-breach of the arrival rate, a `/profilez` trace
   naming a port kernel).
   Then `fleet` (`fleet_phase`): three such Leader/Helper pairs on the
   card, each party over its own database with its own
   `SnapshotManager`, in a `ReplicaSet` behind a `FleetRouter`, one
   telemetry scope a replica in a `FleetTelemetry`; 12 tenant threads of
   this process send 1,024 one-query `LeaderRequest`s closed loop through
   the router: every answer its generation's record, each party's
   launches its batches' plans, q/s, p50 / p99, requests a replica, the
   fleet's duty cycle beside the card's busy share. `fleet_spillover`
   (the busiest replica's admission sheds everything: spillovers within
   one generation), `fleet_rotation` x3 (a quorum of 2, each wave closed
   loop with no think time: a 64-row delta under tenants that pick their
   replica and ask its Leader, as `benchmarks/fleet_bench.py`'s do,
   staleness; a laggard shed, converged and readmitted under tenants
   through the router, whose pins hold every flip off; `QuorumFailed`
   with nothing flipped), `fleet_probe` (the
   `CrossReplicaProbe` passes, catches a wrong word in one replica's
   staging with a bundle, passes again), `fleet_breaker` (each Leader's
   breaker opened by a failing Helper leg drains its replica, closed
   restores it) and `fleet_admin` (`FLEET_ADMIN_ROUTES`; every replica's
   breaker transitions and flips on `/fleet-timelinez`, each with its
   replica's id).
6. The DPF and DCF paths, each run with every launch count set to 0
   just before it and checked just after:
   - `dcf`: `DistributedComparisonFunction.create(32, IntType(64))`,
     batches of 1,024 and 256 keys (one key pair, the parties
     alternating) at random points; each point also evaluated with the
     parties swapped, and every pair of shares must reconstruct
     beta * [x < alpha] mod 2^64; one K8 launch (31 levels, 32 stops)
     and one K3 launch a batch;
     evaluations per second, device idle share;
   - `dpf_full_domain`, once per expansion mode: one key pair over 2^20,
     IntType(64), `evaluate_until(0, [], ctx)`; the modes' shares equal,
     the two parties' sum beta at alpha and 0 elsewhere; ms per
     evaluation;
   - `dpf_point`: `evaluate_at` at 1,024 points equals the full-domain
     values there (one K8 launch of 19 levels a party); an incremental
     DPF over
     (8, 14, 20) through `evaluate_next` with 64 prefixes per level after
     the first (resumed through one K8 launch) reconstructs at every level and
     equals its own full-domain evaluation at the last; one more
     `evaluate_next` at 40 prefixes walks its narrow levels on K8.
   - `mic`: the Multiple Interval Containment gate at log_group_size 64
     (the Z_2^64 ring of eprint 2020/1392's secure inference), 10
     intervals [100i, 100i + 50], 16,384 masked inputs (one 128 x 128
     activation map) under 64 key pairs from the port's `gen`, each with
     its own r_in and r_out (keygen ms per pair). Each party's batch is
     staged once (each DCF key repeated 20 times on the device, equal to
     the repeated key list staged on the host, both timed) and evaluated
     by `batch_eval_device` as one DCF batch of the p and q' points: K8 = 1
     and K3 = 1 a party batch. Every input and interval must reconstruct
     [p_j <= x <= q_j] + r_out_j mod 2^64, and the first 256 inputs equal
     a `device="cpu"` gate's; batch ms (median and all runs), evaluations
     per second, the device's idle share. Then `mic_bench_shape`: the JAX
     package's `bench_mic` shape (a 2^20 group, 16 keys).
   - `dpf_value_types`: a DPF key pair over 2^20 with
     `IntModNType(32, 4294967291)` (one block a leaf, 20 tree levels,
     hashed at the expansion's exit) and with `TupleType([IntType(32),
     IntModNType(32, 4294967291)])` (two blocks a leaf: the expansion
     exits with the seeds and one K3 launch hashes both blocks; tail mode
     runs K6 and K2 without K5), `evaluate_until(0, [], ctx)` in every
     mode with the launches `expansion_launches` derives: card equal to
     the plain versions and the modes to one another, the shares summing
     to beta at alpha and 0 elsewhere in each element's group;
     `evaluate_at` at 1,024 points equal to the full domain there; ms
     per evaluation beside the IntType(64) line's. Then
     `int_mod_n_sample`: 2^20 blocks sampled as `IntModNType(32,
     1000003)` on the card (`bench_int_mod_n`'s shape), equal to the
     host face, in ms.
   Every call's values in these phases must also equal the plain
   versions' (a `device="cpu"` DPF, DCF or gate, in the same expansion
   mode) on the same keys and points: off alpha's path both parties hold
   the same seeds, so a kernel error they share would still reconstruct.
7. Dense PIR's other inner product and its serving tiers (the kernel
   lines and the probe print after phase 3's, `main_path_v1` after phase
   5's, the tiers after phase 6), the paths each run with every launch
   count set to 0 just before it and checked just after:
   - `kernel` lines for K7 `xor_counts` (the v1 inner product's counts, at
     the main path's shape), K1's accumulate entry (one streaming chunk:
     2^17 records, 1,024 queries; two half spans XORed in must equal one
     whole call) and K9 `repeat_tiles` (the probe's [1, 2] x 2 and a
     [256, 128] source x 32), each `torch.equal` to its plain version,
     with registers and spills; K1, K7 and the accumulate entry also time
     `torch._int_mm` and `torch.mm` in bf16 with float32 out on the
     unpacked 0/1 operands (`library_ms` the faster; the unpacking
     apart), whose counts must agree and equal K7's, and whose parity
     must equal K1's; K9's `library_ms` is `x.repeat(1, factor)`. K1, K7
     and the accumulate entry are one count product on the tensor cores'
     single-bit path: their bound is the larger of their bytes and their
     operations at the single-bit rate (`B1_OPS_PER_S`), and each line
     gives `bound_share` (bound over device time), the int8 rate it
     reached (`int8_ops_per_s`) and its share of the int8 product's time
     (`int8_bound_ms`, 0.278 ms at both shapes; `int8_bound_share`);
   - `count_product_edges`: K1, K7 and the accumulate entry at ragged
     shapes (every nq in {1, 5, 12, 33, 136, 1,024}, G in {1, 7, 136,
     200, 4,096}, W in {1, 5, 8, 33, 64}), all ones (counts of 32G), no
     selection, a zero database, one set bit at value bit 0 or 31 of the
     first and the last record, and two strided group spans accumulated
     into non-zero results, each `torch.equal` to the plain versions;
   - `kernel` lines at the tiers' shapes (configs[2], 32 word columns of
     keys): K4's head and tail for the materialized tier's 15 levels and
     for one streaming or chunked chunk's 10 levels from one node's 32
     columns, and for the DPF full domain's 14 plane levels (configs[0],
     one key word), K2 at every width from 32 to 32,768 columns (the
     streaming cut state's 5 levels, marked `streaming_cut`, and the
     materialized tier's middle levels), each `torch.equal` to its plain
     version;
   - `kernel` lines for `leaf_blocks` (the leaf values out of plane
     layout into selection blocks, in the expansion's exit order, with the
     cached block -> node map the serving paths pass: at the main path's
     8,192 blocks in the walk plan's order and in the level plan's
     bit-reversed one, the materialized tier's 32,768 and one chunk's
     1,024), each `torch.equal` to its plain version, with registers and
     spills;
   - `probe`: `interpret_repeat_tiles` on the card (one K9 launch) says
     the kernel tiles like Mosaic;
   - `main_path_v1`: the main path's database built with
     `inner_product="v1"`, both parties served in the default mode: every
     record reconstructs, K4 = 4 and K7 = 2 launches, no K1;
   - `staging` for configs[2]'s image (`stage_and_measure`): the
     pipelined staging (`pir/database.py:stage_bitmajor`, 8 slabs) and
     the one-copy staging it replaced, on the same image in turns
     (pipelined, one-copy, one-copy, pipelined): ms, `db_staging`
     copies, syncs, `overlapped_ms` and peak bytes each; gates: equal
     bit for bit, copies > syncs, `overlapped_ms` > 0, peak under 1.5x
     the staging;
   - `tier` x4 at `BASELINE.json` configs[2] (2^22 x 256 B records, 1,024
     queries): `materialized` at the card's default budget, `streaming`
     under a 64 MiB selection budget (`CapacityModel(selection_budget=64
     << 20)` through `set_default_capacity_model`) and `chunked` under
     the same budget with `set_tier_floor("chunked")`. Each prints the
     planner's plan; the streaming and chunked responses must equal the
     materialized tier's and reconstruct every queried record, with the
     launch counts the plan gives (K1 = 2 x chunks; on the chunked tier
     one K8 walk a chunk); q/s, the device's
     idle share, and the modeled against the measured peak bytes
     (`torch.cuda.max_memory_allocated` around one party's batch), with
     the bytes of that batch's staged keys and response rows, which the
     model does not count, measured beside them; then the materialized
     tier once more in tail mode (`expansion="tail"`: K6, K2 for the
     middle levels, K5), its responses equal to the first run's, its
     launches from the plan, its peak under the same gate.
   Then sparse PIR (its own generator), each run with every launch count
   set to 0 just before it and checked just after:
   - `sparse_small`: 3,000 keys (4,500 buckets, 36 selection blocks under
     a covering tree of 64), 40 queries with 8 absent keys: in every
     expansion mode and on every tier (forced with the tier floor), the
     card's responses equal a `device="cpu"` server's, every present key
     resolves to its value and every absent key to None;
   - `sparse` x6: `BASELINE.json` configs[4] on one card, the JAX
     package's `bench_sparse_big` shape: 2^24 keys `b"k%012d" % i` with
     16-byte values from `default_rng(13)`, `generate_params(2**24,
     seed=b"0123456789abcdef")` (25,165,824 buckets, 3 SHA256 hashes,
     196,608 selection blocks: 18 expansion levels, no host walk), built
     through the builder (`build_s`; the SHA256 hashing, the native build
     of the slot array and the packing of the bucket rows timed again
     alone, the staging, with its `staging` line as configs[2]'s), one
     dense staging of 32-byte bucket rows (key words, then value words). Batches of 64 and 128 queries (8 absent
     each) in walk mode on the planner's tier at the default budget, then
     streaming and chunked under a 64 MiB budget with the tier floor: the
     launches the plan gives, every present key resolved, every absent
     key None, the tiers' bytes equal to the default tier's, the peak of
     one party's batch within the model plus its staged keys, response
     rows (at the bucket row's width), index vectors and 2 MiB of the
     caching allocator's granularity; ms, q/s and the device's idle share;
   - `sparse_two_party`: a Leader and a Helper over that database, the
     client built from `get_public_params()` bytes, 128 queries through
     the hybrid-encrypted Helper leg and the one-time pad: every value
     resolves and every absent key is `KeyNotFound`; round-trip ms by
     step and q/s;
   - `sparse_serving` (`sparse_serving_phase`): sparse Leader and
     Helper sessions over TCP on that database and a replica, 64
     one-lookup clients, then a 4,096-upsert write batch rotated in
     under traffic as a delta of the touched bucket rows (the card's
     allocated bytes, after the drain, moved as the stagings held
     moved, within 2 MiB); `sparse_probe`:
     the prober's `sparse_kv` and `sparse_absent` on the Leader, `ok`
     before the rotation and after it with the goldens rotated.
   Then private heavy hitters (its own generator), each party's launches
   counted on its own aggregator's stream from just before each run:
   - `hh_small`: the JAX test's 8-bit config and values, and a 24-bit
     config of 512 clients (`skewed_values`): every round's shares and
     each party's cut states on the card equal `device="cpu"` servers',
     unchunked and under a budget of two prefixes a chunk, each level
     also from the root; each party's K8 and K3 launches equal its level
     plans; the result equals `plaintext_heavy_hitters`;
   - `heavy_hitters`: 65,536 reports of the JAX heavy-hitters bench's
     population (`skewed_values(65536, 64, seed=13)`, copied) over 64-bit
     values, 4-bit rounds, threshold 32, 32-bit counts, made by the
     port's client in 8 spawned worker processes (keygen s, and each
     worker's report and packing ms a pair), each party's keys staged
     once (staging s); the Helper behind a `FramedTcpServer` on loopback,
     the Leader over `TcpTransport`, each party on its own CUDA stream at
     the card's default frontier budget. Gates: the four hot values with
     their counts and nothing else, the frontier widths 16, 256, 4,096,
     then 64 x 13, each party's K8 and K3 launches equal to its level
     plans, and the widest level of one party alone within its modeled
     chunk peak plus the level's cut states (counted exactly) and 2 MiB.
     The line gives sweep s, each round's ms, lanes/s, the device's idle
     share (the union of kernel intervals of a profiled session), each
     round's host and device ms with the parties one after the other,
     the modeled and measured peak bytes, and the cost ledger's cells.
   Before them, two `kernel` lines at the widest level's chunk shape:
   K8 `path_level` (`mode` `hh_chunk`: 4 levels per seed over the
   chunk's word columns, KW = 2,048) and K3 `value_hash` (`path`
   `hh_chunk`, the chunk's lanes).
8. `{"kernels": [...]}`: every ported kernel with its launches on the
   main path (the run of the mode or path that launches it; K1 from the
   default mode's; K8 from the 1,024-key DCF batch, `ms`/`bound_ms` of its
   31-level walk at 32 word columns; K7 from `main_path_v1`, the accumulate
   entry from `streaming`, K9 from `probe`, `leaf_blocks` from the default
   mode's), its agreement, times (`ms` and `device_ms`) and bound.
9. `{"ok": true, "device": {...}}` as the last line.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20260
NUM_RECORDS = 1 << 20
RECORD_BYTES = 256
NUM_QUERIES = 128
# BASELINE.json configs[2] (its record size is the repo's bench default,
# bench.py:102), and the selection budget that sends it to the streaming
# and chunked tiers (64 MiB against the 512 MiB selection matrix).
TIER_RECORDS = 1 << 22
TIER_QUERIES = 1024
TIER_BUDGET = 64 << 20
# The chunk levels and the cut (the streaming tier's K2 levels before its
# scan, the chunked tier's path bits) of both 64 MiB plans (the tier phase
# checks its plans against them): the kernel lines at the tiers' shapes
# use them.
TIER_CHUNK_LEVELS = 10
TIER_CUT_LEVELS = 5
# int8 tensor-core rate of an H100 SXM (dense, at 700 W): the rate of a
# count product of 0/1 operands as int8 (K1, its accumulate entry, K7).
INT8_OPS_PER_S = 1.979e15
# The single-bit tensor-core rate (an AND and a count per bit pair), the
# count product's bound. NVIDIA publishes none for Hopper;
# `tools/torch_b1_mma_probe.py` measured it on an H100 80GB HBM3 at 700 W:
# `wgmma.m64n256k256.b1` 1.557e16-1.572e16 (its int8 `wgmma` control
# 1.961e15, 0.99 of the published peak), `mma.sync.m16n8k256.b1`
# 1.028e16. The faster form, the one the kernel issues, sets the bound.
B1_OPS_PER_S = 1.572e16
# HBM rate of the card (bytes/s), by product name; INT32 logic rate is
# reckoned from the SM count and the max SM clock nvidia-smi reports.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
INT32_LANES_PER_SM = 64
# The fewest two-input gates that compute the AES S-box (Boyar and
# Peralta, "A depth-16 circuit for the AES S-box", 2012: 113 gates) and
# one MixColumns column (Maximov, "AES MixColumn with 92 XOR gates",
# IACR ePrint 2019/833). The bounds count these, not the port's own
# circuits, so that they hold for any bitsliced AES.
SBOX_GATES = 113
MIXCOLUMN_XORS = 92
# Cycles of the device-side sleep that `kernel_time_ms` queues first
# (~25 ms at 2 GHz): longer than the host takes to dispatch 20 launches.
SLEEP_CYCLES = 50_000_000
# Threads a word column's AES takes in K4 and K8 (`kGroup`,
# csrc/split_aes.cuh), and the levels of the walk that times one level.
SPLIT_GROUP = 16
LATENCY_LEVELS = 256
# Rounds of each host step the two-party phase times (the median is kept).
TWO_PARTY_REPS = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms): the device stream's
    time for the whole call, host dispatch gaps included (the plain
    versions, whose thousands of small ops keep the card waiting on the
    host)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_time_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Device time of one launch (ms): `reps` launches queued behind a
    device-side sleep, so the host's dispatch runs ahead of the card and
    the events between them see the kernels alone, back to back; the
    median over `rounds`."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def require_equal(name, got, want) -> int:
    import torch

    if isinstance(got, tuple):
        for g, w in zip(got, want):
            require_equal(name, g, w)
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs_err(got, want)


def aes_word_ops(key) -> int:
    """The fewest 32-bit word operations of one bitsliced AES-128 on one
    32-lane column, in published two-input gates: 160 S-boxes of
    `SBOX_GATES`, 9 x 4 MixColumns columns of `MIXCOLUMN_XORS`, and the
    AddRoundKeys. With a fixed key (index 0, 1, 2) that is one NOT per set
    round-key bit (a clear bit costs nothing); with the select-key
    AddRoundKey of K4 and K8 (`"select"`: left key where a lane's select
    bit is 0, right key where it is 1) one operation per bit set in
    either key (an XOR with the select word or its complement, or a
    NOT)."""
    from distributed_point_functions_tpu_torch.ops import sbox_codegen
    from distributed_point_functions_tpu_torch.ops.aes_bitslice import _rk_bits

    if key == "select":
        bits = _rk_bits(sbox_codegen.ROUND_KEYS[0][1]) | _rk_bits(sbox_codegen.ROUND_KEYS[1][1])
    else:
        bits = _rk_bits(sbox_codegen.ROUND_KEYS[key][1])
    return 160 * SBOX_GATES + 36 * MIXCOLUMN_XORS + int(bits.sum())


# One AES-128 per thread with the key fixed at compile time (or the
# select-key AddRoundKey of K4 and K8, its select word read from memory),
# its ten rounds written out in a row (no loop, so each instruction in the
# SASS runs once), and the round keys' NOTs free to fold into the
# three-input LOP3 instructions around them: the fewest instructions the
# compiler finds for the port's circuit (the kernels keep the rounds in a
# loop).
def aes_probe_source(key) -> str:
    ark = ("add_round_key_select(s, sel, {})" if key == "select"
           else f"add_round_key(s, {key}, {{}})")
    rounds = "\n".join(
        f"  sub_bytes(s); {'shift_rows_mix_columns' if rnd < 10 else 'shift_rows'}(s);"
        f" {ark.format(rnd)};"
        for rnd in range(1, 11))
    load_sel = ("  const uint32_t sel = in[128 * blockDim.x + threadIdx.x];\n"
                if key == "select" else "")
    return f"""#include "aes_generated.cuh"
extern "C" __global__ void aes_probe(const uint32_t* in, uint32_t* out) {{
  uint32_t s[128];
{load_sel}#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = in[p * blockDim.x + threadIdx.x];
  {ark.format(0)};
{rounds}
#pragma unroll
  for (int p = 0; p < 128; ++p) out[p * blockDim.x + threadIdx.x] = s[p];
}}
"""


PROBE_KEYS = (0, 1, 2, "select")  # kKeyLeft, kKeyRight, kKeyValue, select-key


def start_aes_probe(cuda_lib, work: Path) -> list:
    """Start one nvcc per key, compiling `aes_probe_source` to a cubin in
    `work`."""
    procs = []
    for key in PROBE_KEYS:
        (work / f"aes_probe{key}.cu").write_text(aes_probe_source(key))
        procs.append(subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.ARCH, "-O3", "-std=c++17", "-cubin",
             "-I", str(cuda_lib.CSRC), str(work / f"aes_probe{key}.cu"),
             "-o", str(work / f"aes_probe{key}.cubin")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def sass_counts(sass: str) -> tuple:
    """(LOP3, all, branch) instructions in a `cuobjdump -sass` listing."""
    lop3 = total = branches = 0
    for line in sass.splitlines():
        if not (line.strip().startswith("/*") and "*/" in line):
            continue
        op = line.split("*/", 1)[1].split()
        if op and op[0].startswith("@"):
            op = op[1:]  # a predicate
        if op and not op[0].startswith("/*"):
            total += 1
            lop3 += op[0].startswith("LOP3")
            branches += op[0].startswith("BRA")
    return lop3, total, branches


def aes_sass_ops(cuda_lib, work: Path, procs) -> dict:
    """{key index: (LOP3 instructions, all instructions)} of one AES in
    the probe's SASS (`cuobjdump -sass`)."""
    cuobjdump = str(Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    counts = {}
    for key, proc in zip(PROBE_KEYS, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the AES probe:\n{out[-4000:]}")
        sass = subprocess.run(
            [cuobjdump, "-sass", str(work / f"aes_probe{key}.cubin")],
            capture_output=True, text=True, check=True).stdout
        lop3, total, branches = sass_counts(sass)
        # One BRA is the self-loop after EXIT; more would be a loop, whose
        # body the static count would under-count.
        if branches > 1 or lop3 == 0:
            raise RuntimeError(f"AES probe {key}: {branches} branches, {lop3} LOP3")
        counts[key] = (lop3, total)
    return counts


DCF_LDS = 32
DCF_BATCHES = (1024, 256)
FD_LDS = 20
HIERARCHY = (8, 14, 20)
PREFIXES = 64
POINTS = 1024
# The MIC gate: the Z_2^64 ring of eprint 2020/1392's secure inference, the
# JAX package's `bench_mic` big shape (10 intervals [100i, 100i + 50]),
# one 128 x 128 activation map of masked inputs, 64 distinct key pairs;
# and the JAX benchmark's own shape (a 2^20 group, 16 keys).
MIC_LGS = 64
MIC_INTERVALS = 10
MIC_INPUTS = 128 * 128
MIC_KEYS = 64
MIC_PLAIN_CHECK = 256
MIC_BENCH_LGS = 20
MIC_BENCH_KEYS = 16
# The sampled value types through the DPF (the JAX package's test zoo) and
# `bench_int_mod_n`'s sampling shape.
P32 = 4294967291
INT_MOD_N_SAMPLES = 1 << 20
INT_MOD_N_MODULUS = 1000003
# Sparse PIR (BASELINE.json configs[4] on one card; the JAX package's
# benchmarks/baseline_suite.py:156-212): 2^24 keys "k%012d", 16-byte values
# from default_rng(13), the cuckoo seed below, batches of 64 and 128
# queries with some absent keys; `sparse_small` at 3,000 keys.
SPARSE_KEYS = 1 << 24
SPARSE_SMALL_KEYS = 3000
SPARSE_VALUE_BYTES = 16
SPARSE_SEED = b"0123456789abcdef"
SPARSE_QUERIES = (64, 128)
SPARSE_ABSENT = 8  # absent keys in every batch
SPARSE_REPS = 5


def as_u64(shares):
    """int32[n, 2] limbs -> int64[n] holding the uint64's bits (sums of
    these wrap mod 2^64, as the shares do)."""
    import torch

    return ((shares[:, 0].to(torch.int64) & 0xFFFFFFFF)
            | (shares[:, 1].to(torch.int64) << 32))


def host_ms(fn, reps: int) -> list:
    """Host-clock times (ms) of `reps` calls, each ended by a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_busy(fn) -> dict:
    """One call under torch.profiler: its wall and device-busy ms, the
    device's idle share, the operations that took the most host time
    (name, calls, self host ms, device ms) and those that took the most
    device time (name, calls, self device ms)."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    averages = prof.key_averages()
    top = sorted(averages, key=lambda a: -a.self_cpu_time_total)[:8]
    top_device = sorted(averages, key=lambda a: -a.self_device_time_total)[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_host_ops": [[a.key, a.count, a.self_cpu_time_total / 1e3,
                              a.device_time_total / 1e3] for a in top],
            "top_device_ops": [[a.key, a.count, a.self_device_time_total / 1e3]
                               for a in top_device]}


def counted(fn, want: dict, what: str) -> dict:
    """Run `fn` with every launch count set to 0 just before it; the counts
    just after must be `want` (0 for every kernel it does not name)."""
    import torch

    from distributed_point_functions_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    got = dict(cuda_lib.LAUNCHES)
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, expected {want}")
    return got


def dcf_phase(rng, dev) -> dict:
    """BASELINE.json configs[3], the DCF benchmark's shape: 2^32 domain,
    IntType(64), batches of 1,024 and 256 keys (one key pair, the parties
    alternating, as the JAX package's benchmark does) at as many random
    points. Each point is evaluated with both parties' keys (the batch,
    then a batch with the parties swapped), and every pair of shares must
    reconstruct beta * [x < alpha] mod 2^64. A batch walks 31 tree levels
    in one K8 launch (32 stops, one a hierarchy level) and hashes the stops
    in one K3 launch. Returns the 1,024-key batch's launch counts."""
    import torch

    from distributed_point_functions_tpu_torch.dcf import DistributedComparisonFunction
    from distributed_point_functions_tpu_torch.value_types import IntType

    dcf = DistributedComparisonFunction.create(DCF_LDS, IntType(64))
    cpu = DistributedComparisonFunction.create(DCF_LDS, IntType(64), device="cpu")
    alpha = int(rng.integers(1, (1 << DCF_LDS) - 1))
    beta = int(rng.integers(1, 1 << 63))
    t0 = time.perf_counter()
    k0, k1 = dcf.generate_keys(alpha, beta)
    keygen_s = time.perf_counter() - t0
    first = None
    for batch in DCF_BATCHES:
        xs = [int(x) for x in rng.integers(0, 1 << DCF_LDS, batch)]
        xs[:3] = [alpha - 1, alpha, alpha + 1]
        keys = [(k0, k1)[i % 2] for i in range(batch)]
        swapped_keys = [(k1, k0)[i % 2] for i in range(batch)]
        t0 = time.perf_counter()
        staged = dcf.stage_keys(keys)
        torch.cuda.synchronize()
        stage_ms = (time.perf_counter() - t0) * 1e3
        swapped = dcf.stage_keys(swapped_keys)
        run = lambda: dcf.batch_evaluate(None, xs, staged=staged)  # noqa: E731
        run()  # warm-up
        out = []
        launches = counted(lambda: out.append(run()),
                           {"path_level": 1, "value_hash": 1},
                           f"dcf {batch} keys")
        shares = (out[0], dcf.batch_evaluate(None, xs, staged=swapped))
        # The card against the plain versions on the host, on the same
        # keys and points: a wrong kernel whose error both parties share
        # would still reconstruct.
        for got, ks in zip(shares, (keys, swapped_keys)):
            if not torch.equal(got.cpu(), cpu.batch_evaluate(ks, xs)):
                raise AssertionError(f"dcf {batch} keys: card and plain shares differ")
        total = as_u64(shares[0]) + as_u64(shares[1])
        want = torch.tensor([beta if x < alpha else 0 for x in xs],
                            dtype=torch.int64, device=dev)
        if not torch.equal(total, want):
            raise AssertionError(f"dcf {batch} keys: shares do not reconstruct")
        times = host_ms(run, 15)
        batch_ms = statistics.median(times)
        emit({"phase": "dcf", "log_domain_size": DCF_LDS, "value_type": "IntType(64)",
              "keys": batch, "points": batch, "reconstructed": batch,
              "card_equals_plain": True, "launches": launches, "keygen_s": keygen_s,
              "stage_ms": stage_ms, "batch_ms": batch_ms, "batch_ms_all": times,
              "evaluations_per_sec": batch / batch_ms * 1e3, **device_busy(run)})
        first = first or launches
    return first


def expansion_launches(mode: str, levels: int, columns: int = 1,
                       hashed: bool = True) -> dict:
    """Launches of one key's plane expansion over `levels` levels from
    `columns` word columns (`dense_eval_planes.expand_planned`). A level
    whose leaves take more than one block (`hashed=False`) leaves the
    expansion as seeds (K4's tail without its hash; tail mode without K5)
    and hashes them in one K3 launch."""
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import expansion_plan

    tail_levels = {"tail_levels": 0} if mode == "tail" and not hashed else {}
    head, tail, _ = expansion_plan(mode, columns, levels, **tail_levels)
    head_k, tail_k = (("walk_descend", "walk_descend") if mode == "walk"
                      else ("expand_head", "expand_tail"))
    out = {}
    if head:
        out[head_k] = 1
    if levels - head - tail:
        out["expand_level"] = levels - head - tail
    if tail:
        out[tail_k] = out.get(tail_k, 0) + 1
    if not tail or not hashed:
        out["value_hash"] = 1
    return out


def with_expansion(dpf, mode):
    """`dpf` with its subtree expansion in `mode` (a private hook of the
    port's DPF: its users get the default)."""
    dpf._expansion = mode
    return dpf


def dpf_full_domain_phase(rng, dev) -> dict:
    """BASELINE.json configs[0]: one DPF key pair over 2^20, IntType(64),
    full-domain `evaluate_until`: 19 tree levels (5 on the host, 14 in
    plane layout), 2^19 leaves, 2^20 values per party. In each expansion
    mode: the shares must equal the mode's plain versions on the host and
    the other modes', and the two parties' shares must sum to beta at
    alpha and to 0 elsewhere."""
    import torch

    from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import EXPANSION_MODES
    from distributed_point_functions_tpu_torch.value_types import IntType

    params = DpfParameters(FD_LDS, IntType(64))
    alpha = int(rng.integers(0, 1 << FD_LDS))
    beta = int(rng.integers(1, 1 << 63))
    dpfs = {m: with_expansion(DistributedPointFunction.create(params), m)
            for m in EXPANSION_MODES}
    keys = dpfs["walk"].generate_keys(alpha, beta)
    plane_levels = dpfs["walk"]._hierarchy_to_tree[0] - 5
    shares, ms_per_mode = {}, {}
    for mode, dpf in dpfs.items():
        def run(k, dpf=dpf):
            return dpf.evaluate_until(0, [], dpf.create_evaluation_context(k))

        run(keys[0])  # warm-up
        out = []
        want = {k: 2 * v for k, v in expansion_launches(mode, plane_levels).items()}
        launches = counted(lambda: out.extend(run(k) for k in keys), want,
                           f"dpf full domain ({mode})")
        # The mode's plain versions on the host, on the same keys.
        cpu = with_expansion(DistributedPointFunction.create(params, device="cpu"), mode)
        for k, got in zip(keys, out):
            if not torch.equal(got.cpu(), cpu.evaluate_until(0, [], cpu.create_evaluation_context(k))):
                raise AssertionError(f"dpf full domain ({mode}): card and plain values differ")
        total = as_u64(out[0]) + as_u64(out[1])
        nonzero = total.nonzero().flatten().tolist()
        if out[0].shape != (1 << FD_LDS, 2) or nonzero != [alpha] or int(total[alpha]) != beta:
            raise AssertionError(f"dpf full domain ({mode}): shares do not reconstruct")
        shares[mode] = out
        times = host_ms(lambda: run(keys[0]), 7)
        ms = ms_per_mode[mode] = statistics.median(times)
        emit({"phase": "dpf_full_domain", "expansion": mode, "log_domain_size": FD_LDS,
              "value_type": "IntType(64)", "values": 1 << FD_LDS, "reconstructed": True,
              "card_equals_plain": True, "launches": launches, "ms_per_evaluation": ms, "ms_all": times,
              "ns_per_value": ms * 1e6 / (1 << FD_LDS), **device_busy(lambda: run(keys[0]))})
    for mode in EXPANSION_MODES:
        if not all(torch.equal(a, b) for a, b in zip(shares[mode], shares["walk"])):
            raise AssertionError(f"dpf full domain: {mode} differs from walk")
    return {"dpf": dpfs["walk"], "keys": keys, "alpha": alpha, "beta": beta,
            "shares": shares["walk"], "ms": ms_per_mode}


def dpf_point_phase(rng, dev, full: dict) -> None:
    """Point and resumed hierarchical evaluation. `evaluate_at` at 1,024
    points of the full-domain key (no context: K8 in shared mode, one
    launch of 19 levels a party) must equal its full-domain values there. An
    incremental DPF over (8, 14, 20) with the same alpha is evaluated with
    `evaluate_next`, 64 prefixes per level after the first (resumed
    through K8 from the context); its last level must equal its own
    full-domain evaluation at those points, and every level's shares must
    reconstruct. Then one `evaluate_next` at 40 prefixes, not a multiple
    of 32: its first 2 expansion levels walk on the card (K8, one launch
    besides the resumed walk's) until 160 lanes fill whole words. Every
    call's values must equal the plain versions' on the host for the same
    keys and prefixes."""
    import torch

    from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
    from distributed_point_functions_tpu_torch.value_types import IntType

    dpf, keys, alpha = full["dpf"], full["keys"], full["alpha"]
    tree = dpf._hierarchy_to_tree[0]
    pts = [int(x) for x in rng.integers(0, 1 << FD_LDS, POINTS)]
    pts[:2] = [alpha, alpha ^ 1]
    dpf.evaluate_at(keys[0], 0, pts)  # warm-up
    out = []
    at_launches = counted(lambda: out.extend(dpf.evaluate_at(k, 0, pts) for k in keys),
                          {"path_level": 2, "value_hash": 2}, "evaluate_at")
    cpu = DistributedPointFunction.create(dpf.parameters[0], device="cpu")
    idx = torch.tensor(pts, device=dev)
    for got, want, k in zip(out, full["shares"], keys):
        if not torch.equal(got, want[idx]):
            raise AssertionError("evaluate_at differs from the full-domain values")
        if not torch.equal(got.cpu(), cpu.evaluate_at(k, 0, pts)):
            raise AssertionError("evaluate_at: card and plain values differ")
    at_times = host_ms(lambda: dpf.evaluate_at(keys[0], 0, pts), 15)
    at_profile = device_busy(lambda: dpf.evaluate_at(keys[0], 0, pts))

    params = [DpfParameters(lds, IntType(64)) for lds in HIERARCHY]
    inc = DistributedPointFunction.create_incremental(params)
    inc_cpu = DistributedPointFunction.create_incremental(params, device="cpu")
    betas = [int(b) for b in rng.integers(1, 1 << 63, len(HIERARCHY))]
    ikeys = inc.generate_keys_incremental(alpha, betas)
    whole = [inc.evaluate_until(len(HIERARCHY) - 1, [], inc.create_evaluation_context(k))
             for k in ikeys]

    def pick(nodes, count, mine):
        picked = [nodes[i] for i in rng.choice(len(nodes), count, replace=False)]
        if mine not in picked:
            picked[0] = mine
        return picked

    # Each IntType(64) tree node holds two domain points, so the prefixes
    # are drawn as 64 distinct tree nodes (alpha's among them) with a
    # random point of each: 64 lanes of K8 walk.
    steps = [[]]
    for hl in range(len(HIERARCHY) - 1):
        lds = HIERARCHY[hl]
        if hl:  # the tree nodes below the last step's prefixes
            per = 1 << (lds - HIERARCHY[hl - 1] - 1)
            nodes = [q * per + j for q in steps[-1] for j in range(per)]
        else:
            nodes = list(range(1 << (lds - 1)))
        mine = alpha >> (FD_LDS - lds + 1)
        picked = pick(nodes, PREFIXES, mine)
        steps.append([2 * t + int(rng.integers(0, 2)) for t in picked])
        steps[-1][picked.index(mine)] = alpha >> (FD_LDS - lds)
    walk_levels = [0, inc._hierarchy_to_tree[0],
                   inc._hierarchy_to_tree[1] - inc._hierarchy_to_tree[0]]
    ctxs = [inc.create_evaluation_context(k) for k in ikeys]
    cpu_ctxs = [inc_cpu.create_evaluation_context(k) for k in ikeys]

    def check_level(what, hl, prefixes, out, cpu_ctxs):
        lds = HIERARCHY[hl]
        span = 1 << (lds - (HIERARCHY[hl - 1] if hl else 0))
        points = ([p * span + j for p in prefixes for j in range(span)] if hl
                  else list(range(span)))
        for got, c in zip(out, cpu_ctxs):
            if not torch.equal(got.cpu(), inc_cpu.evaluate_next(prefixes, c)):
                raise AssertionError(f"{what}: card and plain values differ")
        total = as_u64(out[0]) + as_u64(out[1])
        expect = torch.tensor([betas[hl] if p == alpha >> (FD_LDS - lds) else 0
                               for p in points], dtype=torch.int64, device=dev)
        if not torch.equal(total, expect):
            raise AssertionError(f"{what}: shares do not reconstruct")
        return points

    levels = []
    for hl, prefixes in enumerate(steps):
        expand = inc._hierarchy_to_tree[hl] - (inc._hierarchy_to_tree[hl - 1] if hl else 5)
        want = {k: 2 * v for k, v in expansion_launches(
            "walk", expand, len(prefixes) // 32 if hl else 1).items()}
        if walk_levels[hl]:
            want["path_level"] = 2  # one walk a party
        out = []
        launches = counted(lambda: out.extend(inc.evaluate_next(prefixes, c) for c in ctxs),
                           want, f"evaluate_next level {hl}")
        points = check_level(f"evaluate_next level {hl}", hl, prefixes, out, cpu_ctxs)
        levels.append({"hierarchy_level": hl, "log_domain_size": HIERARCHY[hl],
                       "prefixes": len(prefixes), "values": len(points),
                       "launches": launches})
    idx = torch.tensor(points, device=dev)
    if not all(torch.equal(got, w[idx]) for got, w in zip(out, whole)):
        raise AssertionError("evaluate_next differs from the full-domain values")

    # 40 prefixes of level 1 (40 tree nodes): 2 narrow levels on K8 (40 ->
    # 160 lanes), then 4 plane levels from 5 word columns.
    mine = alpha >> (FD_LDS - HIERARCHY[0] + 1)
    nodes = pick(list(range(1 << (HIERARCHY[0] - 1))), 40, mine)
    narrow = [2 * t + int(rng.integers(0, 2)) for t in nodes]
    narrow[nodes.index(mine)] = alpha >> (FD_LDS - HIERARCHY[0])
    ctxs = [inc.create_evaluation_context(k) for k in ikeys]
    cpu_ctxs = [inc_cpu.create_evaluation_context(k) for k in ikeys]
    for c, c_cpu in zip(ctxs, cpu_ctxs):
        inc.evaluate_next([], c)
        inc_cpu.evaluate_next([], c_cpu)
    expand = inc._hierarchy_to_tree[1] - inc._hierarchy_to_tree[0] - 2
    want = {k: 2 * v for k, v in expansion_launches("walk", expand, 5).items()}
    want["path_level"] = 2 * 2  # a party: the resumed walk and the narrow levels
    out = []
    narrow_launches = counted(lambda: out.extend(inc.evaluate_next(narrow, c) for c in ctxs),
                              want, "evaluate_next at 40 prefixes")
    check_level("evaluate_next at 40 prefixes", 1, narrow, out, cpu_ctxs)

    def chain():
        ctx = inc.create_evaluation_context(ikeys[0])
        for prefixes in steps:
            inc.evaluate_next(prefixes, ctx)

    chain_times = host_ms(chain, 7)
    emit({"phase": "dpf_point", "log_domain_size": FD_LDS, "value_type": "IntType(64)",
          "points": POINTS, "equals_full_domain": True, "card_equals_plain": True,
          "launches": at_launches,
          "evaluate_at_ms": statistics.median(at_times), "evaluate_at_ms_all": at_times,
          "points_per_sec": POINTS / statistics.median(at_times) * 1e3,
          "evaluate_at_profile": at_profile,
          "hierarchy": list(HIERARCHY), "evaluate_next": levels,
          "evaluate_next_equals_full_domain": True,
          "evaluate_next_40_prefixes": {"launches": narrow_launches, "narrow_levels": 2},
          "evaluate_next_chain_ms": statistics.median(chain_times),
          "evaluate_next_chain_ms_all": chain_times})


def mic_phase(rng, dev) -> dict:
    """The MIC gate on the card at log_group_size 64 (MIC_* above): 64
    key pairs from the port's `gen`, each with its own r_in and r_out
    (keygen timed per pair); 16,384 masked inputs, input i = (plain_i +
    r_in) mod 2^64 under pair i mod 64 for uniform plain_i. Each party's
    batch is staged once (`stage_keys`: each DCF key staged, then repeated
    2 x 10 times on the device, which must equal the repeated key list
    staged on the host, timed beside it) and evaluated by
    `batch_eval_device`: one DCF batch of 327,680 points, so one K8 walk of
    63 levels with 64 stops and one K3 launch a party batch. Both parties'
    shares must sum to [p_j <= plain_i <= q_j] + r_out_j mod 2^64 for every
    input and interval, and each party's first 256 inputs must equal a
    `device="cpu"` gate's on the same keys and points. Then the JAX
    package's `bench_mic` shape (a 2^20 group, 16 keys at inputs 0-15)
    through `batch_eval` and `batch_eval_device`. Returns the launches."""
    import torch

    from distributed_point_functions_tpu_torch.fss_gates import (
        Interval,
        MicParameters,
        MultipleIntervalContainmentGate,
    )
    from distributed_point_functions_tpu_torch.ops.words import to_numpy

    ni = MIC_INTERVALS

    def gate_of(lgs, device):
        return MultipleIntervalContainmentGate.create(MicParameters(
            lgs, [Interval(100 * i, 100 * i + 50) for i in range(ni)]), device=device)

    gate, cpu = gate_of(MIC_LGS, dev), gate_of(MIC_LGS, "cpu")
    top = (1 << MIC_LGS) - 1
    r_in = rng.integers(0, top, MIC_KEYS, dtype=np.uint64, endpoint=True)
    r_out = rng.integers(0, top, (MIC_KEYS, ni), dtype=np.uint64, endpoint=True)
    pairs, keygen_ms = [], []
    for i in range(MIC_KEYS):
        t0 = time.perf_counter()
        pairs.append(gate.gen(int(r_in[i]), [int(r) for r in r_out[i]]))
        keygen_ms.append((time.perf_counter() - t0) * 1e3)
    pair = np.arange(MIC_INPUTS) % MIC_KEYS
    plain = rng.integers(0, top, MIC_INPUTS, dtype=np.uint64, endpoint=True)
    xs = plain + r_in[pair]  # mod 2^64
    keys = [[pairs[j][party] for j in pair] for party in (0, 1)]

    stage_ms, staged = [], []
    for party in (0, 1):
        t0 = time.perf_counter()
        staged.append(gate.stage_keys(keys[party]))
        torch.cuda.synchronize()
        stage_ms.append((time.perf_counter() - t0) * 1e3)
    # The repeat per interval on the device against the repeated key list
    # staged on the host.
    dcf_keys = [k.dcf_key for k in keys[0]]
    base = gate.dcf.stage_keys(dcf_keys)
    repeat_times = host_ms(lambda: base.repeat(2 * ni), 5)
    t0 = time.perf_counter()
    host = gate.dcf.stage_keys([k for k in dcf_keys for _ in range(2 * ni)])
    torch.cuda.synchronize()
    host_repeat_ms = (time.perf_counter() - t0) * 1e3
    repeated = base.repeat(2 * ni)

    def fields(b):
        return [b.parties, b.state, b.ctrl, b.cw_planes, b.cw_left, b.cw_right,
                *b.value_corrections]

    if repeated.n != host.n or not all(
            torch.equal(a, b) for a, b in zip(fields(repeated), fields(host))):
        raise AssertionError("mic: the device repeat differs from the host's staging")
    del base, host, repeated

    def run(party):
        return gate.batch_eval_device(None, xs, staged=staged[party])

    run(0)  # warm-up
    out = []
    launches = counted(lambda: out.extend(run(party) for party in (0, 1)),
                       {"path_level": 2, "value_hash": 2}, "mic")
    limbs = [to_numpy(o) for o in out]
    u64 = [a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))
           for a in limbs]
    lower = np.array([100 * i for i in range(ni)], dtype=np.uint64)
    inside = (plain[:, None] >= lower) & (plain[:, None] <= lower + np.uint64(50))
    want = inside.astype(np.uint64) + r_out[pair]
    agree = (u64[0] + u64[1]) == want
    reconstructed = int(agree.sum())
    if reconstructed != MIC_INPUTS * ni or any(a[..., 2:].any() for a in limbs):
        raise AssertionError(
            f"mic: {reconstructed} of {MIC_INPUTS * ni} shares reconstruct")
    for party in (0, 1):
        plain_shares = cpu.batch_eval_device(keys[party][:MIC_PLAIN_CHECK],
                                             xs[:MIC_PLAIN_CHECK])
        if not torch.equal(out[party][:MIC_PLAIN_CHECK].cpu(), plain_shares):
            raise AssertionError("mic: card and plain shares differ")
    times = host_ms(lambda: run(0), 10)
    batch_ms = statistics.median(times)
    emit({"phase": "mic", "log_group_size": MIC_LGS, "intervals": ni,
          "inputs": MIC_INPUTS, "key_pairs": MIC_KEYS,
          "reconstructed": reconstructed, "of": MIC_INPUTS * ni,
          "card_equals_plain_first": MIC_PLAIN_CHECK, "launches": launches,
          "launches_per_party_batch": {"path_level": 1, "value_hash": 1},
          "keygen_ms_per_pair_median": statistics.median(keygen_ms),
          "keygen_ms_per_pair_all": keygen_ms,
          "stage_ms": stage_ms, "repeat_on_device_ms": statistics.median(repeat_times),
          "repeat_on_device_ms_all": repeat_times,
          "repeated_list_staged_on_host_ms": host_repeat_ms,
          "batch_ms": batch_ms, "batch_ms_all": times,
          "evaluations_per_sec": MIC_INPUTS * ni / batch_ms * 1e3,
          **device_busy(lambda: run(0))})
    del staged, out

    bench = gate_of(MIC_BENCH_LGS, dev)
    k0, _ = bench.gen(7, [0] * ni)
    bench_keys, bench_xs = [k0] * MIC_BENCH_KEYS, list(range(MIC_BENCH_KEYS))
    bench.batch_eval(bench_keys, bench_xs)  # warm-up
    ints = host_ms(lambda: bench.batch_eval(bench_keys, bench_xs), 15)
    dev_times = host_ms(lambda: bench.batch_eval_device(bench_keys, bench_xs), 15)
    emit({"phase": "mic_bench_shape", "log_group_size": MIC_BENCH_LGS, "intervals": ni,
          "keys": MIC_BENCH_KEYS, "batch_eval_ms": statistics.median(ints),
          "batch_eval_ms_all": ints,
          "batch_eval_device_ms": statistics.median(dev_times),
          "batch_eval_device_ms_all": dev_times,
          "evaluations_per_sec": MIC_BENCH_KEYS * ni / statistics.median(ints) * 1e3})
    return launches


def dpf_value_types_phase(rng, dev, full: dict) -> None:
    """The sampled value types through the DPF at configs[0]'s 2^20 domain:
    `IntModNType(32, 4294967291)` (one block a leaf, no packing: 20 tree
    levels, the fused hash at the expansion's exit) and `TupleType([IntType(32),
    IntModNType(32, 4294967291)])` (two blocks a leaf: the expansion exits
    with the leaf seeds, K4's tail without its hash or, in tail mode, K6 and
    K2 without K5, and one K3 launch hashes seed + j for j < 2). Each key
    pair runs `evaluate_until(0, [], ctx)` in every expansion mode with the
    launches `expansion_launches` derives; the card must equal the plain
    versions on the host (both keys in walk mode, party 1's in the others),
    the modes one another, and the parties' shares must sum, element by
    element in each element's group, to beta at alpha and 0 elsewhere.
    `evaluate_at` at 1,024 points (one K8 and one K3 launch a key) must
    equal the full-domain values there. Then `bench_int_mod_n`'s shape:
    2^20 blocks sampled as `IntModNType(32, 1000003)` on the card
    (`dev_from_value_blocks`), equal to the host face's `block % N`."""
    import torch

    from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
    from distributed_point_functions_tpu_torch.ops import aes, limb
    from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import EXPANSION_MODES
    from distributed_point_functions_tpu_torch.value_types import (
        IntModNType,
        IntType,
        TupleType,
        tree_leaves,
        tree_map,
    )

    def equal(a, b) -> bool:
        a, b = tree_leaves(a), tree_leaves(b)
        return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    for label, vt in (("IntModNType(32, 4294967291)", IntModNType(32, P32)),
                      ("TupleType([IntType(32), IntModNType(32, 4294967291)])",
                       TupleType([IntType(32), IntModNType(32, P32)]))):
        params = DpfParameters(FD_LDS, vt)
        dpfs = {m: with_expansion(DistributedPointFunction.create(params, device=dev), m)
                for m in EXPANSION_MODES}
        cpus = {m: with_expansion(DistributedPointFunction.create(params, device="cpu"), m)
                for m in EXPANSION_MODES}
        dpf = dpfs["walk"]
        alpha = int(rng.integers(0, 1 << FD_LDS))
        beta = (int(rng.integers(1, P32)) if isinstance(vt, IntModNType)
                else (int(rng.integers(1, 1 << 32)), int(rng.integers(1, P32))))
        keys = dpf.generate_keys(alpha, beta)
        num_blocks = dpf._blocks_needed[0]
        plane_levels = dpf._hierarchy_to_tree[0] - 5
        shares, ms, launches = {}, {}, {}
        for mode, mode_dpf in dpfs.items():
            def run(k, d=mode_dpf):
                return d.evaluate_until(0, [], d.create_evaluation_context(k))

            run(keys[0])  # warm-up
            out = []
            want = {k: 2 * v for k, v in expansion_launches(
                mode, plane_levels, hashed=num_blocks == 1).items()}
            launches[mode] = counted(lambda: out.extend(run(k) for k in keys), want,
                                     f"dpf_value_types {label} ({mode})")
            cpu = cpus[mode]
            for party in ((0, 1) if mode == "walk" else (1,)):
                plain = cpu.evaluate_until(0, [], cpu.create_evaluation_context(keys[party]))
                if not equal(out[party], plain):
                    raise AssertionError(f"dpf_value_types {label} ({mode}): card and plain differ")
            shares[mode] = out
            times = host_ms(lambda: run(keys[0]), 7)
            ms[mode] = statistics.median(times)
        for mode in EXPANSION_MODES:
            if not all(equal(a, b) for a, b in zip(shares[mode], shares["walk"])):
                raise AssertionError(f"dpf_value_types {label}: {mode} differs from walk")
        total = vt.dev_add(*shares["walk"])
        for got, want in zip(tree_leaves(total), tree_leaves(vt.dev_const(beta, (), dev))):
            nonzero = (got != 0).any(dim=-1).nonzero().flatten().tolist()
            if got.shape[0] != 1 << FD_LDS or nonzero != [alpha] or not torch.equal(got[alpha], want):
                raise AssertionError(f"dpf_value_types {label}: shares do not reconstruct")
        pts = [int(x) for x in rng.integers(0, 1 << FD_LDS, POINTS)]
        pts[:2] = [alpha, alpha ^ 1]
        dpf.evaluate_at(keys[0], 0, pts)  # warm-up
        at = []
        at_launches = counted(lambda: at.extend(dpf.evaluate_at(k, 0, pts) for k in keys),
                              {"path_level": 2, "value_hash": 2},
                              f"dpf_value_types {label} evaluate_at")
        idx = torch.tensor(pts, device=dev)
        for got, whole in zip(at, shares["walk"]):
            if not equal(got, tree_map(lambda x: x[idx], whole)):
                raise AssertionError(f"dpf_value_types {label}: evaluate_at differs")
        if not equal(at[0], cpus["walk"].evaluate_at(keys[0], 0, pts)):
            raise AssertionError(f"dpf_value_types {label}: evaluate_at card and plain differ")
        at_times = host_ms(lambda: dpf.evaluate_at(keys[0], 0, pts), 15)
        emit({"phase": "dpf_value_types", "value_type": label, "log_domain_size": FD_LDS,
              "blocks_per_leaf": num_blocks, "tree_levels": dpf._hierarchy_to_tree[0],
              "hashed_at_exit": num_blocks == 1, "values": 1 << FD_LDS,
              "reconstructed": True, "card_equals_plain": True, "modes_equal": True,
              "launches": launches, "ms_per_evaluation": ms,
              "int64_ms_per_evaluation": full["ms"],
              "evaluate_at_points": POINTS, "evaluate_at_launches": at_launches,
              "evaluate_at_ms": statistics.median(at_times), "evaluate_at_ms_all": at_times,
              **device_busy(lambda: dpfs["walk"].evaluate_until(
                  0, [], dpfs["walk"].create_evaluation_context(keys[0])))})

    vt = IntModNType(32, INT_MOD_N_MODULUS)
    blocks_np = rng.integers(0, 1 << 32, (INT_MOD_N_SAMPLES, 4), dtype=np.uint32)
    blocks = to_tensor(blocks_np, dev)

    def sample():
        return vt.dev_from_value_blocks(blocks[:, None, :])

    host = np.array([v % INT_MOD_N_MODULUS for v in aes.limbs_to_u128s(blocks_np)],
                    dtype=np.uint32)
    if not np.array_equal(to_numpy(sample())[:, 0, 0], host):
        raise AssertionError("int_mod_n sampling: card and host differ")
    emit({"phase": "int_mod_n_sample", "value_type": f"IntModNType(32, {INT_MOD_N_MODULUS})",
          "blocks": INT_MOD_N_SAMPLES, "card_equals_host": True,
          "dev_sample_ms": cuda_time_ms(sample, reps=20),
          "divmod_const_ms": cuda_time_ms(
              lambda: limb.divmod_const(blocks, INT_MOD_N_MODULUS, 4), reps=20)})


def ptxas_table(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "smem"}} from the build's `-Xptxas -v` report."""
    table, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            table[name] = {}
        elif name and "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split() if x.isdigit()]
            table[name]["spill_stores"], table[name]["spill_loads"] = nums[1], nums[2]
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            table[name]["registers"] = int(words[words.index("Used") + 1])
            table[name]["smem"] = (int(words[words.index("smem") - 2])
                                   if "smem" in words else 0)
    return table


def ptxas_of(table: dict, kernel: str) -> dict:
    """The ptxas figures of the first kernel whose mangled name holds
    `kernel`."""
    return next(v for k, v in table.items() if kernel in k)


def leaf_kernel(key_groups: int) -> str:
    """The mangled-name part of the `leaf_blocks` kernel that a KG takes
    (`tile_cols` in csrc/leaf_blocks.cu: 64 word columns a tile from KG =
    32, else 32)."""
    return f"leaf_blocks_kernelILi{64 if key_groups >= 32 else 32}E"


def unpack_operands(db_perm, packed):
    """The 0/1 int8 operands of the count product: selections [nq, 32G]
    and database bits [32G, 32W], records in (b, g) order, columns in
    (j, w) order."""
    import torch

    nq, num_groups = packed.shape
    num_words = db_perm.shape[2]
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    sel = ((packed[:, None, :] >> shifts[None, :, None]) & 1).to(torch.int8)
    rows = db_perm.reshape(-1, num_words)
    bits = torch.empty((rows.shape[0], 32, num_words), dtype=torch.int8,
                       device=packed.device)
    for j in range(32):  # one int32 temporary of the database's size at a time
        bits[:, j] = (rows >> j) & 1
    return sel.reshape(nq, -1), bits.reshape(rows.shape[0], -1)


def count_product_edges(dev) -> dict:
    """K1, its accumulate entry and K7 at the cases of
    `ops/count_product_cases.py` (the card's tests run the same): ragged
    shapes (query, group and word counts off the kernel's tiles), the
    extremes (all ones: counts of 32G; no selection; a zero database; one
    set bit at value bit 0 or 31 of the first or last record), and two
    strided group spans accumulated into non-zero results, each
    `torch.equal` to the plain versions. Raises on any difference; returns
    the phase's line."""
    import torch

    from distributed_point_functions_tpu_torch.ops import count_product_cases as cases

    for shape in cases.EDGE_SHAPES:
        cases.check_shape(*shape, dev)
    for shape in cases.EXTREME_SHAPES:
        cases.check_extremes(*shape, dev)
    for bit in (0, 31):
        for last in (False, True):
            cases.check_single_bit(bit, last, dev)
    cases.check_strided_spans(dev)
    torch.cuda.synchronize()
    return {"phase": "count_product_edges", "ragged_shapes": cases.EDGE_SHAPES,
            "extreme_shapes": cases.EXTREME_SHAPES,
            "extremes": ["all ones (counts 32G)", "no selection", "zero database"],
            "single_bit_cases": 8, "strided_spans_equal_one_call": True,
            "equal_to_plain": True}


def tier_launches(plan, mode: str, key_groups: int) -> dict:
    """Launches of one batch of both parties on `plan`
    (`planner.ServingPlan`) in expansion `mode`. The chunked tier runs one
    chunk a granule-padded span of blocks (the plan's num_chunks is its
    lower bound: a ragged block count runs fewer)."""
    from distributed_point_functions_tpu_torch.pir.planner import CHUNK_GRANULE_LEVELS

    per_party = {}

    def add(counts, times=1):
        for name, n in counts.items():
            per_party[name] = per_party.get(name, 0) + n * times

    if plan.mode == "materialized":
        add(expansion_launches(mode, plan.expand_levels, key_groups))
        add({"leaf_blocks": 1, "xor_inner_product": 1})
    elif plan.mode == "streaming":
        add({"expand_level": plan.cut_levels})
        add(expansion_launches(mode, plan.chunk_levels, key_groups), plan.num_chunks)
        add({"leaf_blocks": 1, "xor_inner_product": 1}, plan.num_chunks)
    else:
        granule = 1 << min(plan.expand_levels, CHUNK_GRANULE_LEVELS)
        chunks = (-(-plan.num_blocks // granule) * granule) >> plan.chunk_levels
        if plan.cut_levels:  # one K8 walk a chunk
            add({"path_level": 1}, chunks)
        add(expansion_launches(mode, plan.chunk_levels, key_groups), chunks)
        add({"leaf_blocks": 1, "xor_inner_product": 1}, chunks)
    return {name: 2 * n for name, n in per_party.items() if n}


def bucket_batches(session, party: str) -> dict:
    """{bucket: batches} from a session's `<party>.batcher.bucket_batches`
    counters."""
    prefix = f"{party}.batcher.bucket_batches{{bucket="
    return {int(k[len(prefix):-1]): v for k, v in session.metrics.export()["counters"].items()
            if k.startswith(prefix)}


def launch_mark(session, party: str) -> tuple:
    """What `planned_launches` counts from: a session's batches by bucket
    and its own launches."""
    return bucket_batches(session, party), dict(session.launches)


def planned_launches(session, party: str, before: tuple) -> tuple:
    """Since `before` (`launch_mark`): the batches `session` formed by
    bucket, the launches their plans give (`tier_launches`, one party's
    half), and the launches it made; counts of 0 are left out."""
    batches0, launches0 = before
    formed = {b: n - batches0.get(b, 0) for b, n in bucket_batches(session, party).items()
              if n - batches0.get(b, 0)}
    server = getattr(session.server, "dense_server", session.server)
    want = {}
    for b, n in formed.items():
        for name, c in tier_launches(server._plan_serving(b), server.expansion,
                                     -(-b // 32)).items():
            want[name] = want.get(name, 0) + n * c // 2
    got = {name: c - launches0.get(name, 0) for name, c in session.launches.items()
           if c - launches0.get(name, 0)}
    return formed, want, got


# What each admin route answers (status, content type) with the
# attachments of `serving_phase`'s admin step: a registry, a prober,
# bundles, the capacity accuracy export, snapshots, a time-series
# sampler, a workload observatory and a forecaster; no fleet. Written
# out here, since this script imports nothing of the JAX package; a CPU
# test holds it equal to the JAX package's `AdminServer` with the same
# attachments.
_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json"
ADMIN_ROUTES = {
    "/healthz": (200, _JSON),
    "/metrics": (200, "text/plain; version=0.0.4; charset=utf-8"),
    "/varz": (200, _JSON),
    "/statusz": (200, "text/html; charset=utf-8"),
    "/tracez": (200, _JSON),
    "/eventz": (200, _TEXT),
    "/probez": (200, _JSON),
    "/debugz": (200, _JSON),
    "/criticalz": (200, _TEXT),
    "/capacityz": (200, _TEXT),
    "/utilz": (200, _TEXT),
    "/timeseriesz": (200, _TEXT),
    "/workloadz": (200, _TEXT),
    "/forecastz": (200, _TEXT),
    "/fleetz": (404, _TEXT),
    "/fleet-statusz": (404, _TEXT),
    "/fleet-timelinez": (404, _TEXT),
    "/profilez": (200, _JSON),
}
ADMIN_PROFILE_MS = 200

# What each admin route answers (status, content type) with the
# attachments of `fleet_phase`'s admin step: a `ReplicaSet`, a
# `FleetTelemetry`, the fleet's registry and time-series store, bundles,
# its journal and a profile directory. A CPU test holds it equal to the
# JAX package's `AdminServer` with the same attachments.
FLEET_ADMIN_ROUTES = {
    **ADMIN_ROUTES,
    "/healthz": (200, _TEXT),
    "/probez": (404, _TEXT),
    "/capacityz": (404, _TEXT),
    "/workloadz": (404, _TEXT),
    "/forecastz": (404, _TEXT),
    "/fleetz": (200, _JSON),
    "/fleet-statusz": (200, _TEXT),
    "/fleet-timelinez": (200, _TEXT),
}


def fleet_admin(admin_cls, bundles, replica_set, telemetry, journal, profile_dir):
    """An `admin_cls` (`AdminServer`) on port 0 with the fleet's
    attachments (FLEET_ADMIN_ROUTES says what each route answers)."""
    return admin_cls(port=0, fleet=replica_set, fleet_telemetry=telemetry,
                     registry=telemetry.registry, timeseries=telemetry.store,
                     bundles=bundles, journal=journal, profile_dir=profile_dir)
# One Prometheus text sample line: a name, labels, a value, an optional
# timestamp and an optional OpenMetrics exemplar.
PROMETHEUS_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})?'
    r' [-+]?([0-9.eE+-]+|Inf|NaN)( [0-9]+)?( # \{.*\} \S+( \S+)?)?$')


def http_get(url: str, timeout: float = 30.0):
    """(status, content type, body) of one GET, errors included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def scrape_admin(port: int, routes=ADMIN_ROUTES) -> dict:
    """Each of `routes` (default: every admin route) once: {route:
    (status, content type, body)}; `/profilez` for ADMIN_PROFILE_MS."""
    out = {}
    for route in routes:
        query = f"?duration_ms={ADMIN_PROFILE_MS}" if route == "/profilez" else ""
        out[route] = http_get(f"http://127.0.0.1:{port}{route}{query}")
    return out


def stage_and_measure(db, host, dev, label: str, smi_line: str) -> dict:
    """Stage `db` (the pipelined staging of its host image `host`) and
    time the one-copy staging of the same image beside it, in turns:
    pipelined (`db` itself), one-copy, one-copy, pipelined (a second
    database over the same image, then released). Gates the first run:
    its staging equals the one-copy staging, more `db_staging` copies
    than syncs, `overlapped_ms` > 0, and a peak under 1.5x the staging.
    Prints the `staging` line; returns it."""
    import torch

    from distributed_point_functions_tpu_torch.observability.device import (
        default_telemetry,
    )
    from distributed_point_functions_tpu_torch.ops.inner_product_kernels import (
        permute_db_bitmajor,
    )
    from distributed_point_functions_tpu_torch.ops.words import to_tensor
    from distributed_point_functions_tpu_torch.pir import DenseDpfPirDatabase
    from distributed_point_functions_tpu_torch.pir.database import slab_spans

    ledger = default_telemetry().transfers

    def measured(run):
        fields = ("copies", "syncs", "overlapped_ms", "sync_wait_ms", "bytes_h2d")
        before = {f: getattr(ledger, f)("db_staging") for f in fields}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {f: getattr(ledger, f)("db_staging") - before[f] for f in fields}
        return out, {"stage_ms": ms, **got,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev) - base}

    def one_copy():
        rows = to_tensor(host, dev)
        return permute_db_bitmajor(rows)

    staged, first = measured(db.staged)
    yard, one = measured(one_copy)
    if not torch.equal(staged, yard):
        raise AssertionError(f"staging {label}: differs from the one-copy staging")
    del yard
    _, one_again = measured(one_copy)
    second_db = DenseDpfPirDatabase.from_words(host, db.size, db.max_value_size, device=dev)
    _, second = measured(second_db.staged)
    second_db.release_stagings()
    del second_db
    nbytes = staged.numel() * 4
    line = {"phase": "staging", "config": label, "records": db.size,
            "host_image_bytes": host.nbytes, "staged_bytes": nbytes,
            "slabs": len(slab_spans(host.shape[0])),
            "pipelined": first, "pipelined_again": second,
            "one_copy": one, "one_copy_again": one_again,
            "peak_over_staged": first["peak_bytes"] / nbytes,
            "one_copy_peak_over_staged": one["peak_bytes"] / nbytes,
            "equals_one_copy": True, "device": smi_line}
    emit(line)
    if not first["copies"] > first["syncs"]:
        raise AssertionError(f"staging {label}: {first['copies']} copies, "
                             f"{first['syncs']} syncs")
    if not first["overlapped_ms"] > 0:
        raise AssertionError(f"staging {label}: nothing overlapped")
    if not first["peak_bytes"] < 1.5 * nbytes:
        raise AssertionError(f"staging {label}: peak {first['peak_bytes']} B, "
                             f"staging {nbytes} B")
    return line


def probe_plan(prober, kind: str):
    """The serving plan of one share of a dense probe of `kind` (its
    golden keys, bucketed unless `pir_unbatched`, under the tier floor
    the kind forces) and its key count."""
    from distributed_point_functions_tpu_torch.pir import server as server_mod
    from distributed_point_functions_tpu_torch.serving.batcher import bucket_size

    server = prober._session.server
    keys = len(prober._indices)
    if kind != "pir_unbatched":
        keys = bucket_size(keys)
    floor = {"pir_streaming": "streaming", "pir_chunked": "chunked"}.get(kind)
    previous = server_mod.tier_floor()
    server_mod.set_tier_floor(floor)
    try:
        return server._plan_serving(keys), keys
    finally:
        server_mod.set_tier_floor(previous)


def probe_want_launches(prober, kind: str) -> dict:
    """The launches one probe of `kind` must make in this process: the
    plan of its tier for the golden pair (`tier_launches`: both plain
    shares, a batch each, on the prober's server; `pir_materialized` and
    `leader_e2e` at the cleared floor, whose Leader's and Helper's shares
    are the two batches; `pir_unbatched` off the batcher), or the sweep
    servers' level plans (`hh_sweep`; read after the probe)."""
    if kind == "hh_sweep":
        want = {}
        for server in prober._hh[:2]:
            for name, n in hh_want_launches(server.aggregator.plans).items():
                want[name] = want.get(name, 0) + n
        return want
    plan, keys = probe_plan(prober, kind)
    return tier_launches(plan, prober._session.server.expansion, -(-keys // 32))


def held_staging_bytes(dbs) -> int:
    """Device bytes of the stagings the dense or sparse databases `dbs`
    hold, a tensor that several share (a `replica()`) counted once."""
    seen = {}
    for db in dbs:
        dense = getattr(db, "dense_database", db)
        with dense._stage_lock:
            tensors = [dense._db_perm,
                       dense._streaming[1] if dense._streaming is not None else None,
                       dense._chunked[1] if dense._chunked is not None else None]
        for t in tensors:
            if t is not None:
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def xor_staged_word(db, row: int, word: int, value: int) -> int:
    """XOR `value` (a signed 32-bit int) into word `word` of record `row`,
    in place, in every staging the dense database `db` holds: the
    bit-major staging, the streaming tier's chunks (at the row's place
    in streaming block order) and a padded chunked copy. A second call
    with the same arguments undoes it. Returns the stagings changed."""
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
        streaming_block_order,
    )

    with db._stage_lock:
        tensors = [db._staged_locked()]
        tensors[0][row % 32, row // 32, word] ^= value
        if db._chunked is not None and db._chunked[1] is not tensors[0]:
            db._chunked[1][row % 32, row // 32, word] ^= value
            tensors.append(db._chunked[1])
        if db._streaming is not None:
            cut, chunks = db._streaming
            levels = max(0, (db.num_selection_blocks - 1).bit_length())
            order = streaming_block_order(levels, cut)
            pos = int(np.flatnonzero(order == row // 128)[0]) * 128 + row % 128
            span = (128 << levels) >> cut
            local = pos % span
            chunks[pos // span, local % 32, local // 32, word] ^= value
            tensors.append(chunks)
    return len(tensors)


def tiers_phase(rng, dev, smi_line: str) -> dict:
    """BASELINE.json configs[2]: 2^22 records of 256 B, 1,024 queries,
    both parties, the default expansion mode, on each serving tier the
    planner gives: materialized at the card's default budget (1/16 of its
    memory), streaming under a 64 MiB budget, chunked under the same
    budget with the tier floor; then the materialized tier once more in
    tail mode (K6, K2 for the middle levels, K5). Every other run's
    responses must equal the first materialized run's and reconstruct
    every queried record, and every run's peak must pass the same gate.
    Returns {run: launch counts}, the run named by its tier, with the
    mode in brackets where it is not the default."""
    import torch

    from distributed_point_functions_tpu_torch.capacity.model import (
        CapacityModel,
        set_default_capacity_model,
    )
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirClient,
        DenseDpfPirDatabase,
        DenseDpfPirServer,
    )
    from distributed_point_functions_tpu_torch.pir import server as server_mod
    from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        DEFAULT_EXPANSION,
        pack_key_batch,
    )
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    t0 = time.perf_counter()
    data = rng.bytes(TIER_RECORDS * RECORD_BYTES)
    records = [data[i * RECORD_BYTES:(i + 1) * RECORD_BYTES] for i in range(TIER_RECORDS)]
    db = DenseDpfPirDatabase(records)
    setup_s = time.perf_counter() - t0
    stage_and_measure(db, db.host_rows(), dev, "BASELINE.json configs[2]", smi_line)
    idx = [int(i) for i in rng.integers(0, TIER_RECORDS, TIER_QUERIES)]
    t0 = time.perf_counter()
    r0, r1 = DenseDpfPirClient.create(
        TIER_RECORDS, encrypt_decrypt.encrypt).create_plain_requests(idx)
    keygen_s = time.perf_counter() - t0

    def serve(server):
        s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
        s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
        torch.cuda.synchronize()
        return s0, s1

    reference, launches = None, {}
    for tier, budget, floor, mode in (
            ("materialized", None, None, DEFAULT_EXPANSION),
            ("streaming", TIER_BUDGET, None, DEFAULT_EXPANSION),
            ("chunked", TIER_BUDGET, "chunked", DEFAULT_EXPANSION),
            ("materialized", None, None, "tail")):
        set_default_capacity_model(
            None if budget is None else CapacityModel(selection_budget=budget))
        server_mod.set_tier_floor(floor)
        server = DenseDpfPirServer.create_plain(db, expansion=mode)
        plan = server._plan_serving(TIER_QUERIES)
        run = tier if mode == DEFAULT_EXPANSION else f"{tier} ({mode})"
        if plan.mode != tier or (tier != "materialized"
                                 and (plan.chunk_levels, plan.cut_levels)
                                 != (TIER_CHUNK_LEVELS, TIER_CUT_LEVELS)):
            raise AssertionError(f"tier {tier}: the planner chose {plan}")
        t0 = time.perf_counter()
        serve(server)  # warm-up, and the tier's staging
        first_s = time.perf_counter() - t0
        out = []
        launches[run] = counted(
            lambda: out.append(serve(server)),
            tier_launches(plan, mode, TIER_QUERIES // 32), f"{run} tier")
        shares = out[0]
        if reference is None:
            reference = shares
        elif shares != reference:
            raise AssertionError(f"{run} tier: responses differ from the materialized tier's")
        for a, b, i in zip(*shares, idx):
            if bytes(x ^ y for x, y in zip(a, b)) != records[i]:
                raise AssertionError(f"{run} tier: record {i} does not reconstruct")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        server.handle_plain_request(r0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        # What the batch holds besides selections: its staged and packed
        # keys, and (streaming, chunked) the response rows it XORs into.
        before = torch.cuda.memory_allocated(dev)
        staged = stage_keys(r0.plain_request.dpf_keys, server.walk_levels, device=dev)
        packed_keys = pack_key_batch(*staged, server.expand_levels)
        keys_bytes = torch.cuda.memory_allocated(dev) - before
        del staged, packed_keys
        response_bytes = (0 if tier == "materialized"
                          else 32 * (-(-TIER_QUERIES // 32)) * RECORD_BYTES)
        # Beyond those, only index vectors (4 bytes a leaf node at most)
        # and one node's slice of the cut state may be alive.
        allowed = (plan.selection_bytes_peak + keys_bytes + response_bytes
                   + (4 << plan.expand_levels) + (1 << 16))
        if peak > allowed:
            raise AssertionError(
                f"{run} tier: peak {peak} B above the model's "
                f"{plan.selection_bytes_peak} B plus keys and response ({allowed} B)")
        times = host_ms(lambda: serve(server), 5)
        emit({"phase": "tier", "tier": tier, "config": "BASELINE.json configs[2]",
              "records": TIER_RECORDS, "record_bytes": RECORD_BYTES,
              "queries": TIER_QUERIES, "expansion": mode,
              "plan": dataclasses.asdict(plan), "tier_floor": server_mod.tier_floor(),
              "reconstructed": TIER_QUERIES, "equals_materialized": True,
              "launches": launches[run], "setup_s": setup_s, "keygen_s": keygen_s,
              "first_batch_s": first_s, "batch_ms": statistics.median(times),
              "batch_ms_all": times,
              "queries_per_sec": TIER_QUERIES / statistics.median(times) * 1e3,
              "modeled_selection_bytes": plan.selection_bytes_peak,
              "measured_peak_bytes_one_party": peak,
              "staged_keys_bytes": keys_bytes, "response_bytes": response_bytes,
              "peak_over_model_bytes": peak - plan.selection_bytes_peak,
              "peak_less_keys_and_response_over_model_bytes":
                  peak - keys_bytes - response_bytes - plan.selection_bytes_peak,
              **device_busy(lambda: server.handle_plain_request(r0))})
    set_default_capacity_model(None)
    server_mod.clear_tier_floor()
    return launches


def sparse_keys(n: int) -> list:
    return [b"k%012d" % i for i in range(n)]


def sparse_queries(rng, num_keys: int, nq: int) -> list:
    """nq queries: present keys (`sparse_keys`) drawn by `rng`, and
    SPARSE_ABSENT absent ones spread among them."""
    out = [b"k%012d" % i for i in rng.integers(0, num_keys, nq - SPARSE_ABSENT)]
    for j in range(SPARSE_ABSENT):
        out.insert(j * (nq // SPARSE_ABSENT), b"absent%06d" % j)
    return out


def check_sparse(client, shares, queries, value_of, value_size, what: str) -> int:
    """Both parties' plain responses XORed and matched per query: every
    present key's value (`value_of(key)`, zero-padded to the longest) and
    None for every absent key (`value_of` gives None). Returns the number
    of present keys found."""
    raw = [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(*shares)]
    found = 0
    for q, v in zip(queries, client._match(raw, queries)):
        want = value_of(q)
        if want is None:
            if v is not None:
                raise AssertionError(f"{what}: absent key {q!r} resolved to a value")
        elif v != want + bytes(value_size - len(want)):
            raise AssertionError(f"{what}: key {q!r} does not resolve to its value")
        else:
            found += 1
    return found


def sparse_small_phase(rng, dev) -> dict:
    """3,000 keys (4,500 buckets, 36 selection blocks under a covering tree
    of 64): the card's responses must equal a `device="cpu"` server's on
    the same database in every expansion mode and on every tier (each
    forced with the tier floor), with the launches the plan gives; every
    present key resolves to its value, every absent key to None."""
    import torch

    from distributed_point_functions_tpu_torch.pir import (
        CuckooHashedDpfPirDatabase,
        CuckooHashingSparseDpfPirClient,
        CuckooHashingSparseDpfPirServer,
    )
    from distributed_point_functions_tpu_torch.pir import server as server_mod
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import EXPANSION_MODES
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    keys = sparse_keys(SPARSE_SMALL_KEYS)
    values = [rng.bytes(int(rng.integers(0, SPARSE_VALUE_BYTES + 1))) for _ in keys]
    records = dict(zip(keys, values))
    params = CuckooHashingSparseDpfPirServer.generate_params(len(keys), seed=SPARSE_SEED)
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params)
    for kv in records.items():
        builder.insert(kv)
    gpu_db, cpu_db = builder.build(), builder.build(device="cpu")
    queries = sparse_queries(rng, len(keys), 40)
    launches = {}
    for mode in EXPANSION_MODES:
        gpu = CuckooHashingSparseDpfPirServer.create_plain(params, gpu_db, expansion=mode)
        cpu = CuckooHashingSparseDpfPirServer.create_plain(params, cpu_db, device="cpu",
                                                           expansion=mode)
        client = CuckooHashingSparseDpfPirClient.create_from_public_params(
            gpu.get_public_params(), encrypt_decrypt.encrypt)
        requests = client.create_plain_requests(queries)
        want = [cpu.handle_request(r).dpf_pir_response.masked_response for r in requests]
        check_sparse(client, want, queries, records.get, cpu_db.value_size,
                     f"sparse_small ({mode}, plain)")
        for tier in ("materialized", "streaming", "chunked"):
            server_mod.set_tier_floor(tier)
            plan = gpu.dense_server._plan_serving(3 * len(queries))
            if plan.mode != tier:
                raise AssertionError(f"sparse_small: the floor {tier} planned {plan}")
            out = []
            launches[f"{tier} ({mode})"] = counted(
                lambda: out.append([gpu.handle_request(r).dpf_pir_response.masked_response
                                    for r in requests]),
                tier_launches(plan, mode, -(-3 * len(queries) // 32)),
                f"sparse_small {tier} ({mode})")
            if out[0] != want:
                raise AssertionError(f"sparse_small {tier} ({mode}): card and plain differ")
        server_mod.clear_tier_floor()
    torch.cuda.synchronize()
    emit({"phase": "sparse_small", "keys": len(keys), "buckets": params.num_buckets,
          "selection_blocks": gpu_db.num_selection_blocks, "queries": len(queries),
          "absent": SPARSE_ABSENT, "modes": list(EXPANSION_MODES),
          "tiers": ["materialized", "streaming", "chunked"], "card_equals_plain": True,
          "resolved": True, "launches": launches})
    return launches


def sparse_phase(dev, smi_line: str) -> dict:
    """BASELINE.json configs[4] on one card: 2^24 keys, built through the
    builder (its steps timed apart as well: the SHA256 hashing alone, the
    native build of the slot array, the packing of the bucket rows, the
    staging), served by `CuckooHashingSparseDpfPirServer` in walk mode to
    batches of 64 and 128 queries on the planner's tier at the default
    budget, then streaming and chunked under a 64 MiB budget with the tier
    floor: launches from the plan, every present key resolved, every absent
    key None, the tiers' bytes equal, the peak against the model. The
    keys and values are dropped once built (the database keeps what it
    serves): the checks rebuild a queried key's value from the values'
    array. Returns (database, params, value_of, {run: launches})."""
    import torch

    from distributed_point_functions_tpu_torch import native
    from distributed_point_functions_tpu_torch.capacity.model import (
        CapacityModel,
        set_default_capacity_model,
    )
    from distributed_point_functions_tpu_torch.pir import (
        CuckooHashedDpfPirDatabase,
        CuckooHashingSparseDpfPirClient,
        CuckooHashingSparseDpfPirServer,
    )
    from distributed_point_functions_tpu_torch.pir import server as server_mod
    from distributed_point_functions_tpu_torch.pir.cuckoo_database import (
        cuckoo_slots,
        pack_buckets,
    )
    from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import pack_key_batch
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    build = {}
    t0 = time.perf_counter()
    keys = sparse_keys(SPARSE_KEYS)
    vrng = np.random.default_rng(13)
    raw = vrng.integers(0, 256, (SPARSE_KEYS, SPARSE_VALUE_BYTES), dtype=np.uint8)
    flat = raw.tobytes()
    values = [flat[i:i + SPARSE_VALUE_BYTES]
              for i in range(0, len(flat), SPARSE_VALUE_BYTES)]
    del flat
    build["data_ms"] = (time.perf_counter() - t0) * 1e3
    params = CuckooHashingSparseDpfPirServer.generate_params(SPARSE_KEYS, seed=SPARSE_SEED)
    t0 = time.perf_counter()
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params)
    for kv in zip(keys, values):
        builder.insert(kv)
    build["insert_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    db = builder.build()
    build["build_ms"] = (time.perf_counter() - t0) * 1e3
    build["stage_ms"] = stage_and_measure(
        db.dense_database, db.dense_database.host_rows(), dev,
        "BASELINE.json configs[4], one card", smi_line)["pipelined"]["stage_ms"]
    build["build_s"] = (build["insert_ms"] + build["build_ms"] + build["stage_ms"]) / 1e3
    # The builder's steps again, each alone, on the same inputs.
    seeds = [SPARSE_SEED + str(i).encode() for i in range(params.num_hash_functions)]
    t0 = time.perf_counter()
    native.cuckoo_hash_buckets(keys, seeds, params.num_buckets)
    build["hash_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    slots = cuckoo_slots(params, keys)
    build["native_build_ms"] = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(slots, db.slot_index):
        raise AssertionError("sparse: two builds of one input differ")
    t0 = time.perf_counter()
    pack_buckets(slots, keys, values)
    build["pack_ms"] = (time.perf_counter() - t0) * 1e3
    del slots, builder, keys, values

    def value_of(key):
        if not key.startswith(b"k"):
            return None
        i = int(key[1:])
        return bytes(raw[i])

    occupancy = db.size / db.num_buckets

    server = CuckooHashingSparseDpfPirServer.create_plain(params, db, device=dev)
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        server.get_public_params(), encrypt_decrypt.encrypt)
    qrng = np.random.default_rng(SEED + 20)
    launches = {}
    row_bytes = 4 * db.dense_database.staged().shape[2]
    for nq in SPARSE_QUERIES:
        queries = sparse_queries(qrng, SPARSE_KEYS, nq)
        t0 = time.perf_counter()
        r0, r1 = client.create_plain_requests(queries)
        keygen_ms = (time.perf_counter() - t0) * 1e3
        nk = len(r0.plain_request.dpf_keys)

        def serve():
            s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
            s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
            torch.cuda.synchronize()
            return s0, s1

        reference = None
        for tier, budget, floor in (("default", None, None),
                                    ("streaming", TIER_BUDGET, "streaming"),
                                    ("chunked", TIER_BUDGET, "chunked")):
            set_default_capacity_model(
                None if budget is None else CapacityModel(selection_budget=budget))
            server_mod.set_tier_floor(floor)
            plan = server.dense_server._plan_serving(nk)
            if floor is not None and plan.mode != floor:
                raise AssertionError(f"sparse {nq}q: the floor {floor} planned {plan}")
            run = f"{nq}q {plan.mode}"
            t0 = time.perf_counter()
            serve()  # warm-up, and the tier's staging
            first_s = time.perf_counter() - t0
            out = []
            launches[run] = counted(lambda: out.append(serve()),
                                    tier_launches(plan, "walk", -(-nk // 32)),
                                    f"sparse {run}")
            shares = out[0]
            if reference is None:
                reference = shares
            elif shares != reference:
                raise AssertionError(f"sparse {run}: bytes differ from the default tier's")
            found = check_sparse(client, shares, queries, value_of, db.value_size,
                                 f"sparse {run}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            server.handle_plain_request(r0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            before = torch.cuda.memory_allocated(dev)
            staged = stage_keys(r0.plain_request.dpf_keys, server.dense_server.walk_levels,
                                device=dev)
            packed_keys = pack_key_batch(*staged, server.dense_server.expand_levels)
            keys_bytes = torch.cuda.memory_allocated(dev) - before
            del staged, packed_keys
            # The response rows the streaming and chunked tiers XOR into,
            # at the bucket row's width.
            response_bytes = (0 if plan.mode == "materialized"
                              else 32 * (-(-nk // 32)) * row_bytes)
            # Index vectors, and the caching allocator's granularity: it
            # counts a cached block whole where the rest of it would be
            # under 1 MiB, and the peak holds two blocks of a few MiB at
            # a chunk (its leaf values and its selections).
            allowed = (plan.selection_bytes_peak + keys_bytes + response_bytes
                       + (4 << plan.expand_levels) + (1 << 16) + (2 << 20))
            if peak > allowed:
                raise AssertionError(
                    f"sparse {run}: peak {peak} B above the model's "
                    f"{plan.selection_bytes_peak} B plus keys and response ({allowed} B)")
            times = host_ms(serve, SPARSE_REPS)
            emit({"phase": "sparse", "config": "BASELINE.json configs[4], one card",
                  "keys": SPARSE_KEYS, "value_bytes": SPARSE_VALUE_BYTES,
                  "buckets": params.num_buckets, "hash_functions": params.num_hash_functions,
                  "occupancy": occupancy, "selection_blocks": db.num_selection_blocks,
                  "row_bytes": row_bytes, "key_bytes": db.key_size,
                  "queries": nq, "absent": SPARSE_ABSENT, "keys_a_party": nk,
                  "found": found, "tier": plan.mode, "expansion": "walk",
                  "plan": dataclasses.asdict(plan), "tier_floor": server_mod.tier_floor(),
                  "equals_default_tier": True, "launches": launches[run],
                  **build, "keygen_ms": keygen_ms, "first_batch_s": first_s,
                  "batch_ms": statistics.median(times), "batch_ms_all": times,
                  "queries_per_sec": nq / statistics.median(times) * 1e3,
                  "modeled_selection_bytes": plan.selection_bytes_peak,
                  "measured_peak_bytes_one_party": peak,
                  "staged_keys_bytes": keys_bytes, "response_bytes": response_bytes,
                  "peak_less_keys_and_response_over_model_bytes":
                      peak - keys_bytes - response_bytes - plan.selection_bytes_peak,
                  **device_busy(lambda: server.handle_plain_request(r0)),
                  "device": smi_line})
    set_default_capacity_model(None)
    server_mod.clear_tier_floor()
    return db, params, value_of, launches


def sparse_two_party_phase(db, params, value_of, dev, smi_line: str) -> dict:
    """A Leader and a Helper `CuckooHashingSparseDpfPirServer` on the card
    over the 2^24-key database; the client is built from the Leader's
    `get_public_params()` bytes, its request carries the Helper's keys
    hybrid-encrypted with the one-time pad's seed; 128 queries with
    absent keys. Every value must resolve and every absent key be
    `KeyNotFound`; round-trip ms by step (median of SPARSE_REPS rounds)."""
    import torch

    from distributed_point_functions_tpu_torch.pir import (
        CuckooHashingSparseDpfPirClient,
        CuckooHashingSparseDpfPirServer,
        KeyNotFound,
    )
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    helper = CuckooHashingSparseDpfPirServer.create_helper(
        params, db, encrypt_decrypt.decrypt, device=dev)

    def sender(helper_request, while_waiting):
        while_waiting()
        return helper.handle_request(helper_request)

    leader = CuckooHashingSparseDpfPirServer.create_leader(params, db, sender, device=dev)
    wire = leader.get_public_params()
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        wire, encrypt_decrypt.encrypt)
    nq = SPARSE_QUERIES[-1]
    queries = sparse_queries(np.random.default_rng(SEED + 21), SPARSE_KEYS, nq)
    request, state = client.create_request(queries)
    leader.handle_request(request)  # warm-up
    out = []
    plan = leader.dense_server._plan_serving(3 * nq)
    launches = counted(lambda: out.append(leader.handle_request(request)),
                       tier_launches(plan, "walk", -(-3 * nq // 32)), "sparse_two_party")
    resolved = client.resolve(out[0], state)
    for q, v in zip(queries, resolved):
        want = value_of(q)
        if want is None:
            if not isinstance(v, KeyNotFound) or v.key != q:
                raise AssertionError(f"sparse_two_party: absent key {q!r} gave {v!r}")
        elif v != want + bytes(db.value_size - len(want)):
            raise AssertionError(f"sparse_two_party: key {q!r} does not resolve")
    rounds = {"create_request_ms": [], "handle_request_ms": [], "resolve_ms": [],
              "round_trip_ms": []}
    for _ in range(SPARSE_REPS):
        t0 = time.perf_counter()
        req, st = client.create_request(queries)
        t1 = time.perf_counter()
        resp = leader.handle_request(req)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        client.resolve(resp, st)
        t3 = time.perf_counter()
        for k, v in zip(rounds, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
            rounds[k].append(v * 1e3)
    emit({"phase": "sparse_two_party", "keys": SPARSE_KEYS, "queries": nq,
          "absent": SPARSE_ABSENT, "tier": plan.mode, "expansion": "walk",
          "public_params_bytes": len(wire), "resolved": nq, "launches": launches,
          **{k: statistics.median(v) for k, v in rounds.items()}, "rounds_ms": rounds,
          "queries_per_sec": nq / statistics.median(rounds["round_trip_ms"]) * 1e3,
          **device_busy(lambda: leader.handle_request(request)), "device": smi_line})
    return launches


# `sparse_serving` (after `sparse_two_party`, on its database): client
# processes and threads, the closed-loop lookups before and during the
# rotation, the write batch's overwrites and new keys, present keys'
# share of the lookups.
SPARSE_SERVING_PROCESSES = 4
SPARSE_SERVING_THREADS = 16
SPARSE_SERVING_REQUESTS = 1024
SPARSE_SERVING_WAVE = 1024
SPARSE_UPSERTS = 4096
SPARSE_PRESENT_SHARE = 0.9
SPARSE_CHECK_QUERIES = 128  # queries a request of the after-flip check


def sparse_serving_client(root: str, conn, port: int, public_params: bytes,
                          num_keys: int, seed: int, left, done) -> None:
    """A client process of `sparse_serving` (started with `spawn`; it never
    touches the card). Per command `(threads, hot, hot_share)` it runs
    `threads` closed-loop threads, each on its own TCP connection to the
    Leader, one lookup a request: a key of `hot` with probability
    `hot_share`, else a present key (`sparse_keys(num_keys)`) with probability
    `SPARSE_PRESENT_SHARE`, else an absent one; until `left` reaches 0.
    Sends back [(query, value or None, latency s, request digest, sent)],
    or the first failure. None ends the process."""
    import threading

    sys.path.insert(0, root)
    from distributed_point_functions_tpu_torch import serialization
    from distributed_point_functions_tpu_torch.pir import CuckooHashingSparseDpfPirClient
    from distributed_point_functions_tpu_torch.pir.sparse_client import KeyNotFound
    from distributed_point_functions_tpu_torch.serving import transport
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        public_params, encrypt_decrypt.encrypt)
    dpf = client._wrapped_client.dpf
    wave, socks = 0, {}
    conn.send("ready")
    while (cmd := conn.recv()) is not None:
        threads, hot, hot_share = cmd
        wave += 1
        out, errors, lock = [], [], threading.Lock()

        def run(t):
            rng = np.random.default_rng([seed, wave, t])
            while not errors:
                with left.get_lock():
                    if left.value <= 0:
                        return
                    left.value -= 1
                if hot and rng.random() < hot_share:
                    q = hot[int(rng.integers(0, len(hot)))]
                elif rng.random() < SPARSE_PRESENT_SHARE:
                    q = b"k%012d" % int(rng.integers(0, num_keys))
                else:
                    q = b"absent%012d" % int(rng.integers(0, 1 << 40))
                sent = time.perf_counter()
                try:
                    if t not in socks:
                        socks[t] = socket.create_connection(("127.0.0.1", port))
                    request, state = client.create_request([q])
                    wire = serialization.serialize_pir_request(dpf, request)
                    transport.send_msg(socks[t], wire)
                    value = client.resolve(serialization.parse_pir_response(
                        transport.recv_msg(socks[t])), state)[0]
                except Exception as e:  # noqa: BLE001 - sent to the parent
                    errors.append(e)
                    return
                with lock:
                    out.append((q, None if isinstance(value, KeyNotFound) else value,
                                time.perf_counter() - sent, wire_digest(wire), sent))
                with done.get_lock():
                    done.value += 1

        pool = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join()
        conn.send(errors[0] if errors else out)
    for sock in socks.values():
        sock.close()
    conn.close()


def sparse_serving_phase(db, params, value_of, dev, smi_line: str) -> None:
    """`sparse_serving` at configs[4]: a `SparseHelperSession` behind a
    `FramedTcpServer` and a `SparseLeaderSession` reaching it through a
    `TcpTransportPool`, over `sparse_phase`'s 2^24-key database (the
    Helper's a `replica` of it, so that each party rotates its own), with
    admission pricing the "sparse" workload. 64 client threads send
    one-lookup requests, closed loop, present and absent keys mixed: every
    present key resolves to its value, every absent key to `KeyNotFound`,
    each party's launches equal the plans of the batches it formed. Then
    a write batch (`SPARSE_UPSERTS`: half overwrites, half new keys)
    through `Builder.build_from(prev)` rotates both parties under a wave
    that looks the written keys up half the time: the stagings are deltas
    of the touched bucket rows (`bytes_saved > 0`, bytes staged = rows x
    (8 + the row's bytes), the dense delta's count), every answer is its key's in
    the generation its Leader share bound to (the Leader refuses a Helper
    share of another), every written key reads its new value after the
    flip, `torch.cuda.memory_allocated` after the old generation drained
    has moved within 2 MiB of what the stagings held moved (generation
    0's parties share one staging, generation 1's hold one each), and a
    database of another geometry is refused with `SnapshotMismatch`.
    Prints the `sparse_serving` line."""
    import multiprocessing
    import threading

    import torch

    from distributed_point_functions_tpu_torch.observability import costmodel
    from distributed_point_functions_tpu_torch.observability.events import EventJournal
    from distributed_point_functions_tpu_torch.pir import (
        CuckooHashedDpfPirDatabase,
        CuckooHashingSparseDpfPirServer,
        KeyNotFound,
    )
    from distributed_point_functions_tpu_torch.serving import (
        FramedTcpServer,
        RotationCoordinator,
        ServingConfig,
        SnapshotManager,
        SnapshotMismatch,
        SparseHelperSession,
        SparseLeaderSession,
        TcpTransportPool,
        make_sparse_client,
    )
    from distributed_point_functions_tpu_torch.serving.prober import Prober
    from distributed_point_functions_tpu_torch.serving.service import evaluated_generation
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    t_phase = time.perf_counter()
    steps = {}
    hdb = db.replica()
    hdb.prestage()
    config = ServingConfig(max_batch_size=128, max_wait_ms=2.0, request_timeout_ms=60_000.0,
                           admission_enabled=True, admission_queue_budget_ms=1e9)
    helper = SparseHelperSession(params, hdb, encrypt_decrypt.decrypt, config, device=dev)
    helper_tcp = FramedTcpServer(helper.handle_wire, host="127.0.0.1", name="helper").start()
    leader = SparseLeaderSession(
        params, db, TcpTransportPool("127.0.0.1", helper_tcp.port,
                                     SPARSE_SERVING_PROCESSES * SPARSE_SERVING_THREADS),
        config, device=dev)
    bound = {}

    def leader_wire(data):
        reply = leader.handle_wire(data)
        bound[wire_digest(data)] = evaluated_generation()
        return reply

    leader_tcp = FramedTcpServer(leader_wire, host="127.0.0.1", name="leader").start()
    ctx = multiprocessing.get_context("spawn")
    left, done = ctx.Value("i", 0), ctx.Value("i", 0)
    procs, pipes = [], []
    root = str(Path(__file__).resolve().parent)
    public = leader.server.get_public_params()
    for k in range(SPARSE_SERVING_PROCESSES):
        parent_end, child_end = ctx.Pipe()
        proc = ctx.Process(target=sparse_serving_client, daemon=True, args=(
            root, child_end, leader_tcp.port, public, SPARSE_KEYS, SEED + 60 + k, left,
            done))
        proc.start()
        procs.append(proc)
        pipes.append(parent_end)
    # The write batch and both parties' generation 1 while the clients start.
    t0 = time.perf_counter()
    wrng = np.random.default_rng(SEED + 61)
    upserts = {b"k%012d" % int(i): wrng.bytes(SPARSE_VALUE_BYTES)
               for i in wrng.choice(SPARSE_KEYS, SPARSE_UPSERTS // 2, replace=False)}
    upserts.update({b"n%012d" % i: wrng.bytes(SPARSE_VALUE_BYTES)
                    for i in range(SPARSE_UPSERTS // 2)})
    builder = CuckooHashedDpfPirDatabase.Builder()
    for kv in upserts.items():
        builder.insert(kv)
    gen1 = []
    for base in (db, hdb):
        t1 = time.perf_counter()
        gen1.append(builder.build_from(base))
        steps.setdefault("build_from_s", []).append(time.perf_counter() - t1)
    if not np.array_equal(gen1[0].slot_index, gen1[1].slot_index):
        raise AssertionError("sparse_serving: the parties' generation 1 layouts differ")
    rows = len(gen1[0].dense_database._delta_rows)
    row_bytes = 4 * db.dense_database.staged().shape[2]
    steps["write_batch_s"] = time.perf_counter() - t0
    for pipe in pipes:
        if pipe.recv() != "ready":
            raise AssertionError("sparse_serving: a client process did not start")

    def closed_loop(total, hot=(), hot_share=0.0):
        left.value = total
        done.value = 0
        for pipe in pipes:
            pipe.send((SPARSE_SERVING_THREADS, list(hot), hot_share))
        out = []
        for pipe in pipes:
            got = pipe.recv()
            if isinstance(got, Exception):
                raise got
            out += got
        if len(out) != total:
            raise AssertionError(f"sparse_serving: {len(out)} answers of {total}")
        return out

    def check(q, value, generation):
        want = upserts.get(q) if generation == 1 and q in upserts else value_of(q)
        if want is None:
            if value is not None:
                raise AssertionError(f"sparse_serving: absent key {q!r} gave {value!r}")
        elif value != want + bytes(db.value_size - len(want)):
            raise AssertionError(f"sparse_serving: key {q!r} is not its generation "
                                 f"{generation} value")

    t0 = time.perf_counter()
    closed_loop(2 * SPARSE_SERVING_PROCESSES * SPARSE_SERVING_THREADS)  # warm-up
    torch.cuda.synchronize()
    steps["warmup_s"] = time.perf_counter() - t0
    parties = (("leader", leader), ("helper", helper))
    before = {p: launch_mark(s, p) for p, s in parties}
    t0 = time.perf_counter()
    out = closed_loop(SPARSE_SERVING_REQUESTS)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    steps["closed_loop_s"] = wall_s
    launches = {}
    for party, session in parties:
        formed, want, got = planned_launches(session, party, before[party])
        if got != want:
            raise AssertionError(f"sparse_serving: {party} launched {got}, its plans {want}")
        launches[party] = {"launches": got, "batches_by_bucket": formed}
    found = 0
    for q, value, _, digest, _ in out:
        check(q, value, bound.pop(digest))
        found += value is not None
    lat = sorted(x[2] * 1e3 for x in out)

    # The prober's sparse kinds on the Leader: golden keys (one of them
    # overwritten by the write batch, one written new) and an absent key.
    t0 = time.perf_counter()
    overwritten = next(k for k in upserts if k.startswith(b"k"))
    goldens = [overwritten] + [b"k%012d" % i for i in (0, SPARSE_KEYS - 1)
                               if b"k%012d" % i != overwritten][:1]
    prober = Prober(leader, sparse_records={k: value_of(k) for k in goldens},
                    sparse_absent_key=b"a%012d" % 0, journal=EventJournal())
    probes = {"before": {r["kind"]: (r["status"], r["ms"]) for r in prober.run_cycle()}}
    steps["sparse_probe_s"] = time.perf_counter() - t0

    # The rotation under traffic.
    t_rot = time.perf_counter()
    managers = SnapshotManager(leader), SnapshotManager(helper)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    held_before = held_staging_bytes([db, hdb])  # the Helper's a replica: one staging
    report, flipped = {}, [None]

    def rotate():
        while done.value < SPARSE_SERVING_WAVE // 4:
            time.sleep(0.001)
        report.update(RotationCoordinator(*managers).rotate(*gen1))
        flipped[0] = time.perf_counter()

    done.value = 0  # the rotation waits for this wave's answers
    rotator = threading.Thread(target=rotate)
    rotator.start()
    wave = closed_loop(SPARSE_SERVING_WAVE, hot=list(upserts), hot_share=0.5)
    rotator.join()
    if flipped[0] is None:
        raise AssertionError("sparse_serving: the rotation did not finish")
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated(dev)
    held_after = held_staging_bytes(gen1)
    counts, after_flip = {0: 0, 1: 0}, 0
    for q, value, _, digest, sent in wave:
        generation = bound.pop(digest)
        if generation not in counts:
            raise AssertionError(f"sparse_serving: {q!r} bound to {generation}")
        counts[generation] += 1
        check(q, value, generation)
        if sent > flipped[0]:
            after_flip += 1
            if generation != 1:
                raise AssertionError(f"sparse_serving: {q!r} sent after the flip "
                                     f"answered from generation {generation}")
    if not counts[0] or not after_flip:
        raise AssertionError(f"sparse_serving: the wave did not span the rotation "
                             f"({counts}, {after_flip} sent after it)")
    stages = {p: m.export() for p, m in zip(("leader", "helper"), managers)}
    for party, state in stages.items():
        stage = state["last_stage"]
        if (stage["mode"] != "delta" or stage["bytes_saved"] <= 0
                or stage["bytes_staged"] != rows * (8 + row_bytes)):
            raise AssertionError(f"sparse_serving: {party} staged {stage}, "
                                 f"{rows} touched rows of {row_bytes} B")
        if [d["generation"] for d in state["drains"]] != [0]:
            raise AssertionError(f"sparse_serving: {party} drains {state['drains']}")
    if db.staged_bytes() or hdb.staged_bytes():
        raise AssertionError("sparse_serving: generation 0 still holds its staging")
    if abs((mem_after - mem_before) - (held_after - held_before)) > 2 << 20:
        raise AssertionError(
            f"sparse_serving: memory_allocated {mem_after} after the drain, "
            f"{mem_before} before the rotation; the stagings held {held_after} "
            f"after, {held_before} before")
    steps["rotation_s"] = time.perf_counter() - t_rot
    # Every written key reads its new value.
    t0 = time.perf_counter()
    client = make_sparse_client(leader, encrypt_decrypt.encrypt)
    written = list(upserts)
    for k in range(0, len(written), SPARSE_CHECK_QUERIES):
        queries = written[k:k + SPARSE_CHECK_QUERIES]
        request, state = client.create_request(queries)
        for q, value in zip(queries, client.resolve(leader.handle_request(request), state)):
            if isinstance(value, KeyNotFound):
                value = None
            check(q, value, 1)
    steps["written_check_s"] = time.perf_counter() - t0
    # The sparse probes again on generation 1, the goldens rotated.
    newest = next(k for k in upserts if k.startswith(b"n"))
    prober.rotate_sparse_goldens({k: upserts.get(k, value_of(k)) for k in goldens + [newest]},
                                 generation=1)
    probes["after"] = {r["kind"]: (r["status"], r["ms"]) for r in prober.run_cycle()}
    probes["golden_keys_after"] = [k.decode() for k in prober._sparse_keys]
    emit({"phase": "sparse_probe", "config": "BASELINE.json configs[4], one card",
          **probes, "device": smi_line})
    if any(status != "pass" for when in ("before", "after")
           for status, _ in probes[when].values()) or \
            set(probes["after"]) != {"sparse_kv", "sparse_absent"}:
        raise AssertionError(f"sparse_probe: {probes}")
    # Another geometry is refused before anything stages.
    small = CuckooHashedDpfPirDatabase.Builder().set_params(
        CuckooHashingSparseDpfPirServer.generate_params(1000, seed=SPARSE_SEED))
    for i in range(1000):
        small.insert((b"k%012d" % i, bytes(SPARSE_VALUE_BYTES)))
    try:
        managers[0].stage(small.set_generation(2).build(device=dev))
    except SnapshotMismatch as e:
        refused = str(e)
    else:
        raise AssertionError("sparse_serving: a database of another geometry was staged")
    cost = leader.admission.admit(3)
    leader.admission.release(cost.cost)
    cells = sorted(c for c in costmodel.default_cost_ledger().export()["cells"]
                   if c.startswith("sparse/"))
    if cost.cost.unit != "sparse_keys" or not cells:
        raise AssertionError(f"sparse_serving: admission priced {cost.cost}, cells {cells}")
    for pipe in pipes:
        pipe.send(None)
    for proc in procs:
        proc.join(timeout=30)
        if proc.exitcode != 0:
            raise AssertionError(f"sparse_serving: a client process exited {proc.exitcode}")
    counters = leader.metrics.export()["counters"]
    emit({"phase": "sparse_serving", "config": "BASELINE.json configs[4], one card",
          "keys": SPARSE_KEYS, "value_bytes": SPARSE_VALUE_BYTES,
          "client_processes": SPARSE_SERVING_PROCESSES,
          "client_threads": SPARSE_SERVING_THREADS, "lookups_a_request": 1,
          "requests": SPARSE_SERVING_REQUESTS, "present_found": found,
          "absent": len(out) - found, "queries_per_sec": SPARSE_SERVING_REQUESTS / wall_s,
          "p50_ms": lat[len(lat) // 2], "p99_ms": lat[int(len(lat) * 0.99)],
          "by_party": launches,
          "write_batch": {"upserts": SPARSE_UPSERTS, "new_keys": SPARSE_UPSERTS // 2,
                          "touched_rows": rows, "row_bytes": row_bytes,
                          "size_after": gen1[0].size},
          "wave_requests": SPARSE_SERVING_WAVE, "answers_by_generation": counts,
          "answers_sent_after_flip": after_flip,
          "staleness_ms": report["staleness_ms"],
          "bytes_staged": {p: s["last_stage"]["bytes_staged"] for p, s in stages.items()},
          "bytes_saved": {p: s["last_stage"]["bytes_saved"] for p, s in stages.items()},
          "bytes_full_image": stages["leader"]["last_stage"]["bytes_full_image"],
          "bytes_freed": {p: s["drains"][0]["bytes_freed"] for p, s in stages.items()},
          "memory_allocated_before": mem_before, "memory_allocated_after": mem_after,
          "stagings_held_before": held_before, "stagings_held_after": held_after,
          "mismatch_retries": counters.get("leader.snapshot_retries", 0),
          "snapshot_mismatches": counters.get("leader.snapshot_mismatches", 0),
          "written_keys_checked": len(written), "geometry_refused": refused[:160],
          "admission_unit": cost.cost.unit, "admission_price_ms_3_keys": cost.cost.device_ms,
          "ledger_sparse_cells": cells, "steps_s": steps,
          "phase_s": time.perf_counter() - t_phase, "device": smi_line})
    leader_tcp.stop()
    helper_tcp.stop()
    leader.close()
    helper.close()
    del gen1


def stage_keys_numpy(dense_eval, keys, walk_levels):
    """`dense_eval.stage_keys_host` with the numpy walk (the plain version)
    in place of the native one: the staging figure of the trees before the
    native host library, beside it for one PR."""
    s0, c0, cws, cwl, cwr, vc = dense_eval.stage_keys_host(keys, 0)
    s0, c0 = dense_eval._walk_zeros_host_plain(s0, c0, cws, cwl, cwr, walk_levels)
    return s0, c0, cws[walk_levels:], cwl[walk_levels:], cwr[walk_levels:], vc


def two_party_phase(rng, dev, db, records, walk_levels: int, smi_line: str) -> dict:
    """BASELINE.json configs[1] served the way the reference is deployed:
    the client's `LeaderRequest` (its keys, and the Helper's encrypted to
    the fixed test keyset) through a Leader and a Helper
    `DenseDpfPirServer` on the card, in walk mode, over the main path's
    staged database; an in-process sender calls `while_waiting` (the
    Leader's own share) and then the Helper. Checks every record through
    `handle_response`, the Leader's share and the Helper's masked bytes
    against a plain server and the pad, the launch counts, and the native
    keygen and walk against their numpy plain versions; times each host
    step (median of `TWO_PARTY_REPS` rounds), the round trip's q/s and the
    device's idle share. Returns the counted launches."""
    import torch

    from distributed_point_functions_tpu_torch import prng, serialization
    from distributed_point_functions_tpu_torch.crypto import BACKEND
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirClient,
        DenseDpfPirServer,
        dense_eval,
        messages,
    )
    from distributed_point_functions_tpu_torch.pir.client import ENCRYPTION_CONTEXT_INFO
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    helper = DenseDpfPirServer.create_helper(db, encrypt_decrypt.decrypt, device=dev,
                                             expansion="walk")
    seen = []

    def sender(helper_request, while_waiting):
        while_waiting()
        seen.append(helper.handle_request(helper_request))
        return seen[-1]

    leader = DenseDpfPirServer.create_leader(db, sender, device=dev, expansion="walk")
    plain = DenseDpfPirServer.create_plain(db, device=dev, expansion="walk")
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    dpf = client.dpf
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, NUM_QUERIES)]
    want = [records[i] for i in idx]

    request, state = client.create_request(idx)
    leader.handle_request(request)  # warm-up
    torch.cuda.synchronize()
    out = []
    launches = counted(lambda: out.append(leader.handle_request(request)),
                       {"walk_descend": 4, "leaf_blocks": 2, "xor_inner_product": 2},
                       "two_party")
    combined = out[0].dpf_pir_response.masked_response
    if client.handle_response(out[0], state) != want:
        raise AssertionError("two_party: a record does not reconstruct")
    # The Helper's leg as it arrived, decrypted with the test keyset.
    ciphertext = request.leader_request.encrypted_helper_request.encrypted_request
    inner = messages.parse_helper_request(
        dpf, encrypt_decrypt.decrypt(ciphertext, ENCRYPTION_CONTEXT_INFO))
    if inner.one_time_pad_seed != state.one_time_pad_seed:
        raise AssertionError("two_party: the Helper's pad seed is not the client's")

    def share(keys):
        return plain.handle_plain_request(messages.PirRequest(
            plain_request=messages.PlainRequest(keys))).dpf_pir_response.masked_response

    helper_masked = seen[-1].dpf_pir_response.masked_response
    helper_share = share(inner.plain_request.dpf_keys)
    pad = prng.Aes128CtrSeededPrng(inner.one_time_pad_seed)
    if helper_masked != [prng.xor_bytes(r, pad.get_random_bytes(len(r)))
                         for r in helper_share]:
        raise AssertionError("two_party: the Helper's bytes are not its share XOR the pad")
    leader_keys = request.leader_request.plain_request.dpf_keys
    if [prng.xor_bytes(c, h) for c, h in zip(combined, helper_masked)] != share(leader_keys):
        raise AssertionError("two_party: the Leader's share differs from the plain server's")

    # Native keygen and walk against their numpy plain versions here.
    alphas = [i // 128 for i in idx]
    betas = [1 << (i % 128) for i in idx]
    roots = rng.integers(0, 1 << 32, (2, NUM_QUERIES, 4), dtype=np.uint32)
    if (dpf.generate_keys_batch(alphas, betas, _root_seeds=roots)
            != dpf._generate_keys_batch_plain(alphas, betas, _root_seeds=roots)):
        raise AssertionError("two_party: native keygen differs from the numpy keygen")
    staged = dense_eval.stage_keys_host(leader_keys, walk_levels)
    staged_np = stage_keys_numpy(dense_eval, leader_keys, walk_levels)
    if not all(np.array_equal(a, b) for a, b in zip(staged, staged_np)):
        raise AssertionError("two_party: the native walk differs from the numpy walk")
    if "google.protobuf" in sys.modules:
        raise AssertionError("two_party: google.protobuf was imported")

    # Host ms of each step: the median of TWO_PARTY_REPS rounds.
    helper_request = messages.HelperRequest(
        messages.PlainRequest(inner.plain_request.dpf_keys), inner.one_time_pad_seed)
    helper_bytes = messages.serialize_helper_request(dpf, helper_request)
    leader_wire = serialization.serialize_pir_request(dpf, request)
    leader_plain = messages.PirRequest(plain_request=request.leader_request.plain_request)
    helper_plain = messages.PirRequest(plain_request=inner.plain_request)
    steps = {
        "keygen_native_ms": lambda: dpf.generate_keys_batch(alphas, betas),
        "keygen_numpy_ms": lambda: dpf._generate_keys_batch_plain(alphas, betas),
        "helper_request_serialize_ms":
            lambda: messages.serialize_helper_request(dpf, helper_request),
        "encrypt_ms": lambda: encrypt_decrypt.encrypt(helper_bytes, ENCRYPTION_CONTEXT_INFO),
        "create_request_ms": lambda: client.create_request(idx),
        "leader_request_serialize_ms":
            lambda: serialization.serialize_pir_request(dpf, request),
        "leader_request_parse_ms": lambda: serialization.parse_pir_request(dpf, leader_wire),
        "helper_decrypt_ms":
            lambda: encrypt_decrypt.decrypt(ciphertext, ENCRYPTION_CONTEXT_INFO),
        "helper_parse_ms": lambda: messages.parse_helper_request(dpf, helper_bytes),
        "stage_keys_host_native_ms":
            lambda: dense_eval.stage_keys_host(leader_keys, walk_levels),
        "stage_keys_host_numpy_ms":
            lambda: stage_keys_numpy(dense_eval, leader_keys, walk_levels),
        "leader_serve_ms": lambda: leader.handle_plain_request(leader_plain),
        "helper_serve_ms": lambda: helper.handle_plain_request(helper_plain),
        "helper_mask_ms": lambda: prng.mask_all(
            helper_share, prng.Aes128CtrSeededPrng(inner.one_time_pad_seed)),
        "leader_combine_ms":
            lambda: [prng.xor_bytes(h, c) for h, c in zip(helper_masked, combined)],
        "leader_handle_request_ms": lambda: leader.handle_request(request),
        "unmask_ms": lambda: client.handle_response(out[0], state),
    }
    rounds = {name: host_ms(fn, TWO_PARTY_REPS) for name, fn in steps.items()}

    def round_trip():
        req, st = client.create_request(idx)
        client.handle_response(leader.handle_request(req), st)

    trips = host_ms(round_trip, 2 * TWO_PARTY_REPS)
    qps = sorted(NUM_QUERIES / t * 1e3 for t in trips)
    busy = device_busy(lambda: leader.handle_request(request))
    emit({"phase": "two_party", "records": NUM_RECORDS, "record_bytes": RECORD_BYTES,
          "queries": NUM_QUERIES, "expansion": "walk", "reconstructed": NUM_QUERIES,
          "launches": launches, "crypto_backend": BACKEND,
          "google_protobuf_loaded": "google.protobuf" in sys.modules,
          "native_keygen_equals_numpy": True, "native_walk_equals_numpy": True,
          "helper_request_bytes": len(helper_bytes), "ciphertext_bytes": len(ciphertext),
          "leader_request_bytes": len(leader_wire), "walk_levels": walk_levels,
          **{name: statistics.median(t) for name, t in rounds.items()},
          "rounds_ms": rounds,
          "round_trip_ms": statistics.median(trips), "round_trip_ms_all": trips,
          "queries_per_sec": statistics.median(qps),
          "queries_per_sec_min": qps[0], "queries_per_sec_max": qps[-1],
          **busy, "device": smi_line})
    return launches


# The serving phase: client processes and threads a process (64 clients),
# the requests of the closed loop and of the rotation wave, the
# sequential baseline, the rows the rotation updates, and the requests of
# the device-idle trace.
SERVING_PROCESSES = 4
SERVING_THREADS = 16
SERVING_REQUESTS = 4096
SERVING_ROTATION_REQUESTS = 1024
SERVING_SEQUENTIAL = 256
SERVING_UPDATES = 64
SERVING_TRACED = 128
# `overload` (after `serving_rotation`, on its databases): the admission
# budget, the requests' deadline, the saturation run's requests, the 2x
# open-loop run, the tenants' weights, the workload's Zipf exponent, the
# brownout ladder's batch cap, the recalibration drill's misprice.
OVERLOAD_BUDGET_MS = 300.0
OVERLOAD_DEADLINE_MS = 1000.0
OVERLOAD_SATURATION_REQUESTS = 512
OVERLOAD_TRACED = 128
OVERLOAD_SECONDS = 10.0
OVERLOAD_SENDERS = 24  # sender threads a client process
OVERLOAD_WEIGHTS = {"gold": 3.0, "bronze": 1.0}
OVERLOAD_ZIPF = 1.1
OVERLOAD_ZIPF_SEED = 7
OVERLOAD_BATCH_CAP = 8
OVERLOAD_MISPRICE = 2.0


def merged_busy_ms(intervals) -> float:
    """Length (ms) of the union of (start_us, end_us) intervals: the time
    the device ran at least one kernel, on any stream."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def wire_digest(data: bytes) -> bytes:
    import hashlib

    return hashlib.sha256(data).digest()[:16]


def serving_client(root: str, conn, port: int, num_records: int, seed: int,
                   left, done) -> None:
    """A client process of the serving phase (started with `spawn`; it
    never touches the card). Per command `(threads, hot, hot_share[,
    port])` from the pipe it runs `threads` closed-loop threads, each on
    its own TCP connection to the Leader (at `port`, else the process's),
    one query a request (record `hot[k]` with probability `hot_share`,
    else uniform), until the shared count `left` reaches 0, adding each
    answer to `done`; then it sends back [(index, answer, latency s,
    request digest, perf_counter at send)]. A failed request is sent back
    as its exception. A dict command runs `open_loop_wave` instead and
    sends back its records. None ends the process."""
    import threading

    sys.path.insert(0, root)
    from distributed_point_functions_tpu_torch import serialization
    from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient
    from distributed_point_functions_tpu_torch.serving import transport
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    client = DenseDpfPirClient.create(num_records, encrypt_decrypt.encrypt)
    wave = 0
    socks = {}  # (thread index, port) -> its connection, kept across waves
    conn.send("ready")
    while (cmd := conn.recv()) is not None:
        wave += 1
        if isinstance(cmd, dict):
            conn.send(open_loop_wave(client, cmd, np.random.default_rng([seed, wave])))
            continue
        threads, hot, hot_share = cmd[:3]
        to = cmd[3] if len(cmd) > 3 else port
        out, errors, lock = [], [], threading.Lock()

        def run(t):
            rng = np.random.default_rng([seed, wave, t])
            while not errors:
                with left.get_lock():
                    if left.value <= 0:
                        return
                    left.value -= 1
                i = (hot[int(rng.integers(0, len(hot)))]
                     if hot and rng.random() < hot_share
                     else int(rng.integers(0, num_records)))
                sent = time.perf_counter()
                try:
                    if (t, to) not in socks:
                        socks[t, to] = socket.create_connection(("127.0.0.1", to))
                    request, state = client.create_request([i])
                    wire = serialization.serialize_pir_request(client.dpf, request)
                    transport.send_msg(socks[t, to], wire)
                    response = serialization.parse_pir_response(
                        transport.recv_msg(socks[t, to]))
                    answer = client.handle_response(response, state)[0]
                except Exception as e:  # noqa: BLE001 - sent to the parent
                    errors.append(e)
                    return
                latency = time.perf_counter() - sent
                with lock:
                    out.append((i, answer, latency, wire_digest(wire), sent))
                with done.get_lock():
                    done.value += 1

        pool = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join()
        conn.send(errors[0] if errors else out)
    for sock in socks.values():
        sock.close()
    conn.close()


def zipf_indices(rng, n: int, num_records: int, exponent: float = OVERLOAD_ZIPF):
    """`n` record indices drawn with P(rank r) proportional to r^-exponent,
    ranks mapped to records by a fixed permutation (a Zipfian population
    whose hot records are spread over the database)."""
    cdf = np.cumsum(np.arange(1, num_records + 1, dtype=np.float64) ** -exponent)
    ranks = np.searchsorted(cdf, rng.random(n) * cdf[-1])
    return np.random.default_rng(OVERLOAD_ZIPF_SEED).permutation(num_records)[ranks]


def open_loop_wave(client, cmd: dict, rng) -> dict:
    """One open-loop wave of a client process: requests of one query
    arrive at `cmd["rate"]` a second for `cmd["duration_s"]`, each to a
    tenant drawn from `cmd["tenants"]` (its Leader port) and for a Zipfian
    record (`zipf_indices`), whatever the answers do; `cmd["threads"]`
    threads send them, each with its own connection a port, in a trace
    envelope so that a shed comes back typed. The process honors a shed's
    retry hint as the JAX package's overload test's clients do (at most
    50 ms): the tenant's arrivals within it are not sent, and are counted
    as deferred. Returns {"records": [(tenant, index, answer or None, shed
    (retry_after_s, message) or None, error text or None, latency s from
    the scheduled arrival, send lag s)], "deferred": {tenant: n}}."""
    import queue
    import threading

    from distributed_point_functions_tpu_torch import serialization
    from distributed_point_functions_tpu_torch.observability import propagation
    from distributed_point_functions_tpu_torch.serving import transport

    tenants = sorted(cmd["tenants"])
    n = int(cmd["rate"] * cmd["duration_s"])
    picks = rng.integers(0, len(tenants), n)
    indices = zipf_indices(rng, n, cmd["num_records"])
    arrivals: "queue.Queue" = queue.Queue()
    out, lock = [], threading.Lock()
    backoff = {t: 0.0 for t in tenants}  # perf_counter until which a tenant waits
    deferred = {t: 0 for t in tenants}

    def send(t):
        socks = {}
        while (item := arrivals.get()) is not None:
            t_sched, tenant, i = item
            lag = time.perf_counter() - t_sched
            answer = shed = error = None
            try:
                sock = socks.get(tenant)
                if sock is None:
                    sock = socks[tenant] = socket.create_connection(
                        ("127.0.0.1", cmd["tenants"][tenant]))
                request, state = client.create_request([i])
                wire = serialization.serialize_pir_request(client.dpf, request)
                transport.send_msg(sock, propagation.encode_request(
                    f"{t:04x}{i:012x}", wire, version=1))
                reply = transport.recv_msg(sock)
                try:
                    _, inner = propagation.try_decode_response(reply)
                    answer = client.handle_response(
                        serialization.parse_pir_response(inner), state)[0]
                except propagation.WireErrorResponse as e:
                    shed = (e.retry_after_s, str(e))
                    with lock:
                        backoff[tenant] = max(backoff[tenant], time.perf_counter()
                                              + min(e.retry_after_s, 0.05))
            except Exception as e:  # noqa: BLE001 - sent to the parent
                error = f"{type(e).__name__}: {e}"
                sock = socks.pop(tenant, None)
                if sock is not None:
                    sock.close()
            with lock:
                out.append((tenant, int(i), answer, shed, error,
                            time.perf_counter() - t_sched, lag))
        for sock in socks.values():
            sock.close()

    pool = [threading.Thread(target=send, args=(t,)) for t in range(cmd["threads"])]
    for th in pool:
        th.start()
    t0 = time.perf_counter() + 0.05
    for k in range(n):
        t_sched = t0 + k / cmd["rate"]
        delay = t_sched - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tenant = tenants[int(picks[k])]
        with lock:
            wait = time.perf_counter() < backoff[tenant]
            deferred[tenant] += wait
        if not wait:
            arrivals.put((t_sched, tenant, int(indices[k])))
    for _ in pool:
        arrivals.put(None)
    for th in pool:
        th.join()
    return {"records": out, "deferred": deferred}


def walk_selections_plain(staged, expand_levels: int, num_blocks: int):
    """The selection blocks of staged keys through the plain versions of
    walk mode's kernels (K4's head and tail, K2 for any level between,
    `leaf_blocks`), on the staged tensors' device: what
    `evaluate_selection_blocks_planes(..., mode="walk")` computes with the
    kernels."""
    import torch

    from distributed_point_functions_tpu_torch.ops import expand_planes as ep
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        exit_block_nodes,
        expansion_plan,
        pack_key_batch,
    )

    nk = staged[0].shape[0]
    state, ctrl, cwp, cwl, cwr, vc = pack_key_batch(*staged, expand_levels)
    kg = ctrl.shape[0]
    plan = expansion_plan("walk", kg, expand_levels)
    head, tail, _ = plan
    if not tail:
        raise AssertionError("walk mode's plan has no tail")
    if head:
        state, ctrl = ep.walk_descend_plain(state, ctrl, cwp[:head], cwl[:head],
                                            cwr[:head], node_lanes=kg)
    for lvl in range(head, expand_levels - tail):
        state, ctrl = ep.expand_level_plain(state, ctrl, cwp[lvl], cwl[lvl], cwr[lvl])
    a = expand_levels - tail
    values, _ = ep.walk_descend_plain(state, ctrl, cwp[a:], cwl[a:], cwr[a:], vc,
                                      value_hash=True, node_lanes=kg)
    block_node = torch.from_numpy(
        exit_block_nodes(expand_levels, *plan, True, num_blocks)).to(values.device)
    return ep.leaf_blocks_plain(
        values, ep.node_blocks(block_node, values.shape[-1] // kg), num_blocks)[:nk]


def serving_phase(dev, records, smi_line: str) -> None:
    """BASELINE.json configs[1] served as deployed by the serving runtime:
    a Helper and a Leader session, each over its own database on the card
    and behind a `FramedTcpServer` on loopback, the Leader reaching the
    Helper through a pool of TCP connections; `SERVING_PROCESSES` client
    processes of `SERVING_THREADS` threads send framed `LeaderRequest`s of
    one query each, closed loop. Each session's batcher coalesces them into
    power-of-two buckets on its own CUDA stream. Checks the kernels of
    every bucket from 1 to 128 keys at this size against their plain
    versions, every answer through `handle_response`, and the launches
    against the plans of the buckets formed; prints the `serving` line
    (q/s, latency, batches, pad waste, idle share) beside one sequential
    client's. Then rotates both parties to generation 1 (a delta of
    `SERVING_UPDATES` rows) under the same traffic and gates every
    answer's generation, the delta, and the freed staging
    (`serving_rotation`)."""
    import multiprocessing
    import threading

    import torch

    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
    from distributed_point_functions_tpu_torch.ops.inner_product import xor_inner_product
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirClient,
        DenseDpfPirDatabase,
        DenseDpfPirServer,
    )
    from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        evaluate_selection_blocks_planes,
    )
    from distributed_point_functions_tpu_torch.serving import (
        FramedTcpServer,
        HelperSession,
        LeaderSession,
        RotationCoordinator,
        ServingConfig,
        SnapshotManager,
        TcpTransportPool,
    )
    from distributed_point_functions_tpu_torch.serving.service import evaluated_generation
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    t_phase = time.perf_counter()
    steps = {}
    rng = np.random.default_rng(SEED + 40)
    config = ServingConfig(max_batch_size=128, max_wait_ms=2.0)
    ldb = DenseDpfPirDatabase(records, device=dev)
    hdb = DenseDpfPirDatabase(records, device=dev)
    ldb.staged()
    hdb.staged()
    helper = HelperSession(hdb, encrypt_decrypt.decrypt, config=config, device=dev)
    helper_tcp = FramedTcpServer(helper.handle_wire, host="127.0.0.1", name="helper").start()
    leader = LeaderSession(
        ldb, TcpTransportPool("127.0.0.1", helper_tcp.port,
                              SERVING_PROCESSES * SERVING_THREADS),
        config=config, device=dev)
    # The generation each request's Leader share bound to, by request digest.
    bound = {}

    def leader_wire(data):
        reply = leader.handle_wire(data)
        bound[wire_digest(data)] = evaluated_generation()
        return reply

    leader_tcp = FramedTcpServer(leader_wire, host="127.0.0.1", name="leader").start()
    # The clients start now, so that they import while the databases
    # stage and the buckets are checked.
    ctx = multiprocessing.get_context("spawn")
    left, done = ctx.Value("i", 0), ctx.Value("i", 0)
    procs, pipes = [], []
    root = str(Path(__file__).resolve().parent)
    for k in range(SERVING_PROCESSES):
        parent_end, child_end = ctx.Pipe()
        proc = ctx.Process(target=serving_client, daemon=True, args=(
            root, child_end, leader_tcp.port, NUM_RECORDS, SEED + 41 + k, left, done))
        proc.start()
        procs.append(proc)
        pipes.append(parent_end)
    steps["setup_s"] = time.perf_counter() - t_phase

    # The kernels of every bucket at this size against their plain
    # versions on the card: the selections of b keys (K4 x 2,
    # `leaf_blocks`) and K1 on them.
    t0 = time.perf_counter()
    server = leader.server
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    staged_db = ldb.staged()
    rows = ipk.rows_from_bitmajor(staged_db)[: NUM_RECORDS]
    buckets_checked = []
    for b in (1, 2, 4, 8, 16, 32, 64, 128):
        idx = [int(i) for i in rng.integers(0, NUM_RECORDS, b)]
        keys = client.create_plain_requests(idx)[0].plain_request.dpf_keys
        staged = stage_keys(keys, server.walk_levels, device=dev)
        sel = evaluate_selection_blocks_planes(
            *staged, expand_levels=server.expand_levels,
            num_blocks=ldb.num_selection_blocks, mode=server.expansion)
        if not torch.equal(sel, walk_selections_plain(
                staged, server.expand_levels, ldb.num_selection_blocks)):
            raise AssertionError(f"serving: bucket {b}'s selections differ from the plain versions")
        if not torch.equal(ipk.xor_inner_product_staged(staged_db, sel),
                           xor_inner_product(rows, sel, chunk=8192)):
            raise AssertionError(f"serving: bucket {b}'s inner products differ from the plain version")
        buckets_checked.append(b)
    del rows, staged_db, sel
    steps["bucket_check_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for pipe in pipes:
        if pipe.recv() != "ready":
            raise AssertionError("serving: a client process did not start")
    steps["clients_ready_s"] = time.perf_counter() - t0

    def closed_loop(total, hot=(), hot_share=0.0, processes=SERVING_PROCESSES,
                    threads=SERVING_THREADS, port=None):
        """`total` requests from `processes` x `threads` clients (to the
        Leader at `port`, else the first); returns [(index, answer,
        latency s, request digest, sent)]."""
        left.value = total
        done.value = 0
        for pipe in pipes[:processes]:
            pipe.send((threads, list(hot), hot_share)
                      + (() if port is None else (port,)))
        out = []
        for pipe in pipes[:processes]:
            got = pipe.recv()
            if isinstance(got, Exception):
                raise got
            out += got
        if len(out) != total:
            raise AssertionError(f"serving: {len(out)} answers of {total}")
        return out

    t0 = time.perf_counter()
    closed_loop(2 * SERVING_PROCESSES * SERVING_THREADS)  # warm-up
    torch.cuda.synchronize()
    steps["warmup_s"] = time.perf_counter() - t0
    parties = (("leader", leader), ("helper", helper))
    before = {p: launch_mark(s, p) for p, s in parties}
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = closed_loop(SERVING_REQUESTS)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = dict(cuda_lib.LAUNCHES)
    steps["closed_loop_s"] = wall_s
    # Each party's own launches (counted on its batch worker) against the
    # plans of its own batches, and all the process's against their sum.
    formed, want, per_party = {}, {}, {}
    for party, session in parties:
        formed[party], planned, per_party[party] = planned_launches(session, party,
                                                                    before[party])
        if per_party[party] != planned:
            raise AssertionError(f"serving: {party} launched {per_party[party]}, "
                                 f"its batches' plans {planned}")
        for name, n in planned.items():
            want[name] = want.get(name, 0) + n
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"serving: launch counts {got}, expected {want}")
    wrong = [i for i, answer, _, _, _ in out if answer != records[i]]
    if wrong:
        raise AssertionError(f"serving: {len(wrong)} answers differ from their records")
    lat = sorted(x[2] * 1e3 for x in out)
    nbatches = {p: sum(formed[p].values()) for p in formed}
    bucket_keys = {p: sum(b * n for b, n in formed[p].items()) for p in formed}
    # Each party answered every request with one key; the rest of its
    # buckets was padding.
    pad_waste = 1.0 - 2 * SERVING_REQUESTS / sum(bucket_keys.values())

    # The device's idle share: the union of kernel intervals on any
    # stream over the wall time of a traced closed loop.
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        closed_loop(SERVING_TRACED)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = merged_busy_ms(kernels) if kernels else None
    steps["trace_s"] = time.perf_counter() - t0

    # One client, sequential: the unbatched latency.
    t0 = time.perf_counter()
    seq = closed_loop(SERVING_SEQUENTIAL, processes=1, threads=1)
    seq_s = time.perf_counter() - t0
    steps["sequential_s"] = seq_s
    if [i for i, answer, _, _, _ in seq if answer != records[i]]:
        raise AssertionError("serving: a sequential answer differs from its record")
    seq_ms = sorted(x[2] * 1e3 for x in seq)
    for d in (x[3] for x in out + seq):
        bound.pop(d)
    emit({"phase": "serving", "records": NUM_RECORDS, "record_bytes": RECORD_BYTES,
          "client_processes": SERVING_PROCESSES, "client_threads": SERVING_THREADS,
          "requests": SERVING_REQUESTS, "queries_per_request": 1,
          "max_batch_size": config.max_batch_size, "max_wait_ms": config.max_wait_ms,
          "transport": "tcp loopback", "reconstructed": SERVING_REQUESTS,
          "launches": got, "launches_by_party": per_party,
          "buckets_checked_against_plain": buckets_checked,
          "queries_per_sec": SERVING_REQUESTS / wall_s,
          "p50_ms": lat[len(lat) // 2], "p99_ms": lat[int(len(lat) * 0.99)],
          "batches": nbatches, "batches_by_bucket": formed,
          "mean_keys_per_batch": {p: SERVING_REQUESTS / n for p, n in nbatches.items()},
          "pad_waste_share": pad_waste,
          "evaluate_ms_p50": {
              p: s.metrics.export()["histograms"][f"{p}.batcher.evaluate_ms"]["p50"]
              for p, s in (("leader", leader), ("helper", helper))},
          "traced_requests": SERVING_TRACED, "traced_wall_ms": traced_ms,
          "traced_device_events": len(kernels), "device_busy_ms": busy_ms,
          "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / traced_ms,
          "sequential_requests": SERVING_SEQUENTIAL,
          "sequential_p50_ms": seq_ms[len(seq_ms) // 2],
          "sequential_p99_ms": seq_ms[int(len(seq_ms) * 0.99)],
          "sequential_queries_per_sec": SERVING_SEQUENTIAL / seq_s,
          "helper_tcp_reconnects": leader._transport.reconnects, "steps_s": steps,
          "phase_s": time.perf_counter() - t_phase, "device": smi_line})

    # Rotation to generation 1 under the same traffic.
    t_rot = time.perf_counter()
    updated = [int(i) for i in rng.choice(NUM_RECORDS, SERVING_UPDATES, replace=False)]
    gen1 = {i: rng.bytes(RECORD_BYTES) for i in updated}
    builder = DenseDpfPirDatabase.Builder()
    for i in updated:
        builder.update(i, gen1[i])
    leader_mgr, helper_mgr = SnapshotManager(leader), SnapshotManager(helper)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    gen1_dbs = builder.build_from(ldb), builder.build_from(hdb)
    report, flipped = {}, [None]

    def rotate():
        while done.value < SERVING_ROTATION_REQUESTS // 4:
            time.sleep(0.001)
        report.update(RotationCoordinator(leader_mgr, helper_mgr).rotate(*gen1_dbs))
        flipped[0] = time.perf_counter()

    done.value = 0  # the rotation waits for this wave's answers
    rotator = threading.Thread(target=rotate)
    rotator.start()
    # Half the wave queries updated rows.
    wave = closed_loop(SERVING_ROTATION_REQUESTS, hot=updated, hot_share=0.5)
    rotator.join()
    if flipped[0] is None:
        raise AssertionError("serving_rotation: the rotation did not finish")
    del gen1_dbs
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated(dev)
    counts = {0: 0, 1: 0}
    after_flip = 0
    for i, answer, _, digest, sent in wave:
        generation = bound.pop(digest)
        if generation not in counts:
            raise AssertionError(f"serving_rotation: record {i} bound to {generation}")
        counts[generation] += 1
        value = gen1.get(i, records[i]) if generation == 1 else records[i]
        if answer != value:
            raise AssertionError(
                f"serving_rotation: record {i} is not its generation {generation} value")
        if sent > flipped[0]:
            after_flip += 1
            if generation != 1:
                raise AssertionError(f"serving_rotation: record {i} sent after the "
                                     f"flip answered from generation {generation}")
    if not counts[0] or not after_flip:
        raise AssertionError(f"serving_rotation: the wave did not span the rotation "
                             f"({counts}, {after_flip} sent after it)")
    stages = {"leader": leader_mgr.export(), "helper": helper_mgr.export()}
    for party, state in stages.items():
        stage = state["last_stage"]
        if stage["mode"] != "delta" or stage["bytes_saved"] <= 0:
            raise AssertionError(f"serving_rotation: {party} staged {stage}")
        if [d["generation"] for d in state["drains"]] != [0]:
            raise AssertionError(f"serving_rotation: {party} drains {state['drains']}")
    if ldb.staged_bytes() or hdb.staged_bytes():
        raise AssertionError("serving_rotation: generation 0 still holds its staging")
    if abs(mem_after - mem_before) > 2 << 20:
        raise AssertionError(
            f"serving_rotation: memory_allocated {mem_after} after the drain, "
            f"{mem_before} before the rotation")
    counters = leader.metrics.export()["counters"]
    emit({"phase": "serving_rotation", "updated_rows": SERVING_UPDATES,
          "requests": SERVING_ROTATION_REQUESTS, "answers_by_generation": counts,
          "answers_sent_after_flip": after_flip,
          "staleness_ms": report["staleness_ms"],
          "bytes_staged": {p: s["last_stage"]["bytes_staged"] for p, s in stages.items()},
          "bytes_saved": {p: s["last_stage"]["bytes_saved"] for p, s in stages.items()},
          "bytes_full_image": stages["leader"]["last_stage"]["bytes_full_image"],
          "mismatch_retries": counters.get("leader.snapshot_retries", 0),
          "snapshot_mismatches": counters.get("leader.snapshot_mismatches", 0),
          "bytes_freed": {p: s["drains"][0]["bytes_freed"] for p, s in stages.items()},
          "flips": {p: s["history"] for p, s in stages.items()},
          "memory_allocated_before": mem_before, "memory_allocated_after": mem_after,
          "rotation_s": time.perf_counter() - t_rot,
          "phase_s": time.perf_counter() - t_phase, "device": smi_line})
    # The prober and the admin endpoint on the same sessions, generation 1.
    prober_phase(dev, leader, helper, leader_mgr,
                 [gen1.get(i, records[i]) for i in range(NUM_RECORDS)], closed_loop, bound,
                 SERVING_REQUESTS / wall_s, smi_line)
    leader_tcp.stop()
    helper_tcp.stop()
    leader.close()
    helper.close()
    overload_phase(dev, leader.server.database, helper.server.database,
                   lambda i: gen1.get(i, records[i]), closed_loop, pipes,
                   SERVING_REQUESTS / wall_s, smi_line)
    for pipe in pipes:
        pipe.send(None)
    for proc in procs:
        proc.join(timeout=30)
        if proc.exitcode != 0:
            raise AssertionError(f"serving: a client process exited {proc.exitcode}")


PROBE_PERIOD_S = 0.5
PROBE_MAX_DUTY = 0.05
# A probe kind is fresh this long after its last pass: longer than a
# cycle under the wave's load, so a scrape right after a cycle is healthy.
PROBE_FRESHNESS_S = 5.0
PROBE_WAVE_CHUNK = 128  # requests a closed-loop round of the prober's wave
PROBE_WAVE_CAP_S = 90.0  # for the loop's first cycle under the wave
# Past the second cycle's promised start (the first cycle's end and the
# sleep its duty cycle forces), and the wave's limit in all.
PROBE_WAVE_SLACK_S = 20.0
PROBE_WAVE_MAX_S = 240.0
PORT_KERNELS = ("expand_level_kernel", "leaf_blocks_kernel", "path_walk_kernel",
                "repeat_tiles_kernel", "subtree_kernel", "value_hash_kernel",
                "xor_counts_kernel", "xor_ip_kernel")


def prober_phase(dev, leader, helper, manager, records_now, closed_loop, bound,
                 capacity_qps: float, smi_line: str) -> None:
    """The blackbox prober and the admin endpoint on `serving_phase`'s TCP
    Leader and Helper at generation 1 (`records_now`: configs[1]'s records
    with the rotation's rows), with a workload observatory on the Leader,
    a time-series sampler of its registry, a forecaster of the arrival
    rate (the Leader's requests a second) against `capacity_qps` (the
    phase's closed-loop saturation) and
    a `BundleManager` on the prober's failure listener, all attached to
    one `AdminServer`.

    1. `prober`: one cycle of every dense kind, `leader_e2e` and
       `hh_sweep` with no other traffic, each `ok` and launching exactly
       its plan (`probe_want_launches`).
    2. `prober_drill`: one word XORed into a golden record's row of every
       staging the Leader serves: within one cycle every dense kind is a
       `mismatch` and journaled, `/healthz` 503 once the last pass is
       older than the window, one bundle with `statusz`, `metrics` and
       `probes` (the admin's name for the prober's source); undone, the
       next cycle `recovered` and `/healthz` 200. `leader_e2e` is
       reported, not gated: the Helper's database stays clean. (Before
       the wave, so that the wait for the window overlaps nothing.)
    3. `prober_loop` and `admin`: the background loop during a wave of
       the 64 clients, in rounds of PROBE_WAVE_CHUNK requests until the
       loop's second cycle has begun and the admin scrape is done: the
       duty cycle of the loop's complete period (a cycle's busy time
       over the time to the next cycle's start) at or under
       PROBE_MAX_DUTY, no probe failed, every answer its record. Every
       admin route once (`scrape_admin`; `/healthz` right after the
       loop's first cycle, the rest once the sampler holds 10 points):
       each route's status and content type as ADMIN_ROUTES says,
       `/metrics` sample lines parse as Prometheus text and hold
       `prober_probes`, `/timeseriesz` holds samples, the forecast a
       time-to-breach of the arrival rate, and `/profilez`'s trace names
       a port kernel."""
    import threading

    import torch

    from distributed_point_functions_tpu_torch.heavy_hitters import HeavyHittersConfig
    from distributed_point_functions_tpu_torch.observability import (
        AdminServer,
        BundleManager,
        Forecaster,
        MetricsSampler,
    )
    from distributed_point_functions_tpu_torch.observability.events import EventJournal
    from distributed_point_functions_tpu_torch.observability.utilization import (
        default_utilization_tracker,
    )
    from distributed_point_functions_tpu_torch.observability.workload import (
        WorkloadObservatory,
    )
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.serving.prober import Prober
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt
    from distributed_point_functions_tpu_torch.utils.profiling import TRACE_FILE

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="dpf-operator-"))
    journal = EventJournal()
    hh_config = HeavyHittersConfig(domain_bits=8, level_bits=4, threshold=2)
    prober = Prober(leader, records_now, encrypter=encrypt_decrypt.encrypt,
                    hh_values=HH_SMALL_VALUES, hh_config=hh_config,
                    period_s=PROBE_PERIOD_S, max_duty_cycle=PROBE_MAX_DUTY,
                    freshness_window_s=PROBE_FRESHNESS_S, journal=journal)
    observatory = WorkloadObservatory()
    leader.attach_workload(observatory)
    requests = leader.metrics.histogram("leader.request_ms")
    last = [time.monotonic(), requests.export()["count"]]

    def arrival_rate():
        """The Leader's requests a second since the last sample."""
        now, count = time.monotonic(), requests.export()["count"]
        rate = (count - last[1]) / max(1e-6, now - last[0])
        last[:] = [now, count]
        return {"leader.arrival_qps": rate}

    sampler = MetricsSampler(registry=leader.metrics,
                             utilization=default_utilization_tracker(),
                             extra_sources=[arrival_rate], journal=journal)
    forecaster = Forecaster(sampler.store, window_s=60.0, horizon_s=120.0, min_points=8,
                            journal=journal)
    forecaster.watch("leader.arrival_qps", ceiling=capacity_qps)
    bundles = BundleManager(str(work / "bundles"), journal=journal)
    prober.add_failure_listener(bundles.on_probe_failure)
    admin = AdminServer(registry=leader.metrics, profile_dir=str(work), journal=journal,
                        prober=prober, bundles=bundles, capacity=leader.capacity_accuracy,
                        snapshots=manager, timeseries=sampler, workload=observatory,
                        forecast=forecaster).start()
    sampler.start()
    base = f"http://127.0.0.1:{admin.port}"

    # 1. One probe of every kind, each against its plan.
    t0 = time.perf_counter()
    warm = prober.run_cycle()  # also stages the generation's tier layouts
    if any(r["status"] != "pass" for r in warm):
        raise AssertionError(f"prober: the first cycle {warm}")
    per_kind = {}
    for kind in prober.kinds():
        cuda_lib.reset_launch_counts()
        result = prober._run_one(kind)
        torch.cuda.synchronize()
        got = {name: n for name, n in cuda_lib.LAUNCHES.items() if n}
        prober._record(result)
        want = probe_want_launches(prober, kind)
        plan = None if kind == "hh_sweep" else probe_plan(prober, kind)[0]
        per_kind[kind] = {"status": result["status"], "ms": result["ms"],
                          "launches": got, "plan_launches": want,
                          "plan": None if plan is None else {
                              f: getattr(plan, f) for f in (
                                  "mode", "cut_levels", "chunk_levels", "num_chunks")}}
        if result["status"] != "pass" or got != want:
            raise AssertionError(f"prober: {kind} {per_kind[kind]} {result['detail']}")
    emit({"phase": "prober", "records": len(records_now), "record_bytes": RECORD_BYTES,
          "golden_indices": prober._indices, "kinds": per_kind,
          "first_cycle_ms": [r["ms"] for r in warm],
          "step_s": time.perf_counter() - t0, "device": smi_line})

    # 2. Wrong bits in the Leader's stagings, then undone.
    t0 = time.perf_counter()
    db = leader.server.database
    row = prober._indices[0]
    stagings = xor_staged_word(db, row, 0, 1)
    torch.cuda.synchronize()
    drilled = {r["kind"]: r for r in prober.run_cycle()}
    mismatches = journal.tail(n=256, kind="prober.mismatch")
    health = http_get(base + "/healthz")[0]
    deadline = time.monotonic() + PROBE_FRESHNESS_S + 5.0
    while health != 503 and time.monotonic() < deadline:
        time.sleep(0.25)
        health = http_get(base + "/healthz")[0]
    made = bundles.bundles()
    manifest = {}
    if made and made[0].get("path"):
        with open(Path(made[0]["path"]) / "manifest.json") as f:
            manifest = json.load(f)
    xor_staged_word(db, row, 0, 1)
    torch.cuda.synchronize()
    recovered = {r["kind"]: r["status"] for r in prober.run_cycle()}
    recovered_events = journal.tail(n=256, kind="prober.recovered")
    health_after = http_get(base + "/healthz")[0]
    dense = ("pir_materialized", "pir_streaming", "pir_chunked", "pir_unbatched")
    drill = {"phase": "prober_drill", "row": row, "stagings_changed": stagings,
             "statuses": {k: r["status"] for k, r in drilled.items()},
             "leader_e2e": drilled["leader_e2e"]["status"],
             "mismatch_events": len(mismatches), "healthz_during": health,
             "bundles": len(made), "bundle_sources": sorted(manifest.get("sources", {})),
             "recovered": recovered, "recovered_events": len(recovered_events),
             "healthz_after": health_after, "step_s": time.perf_counter() - t0,
             "device": smi_line}
    emit(drill)
    if [drilled[k]["status"] for k in dense] != ["mismatch"] * 4 or len(mismatches) < 4:
        raise AssertionError(f"prober_drill: {drill['statuses']}, {len(mismatches)} events")
    if health != 503 or health_after != 200:
        raise AssertionError(f"prober_drill: /healthz {health} then {health_after}")
    if len(made) != 1 or not {"statusz", "metrics", "probes"} <= set(manifest["sources"]):
        raise AssertionError(f"prober_drill: bundles {made}")
    if any(s != "pass" for s in recovered.values()) or \
            {e["probe_kind"] for e in recovered_events} < set(dense):
        raise AssertionError(f"prober_drill: after the undo {recovered}")
    # 3. The background loop during a wave, and the admin scrape.
    def last_seq():
        return max((r["seq"] for h in prober.export()["history"].values() for r in h),
                   default=0)

    k = len(prober.kinds())
    seq0 = last_seq()
    scraped = {}

    def scrape():
        """`/healthz` right after the loop's first cycle (its passes are
        fresh), the other routes once the sampler holds 10 points of the
        arrival rate (the forecast's history)."""
        deadline = time.monotonic() + PROBE_WAVE_CAP_S
        while last_seq() < seq0 + k and time.monotonic() < deadline:
            time.sleep(0.005)
        scraped.update(scrape_admin(admin.port, ["/healthz"]))
        while (len(sampler.store.series("leader.arrival_qps")) < 10
               and time.monotonic() < deadline):
            time.sleep(0.05)
        scraped.update(scrape_admin(admin.port, [r for r in ADMIN_ROUTES if r != "/healthz"]))

    def wave_deadline():
        """The wave's end on the prober's clock: PROBE_WAVE_CAP_S for the
        loop's first cycle, then the second cycle's promised start (the
        first cycle's end and the sleep its duty cycle forces, so a slow
        host lengthens the period and not the gate) and
        PROBE_WAVE_SLACK_S, never past PROBE_WAVE_MAX_S."""
        first = [r for h in prober.export()["history"].values() for r in h
                 if seq0 < r["seq"] <= seq0 + k]
        if len(first) < k:
            return t_loop + PROBE_WAVE_CAP_S
        start = min(r["t_mono"] - r["ms"] / 1e3 for r in first)
        end = max(r["t_mono"] for r in first)
        promised = end + (end - start) * (1.0 / PROBE_MAX_DUTY - 1.0)
        return min(promised + PROBE_WAVE_SLACK_S, t_loop + PROBE_WAVE_MAX_S)

    scraper = threading.Thread(target=scrape)
    prober.start()
    t_loop = time.monotonic()
    scraper.start()
    answers = []
    # The wave lasts until the loop's second cycle has begun: one whole
    # period (a cycle and the sleep its duty cycle forces) under load.
    while ((scraper.is_alive() or last_seq() <= seq0 + k)
           and time.monotonic() < wave_deadline()):
        answers += closed_loop(PROBE_WAVE_CHUNK)
    wave_s = time.monotonic() - t_loop
    prober.stop()
    scraper.join(timeout=60)
    wrong = [i for i, answer, _, _, _ in answers if answer != records_now[i]]
    for x in answers:
        bound.pop(x[3], None)
    # The loop's cycles, from the probes' end times and durations.
    results = sorted((r for h in prober.export()["history"].values() for r in h
                      if r["seq"] > seq0), key=lambda r: r["seq"])
    cycles = [results[i:i + k] for i in range(0, len(results) - k + 1, k)]
    spans = [(c[0]["t_mono"] - c[0]["ms"] / 1e3, c[-1]["t_mono"],
              sum(r["ms"] for r in c) / 1e3) for c in cycles]
    periods = [(spans[i][2], spans[i + 1][0] - spans[i][0]) for i in range(len(spans) - 1)]
    duty = max((busy / period for busy, period in periods), default=None)
    failed = [r for r in results if r["status"] != "pass"]
    loop = {"phase": "prober_loop", "clients": SERVING_PROCESSES * SERVING_THREADS,
            "wave_requests": len(answers), "wave_s": wave_s,
            "wave_limit_s": wave_deadline() - t_loop,
            "wave_queries_per_sec": len(answers) / wave_s, "cycles": len(cycles),
            "cycle_ms": [(end - start) * 1e3 for start, end, _ in spans],
            "cycle_busy_ms": [busy * 1e3 for _, _, busy in spans],
            "periods_s": [period for _, period in periods],
            "duty_cycle": duty, "max_duty_cycle": PROBE_MAX_DUTY,
            "duty_cycle_over_wave": sum(b for _, _, b in spans) / wave_s,
            "probe_ms": {kind: [r["ms"] for r in results if r["kind"] == kind]
                         for kind in prober.kinds()},
            "failed": len(failed), "wrong_answers": len(wrong), "device": smi_line}
    emit(loop)
    if wrong or failed:
        raise AssertionError(f"prober_loop: {len(wrong)} wrong answers, failed {failed[:3]}")
    if duty is None or duty > PROBE_MAX_DUTY:
        raise AssertionError(
            f"prober_loop: duty cycle {duty} over {len(periods)} periods; cycles busy "
            f"{loop['cycle_busy_ms']} ms, the wave {wave_s:.1f} of {loop['wave_limit_s']:.1f} s")

    statuses = {route: scraped[route][:2] for route in ADMIN_ROUTES if route in scraped}
    metrics_text = scraped["/metrics"][2].decode() if scraped else ""
    samples = [line for line in metrics_text.splitlines() if line and not line.startswith("#")]
    unparsed = [line for line in samples if not PROMETHEUS_SAMPLE.match(line)]
    forecast = forecaster.last_run() or {}
    rate = next((e for e in forecast.get("series", [])
                 if e.get("series") == "leader.arrival_qps"), {})
    trace_names = []
    if statuses.get("/profilez", (None,))[0] == 200:
        with open(Path(json.loads(scraped["/profilez"][2])["log_dir"]) / TRACE_FILE) as f:
            names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
        trace_names = sorted(k for k in PORT_KERNELS if any(k in n for n in names))
    series = sampler.store.export().get("series_count", 0)
    admin_line = {"phase": "admin", "routes": len(scraped),
                  "status": {r: s for r, (s, _) in statuses.items()},
                  "metrics_samples": len(samples), "metrics_unparsed": unparsed[:5],
                  "prober_probes_exposed": "prober_probes " in metrics_text,
                  "timeseries_series": series,
                  "timeseries_samples": sampler.export().get("samples_taken"),
                  "arrival_rate_forecast": {k: rate.get(k) for k in (
                      "state", "last", "ceiling", "time_to_breach_s",
                      "time_to_breach_earliest_s")},
                  "profile_kernels": trace_names, "device": smi_line}
    emit(admin_line)
    if statuses != ADMIN_ROUTES:
        raise AssertionError(f"admin: {statuses}")
    if unparsed or not samples or "prober_probes " not in metrics_text:
        raise AssertionError(f"admin: /metrics {len(samples)} samples, unparsed {unparsed[:3]}")
    if not series or rate.get("time_to_breach_earliest_s") is None:
        raise AssertionError(f"admin: {series} series, arrival-rate forecast {rate}")
    if not trace_names:
        raise AssertionError("admin: the /profilez trace names no port kernel")

    admin.stop()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "operator_steps", "seconds": time.perf_counter() - t_phase})


def shed_reason(message: str):
    """The admission reason in an `Overloaded` message ("... shed at
    admission (quota); ...") that crossed the wire, or None."""
    import re

    m = re.search(r"shed at admission \((\w+)\)", message)
    return m.group(1) if m else None


def overload_phase(dev, ldb, hdb, current, closed_loop, pipes, serving_qps: float,
                   smi_line: str) -> None:
    """`overload` at configs[1]: new Leader and Helper sessions over the
    `serving` phase's databases (generation 1), the Leader with cost-aware
    admission priced by a model calibrated from that phase's closed-loop
    q/s through a history file, then from step 1's saturation (the
    file's newest record), and tenants on Leader ports of their own
    (the wire carries no tenant): `default` (priority 1), `gold` (weight
    3, priority 2) and `bronze` (weight 1, priority 1), each with a quota
    of its weight's share of the saturation, and `batch` (priority 0).
    1. Saturation: closed-loop clients, as many as keep the queue's
       priced cost just under the admission budget; q/s, then a traced run
       (the union of kernel intervals: the idle share) beside the
       utilization tracker's duty cycle and bubbles over the same run.
    2. Twice the saturation, open loop, for `OVERLOAD_SECONDS`, half to
       gold and half to bronze, a 1 s deadline: goodput at least 0.70 of
       the saturation; sheds > 0, each with a hint and a reason; nothing
       expired in a batch; completed keys per tenant within 15% of 3:1.
    3. The brownout ladder, `force_level` 1, 2, 3, 4, 0, with requests of
       priorities 0, 1 and 2 at each: the floor sheds (reason
       `priority`), level 2 forms no batch above the cap under a burst,
       level 3's launches of each party equal the streaming plan, level 0
       restores the tier, the cap and the floor.
    4. Recalibration: a model of this run's own bucket-8 device ms,
       mispriced 2x by its constructor, learns a factor toward 0.5 (clamp
       0.25-4) from the ledger's windows of 16 batches: within 0.15 of
       the factor that makes its price the drill's own measured ms (0.5
       while the batches take what they took in the calibration);
       `set_enabled(False)` gives the raw price back.
    Every answer must equal its record. Prints the `overload` line."""
    import torch

    from distributed_point_functions_tpu_torch import serialization
    from distributed_point_functions_tpu_torch.capacity import (
        BrownoutController,
        CapacityModel,
        Recalibrator,
        TenantPolicy,
        ThroughputCalibration,
        set_default_capacity_model,
    )
    from distributed_point_functions_tpu_torch.observability import costmodel, propagation
    from distributed_point_functions_tpu_torch.observability.utilization import (
        default_utilization_tracker,
    )
    from distributed_point_functions_tpu_torch.observability.workload import (
        WorkloadObservatory,
    )
    from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient
    from distributed_point_functions_tpu_torch.pir import server as server_mod
    from distributed_point_functions_tpu_torch.serving import (
        FramedTcpServer,
        HelperSession,
        LeaderSession,
        ServingConfig,
        TcpTransportPool,
        transport,
    )
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    t_phase = time.perf_counter()
    steps = {}
    tmp = tempfile.mkdtemp(prefix="dpf_overload_")
    history = Path(tmp) / "history.jsonl"
    history.write_text(json.dumps({"metric": "serving_closed_loop_queries_per_sec",
                                   "value": serving_qps, "status": "ok"}) + "\n")
    model = CapacityModel(calibration=ThroughputCalibration(str(history)))
    previous_model = set_default_capacity_model(model)
    price_ms = model.price_pir_keys(1).device_ms
    config = ServingConfig(max_batch_size=128, max_wait_ms=2.0,
                           request_timeout_ms=OVERLOAD_DEADLINE_MS)
    helper = HelperSession(hdb, encrypt_decrypt.decrypt, config=config, device=dev)
    helper_tcp = FramedTcpServer(helper.handle_wire, host="127.0.0.1",
                                 name="helper").start()
    leader = LeaderSession(
        ldb, TcpTransportPool("127.0.0.1", helper_tcp.port, 2 * SERVING_PROCESSES
                              * max(SERVING_THREADS, OVERLOAD_SENDERS)),
        config=dataclasses.replace(config, admission_enabled=True,
                                   admission_queue_budget_ms=OVERLOAD_BUDGET_MS),
        device=dev)
    tracker = default_utilization_tracker()
    observatory = leader.attach_workload(WorkloadObservatory())
    front_door = WorkloadObservatory(name="front_door")
    ports, servers = {}, []
    for tenant in ("default", "gold", "bronze", "batch"):
        tcp = FramedTcpServer(lambda data, tenant=tenant: leader.handle_wire(data, tenant),
                              host="127.0.0.1", name=f"leader-{tenant}").start()
        ports[tenant] = tcp.port
        servers.append(tcp)
    leader.set_tenant("batch", TenantPolicy(priority=0))

    def wrong(out):
        return [i for i, answer, *_ in out if answer != current(i)]

    def counters():
        return leader.metrics.export()["counters"]

    # 1. Saturation just under the budget.
    threads = max(1, int(0.8 * OVERLOAD_BUDGET_MS / price_ms) // SERVING_PROCESSES)
    closed_loop(2 * SERVING_PROCESSES * threads, threads=threads, port=ports["default"])
    tracker.reset()
    before = counters()
    t0 = time.perf_counter()
    sat = closed_loop(OVERLOAD_SATURATION_REQUESTS, threads=threads, port=ports["default"])
    sat_s = time.perf_counter() - t0
    sat_util = tracker.export()
    saturation = OVERLOAD_SATURATION_REQUESTS / sat_s
    sat_shed = counters().get("leader.batcher.requests_shed", 0) - before.get(
        "leader.batcher.requests_shed", 0)
    if wrong(sat):
        raise AssertionError(f"overload: {len(wrong(sat))} saturation answers differ")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        closed_loop(OVERLOAD_TRACED, threads=threads, port=ports["default"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = merged_busy_ms(kernels) if kernels else None
    steps["saturation_s"] = time.perf_counter() - t0
    # The saturation is this run's newest clean record: admission prices
    # the rest of the phase at the rate these sessions sustain.
    with history.open("a") as f:
        f.write(json.dumps({"metric": "serving_closed_loop_queries_per_sec",
                            "value": saturation, "status": "ok"}) + "\n")
    model = CapacityModel(calibration=ThroughputCalibration(str(history)))
    leader.admission.model = model
    set_default_capacity_model(model)

    # 2. Twice the saturation, open loop, two tenants backlogged.
    for tenant, weight in OVERLOAD_WEIGHTS.items():
        rate = saturation * weight / sum(OVERLOAD_WEIGHTS.values())
        leader.set_tenant(tenant, TenantPolicy(weight=weight, priority=2 if weight > 1 else 1,
                                               rate_qps=rate, burst=max(4.0, 0.25 * rate)))
    tracker.reset()
    before = counters()
    t0 = time.perf_counter()
    for pipe in pipes:
        pipe.send({"rate": 2 * saturation / len(pipes), "duration_s": OVERLOAD_SECONDS,
                   "threads": OVERLOAD_SENDERS, "num_records": NUM_RECORDS,
                   "tenants": {t: ports[t] for t in OVERLOAD_WEIGHTS}})
    waves = [pipe.recv() for pipe in pipes]
    records = [r for w in waves for r in w["records"]]
    deferred = {t: sum(w["deferred"][t] for w in waves) for t in OVERLOAD_WEIGHTS}
    over_s = time.perf_counter() - t0
    over_util = tracker.export()
    after = counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    steps["overload_s"] = over_s
    answered = [r for r in records if r[2] is not None]
    sheds = [r for r in records if r[3] is not None]
    errors = [r for r in records if r[4] is not None]
    bad = [r for r in answered if r[2] != current(r[1])]
    if bad:
        raise AssertionError(f"overload: {len(bad)} answers under overload differ")
    in_deadline = [r for r in answered if r[5] <= OVERLOAD_DEADLINE_MS / 1e3]
    goodput = len(in_deadline) / OVERLOAD_SECONDS
    reasons = {}
    for r in sheds:
        reason = shed_reason(r[3][1])
        if r[3][0] <= 0 or reason is None:
            raise AssertionError(f"overload: a shed without a hint or a reason: {r[3]}")
        reasons[reason] = reasons.get(reason, 0) + 1
    keys = {t: sum(1 for r in answered if r[0] == t) for t in OVERLOAD_WEIGHTS}
    shares = {t: keys[t] / max(1, sum(keys.values())) for t in keys}
    for r in records:
        front_door.observe(num_keys=1, tenant=r[0], key_indices=[r[1]])
    # Step 2's gates, raised after the line is printed.
    failures = []
    if goodput < 0.70 * saturation:
        failures.append(f"goodput {goodput:.1f} q/s below 0.70 x the saturation "
                        f"{saturation:.1f}")
    if not sheds:
        failures.append("twice the saturation shed nothing")
    if delta.get("leader.batcher.expired_in_batch", 0):
        failures.append(f"{delta['leader.batcher.expired_in_batch']} requests expired "
                        "in a batch")
    for t, w in OVERLOAD_WEIGHTS.items():
        want = w / sum(OVERLOAD_WEIGHTS.values())
        if abs(shares[t] - want) > 0.15 * want:
            failures.append(f"tenant {t} completed {shares[t]:.3f} of the keys, its "
                            f"weight's share is {want:.3f} ({keys})")
    lat = sorted(r[5] * 1e3 for r in answered)

    # 3. The brownout ladder.
    t0 = time.perf_counter()
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    socks = {}
    rng = np.random.default_rng(SEED + 42)

    def ask(tenant, queries=1):
        """One enveloped request of `queries` queries from the parent:
        (answers, None) or (None, shed reason)."""
        idx = [int(i) for i in rng.integers(0, NUM_RECORDS, queries)]
        if tenant not in socks:
            socks[tenant] = socket.create_connection(("127.0.0.1", ports[tenant]))
        request, state = client.create_request(idx)
        transport.send_msg(socks[tenant], propagation.encode_request(
            "%016x" % int(rng.integers(0, 1 << 62)),
            serialization.serialize_pir_request(client.dpf, request), version=1))
        try:
            _, inner = propagation.try_decode_response(transport.recv_msg(socks[tenant]))
        except propagation.WireErrorResponse as e:
            if e.retry_after_s <= 0:
                raise AssertionError(f"overload: a shed without a hint: {e}")
            return None, shed_reason(str(e))
        answers = client.handle_response(serialization.parse_pir_response(inner), state)
        if answers != [current(i) for i in idx]:
            raise AssertionError(f"overload: an answer to {tenant} differs from its record")
        return answers, None

    for tenant in OVERLOAD_WEIGHTS:  # the ladder's requests are not quota's
        leader.set_tenant(tenant, TenantPolicy(weight=OVERLOAD_WEIGHTS[tenant],
                                               priority=2 if tenant == "gold" else 1))
    ladder = leader.attach_brownout(BrownoutController(signal=lambda: False),
                                    batch_cap=OVERLOAD_BATCH_CAP, cheap_tier="streaming")
    parties = (("leader", leader), ("helper", helper))
    served = {"batch": 0, "bronze": 1, "gold": 2}
    ladder_log = []
    for level in (1, 2, 3, 4, 0):
        ladder.force_level(level)
        floor = {0: 0, 1: 1, 2: 1, 3: 1, 4: 2}[level]
        own = {p: launch_mark(s, p) for p, s in parties}
        n_served = 0
        for tenant, priority in served.items():
            got, reason = ask(tenant)
            if (got is None) != (priority < floor) or (got is None and reason != "priority"):
                raise AssertionError(f"overload: level {level}, {tenant} (priority "
                                     f"{priority}) gave {got!r} / {reason}")
            n_served += got is not None
        entry = {"level": level, "served": n_served,
                 "min_priority": leader.admission.min_priority,
                 "batch_cap": leader.batcher.batch_cap, "tier_floor": server_mod.tier_floor()}
        plan = leader.server._plan_serving(1)
        for party, session in parties:
            formed, want, got = planned_launches(session, party, own[party])
            if got != want or formed != {1: n_served}:
                raise AssertionError(f"overload: level {level}, {party} launched {got} "
                                     f"in batches {formed}, the {plan.mode} plan {want}")
        entry["plan"] = plan.mode
        entry["launches_a_party"] = want
        if level == 2:
            b0 = bucket_batches(leader, "leader")
            # As many clients as keep the queue's priced cost under the
            # budget at the recalibrated price.
            burst_threads = max(1, int(0.8 * OVERLOAD_BUDGET_MS / model.price_pir_keys(
                1).device_ms) // SERVING_PROCESSES)
            burst = closed_loop(SERVING_PROCESSES * burst_threads * 4,
                                threads=burst_threads, port=ports["default"])
            if wrong(burst):
                raise AssertionError("overload: a level-2 answer differs from its record")
            formed = {b: n - b0.get(b, 0) for b, n in bucket_batches(leader, "leader").items()
                      if n - b0.get(b, 0)}
            if max(formed) > OVERLOAD_BATCH_CAP:
                raise AssertionError(f"overload: level 2 formed batches {formed}")
            entry["burst_batches_by_bucket"] = formed
        if level == 3 and (plan.mode != "streaming" or server_mod.tier_floor() != "streaming"):
            raise AssertionError(f"overload: level 3 planned {plan.mode}")
        ladder_log.append(entry)
    if (leader.admission.min_priority, leader.batcher.batch_cap, server_mod.tier_floor()) != (
            0, None, "materialized") or leader.server._plan_serving(1).mode != "materialized":
        raise AssertionError("overload: level 0 did not restore every knob")
    steps["ladder_s"] = time.perf_counter() - t0

    # 4. Recalibration of a mispriced model on this run's device ms.
    t0 = time.perf_counter()
    previous_ledger = costmodel.set_default_cost_ledger(costmodel.CostLedger(window_size=8))
    for _ in range(16):  # one 8-key bucket a party a request
        if ask("default", 8)[0] is None:
            raise AssertionError("overload: a recalibration request was shed")
    cell = costmodel.default_cost_ledger().export()["cells"]["pir/materialized/8"]
    device_ms = cell["mean_actual_ms"]
    rate_history = Path(tmp) / "device.jsonl"
    rate_history.write_text(json.dumps({"metric": "serving_closed_loop_queries_per_sec",
                                        "value": 8e3 / device_ms}) + "\n")
    mispriced = CapacityModel(calibration=ThroughputCalibration(str(rate_history)),
                              misprice={"pir": OVERLOAD_MISPRICE})
    ledger = costmodel.CostLedger(window_size=16)
    rec = Recalibrator(model=mispriced, ledger=ledger, clamp=(0.25, 4.0),
                       min_samples=16).install()
    costmodel.set_default_cost_ledger(ledger)
    for _, session in parties:
        session.batcher.set_cost_model("pir", mispriced.price_pir_keys)
    factors = []
    for _ in range(64):
        if ask("default", 8)[0] is None:
            raise AssertionError("overload: a recalibration request was shed")
        factors.append(rec.factor("pir"))
    raw_ms = OVERLOAD_MISPRICE * 8 * device_ms / 8
    corrected_ms = mispriced.price_pir_keys(8).device_ms
    rec.set_enabled(False)
    reverted_ms = mispriced.price_pir_keys(8).device_ms
    rec.set_enabled(True)
    # The factor that makes the corrected price the drill's own measured
    # bucket-8 ms: 0.5 while the batches take what they took in the
    # calibration; the host's drift between the two moves it.
    drill_ms = ledger.export()["cells"]["pir/materialized/8"]["mean_actual_ms"]
    target = drill_ms / raw_ms
    if not (0.25 <= factors[-1] <= 4.0 and factors[-1] < 1.0
            and abs(factors[-1] - target) <= 0.15):
        failures.append(f"the factor went {factors[::8]}, not toward {target:.3f}")
    if abs(reverted_ms - raw_ms) > 1e-9 * raw_ms:
        failures.append(f"the kill switch priced {reverted_ms}, raw {raw_ms}")
    costmodel.set_default_cost_ledger(previous_ledger)
    for _, session in parties:
        session.batcher.set_cost_model("pir")
    steps["recalibration_s"] = time.perf_counter() - t0

    final = counters()
    emit({"phase": "overload", "config": "BASELINE.json configs[1], one card",
          "records": NUM_RECORDS, "record_bytes": RECORD_BYTES,
          "calibrated_queries_per_sec": serving_qps, "price_ms_a_key": price_ms,
          "recalibrated_queries_per_sec": model.serving_queries_per_sec(),
          "admission_budget_ms": OVERLOAD_BUDGET_MS, "deadline_ms": OVERLOAD_DEADLINE_MS,
          "saturation": {"clients": threads * SERVING_PROCESSES,
                         "requests": OVERLOAD_SATURATION_REQUESTS,
                         "queries_per_sec": saturation, "shed": sat_shed,
                         "duty_cycle_pct": sat_util["totals"]["duty_cycle_pct"],
                         "bubbles_s": sat_util["totals"]["idle_s"],
                         "bubble_ms_p50": sat_util["totals"]["bubble_ms_p50"],
                         "bubble_ms_p99": sat_util["totals"]["bubble_ms_p99"],
                         "traced_requests": OVERLOAD_TRACED, "traced_wall_ms": traced_ms,
                         "device_busy_ms": busy_ms,
                         "device_idle_share": None if busy_ms is None
                         else 1.0 - busy_ms / traced_ms},
          "overload": {"offered_queries_per_sec": 2 * saturation,
                       "seconds": OVERLOAD_SECONDS,
                       "arrivals": len(records) + sum(deferred.values()),
                       "requests": len(records),
                       "answered": len(answered), "goodput_queries_per_sec": goodput,
                       "goodput_over_saturation": goodput / saturation,
                       "wall_s": over_s, "shed": len(sheds), "shed_by_reason": reasons,
                       "deferred_by_retry_hint": deferred,
                       "errors": len(errors), "error_examples": [r[4] for r in errors[:3]],
                       "expired_in_batch": delta.get("leader.batcher.expired_in_batch", 0),
                       "deadline_exceeded": delta.get(
                           "leader.batcher.requests_deadline_exceeded", 0),
                       "keys_by_tenant": keys, "shares_by_tenant": shares,
                       "p50_ms": lat[len(lat) // 2] if lat else None,
                       "p99_ms": lat[int(len(lat) * 0.99)] if lat else None,
                       "send_lag_ms_p99": sorted(r[6] for r in records)[
                           int(len(records) * 0.99)] * 1e3,
                       "server_counters": delta,
                       "duty_cycle_pct": over_util["totals"]["duty_cycle_pct"],
                       "bubbles_s": over_util["totals"]["idle_s"],
                       "busy_s": over_util["totals"]["busy_s"]},
          "admission": leader.admission.export(),
          "workload": {k: v for k, v in observatory.export().items()
                       if k in ("observations", "rate_qps", "burstiness_cv2", "tenants",
                                "deadline_ms")},
          "front_door": {k: v for k, v in front_door.export().items()
                         if k in ("observations", "hot_share_pct", "zipf_exponent",
                                  "top_keys")},
          "ladder": ladder_log,
          "ladder_transitions": [(t["step"], t["action"], t["level_after"])
                                 for t in ladder.export()["transitions"]],
          "recalibration": {"bucket8_device_ms": device_ms, "misprice": OVERLOAD_MISPRICE,
                            "drill_bucket8_ms": drill_ms, "target_factor": target,
                            "factors": factors, "clamp": [0.25, 4.0],
                            "raw_ms": raw_ms, "corrected_ms": corrected_ms,
                            "kill_switch_ms": reverted_ms,
                            "windows": ledger.export()["cells"]},
          "helper_tcp_reconnects": leader._transport.reconnects,
          "steps_s": steps, "phase_s": time.perf_counter() - t_phase,
          "leader_counters_total": {k: v for k, v in final.items()
                                    if "shed" in k or "expired" in k},
          "gate_failures": failures, "device": smi_line})
    if failures:
        raise AssertionError("overload: " + "; ".join(failures))
    for sock in socks.values():
        sock.close()
    for tcp in servers:
        tcp.stop()
    helper_tcp.stop()
    leader.close()
    helper.close()
    set_default_capacity_model(previous_model)
    shutil.rmtree(tmp, ignore_errors=True)


# Private heavy hitters (the JAX package's heavy-hitters bench population,
# `benchmarks/heavy_hitters_bench.py:_skewed_values`, at 65,536 clients
# over 64-bit values): 4-bit rounds, 32-bit counts, threshold 32.
FLEET_REPLICAS = 3
FLEET_TENANTS = 12
FLEET_REQUESTS = 1024
FLEET_TRACED = 32
FLEET_SPILL_REQUESTS = 192
FLEET_ROTATION_REQUESTS = 128
FLEET_CHECK_REQUESTS = 64
FLEET_QUORUM = 2
FLEET_BREAKER_RESET_MS = 500.0
# Tenants of the warm-up start this far apart, so that the router places
# each under the backlog of those before it.
FLEET_STAGGER_S = 0.05
# A request refused this many times (`SnapshotMismatch`: its pair caught
# between its Helper's flip and its Leader's) fails the phase.
FLEET_MAX_REFUSALS = 64


class GenerationRecords:
    """configs[1]'s records at one generation: the base records with the
    rows each rotation up to it wrote (a sequence for the probe's oracle)."""

    def __init__(self, base, writes):
        self._base, self._writes = base, writes

    def __len__(self):
        return len(self._base)

    def __getitem__(self, i):
        return self._writes.get(i, self._base[i])


def fleet_phase(dev, records, smi_line: str) -> None:
    """The replica fleet at BASELINE.json configs[1] on one card:
    FLEET_REPLICAS Leader/Helper pairs, each party a session over its own
    database on the card with its own `SnapshotManager`, each Leader
    reaching its Helper over a `TcpTransportPool` to a `FramedTcpServer`
    on loopback as in `serving_phase`; the pairs in a `ReplicaSet` behind
    a `FleetRouter`, one `ReplicaTelemetry` scope a replica in a
    `FleetTelemetry`, and a `CrossReplicaProbe`. FLEET_TENANTS tenants in
    threads of this process send one-query `LeaderRequest`s closed loop
    through `FleetRouter.handle_request`; every answer must decode through
    `handle_response` to the records of the generation its Leader share
    bound to (`evaluated_generation`). Steps, one JSON line each:

    1. `fleet`: FLEET_REQUESTS requests; q/s, p50 and p99, requests routed
       to each replica, spillovers; each party's launches against the
       plans of the buckets its batcher formed (`tier_launches`) and the
       process's against their sum over the replicas; the fleet duty cycle
       (`fleet.duty_cycle_pct`, the mean of the replicas' trackers) beside
       the card's busy share (the union of every stream's kernel intervals
       in a `torch.profiler` trace of FLEET_TRACED more requests).
    2. `fleet_spillover`: the replica holding the most tenants gets an
       admission budget too small for any request; FLEET_SPILL_REQUESTS
       requests: spillovers > 0, every answer right, one generation for
       every tenant.
    3. `fleet_rotation` x3, each under a closed-loop wave with no think
       time of at least FLEET_ROTATION_REQUESTS requests, half of them for
       the touched rows, that goes on until FLEET_TENANTS requests have
       been sent after the rotation ended (every answer its generation's,
       every request sent after the rotation answered from the new one;
       a request refused with `SnapshotMismatch` is sent again and
       counted). First a delta of SERVING_UPDATES rows to generation 1 on
       every replica at a quorum of FLEET_QUORUM, the tenants picking
       their replica (`FleetRouter.pick`) and asking its Leader, as
       `benchmarks/fleet_bench.py`'s tenants do: every replica flips in
       the second phase, every staging a delta, the worst Helper -> Leader
       flip window as staleness. Then generation 2 with `fleet.stage.r1`
       armed once, the tenants through `FleetRouter.handle_request`, which
       pins both of a replica's managers for each attempt, so that a flip
       waits for a moment with no request on its replica: the quorum
       stages, r1 is shed, converged and readmitted, and so is every
       replica whose flip timed out; the rotation's seconds and each
       replica's flip error are printed. Then generation 3 with two
       replicas armed: `QuorumFailed`, every generation and staging as it
       was, and FLEET_CHECK_REQUESTS requests answered from generation 2.
    4. `fleet_probe`: the `CrossReplicaProbe` (golden rows that the
       rotations touched among them) passes; a word XORed into one
       replica's staging at a golden row gives a mismatch, a
       `fleet.divergence` event and a bundle from the failure listener;
       undone, the probe passes again.
    5. `fleet_breaker`: the Helper leg of each replica in turn fails under
       the `service.helper_leg` failpoint until its Leader's breaker
       opens (the replica drains), then one request after the breaker's
       reset closes it (the replica serves again).
    6. `fleet_admin`: every route of an `AdminServer` with the fleet
       attached (`fleet_admin`) answers as FLEET_ADMIN_ROUTES says, and
       `/fleet-timelinez` holds, from every replica, its Leader's breaker
       transitions and both parties' snapshot flips, each stamped with
       the replica's id."""
    import threading

    import torch

    from distributed_point_functions_tpu_torch.capacity.model import CapacityModel
    from distributed_point_functions_tpu_torch.fleet import (
        FleetRotationCoordinator,
        FleetRouter,
        FleetTelemetry,
        QuorumFailed,
        Replica,
        ReplicaSet,
    )
    from distributed_point_functions_tpu_torch.observability import (
        AdminServer,
        BundleManager,
    )
    from distributed_point_functions_tpu_torch.observability.events import EventJournal
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirClient,
        DenseDpfPirDatabase,
    )
    from distributed_point_functions_tpu_torch.robustness import failpoints
    from distributed_point_functions_tpu_torch.serving import (
        CrossReplicaProbe,
        FramedTcpServer,
        HelperSession,
        HelperUnavailable,
        LeaderSession,
        ServingConfig,
        SnapshotManager,
        SnapshotMismatch,
        TcpTransportPool,
    )
    from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
    from distributed_point_functions_tpu_torch.serving.service import evaluated_generation
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    t_phase = time.perf_counter()
    steps = {}
    rng = np.random.default_rng(SEED + 60)
    work = Path(tempfile.mkdtemp(prefix="dpf-fleet-"))
    helper_config = ServingConfig(max_batch_size=128, max_wait_ms=2.0,
                                  breaker_reset_ms=FLEET_BREAKER_RESET_MS)
    # Admission on every Leader, at a budget no request reaches until the
    # spillover step shrinks one.
    leader_config = dataclasses.replace(helper_config, admission_enabled=True,
                                        admission_queue_budget_ms=1e9)
    journal = EventJournal(capacity=1024)
    replica_set = ReplicaSet(journal=journal)
    fleet_metrics = MetricsRegistry()
    router = FleetRouter(replica_set, journal=journal, metrics=fleet_metrics)
    coordinator = FleetRotationCoordinator(replica_set, quorum=FLEET_QUORUM,
                                           journal=journal)
    telemetry = FleetTelemetry(replica_set, router=router, rotation=coordinator,
                               journal=journal, registry=fleet_metrics)
    coordinator.set_telemetry(telemetry)
    dbs, tcp, replicas = {}, [], []
    for k in range(FLEET_REPLICAS):
        rid = f"r{k}"
        ldb = DenseDpfPirDatabase(records, device=dev)
        hdb = DenseDpfPirDatabase(records, device=dev)
        ldb.staged()
        hdb.staged()
        helper = HelperSession(hdb, encrypt_decrypt.decrypt, config=helper_config,
                               device=dev)
        helper_tcp = FramedTcpServer(helper.handle_wire, host="127.0.0.1",
                                     name=f"helper-{rid}").start()
        leader = LeaderSession(
            ldb, TcpTransportPool("127.0.0.1", helper_tcp.port, FLEET_TENANTS),
            config=leader_config, device=dev)
        tcp.append(helper_tcp)
        # Each replica its own price model, so that /fleetz tells their
        # price cards apart.
        replica = replica_set.add(Replica(
            rid, leader, helper, leader_snapshots=SnapshotManager(leader),
            helper_snapshots=SnapshotManager(helper), capacity=CapacityModel()))
        telemetry.scope(replica)
        replicas.append(replica)
        dbs[rid] = (ldb, hdb)
    writes = {0: {}}  # generation -> {row: record}
    oracle = {0: GenerationRecords(records, writes[0])}
    golden = [0, NUM_RECORDS // 2, NUM_RECORDS - 1]
    updated = [int(i) for i in rng.choice(NUM_RECORDS, SERVING_UPDATES, replace=False)]
    probe = CrossReplicaProbe(replica_set.healthy, records,
                              indices=sorted(golden + updated[:2]),
                              records_provider=lambda g: oracle.get(g),
                              journal=journal, metrics=fleet_metrics)
    telemetry.set_probe(probe)
    bundles = BundleManager(str(work / "bundles"), cooldown_s=0.0, journal=journal)
    telemetry.wire_bundles(bundles)
    clients = [DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
               for _ in range(FLEET_TENANTS)]
    steps["setup_s"] = time.perf_counter() - t_phase

    def traffic(total, hot=(), hot_share=0.0, tally=None, stagger_s=0.0, pinned=True,
                more=None):
        """`total` requests from FLEET_TENANTS closed-loop tenant threads
        (record `hot[k]` with probability `hot_share`, else uniform; tenant
        t starts t x `stagger_s` late), then more while `more()` says so.
        `pinned`: through `FleetRouter.handle_request`; else the tenant
        picks its replica (`FleetRouter.pick`) and asks its Leader. Counts
        answers and refusals in `tally`; returns [(tenant, index, answer,
        generation, latency s from the keygen to the decoded answer,
        perf_counter at the keygen)]."""
        left = [total]  # below 0 once `more()` has let requests past `total`
        tally = {"answered": 0, "refused": 0} if tally is None else tally
        out, errors, lock = [], [], threading.Lock()
        barrier = threading.Barrier(FLEET_TENANTS)

        def ask(request, tenant):
            for _ in range(FLEET_MAX_REFUSALS):
                try:
                    if pinned:
                        return router.handle_request(request, tenant=tenant)
                    return router.pick(tenant).leader.handle_request(request,
                                                                     tenant=tenant)
                except SnapshotMismatch:
                    with lock:
                        tally["refused"] += 1
            raise AssertionError(f"fleet: {tenant}'s request refused "
                                 f"{FLEET_MAX_REFUSALS} times")

        def run(t):
            tenant = f"tenant{t}"
            rng_t = np.random.default_rng([SEED + 61, total, t])
            barrier.wait()
            time.sleep(t * stagger_s)
            while not errors:
                with lock:
                    if left[0] <= 0 and not (more is not None and more()):
                        return
                    left[0] -= 1
                i = (hot[int(rng_t.integers(0, len(hot)))]
                     if hot and rng_t.random() < hot_share
                     else int(rng_t.integers(0, NUM_RECORDS)))
                sent = time.perf_counter()
                try:
                    request, state = clients[t].create_request([i])
                    response = ask(request, tenant)
                    generation = evaluated_generation()
                    answer = clients[t].handle_response(response, state)[0]
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)
                    return
                with lock:
                    out.append((tenant, i, answer, generation,
                                time.perf_counter() - sent, sent))
                    tally["answered"] += 1

        pool = [threading.Thread(target=run, args=(t,)) for t in range(FLEET_TENANTS)]
        for th in pool:
            th.start()
        for th in pool:
            th.join()
        if errors:
            raise errors[0]
        if len(out) != total - left[0]:
            raise AssertionError(f"fleet: {len(out)} answers of {total - left[0]}")
        return out

    def check(answers, what):
        """Every answer its generation's record; {generation: answers}."""
        counts = {}
        for tenant, i, answer, generation, _, _ in answers:
            if generation not in oracle or answer != oracle[generation][i]:
                raise AssertionError(f"{what}: {tenant}'s record {i} is not its "
                                     f"generation {generation} value")
            counts[generation] = counts.get(generation, 0) + 1
        return counts

    def routed():
        return dict(router.export()["routed"])

    # 1. Traffic.
    t0 = time.perf_counter()
    check(traffic(4 * FLEET_TENANTS, stagger_s=FLEET_STAGGER_S), "fleet warm-up")
    torch.cuda.synchronize()
    steps["warmup_s"] = time.perf_counter() - t0
    sessions = {f"{r.replica_id}/{p}": (s, p) for r in replicas
                for p, s in (("leader", r.leader), ("helper", r.helper))}
    before = {k: launch_mark(s, p) for k, (s, p) in sessions.items()}
    routed_before = routed()
    spills_before = router.export()["spillovers"]
    telemetry.sample()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = traffic(FLEET_REQUESTS)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = {name: n for name, n in cuda_lib.LAUNCHES.items() if n}
    sample = telemetry.sample()
    steps["closed_loop_s"] = wall_s
    if check(out, "fleet") != {0: FLEET_REQUESTS}:
        raise AssertionError("fleet: an answer bound to another generation than 0")
    # Each party's launches against the plans of its batches, and the
    # process's against their sum over the replicas.
    formed, want, per_party = {}, {}, {}
    for key, (session, party) in sessions.items():
        formed[key], planned, per_party[key] = planned_launches(session, party, before[key])
        if per_party[key] != planned:
            raise AssertionError(f"fleet: {key} launched {per_party[key]}, "
                                 f"its batches' plans {planned}")
        for name, n in planned.items():
            want[name] = want.get(name, 0) + n
    if got != want:
        raise AssertionError(f"fleet: launch counts {got}, the plans' {want}")
    lat = sorted(x[4] * 1e3 for x in out)
    routed_now = routed()
    by_replica = {rid: n - routed_before.get(rid, 0) for rid, n in routed_now.items()}
    # The card's busy share: the union of kernel intervals on every stream.
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        check(traffic(FLEET_TRACED), "fleet traced")
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = merged_busy_ms(kernels) if kernels else None
    duty = telemetry.sample()["duty_cycle_pct"]
    steps["trace_s"] = time.perf_counter() - t0
    nbatches = {k: sum(v.values()) for k, v in formed.items()}
    emit({"phase": "fleet", "replicas": FLEET_REPLICAS, "records": NUM_RECORDS,
          "record_bytes": RECORD_BYTES, "tenants": FLEET_TENANTS,
          "requests": FLEET_REQUESTS, "queries_per_request": 1,
          "max_batch_size": helper_config.max_batch_size,
          "max_wait_ms": helper_config.max_wait_ms,
          "transport": "in-process router; tcp loopback Leader -> Helper",
          "reconstructed": FLEET_REQUESTS, "launches": got,
          "launches_by_party": per_party, "batches": nbatches,
          "batches_by_bucket": formed,
          "queries_per_sec": FLEET_REQUESTS / wall_s,
          "p50_ms": lat[len(lat) // 2], "p99_ms": lat[int(len(lat) * 0.99)],
          "routed": by_replica,
          "spillovers": router.export()["spillovers"] - spills_before,
          "affinity": router.export()["affinity"],
          "fleet_qps_gauge": sample["qps"],
          "fleet_duty_cycle_pct": duty,
          "traced_requests": FLEET_TRACED, "traced_wall_ms": traced_ms,
          "traced_device_events": len(kernels), "device_busy_ms": busy_ms,
          "device_busy_share": None if busy_ms is None else busy_ms / traced_ms,
          "steps_s": steps, "phase_s": time.perf_counter() - t_phase,
          "device": smi_line})

    # 2. Spillover: the most loaded replica's admission sheds everything.
    t0 = time.perf_counter()
    tenants_of = {}
    for tenant, rid in router.export()["affinity"].items():
        tenants_of.setdefault(rid, []).append(tenant)
    victim = replica_set.get(max(tenants_of, key=lambda r: len(tenants_of[r])))
    spills_before = router.export()["spillovers"]
    routed_before = routed()
    victim.leader.admission.queue_budget_ms = 1e-9
    try:
        spilled = traffic(FLEET_SPILL_REQUESTS)
    finally:
        victim.leader.admission.queue_budget_ms = 1e9
    spills = router.export()["spillovers"] - spills_before
    check(spilled, "fleet_spillover")
    per_tenant = {}
    for tenant, _, _, generation, _, _ in spilled:
        per_tenant.setdefault(tenant, set()).add(generation)
    if not spills or any(len(g) != 1 for g in per_tenant.values()):
        raise AssertionError(f"fleet_spillover: {spills} spillovers, generations by "
                             f"tenant {per_tenant}")
    emit({"phase": "fleet_spillover", "shed_replica": victim.replica_id,
          "shed_replica_tenants": len(tenants_of[victim.replica_id]),
          "requests": FLEET_SPILL_REQUESTS, "reconstructed": FLEET_SPILL_REQUESTS,
          "spillovers": spills,
          "routed": {rid: n - routed_before.get(rid, 0) for rid, n in routed().items()},
          "spillover_rate_pct": router.spillover_rate_pct(),
          "shed_replica_sheds": sum(t["shed"] for t in
                                    victim.leader.admission.export()["tenants"].values()),
          "generations_by_tenant": {t: sorted(g) for t, g in per_tenant.items()},
          "seconds": time.perf_counter() - t0, "device": smi_line})

    # 3. Rotations under the same traffic.
    def next_generation(generation):
        writes[generation] = {i: rng.bytes(RECORD_BYTES) for i in updated}
        oracle[generation] = GenerationRecords(records, writes[generation])
        out = {}
        for rid, (ldb, hdb) in dbs.items():
            builder = DenseDpfPirDatabase.Builder()
            for i in updated:
                builder.update(i, writes[generation][i])
            out[rid] = (builder.build_from(ldb), builder.build_from(hdb))
        return out

    def rotate_under_traffic(generation, armed=(), pinned=True):
        """Rotate to `generation` (a delta of the touched rows), with
        `fleet.stage.<rid>` armed once for each of `armed`, once a quarter
        of FLEET_ROTATION_REQUESTS have been answered, under a wave that
        goes on until FLEET_TENANTS requests have been sent after the
        rotation ended; returns (the new databases, the report, answers by
        generation, answers sent after the rotation, the wave's seconds,
        the rotation's seconds, refusals)."""
        new_dbs = next_generation(generation)
        report, span, raised, after = {}, [None, None], [], [0]
        tally = {"answered": 0, "refused": 0}
        stop = threading.Event()

        def rotate():
            while tally["answered"] < FLEET_ROTATION_REQUESTS // 4 and not stop.is_set():
                time.sleep(0.001)
            registry = failpoints.default_failpoints()
            for rid in armed:
                registry.arm(f"fleet.stage.{rid}", "error", times=1)
            span[0] = time.perf_counter()
            try:
                report.update(coordinator.rotate(new_dbs))
            except Exception as e:  # noqa: BLE001 - raised below
                raised.append(e)
            finally:
                registry.clear()
            span[1] = time.perf_counter()

        def more():  # called under the wave's lock
            if span[1] is None:
                return True
            after[0] += 1
            return after[0] <= FLEET_TENANTS

        t0 = time.perf_counter()
        rotator = threading.Thread(target=rotate)
        rotator.start()
        try:
            wave = traffic(FLEET_ROTATION_REQUESTS, hot=updated, hot_share=0.5,
                           tally=tally, pinned=pinned, more=more)
        finally:
            stop.set()
            rotator.join()
        if raised:
            raise raised[0]
        counts = check(wave, f"fleet_rotation {generation}")
        late = [x for x in wave if x[5] > span[1]]
        if any(x[3] != generation for x in late):
            raise AssertionError(f"fleet_rotation {generation}: a request sent after "
                                 "the rotation answered from an older generation")
        if counts.get(generation - 1, 0) == 0 or not late:
            raise AssertionError(f"fleet_rotation {generation}: the wave did not span "
                                 f"the rotation ({counts}, {len(late)} sent after it)")
        return (new_dbs, report, counts, len(late), time.perf_counter() - t0,
                span[1] - span[0], tally["refused"])

    def flip_errors(report):
        return {rid: row["flip_error"] for rid, row in report["per_replica"].items()
                if "flip_error" in row}

    rotations = []
    new_dbs, report, *wave = rotate_under_traffic(1, pinned=False)
    if (set(replica_set.generations().values()) != {1} or report["laggards"]
            or sorted(report["flipped"]) != sorted(replica_set.generations())):
        raise AssertionError(f"fleet_rotation 1: {report}, transitions "
                             f"{replica_set.export()['history']}")
    for r in replicas:
        for stage in (m.export()["last_stage"] for m in r.managers()):
            if stage["mode"] != "delta" or stage["bytes_saved"] <= 0:
                raise AssertionError(f"fleet_rotation 1: {r.replica_id} staged {stage}")
    dbs = new_dbs
    rotations.append(("delta", "picked", report, *wave, replica_set.generations()))
    readmissions = replica_set.export()["readmissions"]
    new_dbs, report, *wave = rotate_under_traffic(2, armed=("r1",))
    readmitted = replica_set.export()["readmissions"] - readmissions
    if (report["acked"] != ["r0", "r2"]
            or "stage_error" not in report["per_replica"]["r1"]
            or report["laggards"].get("r1") != "recovered"
            or set(report["laggards"].values()) != {"recovered"}
            or set(report["laggards"]) != {"r1"} | set(flip_errors(report))
            or readmitted != len(report["laggards"])
            or set(replica_set.generations().values()) != {2}):
        raise AssertionError(f"fleet_rotation 2: {report}, transitions "
                             f"{replica_set.export()['history']}")
    dbs = new_dbs
    rotations.append(("laggard", "routed", report, *wave, replica_set.generations()))
    t0 = time.perf_counter()
    failed_dbs = next_generation(3)
    registry = failpoints.default_failpoints()
    registry.arm("fleet.stage.r0", "error", times=1)
    registry.arm("fleet.stage.r2", "error", times=1)
    try:
        coordinator.rotate(failed_dbs)
    except QuorumFailed as e:
        quorum_failed = {"acked": e.acked, "failed": sorted(e.failed), "quorum": e.quorum}
    else:
        raise AssertionError("fleet_rotation 3: the rotation met its quorum")
    finally:
        registry.clear()
    if (set(replica_set.generations().values()) != {2}
            or any(m.staging_generation() is not None
                   for r in replicas for m in r.managers())):
        raise AssertionError("fleet_rotation 3: a replica moved after QuorumFailed")
    for db in (d for pair in failed_dbs.values() for d in pair):
        db.release_stagings()
    del failed_dbs, oracle[3], writes[3]
    after_failure = check(traffic(FLEET_CHECK_REQUESTS), "fleet_rotation 3")
    if after_failure != {2: FLEET_CHECK_REQUESTS}:
        raise AssertionError(f"fleet_rotation 3: answers by generation {after_failure}")
    rotations.append(("quorum_failed", "routed", quorum_failed, after_failure, 0,
                      time.perf_counter() - t0, None, 0, replica_set.generations()))
    traffic_of = {"picked": "closed loop, no think time: FleetRouter.pick, then the "
                            "replica's LeaderSession.handle_request (as "
                            "benchmarks/fleet_bench.py)",
                  "routed": "closed loop, no think time: FleetRouter.handle_request, "
                            "which pins both managers of the replica for each attempt"}
    for (kind, route, report, counts, late, seconds, rotation_s, refused,
         generations) in rotations:
        emit({"phase": "fleet_rotation", "kind": kind, "updated_rows": SERVING_UPDATES,
              "quorum": FLEET_QUORUM, "traffic": traffic_of[route],
              "requests": sum(counts.values()),
              "answers_by_generation": counts, "answers_sent_after_rotation": late,
              "refused": refused,
              "report": {k: v for k, v in report.items() if k != "per_replica"},
              "staleness_ms": report.get("staleness_ms"),
              "flip_errors": flip_errors(report) if "per_replica" in report else {},
              "per_replica": report.get("per_replica"),
              "rotation_s": rotation_s,
              "generations": generations, "seconds": seconds, "device": smi_line})

    # 4. The cross-replica probe, and a divergence drill.
    t0 = time.perf_counter()
    first = probe.run_cycle()
    if first["status"] != "pass":
        raise AssertionError(f"fleet_probe: {first}")
    fired = bundles.export()["fired"]
    row = updated[0] if updated[0] in probe.export()["indices"] else golden[1]
    drilled = replicas[1].leader.server.database
    xor_staged_word(drilled, row, 0, 0x5A5A5A5A)
    try:
        bad = probe.run_cycle()
    finally:
        xor_staged_word(drilled, row, 0, 0x5A5A5A5A)
    divergences = [e for e in journal.tail(n=1024) if e["kind"] == "fleet.divergence"]
    bundle = bundles.export()["bundles"][-1] if bundles.export()["bundles"] else {}
    again = probe.run_cycle()
    if (bad["status"] != "mismatch" or bad["divergences"][0]["replica"] != "r1"
            or not divergences or bundles.export()["fired"] != fired + 1
            or bundle.get("reason") != "probe_failure" or again["status"] != "pass"):
        raise AssertionError(f"fleet_probe: drill {bad}, bundles {bundles.export()}, "
                             f"after {again}")
    emit({"phase": "fleet_probe", "indices": probe.export()["indices"],
          "generations": first["generations"], "cycle_ms": first["ms"],
          "drill_row": row, "drill_status": bad["status"],
          "drill_divergences": bad["divergences"], "bundle_reason": bundle["reason"],
          "bundle_sources": sorted(bundle["sources"]),
          "after_status": again["status"], "after_cycle_ms": again["ms"],
          "seconds": time.perf_counter() - t0, "device": smi_line})

    # 5. Each Leader's breaker: opened by a failing Helper leg, closed after.
    t0 = time.perf_counter()
    breaker_rows = {}
    client = clients[0]
    for r in replicas:
        rid = r.replica_id
        registry = failpoints.default_failpoints()
        registry.arm("service.helper_leg", "error", times=None)
        failed = 0
        try:
            while r.leader.breaker.state != "open" and failed < 16:
                try:
                    r.leader.handle_request(client.create_request([1])[0])
                except HelperUnavailable:
                    failed += 1
        finally:
            registry.clear()
        drained = replica_set.state(rid)
        time.sleep(FLEET_BREAKER_RESET_MS / 1e3 + 0.05)
        request, state = client.create_request([golden[1]])
        answer = client.handle_response(r.leader.handle_request(request), state)[0]
        if (drained != "draining" or r.leader.breaker.state != "closed"
                or replica_set.state(rid) != "serving" or answer != oracle[2][golden[1]]):
            raise AssertionError(f"fleet_breaker: {rid} {drained} -> "
                                 f"{replica_set.state(rid)}, breaker "
                                 f"{r.leader.breaker.state}")
        breaker_rows[rid] = {"failed_requests": failed, "drained": drained,
                             "restored": replica_set.state(rid)}
    emit({"phase": "fleet_breaker", "replicas": breaker_rows,
          "seconds": time.perf_counter() - t0, "device": smi_line})

    # 6. The admin endpoint with the fleet attached.
    t0 = time.perf_counter()
    with fleet_admin(AdminServer, bundles, replica_set, telemetry, journal,
                     str(work)) as admin:
        scraped = scrape_admin(admin.port, FLEET_ADMIN_ROUTES)
        _, _, body = http_get(f"http://127.0.0.1:{admin.port}/fleet-timelinez"
                              "?format=json&n=4096")
        _, _, statusz = http_get(f"http://127.0.0.1:{admin.port}/fleet-statusz"
                                 "?format=json")
    answered = {route: (status, ctype) for route, (status, ctype, _) in scraped.items()}
    if answered != FLEET_ADMIN_ROUTES:
        raise AssertionError(f"fleet_admin: {answered}")
    events = json.loads(body)["events"]
    seen = {}
    for e in events:
        seen.setdefault(e.get("replica"), set()).add(e["kind"])
    for r in replicas:
        if not {"breaker.transition", "snapshot.flip"} <= seen.get(r.replica_id, set()):
            raise AssertionError(f"fleet_admin: {r.replica_id}'s events "
                                 f"{sorted(seen.get(r.replica_id, ()))}")
    fleetz = json.loads(scraped["/fleetz"][2])
    status_doc = json.loads(statusz)
    emit({"phase": "fleet_admin", "routes": {k: v[0] for k, v in answered.items()},
          "timeline_events": len(events),
          "kinds_by_replica": {str(k): sorted(v) for k, v in seen.items()},
          "fleetz_counts": fleetz["counts"], "sheds": fleetz["sheds"],
          "readmissions": fleetz["readmissions"],
          "prices": {rid: row["price"].get("replica") for rid, row in
                     fleetz["replicas"].items()},
          "verdict": status_doc["verdict"]["status"],
          "fleet_gauges": status_doc["merged"]["fleet"]["gauges"],
          "seconds": time.perf_counter() - t0, "device": smi_line})

    for helper_tcp in tcp:
        helper_tcp.stop()
    for r in replicas:
        r.leader.close()
        r.helper.close()
    for pair in dbs.values():
        for db in pair:
            db.release_stagings()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "fleet_done", "phase_s": time.perf_counter() - t_phase,
          "device": smi_line})


HH_CLIENTS = 1 << 16
HH_DOMAIN_BITS = 64
HH_THRESHOLD = 32
HH_POPULATION_SEED = 13
HH_WIDTHS = [16, 256, 4096] + [64] * 13
HH_WIDEST_ROUND = 2
HH_WORKERS = 8
HH_JOB = 1024  # values a worker's job
HH_ROUND_TIMEOUT_MS = 600_000.0
# `hh_small`: the JAX test's 8-bit config and values, and a 24-bit one.
HH_SMALL_VALUES = [3, 3, 3, 77, 77, 9, 9, 200]
HH_SMALL_CLIENTS = 512
HH_SMALL_BITS = 24
HH_SMALL_THRESHOLD = 8


def skewed_values(num_clients: int, domain_bits: int, seed: int) -> list:
    """The JAX package's `benchmarks/heavy_hitters_bench.py:_skewed_values`
    (copied): four hot values holding N/4, N/6, N/8 and N/10 of the
    reports, and a uniform tail."""
    import random

    rng = random.Random(seed)
    hot = [rng.randrange(1 << domain_bits) for _ in range(4)]
    weights = [num_clients // 4, num_clients // 6, num_clients // 8,
               num_clients // 10]
    values = []
    for v, w in zip(hot, weights):
        values.extend([v] * max(1, w))
    while len(values) < num_clients:
        values.append(rng.randrange(1 << domain_bits))
    rng.shuffle(values)
    return values[:num_clients]


def hh_reports(root: str, fields: dict, values: list):
    """A worker of the heavy-hitters phase (started with `spawn`; it never
    touches the card): the port's client makes one report per value, and
    each party's keys go back packed as host arrays, with the seconds of
    the reports and of the packing."""
    sys.path.insert(0, root)
    from distributed_point_functions_tpu_torch import heavy_hitters as hh

    config = hh.HeavyHittersConfig(**fields)
    client = hh.HeavyHittersClient(config, device="cpu")
    t0 = time.perf_counter()
    pairs = [client.generate_report(v) for v in values]
    t1 = time.perf_counter()
    dpf = config.make_dpf("cpu")
    packed = tuple(dpf.pack_keys([p[party] for p in pairs]) for party in (0, 1))
    return packed, t1 - t0, time.perf_counter() - t1


def hh_want_launches(plans) -> dict:
    """A server's K8 and K3 launches by its level plans: a walk and a value
    hash a chunk (no walk where a level walks no tree level)."""
    return {"path_level": sum(p.num_chunks for p in plans if p.walk_levels),
            "value_hash": sum(p.num_chunks for p in plans)}


def hh_sweep(servers, config, on_round=None):
    """`run_protocol` written out: the rounds of one sweep, the two
    servers one after the other; `on_round(r, frontier, shares)` sees each
    round's frontier and both parties' shares before the pruning."""
    from distributed_point_functions_tpu_torch import heavy_hitters as hh

    sweep = hh.FrontierSweep(config)
    while not sweep.done:
        r, frontier = sweep.round_index, sweep.frontier
        shares = [s.evaluate_round(r, frontier) for s in servers]
        if on_round is not None:
            on_round(r, frontier, shares)
        sweep.observe_counts(hh.reconstruct_counts(*shares, config.count_bits))
    return sweep


def hh_small_phase(rng, dev) -> None:
    """The heavy-hitters sweep on the card against `device="cpu"`: the JAX
    test's 8-bit config and values, and a 24-bit config of 512 clients.
    Every round's shares and each party's cut states on the card equal the
    CPU's, resumed and from the root (`evaluate_prefixes_batch` with no cut
    state), unchunked and under a budget of two prefixes a chunk; each
    party's K8 and K3 launches equal its level plans; the result equals
    `plaintext_heavy_hitters`."""
    import torch

    from distributed_point_functions_tpu_torch import heavy_hitters as hh
    from distributed_point_functions_tpu_torch.capacity.model import padded_keys

    cases = [("jax_test", hh.HeavyHittersConfig(domain_bits=8, level_bits=4, threshold=2),
              HH_SMALL_VALUES)]
    cases.append(("24_bit", hh.HeavyHittersConfig(
        domain_bits=HH_SMALL_BITS, level_bits=4, threshold=HH_SMALL_THRESHOLD),
        skewed_values(HH_SMALL_CLIENTS, HH_SMALL_BITS, int(rng.integers(1 << 30)))))
    for name, config, values in cases:
        t_case = time.perf_counter()
        client = hh.HeavyHittersClient(config, device="cpu")
        pairs = [client.generate_report(v) for v in values]
        keys = [[p[party] for p in pairs] for party in (0, 1)]
        two = padded_keys(len(values)) * 2 * hh.lane_bytes(1, 1)
        cpu = [hh.HeavyHittersServer(config, k, device="cpu") for k in keys]
        card_dpf, cpu_dpf = config.make_dpf(dev), config.make_dpf("cpu")
        card = {budget: [hh.HeavyHittersServer(config, k, device=dev, budget_bytes=budget)
                         for k in keys] for budget in (None, two)}
        checked = {"rounds": 0, "cut_states": 0, "from_root": 0}

        def compare(r, frontier, want):
            # `want`: the CPU servers' shares, which drive the sweep.
            for budget, servers in card.items():
                got = [s.evaluate_round(r, frontier) for s in servers]
                for g, w in zip(got, want):
                    if not np.array_equal(g, w):
                        raise AssertionError(f"hh_small {name}: round {r} shares differ "
                                             f"(budget {budget})")
                for s, c in zip(servers, cpu):
                    a, b = s.aggregator.cuts, c.aggregator.cuts
                    if not (torch.equal(a.state.cpu(), b.state)
                            and torch.equal(a.ctrl.cpu(), b.ctrl)):
                        raise AssertionError(f"hh_small {name}: round {r} cut state differs")
                    checked["cut_states"] += 1
            for s, c in zip(card[None], cpu):
                frontier_list = [int(p) for p in frontier]
                root, _ = card_dpf.evaluate_prefixes_batch(
                    s.aggregator.staged, r, frontier_list)
                root_cpu, _ = cpu_dpf.evaluate_prefixes_batch(
                    c.aggregator.staged, r, frontier_list)
                if not torch.equal(root.cpu(), root_cpu):
                    raise AssertionError(f"hh_small {name}: round {r} from the root differs")
                checked["from_root"] += 1
            checked["rounds"] += 1

        sweep = hh_sweep(cpu, config, compare)
        torch.cuda.synchronize()
        want = hh.plaintext_heavy_hitters(values, config)
        if dict(sweep.result) != want:
            raise AssertionError(f"hh_small {name}: {dict(sweep.result)} != {want}")
        launches = {}
        for budget, servers in card.items():
            for party, s in enumerate(servers):
                plan_want = hh_want_launches(s.aggregator.plans)
                if s.launches != plan_want:
                    raise AssertionError(f"hh_small {name}: party {party} launches "
                                         f"{s.launches} != plans {plan_want}")
            launches["default" if budget is None else "two_prefixes"] = servers[0].launches
        emit({"phase": "hh_small", "config": name, "clients": len(values),
              "domain_bits": config.domain_bits, "threshold": config.threshold,
              "heavy_hitters": {str(k): v for k, v in sorted(want.items())},
              "widths": [st.frontier_width for st in sweep.rounds], **checked,
              "launches_party0": launches, "phase_s": time.perf_counter() - t_case})


def hh_level_busy(prof, windows) -> list:
    """Device-busy ms inside each host window (start, end) in microseconds
    of the profiler's clock: the union of kernel intervals there."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    out = []
    for lo, hi in windows:
        busy, end = 0.0, lo
        for a, b in spans:
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        out.append(busy / 1e3)
    return out


def heavy_hitters_phase(dev, smi_line: str) -> None:
    """Private heavy hitters at full size on the card: 65,536 reports of
    `skewed_values(65536, 64, seed=13)`, made by the port's client in
    `HH_WORKERS` spawned processes (keygen s), each party's keys staged once
    (staging s), then the Leader/Helper session: the Helper behind a
    `FramedTcpServer` on loopback, the Leader over `TcpTransport`, each
    party's aggregator on its own CUDA stream at the card's default
    frontier budget. Gates: the result is the oracle's four hot values and
    counts, the frontier widths `HH_WIDTHS`, each party's own K8 and K3
    launches (counted from just before the sweep) equal to its level plans.
    Then a profiled session sweep (the device's idle share), and the sweep
    with the parties one after the other (`hh_sweep`), profiled, each
    round's host and device ms, and the widest round of party 0 alone
    between `reset_peak_memory_stats` and `max_memory_allocated`: its peak
    over the bytes before it must be within the modeled chunk peak, the
    level's cut states (counted exactly) and 2 MiB of the caching
    allocator's granularity. Prints the `heavy_hitters` line."""
    import multiprocessing

    import torch

    from distributed_point_functions_tpu_torch import heavy_hitters as hh
    from distributed_point_functions_tpu_torch.dpf import HostKeyBatch
    from distributed_point_functions_tpu_torch.observability import costmodel
    from distributed_point_functions_tpu_torch.serving import FramedTcpServer
    from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
    from distributed_point_functions_tpu_torch.serving.transport import TcpTransport

    t_phase = time.perf_counter()
    fields = {"domain_bits": HH_DOMAIN_BITS, "level_bits": 4,
              "threshold": HH_THRESHOLD, "count_bits": 32}
    config = hh.HeavyHittersConfig(**fields)
    values = skewed_values(HH_CLIENTS, HH_DOMAIN_BITS, HH_POPULATION_SEED)
    want = hh.plaintext_heavy_hitters(values, config)
    root = str(Path(__file__).resolve().parent)

    t0 = time.perf_counter()
    jobs = [(root, fields, values[i:i + HH_JOB]) for i in range(0, len(values), HH_JOB)]
    with multiprocessing.get_context("spawn").Pool(HH_WORKERS) as pool:
        parts = pool.starmap(hh_reports, jobs)
        pool.close()
        pool.join()
    keygen_s = time.perf_counter() - t0
    report_s = sum(p[1] for p in parts)
    pack_s = sum(p[2] for p in parts)
    host = [HostKeyBatch.concat([p[0][party] for p in parts]) for party in (0, 1)]
    del parts
    staging_s, servers = [], []
    for party in (0, 1):
        t0 = time.perf_counter()
        servers.append(hh.HeavyHittersServer(config, host[party], device=dev))
        torch.cuda.synchronize()
        staging_s.append(time.perf_counter() - t0)
    del host
    costmodel.set_default_cost_ledger(costmodel.CostLedger())

    def session_sweep():
        for s in servers:
            s.reset()
        helper = hh.HeavyHittersHelper(servers[1])
        with FramedTcpServer(helper.handle_wire, host="127.0.0.1", name="hh-helper") as srv, \
                TcpTransport("127.0.0.1", srv.port) as transport:
            leader = hh.HeavyHittersLeader(servers[0], transport, metrics=MetricsRegistry(),
                                           round_timeout_ms=HH_ROUND_TIMEOUT_MS)
            return leader.run()

    before = [s.launches for s in servers]
    t0 = time.perf_counter()
    result = session_sweep()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    if result.as_dict() != want or len(want) != 4:
        raise AssertionError(f"heavy_hitters: {result.as_dict()} != the oracle's {want}")
    widths = [st.frontier_width for st in result.rounds]
    if widths != HH_WIDTHS:
        raise AssertionError(f"heavy_hitters: frontier widths {widths} != {HH_WIDTHS}")
    launches = []
    for party, s in enumerate(servers):
        got = {k: v - before[party].get(k, 0) for k, v in s.launches.items()}
        plan_want = hh_want_launches(s.aggregator.plans)
        if got != plan_want:
            raise AssertionError(f"heavy_hitters: party {party} launches {got} != "
                                 f"its level plans' {plan_want}")
        launches.append(got)
    lanes = HH_CLIENTS * sum(widths)
    plans = [[p.num_chunks for p in s.aggregator.plans] for s in servers]
    ledger = costmodel.default_cost_ledger().export()

    # The session profiled: the device's idle share is 1 - the union of
    # kernel intervals (the parties' two streams overlap) over the wall.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("hh_session"):
            t0 = time.perf_counter()
            session_sweep()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    window = next((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == "hh_session")
    session_busy_ms = hh_level_busy(prof, [window])[0]
    del prof

    # The parties one after the other, profiled: each round's host ms and
    # device-busy ms (kernel intervals inside the round's window), and the
    # widest round of party 0 alone: its device memory.
    for s in servers:
        s.reset()
    sweep = hh.FrontierSweep(config)
    agg = servers[0].aggregator
    round_host_ms, names, peak = [], [], None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        while not sweep.done:
            r, frontier = sweep.round_index, sweep.frontier
            names.append(f"hh_round_{r}")
            t0 = time.perf_counter()
            with torch.profiler.record_function(names[-1]):
                if r == HH_WIDEST_ROUND:
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                shares = [servers[0].evaluate_round(r, frontier)]
                if r == HH_WIDEST_ROUND:
                    torch.cuda.synchronize()
                    plan = agg.plans[-1]
                    peak = {"measured_bytes": torch.cuda.max_memory_allocated() - base,
                            "chunk_model_bytes": plan.bytes_peak,
                            "cut_state_bytes": agg.cuts.nbytes,
                            "chunks": plan.num_chunks,
                            "chunk_prefixes": plan.chunk_prefixes,
                            "lane_bytes": plan.lane_bytes, "budget_bytes": plan.budget_bytes}
                    peak["modeled_bytes"] = peak["chunk_model_bytes"] + peak["cut_state_bytes"]
                shares.append(servers[1].evaluate_round(r, frontier))
                torch.cuda.synchronize()
            round_host_ms.append((time.perf_counter() - t0) * 1e3)
            sweep.observe_counts(hh.reconstruct_counts(*shares, config.count_bits))
    if dict(sweep.result) != want:
        raise AssertionError("heavy_hitters: the sequential sweep disagrees")
    if peak["measured_bytes"] > peak["modeled_bytes"] + (2 << 20):
        raise AssertionError(f"heavy_hitters: the widest level took {peak}")
    windows = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
               if e.name in names}
    round_device_ms = hh_level_busy(prof, [windows[n] for n in names])

    emit({"phase": "heavy_hitters", "clients": HH_CLIENTS, "domain_bits": HH_DOMAIN_BITS,
          "level_bits": 4, "threshold": HH_THRESHOLD, "count_bits": 32,
          "heavy_hitters": {str(k): v for k, v in sorted(want.items())},
          "widths": widths, "lanes_per_party": lanes,
          "keygen_s": keygen_s, "keygen_workers": HH_WORKERS,
          "keygen_ms_per_pair_per_worker": keygen_s * 1e3 * HH_WORKERS / HH_CLIENTS,
          "report_ms_per_pair_in_workers": report_s * 1e3 / HH_CLIENTS,
          "pack_ms_per_pair_in_workers": pack_s * 1e3 / HH_CLIENTS,
          "staging_s": staging_s, "sweep_s": sweep_s,
          "round_ms": [st.wall_ms for st in result.rounds],
          "lanes_per_sec_per_party": lanes / sweep_s,
          "lanes_per_sec_both_parties": 2 * lanes / sweep_s,
          "chunks_per_level": plans, "launches": launches,
          "session_device_idle_share": 1.0 - session_busy_ms / ((window[1] - window[0]) / 1e3),
          "session_profiled_wall_ms": profiled_ms,
          "session_device_busy_ms": session_busy_ms,
          "sequential_round_host_ms": round_host_ms,
          "sequential_round_device_ms": round_device_ms,
          "widest_level": peak,
          "cost_ledger": {k: {f: c.get(f) for f in ("samples", "residual_p50",
                                                    "mean_predicted_ms", "mean_actual_ms")}
                          for k, c in ledger["cells"].items()},
          "phase_s": time.perf_counter() - t_phase, "device": smi_line})
    del servers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "distributed_point_functions_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    from distributed_point_functions_tpu_torch import native
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.ops import expand_planes as ep
    from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
    from distributed_point_functions_tpu_torch.ops.inner_product import (
        parity_pack,
        xor_counts_plain,
    )
    from distributed_point_functions_tpu_torch.ops.words import to_tensor
    from distributed_point_functions_tpu_torch.pir import (
        DenseDpfPirClient,
        DenseDpfPirDatabase,
        DenseDpfPirServer,
    )
    from distributed_point_functions_tpu_torch.ops.words import to_tensors
    from distributed_point_functions_tpu_torch.pir import dense_eval
    from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        DEFAULT_EXPANSION,
        EXPANSION_MODES,
        evaluate_selection_blocks_planes,
        exit_block_nodes,
        expansion_plan,
    )
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
        chunk_block_nodes,
    )
    from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    props = torch.cuda.get_device_properties(dev)
    kind = torch.cuda.get_device_name(0)

    # 1. Device.
    smi_line = nvidia_smi("name,power.limit")
    print(smi_line, flush=True)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    hbm = next(v for k, v in HBM_BYTES_PER_S.items() if k in kind) \
        if any(k in kind for k in HBM_BYTES_PER_S) else 3.35e12
    int32_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    from distributed_point_functions_tpu_torch.utils import get_backend_mode_string

    emit({"phase": "backend", "mode": get_backend_mode_string()})
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "sms": props.multi_processor_count, "max_sm_mhz": max_sm_mhz,
          "int32_ops_per_s": int32_ops_per_s, "hbm_bytes_per_s": hbm,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    def bound(ops, nbytes, ops_per_s=int32_ops_per_s):
        t_ops = ops / ops_per_s * 1e3
        t_bytes = nbytes / hbm * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    # 2. Build, with the AES probe compiled beside the kernels.
    t0 = time.perf_counter()
    cuda_lib.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    probe_dir = Path(tempfile.mkdtemp(prefix=".aes_probe-", dir=cuda_lib.BUILD_ROOT))
    try:
        probe = start_aes_probe(cuda_lib, probe_dir)
        cuda_lib.library()
        build_s = time.perf_counter() - t0
        native.get_lib()
        host_build_s = time.perf_counter() - t0 - build_s
        sass = aes_sass_ops(cuda_lib, probe_dir, probe)
    finally:
        shutil.rmtree(probe_dir, ignore_errors=True)
    gate_ops = {k: aes_word_ops(k) for k in sass}
    aes_ops = {k: min(gate_ops[k], sass[k][0]) for k in sass}
    emit({"phase": "build", "seconds": build_s, "host_library_seconds": host_build_s,
          "host_library_dir": str(native.build_dir().relative_to(root)),
          "probe_seconds": time.perf_counter() - t0,
          "dir": str(cuda_lib.build_dir().relative_to(root)),
          "ptxas": cuda_lib.ptxas_report().splitlines(),
          "aes_gate_ops": gate_ops,
          "aes_sass_lop3": {k: v[0] for k, v in sass.items()},
          "aes_sass_instructions": {k: v[1] for k, v in sass.items()},
          "aes_ops_in_bounds": aes_ops})

    rng = np.random.default_rng(SEED)

    def rand_words(*shape):
        return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)

    ptxas = ptxas_table(cuda_lib.ptxas_report())

    # The latency of one split-AES level at one group: one word column
    # walked through LATENCY_LEVELS levels in one K8 launch, device time
    # over the levels.
    lat_args = (rand_words(16, 8, 1), rand_words(1), rand_words(LATENCY_LEVELS, 1),
                rand_words(LATENCY_LEVELS, 16, 8, 1), rand_words(LATENCY_LEVELS, 1),
                rand_words(LATENCY_LEVELS, 1))
    require_equal("path_walk at one column", ep.path_walk(*lat_args),
                  ep.path_walk_plain(*lat_args, (LATENCY_LEVELS,)))
    level_us = kernel_time_ms(lambda: ep.path_walk(*lat_args), reps=5) * 1e3 / LATENCY_LEVELS
    emit({"phase": "split_aes", "group_size": SPLIT_GROUP, "levels": LATENCY_LEVELS,
          "level_latency_us_at_one_group": level_us})

    def split_info(kernel):
        """The group size of K4's and K8's split AES, the kernel's
        registers and spills, and the level latency at one group."""
        return {"group_size": SPLIT_GROUP, "level_latency_us_at_one_group": level_us,
                "ptxas": ptxas_of(ptxas, kernel)}

    # 3. Kernels at the main path's shapes.
    kg = NUM_QUERIES // 32
    expand_levels = ((NUM_RECORDS // 128) - 1).bit_length()
    plans = {mode: expansion_plan(mode, kg, expand_levels) for mode in EXPANSION_MODES}
    results = {}

    # Word ops of one child column of a doubling level (AES + 64 sigma +
    # 128 feed-forward + 256 correction + 2 control) and of one leaf
    # value column (AES + 448).
    child_ops = aes_ops[0] + 64 + 128 + 256 + 2
    value_ops = aes_ops[2] + 64 + 128 + 256

    def doubling_work(g0, r, value, kw=kg):
        """(ops, bytes) of r doubling levels from g0 columns, each tree
        node's children hashed once, plus the value hash: inputs read
        once (state, ctrl, r levels of corrections of kw columns, vc),
        outputs written once (planes and ctrl at width g0 << r)."""
        w = g0 << r
        ops = 2 * g0 * ((1 << r) - 1) * child_ops + (w * value_ops if value else 0)
        nbytes = 4 * (129 * g0 + r * 130 * kw + (128 * kw if value else 0) + 129 * w)
        return ops, nbytes

    def measure(name, run, plain, ops, nbytes, plain_reps=3, plain_warmup=1,
                ops_per_s=int32_ops_per_s):
        """Kernel against plain version; `plain_reps=0` compares without
        timing the plain version (`plain_ms` null)."""
        got = run()
        want = plain()
        torch.cuda.synchronize()
        b_ms, b_by = bound(ops, nbytes, ops_per_s)
        return {"err": require_equal(name, got, want),
                "ms": cuda_time_ms(run, reps=20),
                "device_ms": kernel_time_ms(run),
                "plain_ms": (cuda_time_ms(plain, reps=plain_reps, warmup=plain_warmup)
                             if plain_reps else None),
                "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes}

    def add_up(parts):
        """One batch's figures of a kernel launched in several shapes."""
        ops = sum(p["ops"] for p in parts)
        nbytes = sum(p["bytes"] for p in parts)
        return {"err": max(p["err"] for p in parts),
                "ms": sum(p["ms"] for p in parts),
                "device_ms": sum(p["device_ms"] for p in parts),
                "plain_ms": sum(p["plain_ms"] for p in parts),
                "bound_ms": sum(p["bound_ms"] for p in parts),
                "bound_by": bound(ops, nbytes)[1], "ops": ops, "bytes": nbytes}

    # K2: one launch per level, width G = KG * 2^i.
    levels = []
    for i in range(expand_levels):
        g = kg << i
        args = (rand_words(16, 8, g), rand_words(g), rand_words(16, 8, kg),
                rand_words(kg), rand_words(kg))
        levels.append(measure(
            f"expand_level G={g}", lambda: ep.expand_level(*args),
            lambda: ep.expand_level_plain(*args), 2 * g * child_ops,
            4 * (128 * g + g + 128 * kg + 2 * kg + 2 * 128 * g + 2 * g)))
    k2_ptxas = ptxas_of(ptxas, "expand_level_kernel")
    for i, part in enumerate(levels):
        emit({"phase": "kernel", "name": "expand_level", "level": i, "KG": kg,
              "G": kg << i, "launches_per_batch": 1, **part, "ptxas": k2_ptxas})
    k2 = add_up(levels)
    k2["level_ms"] = [lv["ms"] for lv in levels]
    k2["level_device_ms"] = [lv["device_ms"] for lv in levels]
    k2["level_bound_ms"] = [lv["bound_ms"] for lv in levels]
    results["expand_level"] = k2
    emit({"phase": "kernel", "name": "expand_level", "levels": expand_levels,
          "launches_per_batch": expand_levels, **k2, "ptxas": k2_ptxas})

    # K3: the leaf value hash at width KG * 2^levels.
    g = kg << expand_levels
    args = (rand_words(16, 8, g), rand_words(g), rand_words(16, 8, kg))
    results["value_hash"] = measure(
        "value_hash", lambda: ep.value_hash(*args), lambda: ep.value_hash_plain(*args),
        g * value_ops, 4 * (128 * g + g + 128 * kg + 128 * g))
    emit({"phase": "kernel", "name": "value_hash", "G": g,
          "launches_per_batch": 1, **results["value_hash"]})

    def fused_args(g0, r, kw=kg):
        return (rand_words(16, 8, g0), rand_words(g0), rand_words(r, 16, 8, kw),
                rand_words(r, kw), rand_words(r, kw), rand_words(16, 8, kw))

    # K4: walk mode's head (no value hash) and tail (value hash) phases.
    head, tail, _ = plans["walk"]
    phases = []
    for phase, g0, r, vh in (("head", kg, head, False),
                             ("tail", kg << (expand_levels - tail), tail, True)):
        *args, vc = fused_args(g0, r)
        part = measure(
            f"walk_descend {phase}",
            lambda: ep.walk_descend(*args, vc, value_hash=vh),
            lambda: ep.walk_descend_plain(*args, vc, value_hash=vh),
            *doubling_work(g0, r, vh))
        phases.append(part)
        emit({"phase": "kernel", "name": "walk_descend", "walk_phase": phase,
              "G0": g0, "levels": r, "W": g0 << r, "value_hash": vh,
              "launches_per_batch": 1, **part,
              **split_info("NaturalOrder")})
    results["walk_descend"] = add_up(phases)

    # K4 and K2 at the serving tiers' shapes (BASELINE configs[2]: 1,024
    # queries, 32 word columns of keys): walk mode's head and tail for the
    # materialized tier's 15 levels and for one streaming or chunked
    # chunk's 10 levels from one node's 32 columns; K2 at every width of
    # the streaming cut state (32 -> 512 columns) and of the materialized
    # tier's middle levels (2,048 -> 32,768). K4 also at the DPF full
    # domain's (BASELINE configs[0]: one key, KG = 1, 14 plane levels).
    tier_kg = TIER_QUERIES // 32
    tier_levels = ((TIER_RECORDS // 128) - 1).bit_length()
    # The DPF's tree has FD_LDS - 1 levels, 5 of them on the host.
    for label, key_groups, levels in (("materialized", tier_kg, tier_levels),
                                      ("chunk", tier_kg, TIER_CHUNK_LEVELS),
                                      ("dpf_full_domain", 1, FD_LDS - 1 - 5)):
        head, tail, _ = expansion_plan("walk", key_groups, levels)
        for phase, g0, r, vh in (("head", key_groups, head, False),
                                 ("tail", key_groups << (levels - tail), tail, True)):
            *args, vc = fused_args(g0, r, key_groups)
            part = measure(
                f"walk_descend {label} {phase}",
                lambda: ep.walk_descend(*args, vc, value_hash=vh),
                lambda: ep.walk_descend_plain(*args, vc, value_hash=vh),
                *doubling_work(g0, r, vh, key_groups), plain_reps=1)
            results["walk_descend"]["err"] = max(results["walk_descend"]["err"],
                                                 part["err"])
            emit({"phase": "kernel", "name": "walk_descend", "tier_shape": label,
                  "walk_phase": phase, "KG": key_groups, "G0": g0, "levels": r,
                  "W": g0 << r, "value_hash": vh, **part,
                  **split_info("NaturalOrder")})
    _, tail, _ = expansion_plan("walk", tier_kg, tier_levels)
    # The streaming tier's cut state: its first TIER_CUT_LEVELS K2 levels.
    for i in range(tier_levels - tail):  # every K2 input width of both tiers
        g = tier_kg << i
        args = (rand_words(16, 8, g), rand_words(g), rand_words(16, 8, tier_kg),
                rand_words(tier_kg), rand_words(tier_kg))
        part = measure(
            f"expand_level KG={tier_kg} G={g}", lambda: ep.expand_level(*args),
            lambda: ep.expand_level_plain(*args), 2 * g * child_ops,
            4 * (128 * g + g + 128 * tier_kg + 2 * tier_kg + 2 * 128 * g + 2 * g),
            plain_reps=1)
        results["expand_level"]["err"] = max(results["expand_level"]["err"], part["err"])
        emit({"phase": "kernel", "name": "expand_level", "tier_shape": True,
              "streaming_cut": i < TIER_CUT_LEVELS, "level": i, "KG": tier_kg, "G": g,
              **part, "ptxas": k2_ptxas})

    # leaf_blocks: leaf values out of plane layout into selection blocks,
    # in the exit order of the main path's walk plan (8,192 blocks of 128
    # keys) and of its level plan (bit-reversed: tail and level modes), of
    # the materialized tier's (32,768 blocks of 1,024 keys) and of one
    # streaming chunk (1,024 blocks, bit-reversed), each with the cached
    # block -> node map that the serving path passes. Bytes bound it: each
    # plane word and each block's node read once, each selection word
    # written once (zero blocks included); a 32x32 bit transpose is 480
    # word operations (five rounds of 16 six-operation swaps).
    def exit_map(levels, key_groups, mode):
        plan = expansion_plan(mode, key_groups, levels)
        return exit_block_nodes(levels, *plan, mode == "walk", 1 << levels)

    for label, key_groups, levels, block_node in (
            ("main", kg, expand_levels, exit_map(expand_levels, kg, "walk")),
            ("main_bit_reversed", kg, expand_levels, exit_map(expand_levels, kg, "level")),
            ("materialized", tier_kg, tier_levels, exit_map(tier_levels, tier_kg, "walk")),
            ("chunk", tier_kg, TIER_CHUNK_LEVELS,
             chunk_block_nodes(TIER_CHUNK_LEVELS,
                               expansion_plan("walk", tier_kg, TIER_CHUNK_LEVELS), True))):
        num_blocks = 1 << levels
        g = key_groups * num_blocks
        values = rand_words(16, 8, g)
        block_node = torch.from_numpy(block_node).to(dev)
        node_block = ep.node_blocks(block_node, num_blocks)
        part = measure(
            f"leaf_blocks {label}",
            lambda: ep.leaf_blocks(values, block_node, key_groups),
            lambda: ep.leaf_blocks_plain(values, node_block, num_blocks), 4 * 480 * g,
            4 * (128 * g + num_blocks) + 16 * 32 * key_groups * num_blocks)
        if label == "main":
            results["leaf_blocks"] = part
        else:
            results["leaf_blocks"]["err"] = max(results["leaf_blocks"]["err"], part["err"])
        emit({"phase": "kernel", "name": "leaf_blocks", "shape": label, "KG": key_groups,
              "blocks": num_blocks, **part, "ptxas": ptxas_of(ptxas, leaf_kernel(key_groups))})
    del values

    # K6 and K5: tail mode's head and tiled tail at the main path's shapes,
    # then at the materialized tier's (configs[2], KG = 32: 32 -> 2,048
    # columns over 6 levels, 65,536 -> 2^20 over 4 in 128-column tiles) and
    # the DPF full domain's (KG = 1: 1 -> 1,024 over 10, 1,024 -> 16,384
    # over 4). The plain tail runs tile by tile: one timed call, and at the
    # materialized tier's 512 tiles (~84 s a call) none.
    for label, key_groups, levels in (("main", kg, expand_levels),
                                      ("materialized", tier_kg, tier_levels),
                                      ("dpf_full_domain", 1, FD_LDS - 1 - 5)):
        head, tail, tile_nodes = expansion_plan("tail", key_groups, levels)
        main = label == "main"
        *args, _ = fused_args(key_groups, head, key_groups)
        part = measure(
            f"expand_head {label}", lambda: ep.expand_head(*args),
            lambda: ep.expand_head_plain(*args),
            *doubling_work(key_groups, head, False, key_groups),
            plain_reps=3 if main else 1)
        shape = {"tier_shape": label, "KG": key_groups} if not main else {}
        emit({"phase": "kernel", "name": "expand_head", **shape, "G0": key_groups,
              "levels": head, "W": key_groups << head, "launches_per_batch": 1,
              **part, **split_info("TiledOrder")})
        g0 = key_groups << (levels - tail)
        args = fused_args(g0, tail, key_groups)
        tile_lanes = tile_nodes * key_groups
        part_tail = measure(
            f"expand_tail {label}", lambda: ep.expand_tail(*args, tile_lanes),
            lambda: ep.expand_tail_plain(*args, tile_lanes),
            *doubling_work(g0, tail, True, key_groups),
            plain_reps=0 if label == "materialized" else 1, plain_warmup=0)
        emit({"phase": "kernel", "name": "expand_tail", **shape, "G0": g0,
              "levels": tail, "W": g0 << tail, "tile_lanes": tile_lanes,
              "launches_per_batch": 1, **part_tail, **split_info("TiledOrder")})
        if main:
            results["expand_head"], results["expand_tail"] = part, part_tail
        else:
            for name, got in (("expand_head", part), ("expand_tail", part_tail)):
                results[name]["err"] = max(results[name]["err"], got["err"])

    # K1, its accumulate entry and K7 are one count product of 0/1 matrices,
    # [nq, R] x [R, 32W]: 2 operations per (query, record, value bit, word),
    # bound at the single-bit rate. Each line also gives the int8 rate it
    # reached and its share of the int8 product's time.
    def count_ops(nq, records, words):
        return 2 * nq * records * 32 * words

    def tensor_rate(part):
        int8_ms = part["ops"] / INT8_OPS_PER_S * 1e3
        return {"int8_ops_per_s": part["ops"] / (part["device_ms"] / 1e3),
                "int8_bound_ms": int8_ms,
                "int8_bound_share": int8_ms / part["device_ms"],
                "bound_share": part["bound_ms"] / part["device_ms"]}

    # K1: the inner product over the bit-major staging.
    words = RECORD_BYTES // 4
    groups = NUM_RECORDS // 32
    db_perm = rand_words(32, groups, words)
    packed = rand_words(NUM_QUERIES, groups)
    results["xor_inner_product"] = measure(
        "xor_inner_product",
        lambda: ipk.xor_inner_product_packed(db_perm, packed),
        lambda: ipk.xor_inner_product_packed_plain(db_perm, packed),
        count_ops(NUM_QUERIES, NUM_RECORDS, words),
        4 * (32 * groups * words + NUM_QUERIES * groups + NUM_QUERIES * words),
        ops_per_s=B1_OPS_PER_S)
    def library(db_perm, packed):
        """One PyTorch call on the unpacked 0/1 operands that computes the
        counts K7 computes, whose parity is K1's product: `torch._int_mm`
        (int8 in, int32 out) and `torch.mm` in bf16 with float32 out (exact:
        every count is below 2^24). Both must agree; the faster is the
        yardstick. Returns (counts int32[nq, 32, W], a dict of `library_ms`,
        each call's ms and the unpacking's ms)."""
        unpack_ms = cuda_time_ms(lambda: unpack_operands(db_perm, packed), reps=3,
                                 warmup=1)
        sel, bits = unpack_operands(db_perm, packed)
        counts = torch._int_mm(sel, bits)
        int8_ms = cuda_time_ms(lambda: torch._int_mm(sel, bits), reps=10)
        cast_ms = cuda_time_ms(lambda: (sel.to(torch.bfloat16), bits.to(torch.bfloat16)),
                               reps=3, warmup=1)
        sel, bits = sel.to(torch.bfloat16), bits.to(torch.bfloat16)
        if not torch.equal(torch.mm(sel, bits, out_dtype=torch.float32).to(torch.int32),
                           counts):
            raise AssertionError("the bf16 and int8 count products differ")
        bf16_ms = cuda_time_ms(lambda: torch.mm(sel, bits, out_dtype=torch.float32),
                               reps=10)
        return counts.reshape(packed.shape[0], 32, -1), {
            "library_ms": min(int8_ms, bf16_ms), "library_int_mm_ms": int8_ms,
            "library_mm_bf16_ms": bf16_ms, "library_unpack_ms": unpack_ms,
            "library_bf16_cast_ms": cast_ms}

    counts_lib, lib = library(db_perm, packed)
    if not torch.equal(parity_pack(counts_lib), ipk.xor_inner_product_packed(db_perm, packed)):
        raise AssertionError("xor_inner_product: the parity of the int8 product differs")
    results["xor_inner_product"].update(lib, **tensor_rate(results["xor_inner_product"]),
                                        ptxas=ptxas_of(ptxas, "xor_ip_kernel"))
    results["leaf_blocks"]["ptxas"] = ptxas_of(ptxas, leaf_kernel(kg))
    emit({"phase": "kernel", "name": "xor_inner_product",
          "shape": [NUM_QUERIES, NUM_RECORDS, words],
          "launches_per_batch": 1, **results["xor_inner_product"]})

    # K7: the v1 inner product's counts on the same inputs.
    results["xor_counts"] = measure(
        "xor_counts",
        lambda: ipk.xor_counts(db_perm, packed),
        lambda: xor_counts_plain(db_perm, packed),
        count_ops(NUM_QUERIES, NUM_RECORDS, words),
        4 * (32 * groups * words + NUM_QUERIES * groups + NUM_QUERIES * 32 * words),
        ops_per_s=B1_OPS_PER_S)
    if not torch.equal(counts_lib, ipk.xor_counts(db_perm, packed)):
        raise AssertionError("xor_counts: the int8 product's counts differ")
    results["xor_counts"].update(lib, **tensor_rate(results["xor_counts"]),
                                 ptxas=ptxas_of(ptxas, "xor_counts_kernel"))
    emit({"phase": "kernel", "name": "xor_counts",
          "shape": [NUM_QUERIES, NUM_RECORDS, words],
          "launches_per_batch": 1, **results["xor_counts"]})
    del db_perm, packed, counts_lib

    # K1's accumulate entry at one streaming chunk of BASELINE configs[2]:
    # 2^17 records, 1,024 queries; XORed into running results in place.
    chunk_groups = (1 << 17) // 32
    span = rand_words(32, chunk_groups, words)
    packed = rand_words(TIER_QUERIES, chunk_groups)
    sel = packed.reshape(TIER_QUERIES, -1, 4)
    acc0 = rand_words(TIER_QUERIES, words)
    acc = acc0.clone()
    results["xor_inner_product_accumulate"] = measure(
        "xor_inner_product_accumulate",
        lambda: ipk.xor_inner_product_accumulate(acc, span, sel),
        lambda: acc0 ^ ipk.xor_inner_product_packed_plain(span, packed),
        count_ops(TIER_QUERIES, 1 << 17, words),
        4 * (32 * chunk_groups * words + TIER_QUERIES * chunk_groups
             + 2 * TIER_QUERIES * words),
        ops_per_s=B1_OPS_PER_S)
    halves = torch.zeros_like(acc0)
    half = chunk_groups // 2
    for lo in (0, half):
        ipk.xor_inner_product_accumulate(
            halves, span[:, lo:lo + half],
            packed[:, lo:lo + half].reshape(TIER_QUERIES, -1, 4))
    if not torch.equal(halves, ipk.xor_inner_product_packed(span, packed)):
        raise AssertionError("xor_inner_product_accumulate: two halves differ from one call")
    counts_lib, lib = library(span, packed)
    if not torch.equal(parity_pack(counts_lib), halves):
        raise AssertionError("xor_inner_product_accumulate: the count product differs")
    results["xor_inner_product_accumulate"].update(
        lib, **tensor_rate(results["xor_inner_product_accumulate"]),
        ptxas=ptxas_of(ptxas, "xor_ip_kernel"))
    emit({"phase": "kernel", "name": "xor_inner_product_accumulate",
          "shape": [TIER_QUERIES, 1 << 17, words], "halves_equal_one_call": True,
          **results["xor_inner_product_accumulate"]})
    del span, packed, sel, counts_lib

    # The count product's ragged edges and extremes against the plain versions.
    emit(count_product_edges(dev))

    # K9: Mosaic's tiling repeat, at the probe's shape and at a [256, 128]
    # source tiled 32 times (the v2 TPU kernel's selection repeat).
    k9 = {}
    for height, n, factor in ((1, 2, 2), (256, 128, 32)):
        x = rand_words(height, n)
        k9[height, n, factor] = measure(
            f"repeat_tiles {height}x{n}x{factor}", lambda: ipk.repeat_tiles(x, factor),
            lambda: ipk.repeat_tiles_plain(x, factor), 0,
            4 * (height * n + height * n * factor))
        k9[height, n, factor]["library_ms"] = cuda_time_ms(lambda: x.repeat(1, factor),
                                                           reps=20)
        k9[height, n, factor]["ptxas"] = ptxas_of(ptxas, "repeat_tiles_kernel")
        emit({"phase": "kernel", "name": "repeat_tiles", "shape": [height, n],
              "factor": factor, **k9[height, n, factor]})
    results["repeat_tiles"] = k9[1, 2, 2]
    probe = []
    probe_launches = counted(lambda: probe.append(ipk.interpret_repeat_tiles(dev)),
                             {"repeat_tiles": 1}, "probe")
    if probe != [True]:
        raise AssertionError("interpret_repeat_tiles: K9 does not tile like Mosaic")
    emit({"phase": "probe", "interpret_repeat_tiles": True, "launches": probe_launches})

    # K8: one path-walk level (select-key AES, corrections, control), per
    # seed at the DCF's width (1,024 keys: 32 word columns) and at 65,536
    # lanes, and with one key's shared corrections (KW = 1) at 65,536, 1,024
    # and 64 lanes; then the walks its callers launch: the DCF's 31 levels
    # with a stop at each of its 32 hierarchy levels (G = KW = 32) and a
    # chunk's 5 path bits (configs[2], G = KW = 32, every key on one branch).
    # A column and level: the select-key AES + 64 sigma + 128 feed-forward
    # + 256 correction + 5 control operations; the bytes: the entry state
    # and control, the select words and corrections of every level, and the
    # states and controls of every stop, each once.
    path_ops = aes_ops["select"] + 64 + 128 + 256 + 5
    k8 = {}
    for mode, g, kw, levels, stops in (
            ("per_seed", 32, 32, 1, (1,)), ("per_seed", 2048, 2048, 1, (1,)),
            ("shared", 2048, 1, 1, (1,)), ("shared", 32, 1, 1, (1,)),
            ("shared", 2, 1, 1, (1,)),
            ("dcf_walk", 32, 32, DCF_LDS - 1, tuple(range(DCF_LDS))),
            ("chunk_walk", 32, 32, 5, (5,))):
        sel = (rand_words(levels, g) if mode != "chunk_walk" else
               -to_tensor(rng.integers(0, 2, (levels, 1), dtype=np.uint32), dev).expand(
                   levels, g).contiguous())
        args = (rand_words(16, 8, g), rand_words(g), sel,
                rand_words(levels, 16, 8, kw), rand_words(levels, kw),
                rand_words(levels, kw))
        k8[mode, g] = measure(
            f"path_level {mode} G={g}", lambda: ep.path_walk(*args, stops=stops),
            lambda: ep.path_walk_plain(*args, stops), levels * g * path_ops,
            4 * (129 * g + levels * (g + 130 * kw) + len(stops) * 129 * g))
        emit({"phase": "kernel", "name": "path_level", "mode": mode, "G": g,
              "KW": kw, "lanes": 32 * g, "levels": levels, "stops": len(stops),
              **k8[mode, g],
              **split_info("path_walk_kernel")})
    results["path_level"] = k8["dcf_walk", 32]

    # K3 at the DCF's shape: the walk states of its 32 hierarchy levels,
    # 32 word columns each, hashed with zero corrections in one launch.
    g = 32 * DCF_LDS
    args = (rand_words(16, 8, g), torch.zeros((g,), dtype=torch.int32, device=dev),
            torch.zeros((16, 8, 1), dtype=torch.int32, device=dev))
    part = measure("value_hash dcf", lambda: ep.value_hash(*args),
                   lambda: ep.value_hash_plain(*args), g * value_ops,
                   4 * (128 * g + g + 128 + 128 * g))
    emit({"phase": "kernel", "name": "value_hash", "path": "dcf", "G": g, **part})

    # K8 and K3 at the heavy-hitters phase's widest level (round 2: 4,096
    # prefixes, 4 tree levels walked from round 1's cut states), one chunk
    # of its plan at the card's default budget: prefix-major lanes, per-seed
    # corrections of the staged keys' KW = 2,048 word columns read at
    # column m % KW, every word's path bits all ones or all zeros; then the
    # value hash of the chunk's lanes with zero corrections.
    from distributed_point_functions_tpu_torch.heavy_hitters import plan_level

    # Their own generator, so the later phases' data stay as they were.
    hh_words = np.random.default_rng(SEED + 51)

    def hh_rand(*shape):
        return to_tensor(hh_words.integers(0, 1 << 32, shape, dtype=np.uint32), dev)

    hh_plan = plan_level(HH_CLIENTS, HH_WIDTHS[HH_WIDEST_ROUND], 4, 1)
    kw = HH_CLIENTS // 32
    g = hh_plan.chunk_prefixes * kw
    bits = to_tensor(hh_words.integers(0, 2, (4, hh_plan.chunk_prefixes, 1),
                                       dtype=np.uint32), dev)
    args = (hh_rand(16, 8, g), hh_rand(g),
            (-bits).expand(4, hh_plan.chunk_prefixes, kw).reshape(4, g),
            hh_rand(4, 16, 8, kw), hh_rand(4, kw), hh_rand(4, kw))
    part = measure("path_level hh_chunk", lambda: ep.path_walk(*args),
                   lambda: ep.path_walk_plain(*args, (4,)), 4 * g * path_ops,
                   4 * (129 * g + 4 * (g + 130 * kw) + 129 * g), plain_reps=1)
    emit({"phase": "kernel", "name": "path_level", "mode": "hh_chunk", "G": g, "KW": kw,
          "lanes": 32 * g, "levels": 4, "stops": 1, "chunk_prefixes": hh_plan.chunk_prefixes,
          "chunks_at_widest_level": hh_plan.num_chunks, **part,
          **split_info("path_walk_kernel")})
    del args
    args = (hh_rand(16, 8, g), torch.zeros((g,), dtype=torch.int32, device=dev),
            torch.zeros((16, 8, 1), dtype=torch.int32, device=dev))
    part = measure("value_hash hh_chunk", lambda: ep.value_hash(*args),
                   lambda: ep.value_hash_plain(*args), g * value_ops,
                   4 * (128 * g + g + 128 + 128 * g), plain_reps=1)
    emit({"phase": "kernel", "name": "value_hash", "path": "hh_chunk", "G": g,
          "lanes": 32 * g, "chunk_prefixes": hh_plan.chunk_prefixes, **part})
    del args

    # 4. A small database served on the card and by the plain versions.
    small = [rng.bytes(32) for _ in range(1 << 12)]
    client = DenseDpfPirClient.create(len(small), encrypt_decrypt.encrypt)
    idx = [int(i) for i in rng.integers(0, len(small), 40)]
    reqs = client.create_plain_requests(idx)
    gpu_db = DenseDpfPirDatabase(small)
    cpu_db = DenseDpfPirDatabase(small, device="cpu")
    for mode in EXPANSION_MODES:
        gpu_srv = DenseDpfPirServer.create_plain(gpu_db, expansion=mode)
        cpu_srv = DenseDpfPirServer.create_plain(cpu_db, device="cpu", expansion=mode)
        shares = []
        for party, req in enumerate(reqs):
            a = gpu_srv.handle_plain_request(req).dpf_pir_response.masked_response
            b = cpu_srv.handle_plain_request(req).dpf_pir_response.masked_response
            if a != b:
                raise AssertionError(f"{mode} party {party}: card and plain responses differ")
            shares.append(a)
        for s0, s1, i in zip(*shares, idx):
            if bytes(x ^ y for x, y in zip(s0, s1)) != small[i]:
                raise AssertionError(f"small path ({mode}): record {i} does not reconstruct")
    emit({"phase": "small_path", "records": len(small), "queries": len(idx),
          "modes": list(EXPANSION_MODES), "card_equals_plain": True,
          "reconstructed": True})

    # 5. The main path at 2^20 x 256 B, 128 queries, in each mode.
    t0 = time.perf_counter()
    data = rng.bytes(NUM_RECORDS * RECORD_BYTES)
    records = [data[i * RECORD_BYTES:(i + 1) * RECORD_BYTES]
               for i in range(NUM_RECORDS)]
    db = DenseDpfPirDatabase(records)
    db.staged()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, NUM_QUERIES)]
    t0 = time.perf_counter()
    r0, r1 = client.create_plain_requests(idx)
    keygen_s = time.perf_counter() - t0
    expected = {
        "walk": {"walk_descend": 4, "leaf_blocks": 2, "xor_inner_product": 2},
        "tail": {"expand_head": 2, "expand_tail": 2, "leaf_blocks": 2,
                 "xor_inner_product": 2},
        "level": {"expand_level": 2 * expand_levels, "value_hash": 2,
                  "leaf_blocks": 2, "xor_inner_product": 2},
    }
    launches, first_s, servers = {}, {}, {}

    def serve(server):
        s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
        s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
        torch.cuda.synchronize()
        return s0, s1

    for mode in EXPANSION_MODES:
        server = DenseDpfPirServer.create_plain(db, expansion=mode)
        servers[mode] = server
        serve(server)  # warm-up
        out = []
        t0 = time.perf_counter()
        launches[mode] = counted(lambda: out.append(serve(server)), expected[mode],
                                 f"main path ({mode})")
        first_s[mode] = time.perf_counter() - t0
        s0, s1 = out[0]
        for a, b, i in zip(s0, s1, idx):
            if bytes(x ^ y for x, y in zip(a, b)) != records[i]:
                raise AssertionError(f"main path ({mode}): record {i} does not reconstruct")
    # Batches of the three modes in turns (forward, then backward), so
    # that the shared host's drift falls on all of them alike.
    batch_s = {mode: [] for mode in EXPANSION_MODES}
    for rnd in range(16):
        order = EXPANSION_MODES if rnd % 2 == 0 else EXPANSION_MODES[::-1]
        for mode in order:
            t0 = time.perf_counter()
            serve(servers[mode])
            batch_s[mode].append(time.perf_counter() - t0)
    qps = {mode: NUM_QUERIES / statistics.median(batch_s[mode])
           for mode in EXPANSION_MODES}
    # The share of rounds in which a mode's batch beat another's. The
    # host's spread within a run is wider than the modes' differences, so
    # a mode counts as fastest only if it wins nine rounds in ten against
    # each other mode; `fastest` is null when no mode does.
    wins = {a: {b: sum(x < y for x, y in zip(batch_s[a], batch_s[b]))
                / len(batch_s[a]) for b in EXPANSION_MODES if b != a}
            for a in EXPANSION_MODES}
    fastest = next((a for a in EXPANSION_MODES if min(wins[a].values()) >= 0.9),
                   None)
    for mode in EXPANSION_MODES:
        emit({"phase": "main_path", "expansion": mode, "plan": plans[mode],
              "records": NUM_RECORDS, "record_bytes": RECORD_BYTES,
              "queries": NUM_QUERIES, "reconstructed": NUM_QUERIES,
              "launches": launches[mode], "setup_s": setup_s,
              "keygen_s": keygen_s, "counted_batch_s": first_s[mode],
              "batch_s": batch_s[mode], "queries_per_sec": qps[mode],
              "round_wins": wins[mode], "device": smi_line})

    # Where one party's batch spends its time in each mode: the server's
    # three steps, each ended by a synchronize (host clock), and the
    # device's busy share of one request (the kernels' device time in a
    # profiler trace over the wall time of the call).
    for mode in EXPANSION_MODES:
        server = servers[mode]
        steps = {"stage_keys_ms": [], "expand_ms": [], "inner_product_ms": [],
                 "stage_keys_numpy_ms": []}
        for _ in range(5):
            t0 = time.perf_counter()
            staged_np = to_tensors(stage_keys_numpy(
                dense_eval, r0.plain_request.dpf_keys, server.walk_levels), dev)
            torch.cuda.synchronize()
            steps["stage_keys_numpy_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            staged = stage_keys(
                r0.plain_request.dpf_keys, server.walk_levels, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if not all(torch.equal(a, b) for a, b in zip(staged, staged_np)):
                raise AssertionError("stage_keys: the native walk differs from the numpy walk")
            sel = evaluate_selection_blocks_planes(
                *staged, expand_levels=server.expand_levels,
                num_blocks=db.num_selection_blocks, mode=mode)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            db.inner_product_with(sel)
            t3 = time.perf_counter()
            for k, v in zip(steps, (t1 - t0, t2 - t1, t3 - t2)):
                steps[k].append(v * 1e3)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.handle_plain_request(r0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.device_time for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        mode_kernels = [k for k, n in launches[mode].items() if n]
        emit({"phase": "main_path_breakdown", "expansion": mode,
              "default": mode == DEFAULT_EXPANSION, "party_batch": NUM_QUERIES,
              **{k: statistics.median(v) for k, v in steps.items()},
              "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_idle_share": 1.0 - busy_ms / wall_ms,
              "kernel_device_ms": {k: results[k]["device_ms"] for k in mode_kernels},
              "queries_per_sec": qps[mode], "fastest": fastest})

    # The main path with the v1 inner product: K7's counts and their parity.
    db_v1 = DenseDpfPirDatabase(records, inner_product="v1")
    db_v1.staged()
    server = DenseDpfPirServer.create_plain(db_v1)
    serve(server)  # warm-up
    out = []
    want = {k: n for k, n in expected[DEFAULT_EXPANSION].items()
            if k != "xor_inner_product"}
    launches["v1"] = counted(lambda: out.append(serve(server)),
                             {**want, "xor_counts": 2}, "main path (v1)")
    for a, b, i in zip(*out[0], idx):
        if bytes(x ^ y for x, y in zip(a, b)) != records[i]:
            raise AssertionError(f"main path (v1): record {i} does not reconstruct")
    times = host_ms(lambda: serve(server), 16)
    emit({"phase": "main_path_v1", "inner_product": "v1", "expansion": DEFAULT_EXPANSION,
          "records": NUM_RECORDS, "record_bytes": RECORD_BYTES, "queries": NUM_QUERIES,
          "reconstructed": NUM_QUERIES, "launches": launches["v1"],
          "batch_ms": statistics.median(times), "batch_ms_all": times,
          "queries_per_sec": NUM_QUERIES / statistics.median(times) * 1e3,
          "device": smi_line})
    del db_v1, server

    # The Leader/Helper deployment at the same configuration, over the
    # main path's staged database.
    launches["two_party"] = two_party_phase(
        rng, dev, db, records, servers[DEFAULT_EXPANSION].walk_levels, smi_line)
    del servers, db

    # The serving runtime at the same configuration: batched sessions
    # over framed TCP, then a rotation under traffic.
    serving_phase(dev, records, smi_line)
    # The replica fleet at the same configuration: three pairs behind the
    # router, quorum rotations, the cross-replica probe, the fleet admin.
    fleet_phase(dev, records, smi_line)

    # 6. The DPF and DCF evaluation paths.
    dcf_launches = dcf_phase(rng, dev)
    full = dpf_full_domain_phase(rng, dev)
    dpf_point_phase(rng, dev, full)
    # The FSS layer: its own generator, so the later phases' data stay as
    # they were.
    fss_rng = np.random.default_rng(SEED + 10)
    mic_phase(fss_rng, dev)
    dpf_value_types_phase(fss_rng, dev, full)

    # 7. Dense PIR's serving tiers at BASELINE configs[2].
    tier_counts = tiers_phase(rng, dev, smi_line)

    # Sparse PIR: the small database against the plain versions, then
    # BASELINE configs[4] on one card, plain and as Leader and Helper. Its
    # own generator, so the earlier phases' data stay as they were.
    sparse_rng = np.random.default_rng(SEED + 30)
    sparse_small_phase(sparse_rng, dev)
    sparse_db, sparse_params, sparse_value_of, _ = sparse_phase(dev, smi_line)
    sparse_two_party_phase(sparse_db, sparse_params, sparse_value_of, dev, smi_line)
    sparse_serving_phase(sparse_db, sparse_params, sparse_value_of, dev, smi_line)
    del sparse_db, sparse_value_of

    # Private heavy hitters: the card against the plain versions at small
    # sizes, then 65,536 clients over 64-bit values. Its own generator.
    hh_rng = np.random.default_rng(SEED + 50)
    hh_small_phase(hh_rng, dev)
    heavy_hitters_phase(dev, smi_line)

    # 8. Every ported kernel, with its launches from the run of the mode
    # (or path) that launches it.
    rows = [
        ("expand_level", "level", "csrc/expand_planes.cu", "ops/expand_planes_pallas.py:134"),
        ("value_hash", "level", "csrc/expand_planes.cu", "ops/expand_planes_pallas.py:333"),
        ("xor_inner_product", DEFAULT_EXPANSION, "csrc/inner_product.cu",
         "ops/inner_product_pallas.py:285"),
        ("walk_descend", "walk", "csrc/expand_fused.cu", "ops/expand_planes_pallas.py:649"),
        ("expand_tail", "tail", "csrc/expand_fused.cu", "ops/expand_planes_pallas.py:392"),
        ("expand_head", "tail", "csrc/expand_fused.cu", "ops/expand_planes_pallas.py:453"),
        ("xor_counts", "v1", "csrc/inner_product.cu", "ops/inner_product_pallas.py:130"),
        # No TPU kernel: the JAX package leaves plane layout in XLA here.
        ("leaf_blocks", DEFAULT_EXPANSION, "csrc/leaf_blocks.cu",
         "pir/dense_eval_planes.py:1632"),
    ]
    launches["probe"] = probe_launches
    launches.update(tier_counts)
    extra = [
        # (row, kernel whose count it reads, launching run, source, TPU kernel)
        ("xor_inner_product_accumulate", "xor_inner_product", "streaming",
         "csrc/inner_product.cu", "ops/inner_product_pallas.py:502"),
        ("repeat_tiles", "repeat_tiles", "probe", "csrc/repeat_tiles.cu",
         "ops/inner_product_pallas.py:65"),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"distributed_point_functions_tpu_torch/{src}",
         "replaces": f"distributed_point_functions_tpu/{tpu}",
         "launches": launches[mode][counter],
         "max_abs_err": results[name]["err"],
         "ms": results[name]["ms"],
         "device_ms": results[name]["device_ms"],
         "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"],
         "bound_by": results[name]["bound_by"],
         "library_ms": results[name].get("library_ms")}
        for name, counter, mode, src, tpu in
        [(n, n, m, src, tpu) for n, m, src, tpu in rows] + extra
    ] + [
        {"name": "path_level", "route": "cuda",
         "source": "distributed_point_functions_tpu_torch/csrc/path_level.cu",
         "replaces": "distributed_point_functions_tpu/ops/expand_planes_pallas.py:946",
         "launches": dcf_launches["path_level"],
         "max_abs_err": results["path_level"]["err"],
         "ms": results["path_level"]["ms"],
         "device_ms": results["path_level"]["device_ms"],
         "plain_ms": results["path_level"]["plain_ms"],
         "bound_ms": results["path_level"]["bound_ms"],
         "bound_by": results["path_level"]["bound_by"],
         "library_ms": None},
    ]})

    # 8. The contract line.
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
