#!/usr/bin/env python3
"""K2 `expand_level` and `leaf_blocks` at every serving shape, this
checkout's sources against an earlier tree's.

Builds `distributed_point_functions_tpu_torch/csrc/expand_planes.cu` (K2)
and `leaf_blocks.cu` from this checkout and, with `--parent DIR`, from a
`csrc` directory of an earlier tree (whose `leaf_blocks` takes the node
-> block map and a zeroed output). Each build is held against the plain
versions at every shape, its output first filled with 0xAAAAAAAA so that
a word it leaves unwritten shows; then the builds are timed in turns,
forward and backward, so that drift falls on all alike.

Shapes (BASELINE.json's configurations): K2 at the main path's 13 levels
(KG = 4: 4 -> 16,384 input columns), the streaming cut's 5 (KG = 32: 32
-> 512) and the materialized tier's middle levels (KG = 32: 1,024 ->
32,768); `leaf_blocks` at the main path (KG = 4, 8,192 blocks, the walk
plan's order and the level plan's bit-reversed one), a streaming or
chunked chunk (KG = 32, 1,024 blocks, bit-reversed) and the materialized
tier (KG = 32, 32,768 blocks).

Run from the root of a checkout on a machine with the card and `nvcc`:

    python3 tools/torch_level_leaf_probe.py [--check] [--parent DIR]

It prints the `nvidia-smi` name and power limit, then one JSON line per
build (registers and spills), per shape (equal to the plain version) and
per shape and round (device ms of one launch for each build: 10 launches
queued behind a device-side sleep, the median of 3).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SLEEP_CYCLES = 50_000_000


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_level_leaf_probe: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    check_only = "--check" in argv
    parent = Path(argv[argv.index("--parent") + 1]).resolve() if "--parent" in argv else None
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.ops import expand_planes as ep
    from distributed_point_functions_tpu_torch.ops.words import to_tensor
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        exit_block_nodes,
        expansion_plan,
    )
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
        chunk_block_nodes,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="level_leaf_probe-"))
    builds = [("k2_this", cuda_lib.CSRC, "expand_planes.cu"),
              ("leaf_this", cuda_lib.CSRC, "leaf_blocks.cu")]
    if parent is not None:
        builds += [("k2_parent", parent, "expand_planes.cu"),
                   ("leaf_parent", parent, "leaf_blocks.cu")]
    procs = {}
    for label, csrc, src in builds:
        procs[label] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-shared",
             str(csrc / src), "-o", str(work / f"{label}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    k2_libs, leaf_libs = {}, {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed\n{log[-6000:]}")
        print(json.dumps({"build": label, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}), flush=True)
        lib = ctypes.CDLL(str(work / f"{label}.so"))
        fn = "dpf_expand_level" if label.startswith("k2") else "dpf_leaf_blocks"
        getattr(lib, fn).argtypes = cuda_lib._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        (k2_libs if label.startswith("k2") else leaf_libs)[label] = lib

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20260)

    def words(*shape):
        return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def device_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
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

    def k2_case(g, kg):
        args = (words(16, 8, g), words(g), words(16, 8, kg), words(kg), words(kg))
        out = torch.empty((16, 8, 2 * g), dtype=torch.int32, device=dev)
        out_ctrl = torch.empty((2 * g,), dtype=torch.int32, device=dev)
        want = ep.expand_level_plain(*args)

        def run(name):
            err = k2_libs[name].dpf_expand_level(
                *(a.data_ptr() for a in args), out.data_ptr(), out_ctrl.data_ptr(), g,
                kg, stream())
            if err:
                raise SystemExit(f"expand_level {name}: launch error {err}")
        return run, (out, out_ctrl), want

    def leaf_case(kg, levels, block_node):
        nodes = 1 << levels
        values = words(16, 8, kg * nodes)
        block_node = torch.from_numpy(block_node).to(dev)
        node_block = ep.node_blocks(block_node, nodes)
        out = torch.empty((32 * kg, nodes, 4), dtype=torch.int32, device=dev)
        want = ep.leaf_blocks_plain(values, node_block, nodes)

        def run(name):
            old = name == "leaf_parent"
            if old:
                out.zero_()
            err = leaf_libs[name].dpf_leaf_blocks(
                values.data_ptr(), (node_block if old else block_node).data_ptr(),
                out.data_ptr(), kg * nodes, kg, nodes, stream())
            if err:
                raise SystemExit(f"leaf_blocks {name}: launch error {err}")
        return run, (out,), (want,)

    cases = []
    for i in range(13):
        cases.append(("expand_level", f"main KG=4 G={4 << i}", k2_case(4 << i, 4)))
    for i in list(range(5)) + list(range(5, 11, 2)):
        cases.append(("expand_level", f"tier KG=32 G={32 << i}", k2_case(32 << i, 32)))
    leaf_shapes = (
        ("main walk", 4, 13, exit_block_nodes(13, *expansion_plan("walk", 4, 13), True,
                                              1 << 13)),
        ("main level", 4, 13, exit_block_nodes(13, *expansion_plan("level", 4, 13), False,
                                               1 << 13)),
        ("chunk", 32, 10, chunk_block_nodes(10, expansion_plan("walk", 32, 10), True)),
        ("materialized", 32, 15, exit_block_nodes(15, *expansion_plan("walk", 32, 15), True,
                                                  1 << 15)),
    )
    for label, kg, levels, block_node in leaf_shapes:
        cases.append(("leaf_blocks", label, leaf_case(kg, levels, block_node)))

    for kernel, label, (run, got, want) in cases:
        libs = k2_libs if kernel == "expand_level" else leaf_libs
        for name in libs:
            for t in got:
                t.fill_(-0x55555556)  # 0xAAAAAAAA
            run(name)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{kernel} {label} {name}: differs from the plain version")
        print(json.dumps({"kernel": kernel, "shape": label, "equal_to_plain": list(libs)}),
              flush=True)
    if check_only:
        return 0

    for rnd in range(2):
        for kernel, label, (run, _, _) in cases:
            names = list(k2_libs if kernel == "expand_level" else leaf_libs)
            row = {"round": rnd, "kernel": kernel, "shape": label}
            for name in (names if rnd == 0 else names[::-1]):
                row[f"{name}_ms"] = device_ms(lambda: run(name))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
