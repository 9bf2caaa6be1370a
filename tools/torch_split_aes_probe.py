#!/usr/bin/env python3
"""K4-K6 and K8 on the split AES, shape by shape, against variants of
their sources.

Builds `distributed_point_functions_tpu_torch/csrc/expand_fused.cu` and
`path_level.cu` from this checkout (`this`) and from every `--src
LABEL=DIR` given (a `csrc` directory holding a variant of these sources
with the same C entries), holds each build's K4, K5, K6 and K8 against
the plain versions at every shape the serving paths give them, and times
the builds there in two rounds (forward, then backward) so that drift
falls on all alike. Then each build's level latency at one group: a one-column K8 walk
of 256 levels, device time over the levels. It also prints the SASS
opcode counts of this checkout's K4 and K8 kernels.

Shapes (BASELINE.json's configurations, 32 word columns of keys at 1,024
queries): K4 at the main path's head and tail (KG = 4: 4 -> 2,048 columns
over 9 levels, 2,048 -> 32,768 over 4 with the value hash), the
materialized tier's (KG = 32: 32 -> 2,048, 65,536 -> 2^20), a chunk's (32
-> 2,048, 2,048 -> 32,768) and the DPF full domain's (KG = 1: 1 -> 1,024
over 10 levels, 1,024 -> 16,384); K6 and K5 at tail mode's splits of the
same three (K6: 4 -> 2,048 over 9 levels, 32 -> 2,048 over 6, 1 -> 1,024
over 10; K5 in 128-column tiles: 2,048 -> 32,768, 65,536 -> 2^20, 1,024 ->
16,384, each over 4); K8 one level at G = KW = 32, G = KW =
2,048, G = 2,048 and 32 and 2 with KW = 1, the DCF's 31-level walk with 32
stops (G = KW = 32) and a chunk's 5-level walk (G = KW = 32).

Run from the root of a checkout on a machine with the card and `nvcc`:

    python3 tools/torch_split_aes_probe.py            # check and time
    python3 tools/torch_split_aes_probe.py --check    # check only
    python3 tools/torch_split_aes_probe.py --src other=path/to/csrc

It prints the `nvidia-smi` name and power limit, then one JSON line per
build (registers and spills), per shape (equal to the plain version,
device ms of one launch for each build: 10 launches queued behind a
device-side sleep, the median of 3) and per build for the level latency.
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
LATENCY_LEVELS = 256

# (label, G0, KG, node lanes, r, value hash)
WALK_SHAPES = (
    ("main head", 4, 4, 4, 9, False),
    ("main tail", 2048, 4, 4, 4, True),
    ("materialized head", 32, 32, 32, 6, False),
    ("materialized tail", 65536, 32, 32, 4, True),
    ("chunk head", 32, 32, 32, 6, False),
    ("chunk tail", 2048, 32, 32, 4, True),
    ("dpf head", 1, 1, 1, 10, False),
    ("dpf tail", 1024, 1, 1, 4, True),
)
# (label, G0, KG, r, tile lanes; None: K6)
DOUBLING_SHAPES = (
    ("main head", 4, 4, 9, None),
    ("main tail", 2048, 4, 4, 128),
    ("materialized head", 32, 32, 6, None),
    ("materialized tail", 65536, 32, 4, 128),
    ("dpf head", 1, 1, 10, None),
    ("dpf tail", 1024, 1, 4, 128),
)
# (label, G, KW, levels, stops)
PATH_SHAPES = (
    ("per seed G=32", 32, 32, 1, (1,)),
    ("per seed G=2048", 2048, 2048, 1, (1,)),
    ("shared G=2048", 2048, 1, 1, (1,)),
    ("shared G=32", 32, 1, 1, (1,)),
    ("shared G=2", 2, 1, 1, (1,)),
    ("dcf walk", 32, 32, 31, tuple(range(32))),
    ("chunk walk", 32, 32, 5, (5,)),
)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_split_aes_probe: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    check_only = "--check" in argv
    srcs = {"this": None}
    for i, arg in enumerate(argv):
        if arg == "--src":
            label, _, path = argv[i + 1].partition("=")
            srcs[label] = Path(path).resolve()
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.ops import expand_planes as ep
    from distributed_point_functions_tpu_torch.ops.words import to_tensor

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="split_aes_probe-"))
    procs = {}
    for label, csrc in srcs.items():
        csrc = csrc or cuda_lib.CSRC
        procs[label] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-shared",
             str(csrc / "expand_fused.cu"), str(csrc / "path_level.cu"), "-o",
             str(work / f"{label}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # The SASS of this checkout's K4 and K8: instructions by opcode, per
    # kernel, counted statically (each written-out AES once).
    sass_procs = [subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.ARCH, "-O3", "-std=c++17", "-cubin", "-I",
         str(cuda_lib.CSRC), str(cuda_lib.CSRC / f"{src}.cu"), "-o",
         str(work / f"{src}.cubin")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in ("path_level", "expand_fused")]
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-6000:]}")
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}), flush=True)
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for fn in ("dpf_walk_descend", "dpf_expand_head", "dpf_expand_tail",
                   "dpf_path_walk"):
            if hasattr(lib, fn):  # an earlier tree may lack an entry
                getattr(lib, fn).argtypes = cuda_lib._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    for src, proc in zip(("path_level", "expand_fused"), sass_procs):
        if proc.wait() != 0:
            continue
        sass = subprocess.run(
            [str(Path(cuda_lib._nvcc()).with_name("cuobjdump")), "-sass",
             str(work / f"{src}.cubin")], capture_output=True, text=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {}
            elif fn and line.strip().startswith("/*") and "*/" in line:
                op = line.split("*/", 1)[1].split()
                if op and op[0].startswith("@"):
                    op = op[1:]
                if op and not op[0].startswith("/*"):
                    key = op[0].split(".")[0]
                    counts[fn][key] = counts[fn].get(key, 0) + 1
        for fn, ops in counts.items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
            print(json.dumps({"sass": fn, "instructions": sum(ops.values()),
                              "top": top}), flush=True)

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

    def walk_case(g0, kg, nl, r, vh):
        args = (words(16, 8, g0), words(g0), words(r, 16, 8, kg), words(r, kg),
                words(r, kg), words(16, 8, kg))
        w = g0 << r
        out = torch.empty((16, 8, w), dtype=torch.int32, device=dev)
        out_ctrl = torch.empty((w,), dtype=torch.int32, device=dev)
        want = ep.walk_descend_plain(*args, value_hash=vh, node_lanes=nl)

        def run(lib):
            err = lib.dpf_walk_descend(*(a.data_ptr() for a in args), out.data_ptr(),
                                       out_ctrl.data_ptr(), g0, kg, nl, r, int(vh),
                                       stream())
            if err:
                raise SystemExit(f"walk_descend: launch error {err}")
        return run, (out, out_ctrl), want

    def doubling_case(g0, kg, r, tile):
        args = (words(16, 8, g0), words(g0), words(r, 16, 8, kg), words(r, kg),
                words(r, kg), words(16, 8, kg))
        w = g0 << r
        out = torch.empty((16, 8, w), dtype=torch.int32, device=dev)
        out_ctrl = torch.empty((w,), dtype=torch.int32, device=dev)
        if tile is None:
            args = args[:5]
            want = ep.expand_head_plain(*args)
        else:
            want = ep.expand_tail_plain(*args, tile)

        def run(lib):
            ptrs = [a.data_ptr() for a in args] + [out.data_ptr(), out_ctrl.data_ptr()]
            err = (lib.dpf_expand_head(*ptrs, g0, kg, r, stream()) if tile is None
                   else lib.dpf_expand_tail(*ptrs, g0, kg, tile, r, stream()))
            if err:
                raise SystemExit(f"expand_head/tail: launch error {err}")
        return run, (out, out_ctrl), want

    def path_case(g, kw, levels, stops):
        args = (words(16, 8, g), words(g), words(levels, g), words(levels, 16, 8, kw),
                words(levels, kw), words(levels, kw))
        out = torch.empty((16, 8, len(stops) * g), dtype=torch.int32, device=dev)
        out_ctrl = torch.empty((len(stops) * g,), dtype=torch.int32, device=dev)
        want = ep.path_walk_plain(*args, stops)
        c_stops = (ctypes.c_int * len(stops))(*stops)

        def run(lib):
            err = lib.dpf_path_walk(*(a.data_ptr() for a in args), c_stops, len(stops),
                                    out.data_ptr(), out_ctrl.data_ptr(), g, kw, levels,
                                    stream())
            if err:
                raise SystemExit(f"path_walk: launch error {err}")
        return run, (out, out_ctrl), want

    cases = ([("walk_descend", s[0], walk_case(*s[1:])) for s in WALK_SHAPES]
             + [("expand_head" if s[4] is None else "expand_tail", s[0],
                 doubling_case(*s[1:])) for s in DOUBLING_SHAPES]
             + [("path_walk", s[0], path_case(*s[1:])) for s in PATH_SHAPES])
    def has(lib, kernel):
        return hasattr(lib, f"dpf_{kernel}")

    for kernel, label, (run, got, want) in cases:
        for name, lib in ((n, lb) for n, lb in libs.items() if has(lb, kernel)):
            got[0].zero_()
            run(lib)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise SystemExit(f"{kernel} {label} {name}: differs from the plain version")
        print(json.dumps({"kernel": kernel, "shape": label,
                          "equal_to_plain": [n for n, lb in libs.items() if has(lb, kernel)]}),
              flush=True)
    if check_only:
        return 0

    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for kernel, label, (run, _, _) in cases:
            row = {"round": rnd, "kernel": kernel, "shape": label}
            for name in (n for n in order if has(libs[n], kernel)):
                row[f"{name}_ms"] = device_ms(lambda: run(libs[name]))
            print(json.dumps(row), flush=True)
    run, _, _ = path_case(1, 1, LATENCY_LEVELS, (LATENCY_LEVELS,))
    for name, lib in libs.items():
        ms = device_ms(lambda: run(lib))
        print(json.dumps({"build": name, "level_latency_us": ms * 1e3 / LATENCY_LEVELS,
                          "levels": LATENCY_LEVELS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
