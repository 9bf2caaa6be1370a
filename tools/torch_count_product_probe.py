#!/usr/bin/env python3
"""What sets the pace of the port's count-product kernel (K1, K7) on a card.

Builds variants of `distributed_point_functions_tpu_torch/csrc/inner_product.cu`
side by side, each with one part taken out by the source's `DPF_PACE_*`
macros, and times K7 and K1 at the main path's shape (128 queries x 2^20
records x 256 B) and K1's accumulate entry at one streaming chunk (1,024
queries x 2^17 records), in two rounds (forward, then backward) so that
drift falls on every variant alike:

* `kernel`: the kernel as committed (held against the plain version);
* `no_products`: without the `wgmma` products;
* `no_transposes`: the database words stored as loaded, untransposed;
* `no_database_loads`: the database words made up in registers instead
  of loaded;
* `products_only`: neither the database loads nor the transposes.

Run from the root of a checkout on a machine with the card and `nvcc`:

    python3 tools/torch_count_product_probe.py

It prints the `nvidia-smi` name and power limit, then one JSON line per
variant build and per timing, device ms of one launch (20 launches
queued behind a device-side sleep, the median of 5).
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

VARIANTS = {
    "kernel": (),
    "no_products": ("-DDPF_PACE_NO_PRODUCTS",),
    "no_transposes": ("-DDPF_PACE_NO_TRANSPOSES",),
    "no_database_loads": ("-DDPF_PACE_NO_DB_LOADS",),
    "products_only": ("-DDPF_PACE_NO_DB_LOADS", "-DDPF_PACE_NO_TRANSPOSES"),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_count_product_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops import cuda_lib
    from distributed_point_functions_tpu_torch.ops.inner_product import xor_counts_plain
    from distributed_point_functions_tpu_torch.ops.words import to_tensor

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="count_product_probe-"))
    procs = {}
    for name, defines in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defines, "-shared",
             str(cuda_lib.CSRC / "inner_product.cu"), "-o", str(work / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "wgmma" in ln]}),
            flush=True)
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for fn in ("dpf_xor_inner_product", "dpf_xor_counts"):
            getattr(lib, fn).argtypes = cuda_lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(20260)

    def words(*shape):
        return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
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

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    g_main, g_chunk = (1 << 20) // 32, (1 << 17) // 32
    db, sel = words(32, g_main, 64), words(128, g_main)
    span, sel_chunk, acc = words(32, g_chunk, 64), words(1024, g_chunk), words(1024, 64)
    counts = torch.empty((128, 32, 64), dtype=torch.int32, device=dev)
    out = torch.empty((128, 64), dtype=torch.int32, device=dev)
    want = xor_counts_plain(db, sel)

    def runs(lib):
        def k7():
            return lib.dpf_xor_counts(sel.data_ptr(), db.data_ptr(), counts.data_ptr(),
                                      128, g_main, 64, sms, stream())

        def k1():
            return lib.dpf_xor_inner_product(sel.data_ptr(), db.data_ptr(), out.data_ptr(),
                                             128, g_main, 64, g_main * 64, 0, sms, stream())

        def k1_acc():
            return lib.dpf_xor_inner_product(sel_chunk.data_ptr(), span.data_ptr(),
                                             acc.data_ptr(), 1024, g_chunk, 64, g_chunk * 64,
                                             1, sms, stream())
        return {"xor_counts": k7, "xor_inner_product": k1,
                "xor_inner_product_accumulate": k1_acc}

    if runs(libs["kernel"])["xor_counts"]() != 0:
        raise SystemExit("kernel: launch failed")
    torch.cuda.synchronize()
    if not torch.equal(counts, want):
        raise SystemExit("kernel: counts differ from the plain version")
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            row = {"round": rnd, "variant": name}
            for kernel, fn in runs(libs[name]).items():
                row[kernel] = device_ms(fn)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
