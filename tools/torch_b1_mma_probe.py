#!/usr/bin/env python3
"""The single-bit tensor-core rate on a card, beside the int8 one.

NVIDIA publishes no Hopper rate for the single-bit products (an AND and a
count per bit pair), the form that lets the count product
(`csrc/inner_product.cu`) skip its byte expansion. This builds one
throughput kernel per instruction form, each in a file of its own so that
a form the compiler refuses does not stop the others, and times them on
every SM:

* `mma_s8`: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`;
* `mma_b1`: `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`;
* `wgmma_s8`: `wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8`, both
  operands in shared memory, 128-byte swizzle (the int8 peak's form: the
  control that the probe reaches the published rate);
* `wgmma_b1`: `wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc`,
  the same layout;
* `wgmma_b1_noswizzle`: the same with unswizzled core matrices;
* `wgmma_b1_a_regs`: the same with A in registers.

An instruction of shape m x n x k counts 2 m n k operations (for b1, an
AND and a count per bit pair, as the count product needs). `mma.sync`
warps issue 8 independent accumulator chains, 8 warps a block, 8 blocks
an SM; `wgmma` warpgroups issue 4 products a stage into one 64 x 256
accumulator, keep one stage in flight, 2 blocks of one warpgroup an SM.
The operands hold arbitrary bits: only the rate is read. Run from the
root of a checkout on a machine with the card and `nvcc`:

    python3 tools/torch_b1_mma_probe.py

It prints the `nvidia-smi` name and power limit, then one JSON line per
form: its build (ptxas registers, and any note that `wgmma` was
serialized), device ms of one launch (median of 5 after a warm-up),
operations a second, and the rate against the card's published int8
peak (1.979e15 operations a second).
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
INT8_OPS_PER_S = 1.979e15
CHAINS, WARPS, BLOCKS_PER_SM, ITERS = 8, 8, 8, 4096
WG_BLOCKS_PER_SM, WG_STAGE, WG_ITERS = 2, 4, 4096

MMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) mma_rate(int iters, int32_t* out) {
  const uint32_t x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a0 = x, a1 = x ^ 0x5A5A5A5Au, a2 = x * 3u, a3 = ~x;
  const uint32_t b0 = x >> 3, b1 = x * 7u;
  int32_t d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      asm volatile(
          "mma.sync.aligned.INSTRUCTION "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int blocks, int iters, int32_t* out, void* stream) {
  mma_rate<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# A is 64 rows, B 256 rows, of 128 bytes (a stage's K: 4 products of 32
# bytes). Swizzled: 8-row atoms of 1,024 bytes, stride 1,024 between them
# (SBO); a product's K step advances the start 32 bytes within the row.
# Unswizzled: core matrices of 8 rows x 16 bytes, [8-row group][K core 8]:
# 128 bytes between neighbours along K (LBO), 1,024 along M/N (SBO); a K
# step of 32 bytes is two core matrices, 256 bytes.
WGMMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kABytes = 64 * 128, kBBytes = 256 * 128;

__device__ __forceinline__ uint64_t descriptor(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(LBO >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(LAYOUT) << 62);
}

__global__ void __launch_bounds__(128) wgmma_rate(int iters, int32_t* out) {
  __shared__ __align__(1024) uint32_t smem[(kABytes + kBBytes) / 4];
  for (int i = threadIdx.x; i < (kABytes + kBBytes) / 4; i += 128) {
    smem[i] = i * 0x9E3779B9u + blockIdx.x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = descriptor(smem);
  const uint64_t db = descriptor(smem + kABytes / 4);
  const uint32_t x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a0 = x, a1 = x ^ 0x5A5A5A5Au, a2 = x * 3u, a3 = ~x;
  const int one = 1;
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const uint64_t ak = da + K_STEP * k, bk = db + K_STEP * k;
      (void)ak; (void)a0; (void)a1; (void)a2; (void)a3;
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %SCALE, 0;\n"
          "wgmma.mma_async.sync.aligned.INSTRUCTION {ACC}, A_OPERAND, %BDESC, p;\n}\n"
          : OUTPUTS
          : INPUTS, "l"(bk), "r"(one));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int32_t s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int blocks, int iters, int32_t* out, void* stream) {
  wgmma_rate<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def wgmma_source(instruction: str, swizzle: bool, a_regs: bool) -> str:
    acc = ", ".join(f"%{i}" for i in range(128))
    if a_regs:
        a_operand, inputs, n_in = "{%128, %129, %130, %131}", '"r"(a0), "r"(a1), "r"(a2), "r"(a3)', 4
    else:
        a_operand, inputs, n_in = "%128", '"l"(ak)', 1
    return (WGMMA_SOURCE
            .replace("INSTRUCTION", instruction)
            .replace("{ACC}", "{" + acc + "}")
            .replace("A_OPERAND", a_operand)
            .replace("%BDESC", f"%{128 + n_in}")
            .replace("%SCALE", f"%{129 + n_in}")
            .replace("OUTPUTS", ", ".join(f'"+r"(d[{i}])' for i in range(128)))
            .replace("INPUTS", inputs)
            .replace("STAGE", str(WG_STAGE))
            .replace("K_STEP", "2" if swizzle else "16")
            .replace("LBO", "16" if swizzle else "128")
            .replace("LAYOUT", "1" if swizzle else "0"))


# name: (source, the instruction's m, n, k)
FORMS = {
    "mma_s8": (MMA_SOURCE.replace("INSTRUCTION", "m16n8k32.row.col.s32.s8.s8.s32"),
               16, 8, 32),
    "mma_b1": (MMA_SOURCE.replace("INSTRUCTION", "m16n8k256.row.col.s32.b1.b1.s32.and.popc"),
               16, 8, 256),
    "wgmma_s8": (wgmma_source("m64n256k32.s32.s8.s8", True, False), 64, 256, 32),
    "wgmma_b1": (wgmma_source("m64n256k256.s32.b1.b1.and.popc", True, False), 64, 256, 256),
    "wgmma_b1_noswizzle": (wgmma_source("m64n256k256.s32.b1.b1.and.popc", False, False),
                           64, 256, 256),
    "wgmma_b1_a_regs": (wgmma_source("m64n256k256.s32.b1.b1.and.popc", True, True),
                        64, 256, 256),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_b1_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops import cuda_lib

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="b1_mma_probe-"))
    procs = {}
    for name, (source, *_) in FORMS.items():
        (work / f"{name}.cu").write_text(
            source.replace("CHAINS", str(CHAINS)).replace("WARPS", str(WARPS)))
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(work / f"{name}.cu"),
             "-o", str(work / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    failed = 0
    for name, (_, m, n, k) in FORMS.items():
        log = procs[name].communicate()[0]
        row = {"form": name, "shape": f"m{m}n{n}k{k}", "build_rc": procs[name].returncode,
               "ptxas": [ln.strip() for ln in log.splitlines()
                         if "Used" in ln or "wgmma" in ln.lower()]}
        if procs[name].returncode:
            row["log"] = log[-3000:]
            print(json.dumps(row), flush=True)
            failed += 1
            continue
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.launch.restype = ctypes.c_int
        if name.startswith("mma"):
            blocks, threads, iters = sms * BLOCKS_PER_SM, 32 * WARPS, ITERS
            instructions = CHAINS * ITERS * WARPS * blocks
        else:
            blocks, threads, iters = sms * WG_BLOCKS_PER_SM, 128, WG_ITERS
            instructions = WG_STAGE * WG_ITERS * blocks
        out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)

        def run():
            err = lib.launch(blocks, iters, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, error {err}")
        try:
            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        except RuntimeError as exc:
            row["error"] = str(exc)
            print(json.dumps(row), flush=True)
            failed += 1
            continue
        ms = statistics.median(times)
        ops = 2 * m * n * k * instructions
        row.update({"device_ms": ms, "ops_per_s": ops / (ms / 1e3),
                    "share_of_int8_peak": ops / (ms / 1e3) / INT8_OPS_PER_S})
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
