// Hand-written CUDA for Mosaic's tiling repeat (sm_90a).
//
// K9 `repeat_tiles` replaces the TPU kernel of the probe
// `_interpret_repeat_tiles`
// (distributed_point_functions_tpu/ops/inner_product_pallas.py:65, its
// `pallas_call` at :82), whose body is `pltpu.repeat(x, factor, axis=1)`:
//
//   out[r, k] = x[r, k mod n],   x uint32 [rows, n], out [rows, n * factor]
//
// the whole source tiled along its last axis ([a b] -> [a b a b]), not each
// element repeated. The JAX package probes it to learn which of the two its
// interpreter does; no serving path of either package reaches it. Plain
// PyTorch version: `x.repeat(1, factor)`.
//
// What bounds it on this card: bytes (each output word written once, each
// input word read once; no arithmetic). One thread writes one output word,
// neighbouring threads neighbouring words, so the stores coalesce and the
// source row is read from L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
repeat_tiles_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                    long long rows, long long n, long long width) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * width) return;
  const long long r = i / width;
  const long long k = i % width;
  out[i] = x[r * n + k % n];
}

}  // namespace

// out must hold rows * n * factor words.
extern "C" int dpf_repeat_tiles(const uint32_t* x, uint32_t* out, long long rows,
                                long long n, long long factor, void* stream) {
  const long long width = n * factor;
  const long long total = rows * width;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  repeat_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, out, rows, n, width);
  return static_cast<int>(cudaGetLastError());
}
