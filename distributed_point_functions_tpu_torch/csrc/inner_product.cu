// Hand-written CUDA for the dense-PIR XOR inner product (sm_90a).
//
// K1 `xor_inner_product` replaces the TPU kernel `_ip_kernel_v2`
// (distributed_point_functions_tpu/ops/inner_product_pallas.py:285):
//
//   out[q, w] = XOR over g, b of (bit b of sel[q, g]) ? db[b, g, w] : 0
//
// sel is uint32 [nq, G] packed (bit b of word g selects record 32g+b); db
// is the bit-major staging uint32 [32, G, W] (db[b, g] = record 32g+b,
// `ops/inner_product_kernels.py:permute_db_bitmajor`). The TPU kernel
// takes the parity of exact int8 matmul counts; this is the same function
// as a mask-and-XOR, exact with no count bound. Plain PyTorch version:
// `ops/inner_product.py:xor_inner_product`.
//
// What bounds it on this card: 32-bit logic, not bytes. The database is
// read once per query tile (256 MB at 2^20 x 256 B, ~80 us at 3.35 TB/s),
// but every (query, record, word) costs a masked XOR: nq * R * W word
// operations (8.6e9 at 128 queries x 2^20 x 256 B), which at the INT32 rate is
// several times the read. Design: a block owns a tile of up to 128
// queries and 32 record words, and a span of record groups. It stages the
// span's database words and selection words in shared memory, GS groups
// at a time; each thread keeps 16 query accumulators for one word in
// registers and applies `acc ^= db & mask` with the mask bit shifted out
// of the staged selection word by constants. Blocks combine their partial
// XORs into the output with atomicXor (zeroed first, on the same stream,
// unless the caller accumulates): XOR commutes, so the result is exact in
// any order. The int8 tensor-core redesign (exact counts through
// mma/wgmma) is a later step.
//
// The accumulate entry (the JAX package's
// `xor_inner_product_pallas2_accumulate`, inner_product_pallas.py:502) is
// the same launch without the zeroing: it XORs one record span's product
// into the caller's running result, for the streaming and chunked tiers.
// A span may be a group range of a larger staging: bit row b of db starts
// b_stride words after row 0.
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a): 90 registers, no spills, 36,864
// B shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // record words per block tile (one warp wide)
constexpr int kRows = 8;     // warps per block
constexpr int kQpt = 16;     // queries per thread
constexpr int kTq = kRows * kQpt;  // queries per block tile
constexpr int kGs = 8;       // record groups staged per step
constexpr int kThreads = kLanes * kRows;

__global__ void __launch_bounds__(kThreads)
xor_ip_kernel(const uint32_t* __restrict__ sel, const uint32_t* __restrict__ db,
              uint32_t* __restrict__ out, int nq, int g_total, int w_total,
              int64_t b_stride, int groups_per_block) {
  __shared__ uint32_t db_s[32][kGs][kLanes];
  __shared__ uint32_t sel_s[kTq][kGs];
  const int lane = threadIdx.x % kLanes;
  const int row = threadIdx.x / kLanes;
  const int w0 = blockIdx.x * kLanes;
  const int q0 = blockIdx.y * kTq;
  const int g_begin = blockIdx.z * groups_per_block;
  const int g_end = min(g_total, g_begin + groups_per_block);

  uint32_t acc[kQpt];
#pragma unroll
  for (int k = 0; k < kQpt; ++k) acc[k] = 0u;

  for (int g0 = g_begin; g0 < g_end; g0 += kGs) {
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * kGs * kLanes; i += kThreads) {
      const int l = i % kLanes;
      const int gg = (i / kLanes) % kGs;
      const int b = i / (kLanes * kGs);
      const int g = g0 + gg;
      const int w = w0 + l;
      db_s[b][gg][l] = (g < g_end && w < w_total)
                           ? db[b * b_stride + static_cast<int64_t>(g) * w_total + w]
                           : 0u;
    }
    for (int i = threadIdx.x; i < kTq * kGs; i += kThreads) {
      const int gg = i % kGs;
      const int q = i / kGs;
      const int g = g0 + gg;
      sel_s[q][gg] = (g < g_end && q0 + q < nq)
                         ? sel[static_cast<int64_t>(q0 + q) * g_total + g]
                         : 0u;
    }
    __syncthreads();
#pragma unroll 1
    for (int gg = 0; gg < kGs; ++gg) {
      uint32_t s[kQpt];
#pragma unroll
      for (int k = 0; k < kQpt; ++k) s[k] = sel_s[row + kRows * k][gg];
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t d = db_s[b][gg][lane];
#pragma unroll
        for (int k = 0; k < kQpt; ++k) {
          // All-ones when bit b of the selection word is set.
          const uint32_t mask =
              static_cast<uint32_t>(static_cast<int32_t>(s[k] << (31 - b)) >> 31);
          acc[k] ^= d & mask;
        }
      }
    }
  }

  const int w = w0 + lane;
  if (w >= w_total) return;
#pragma unroll
  for (int k = 0; k < kQpt; ++k) {
    const int q = q0 + row + kRows * k;
    if (q < nq && acc[k] != 0u) {
      atomicXor(out + static_cast<int64_t>(q) * w_total + w, acc[k]);
    }
  }
}

}  // namespace

// out must hold nq * w_total words. Unless `accumulate` is set it is zeroed
// here on `stream` first; with it, the product is XORed into out as it is.
// sel holds at least nq rows of g_total words; db's bit row b starts at
// db + b * b_stride.
extern "C" int dpf_xor_inner_product(const uint32_t* sel, const uint32_t* db,
                                     uint32_t* out, long long nq,
                                     long long g_total, long long w_total,
                                     long long b_stride, int accumulate,
                                     int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!accumulate) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(nq * w_total) * sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long w_tiles = (w_total + kLanes - 1) / kLanes;
  const long long q_tiles = (nq + kTq - 1) / kTq;
  // Enough group spans for about four blocks per SM.
  const long long want = 4LL * num_sms;
  long long spans = want / (w_tiles * q_tiles);
  const long long max_spans = (g_total + kGs - 1) / kGs;
  if (spans < 1) spans = 1;
  if (spans > max_spans) spans = max_spans;
  long long per = (g_total + spans - 1) / spans;
  per = ((per + kGs - 1) / kGs) * kGs;
  spans = (g_total + per - 1) / per;
  dim3 grid(static_cast<unsigned>(w_tiles), static_cast<unsigned>(q_tiles),
            static_cast<unsigned>(spans));
  xor_ip_kernel<<<grid, kThreads, 0, st>>>(sel, db, out, static_cast<int>(nq),
                                           static_cast<int>(g_total),
                                           static_cast<int>(w_total),
                                           static_cast<int64_t>(b_stride),
                                           static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}
