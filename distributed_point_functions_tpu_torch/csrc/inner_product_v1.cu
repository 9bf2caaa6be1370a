// Hand-written CUDA for the v1 dense-PIR inner product's counts (sm_90a).
//
// K7 `xor_counts` replaces the TPU kernel `_ip_kernel`
// (distributed_point_functions_tpu/ops/inner_product_pallas.py:130):
//
//   counts[q, j, w] = #{ records r = 32g + b : bit b of sel[q, g] is 1
//                                              and bit j of db[b, g, w] is 1 }
//
// sel is uint32 [nq, G] packed (bit b of word g selects record 32g+b); db is
// the bit-major staging uint32 [32, G, W] (db[b, g] = record 32g+b); counts
// is int32 [nq, 32, W], exact. The TPU kernel computes the same counts as
// bf16 dots with f32 accumulation, one per (record class b, value bit j),
// exact to 2^24 records; the wrapper keeps that cap and takes each count's
// parity outside the kernel, as the JAX package does, so that bit j of the
// XOR product's word w is counts[q, j, w] & 1. Plain PyTorch version:
// `ops/inner_product.py:xor_counts_plain`.
//
// What bounds it on this card: as a product of 0/1 matrices, [nq, R] x
// [R, 32W], the int8 tensor cores (2 * nq * R * 32W operations) ahead of
// the database read. This first design is integer logic instead, simple
// and exact. A block owns 8 word columns (one warp each), 32 queries and a
// span of record groups; it stages the span's database words and selection
// words in shared memory, 16 groups at a time. For one group and one word
// column, a warp loads the 32 records' words (lane b holds record 32g+b)
// and transposes that 32 x 32 bit matrix across its lanes with five
// shuffle stages, so that lane j holds bit j of the 32 records' words;
// then each query's count is `popc(sel word & transposed word)`, and each
// lane keeps 32 query counts for its value bit j in registers. Blocks add
// their partial counts into the output with atomicAdd (zeroed first, on
// the same stream): integer addition, exact in any order. The POPC unit
// (16 a clock per SM) sets its pace, several times the tensor-core bound;
// a tensor-core design (mma/wgmma on unpacked bits) is a later step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWt = 8;    // word columns per block, one warp each
constexpr int kQt = 32;   // queries per block tile (counts per thread)
constexpr int kGs = 16;   // record groups staged per step
constexpr int kThreads = 32 * kWt;
// Words between the bit rows of the staged database tile: one more than
// the row, so that the 32 lanes reading one word of each row hit 32 banks.
constexpr int kRowPitch = kGs * kWt + 1;
constexpr int kSelPitch = kGs + 1;

// Lane i holds row i of a 32 x 32 bit matrix (bit j = element (i, j));
// returns column `lane`: bit i = element (i, lane). Each stage swaps the
// off-diagonal s x s blocks between lanes s apart.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kMasks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                  0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const uint32_t m = kMasks[k];
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, s);
    x = (lane & s) ? ((x & ~m) | ((y & ~m) >> s)) : ((x & m) | ((y & m) << s));
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
xor_counts_kernel(const uint32_t* __restrict__ sel, const uint32_t* __restrict__ db,
                  int32_t* __restrict__ counts, int nq, int g_total, int w_total,
                  int groups_per_block) {
  __shared__ uint32_t db_s[32 * kRowPitch];
  __shared__ uint32_t sel_s[kQt * kSelPitch];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int w0 = blockIdx.x * kWt;
  const int q0 = blockIdx.y * kQt;
  const int g_begin = blockIdx.z * groups_per_block;
  const int g_end = min(g_total, g_begin + groups_per_block);

  int32_t cnt[kQt];
#pragma unroll
  for (int k = 0; k < kQt; ++k) cnt[k] = 0;

  for (int g0 = g_begin; g0 < g_end; g0 += kGs) {
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * kGs * kWt; i += kThreads) {
      const int l = i % kWt;
      const int gg = (i / kWt) % kGs;
      const int b = i / (kWt * kGs);
      const int g = g0 + gg;
      const int w = w0 + l;
      db_s[b * kRowPitch + gg * kWt + l] =
          (g < g_end && w < w_total)
              ? db[(static_cast<int64_t>(b) * g_total + g) * w_total + w]
              : 0u;
    }
    for (int i = threadIdx.x; i < kQt * kGs; i += kThreads) {
      const int gg = i % kGs;
      const int q = i / kGs;
      const int g = g0 + gg;
      sel_s[q * kSelPitch + gg] =
          (g < g_end && q0 + q < nq)
              ? sel[static_cast<int64_t>(q0 + q) * g_total + g]
              : 0u;
    }
    __syncthreads();
#pragma unroll 1
    for (int gg = 0; gg < kGs; ++gg) {
      const uint32_t t = transpose32(db_s[lane * kRowPitch + gg * kWt + warp], lane);
#pragma unroll
      for (int k = 0; k < kQt; ++k) {
        cnt[k] += __popc(sel_s[k * kSelPitch + gg] & t);
      }
    }
  }

  const int w = w0 + warp;
  if (w >= w_total) return;
#pragma unroll
  for (int k = 0; k < kQt; ++k) {
    const int q = q0 + k;
    if (q < nq && cnt[k] != 0) {
      atomicAdd(counts + (static_cast<int64_t>(q) * 32 + lane) * w_total + w, cnt[k]);
    }
  }
}

}  // namespace

// counts must hold nq * 32 * w_total int32; it is zeroed here on `stream`
// first. sel holds nq rows of g_total words; db is [32, g_total, w_total].
extern "C" int dpf_xor_counts(const uint32_t* sel, const uint32_t* db,
                              int32_t* counts, long long nq, long long g_total,
                              long long w_total, int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(nq * 32 * w_total) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long w_tiles = (w_total + kWt - 1) / kWt;
  const long long q_tiles = (nq + kQt - 1) / kQt;
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
  xor_counts_kernel<<<grid, kThreads, 0, st>>>(
      sel, db, counts, static_cast<int>(nq), static_cast<int>(g_total),
      static_cast<int>(w_total), static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}
