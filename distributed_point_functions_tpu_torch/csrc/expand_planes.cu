// Hand-written CUDA for the plane-resident DPF expansion (sm_90a).
//
// K2 `expand_level` replaces the TPU kernel `_level_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:134):
// one [all-left; all-right] expansion level. K3 `value_hash` replaces
// `_value_kernel` (same file, :333): the leaf MMO hash with the value key
// plus the value correction. Plain PyTorch versions:
// `ops/expand_planes.py:expand_level_plain` / `value_hash_plain`. The
// layout and the per-column bodies are in expand_body.cuh.
//
// What bounds it on this card: integer logic. One child of one word
// column is a whole AES-128 on 128 words (~32k 32-bit XOR/AND/NOT: 160
// tower S-boxes of 168 gates, MixColumns, AddRoundKey), against 1.5 KB
// of state traffic per column -- far above the card's ops:byte balance.
// Design: one thread per (child, word column m), so a level of G columns
// runs 2G threads; the 128-word state lives in registers; neighbouring
// threads touch neighbouring words, so every plane read and write
// coalesces. The fixed round keys are compiled in (a set key bit is a
// NOT, a clear bit nothing) and the S-box is the straight-line tower
// circuit generated from ops/aes_sbox_tower.py (aes_generated.cuh). To
// keep one AES state live rather than three (sigma + left + right), a
// thread computes one child only and re-reads its input column for the
// MMO feed-forward instead of holding sigma in registers. The rounds run
// as a loop (not unrolled) so the body stays small in the instruction
// cache. `nvcc -Xptxas -v` (CUDA 12.8, sm_90a): expand_level_kernel 255
// registers, 200 B stack, 196 B spill stores / 436 B spill loads;
// value_hash_kernel 255 registers, 248 B stack, 248 B / 488 B spills.
//
// Built by ops/cuda_lib.py with nvcc for sm_90a into a library with a
// plain C interface. Without __CUDACC__ (a host C++ compiler) the same
// column bodies build into host entry points that the CPU tests run.

#include "expand_body.cuh"

namespace {

#ifdef __CUDACC__
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
expand_level_kernel(const uint32_t* __restrict__ state,
                    const uint32_t* __restrict__ ctrl,
                    const uint32_t* __restrict__ cwp,
                    const uint32_t* __restrict__ cwl,
                    const uint32_t* __restrict__ cwr,
                    uint32_t* __restrict__ out_state,
                    uint32_t* __restrict__ out_ctrl, int64_t g, int64_t kg) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= 2 * g) return;
  const int child = i >= g ? 1 : 0;
  expand_column(state, ctrl, cwp, cwl, cwr, out_state, out_ctrl, g, kg,
                i - child * g, child, i);
}

__global__ void __launch_bounds__(kThreads)
value_hash_kernel(const uint32_t* __restrict__ state,
                  const uint32_t* __restrict__ ctrl,
                  const uint32_t* __restrict__ vc, uint32_t* __restrict__ out,
                  int64_t g, int64_t kg) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= g) return;
  value_column(state, ctrl, vc, out, g, kg, m);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int dpf_expand_level(const uint32_t* state, const uint32_t* ctrl,
                                const uint32_t* cwp, const uint32_t* cwl,
                                const uint32_t* cwr, uint32_t* out_state,
                                uint32_t* out_ctrl, long long g, long long kg,
                                void* stream) {
  const long long blocks = (2 * g + kThreads - 1) / kThreads;
  expand_level_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      state, ctrl, cwp, cwl, cwr, out_state, out_ctrl, g, kg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_value_hash(const uint32_t* state, const uint32_t* ctrl,
                              const uint32_t* vc, uint32_t* out, long long g,
                              long long kg, void* stream) {
  const long long blocks = (g + kThreads - 1) / kThreads;
  value_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(state, ctrl, vc,
                                                           out, g, kg);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int dpf_expand_level_host(const uint32_t* state, const uint32_t* ctrl,
                                     const uint32_t* cwp, const uint32_t* cwl,
                                     const uint32_t* cwr, uint32_t* out_state,
                                     uint32_t* out_ctrl, long long g,
                                     long long kg) {
  for (long long i = 0; i < 2 * g; ++i) {
    const int child = i >= g ? 1 : 0;
    expand_column(state, ctrl, cwp, cwl, cwr, out_state, out_ctrl, g, kg,
                  i - child * g, child, i);
  }
  return 0;
}

extern "C" int dpf_value_hash_host(const uint32_t* state, const uint32_t* ctrl,
                                   const uint32_t* vc, uint32_t* out,
                                   long long g, long long kg) {
  for (long long m = 0; m < g; ++m) value_column(state, ctrl, vc, out, g, kg, m);
  return 0;
}
#endif
