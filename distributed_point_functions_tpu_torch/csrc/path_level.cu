// Hand-written CUDA for one path-walk level of the DPF (sm_90a).
//
// K8 `path_level` replaces the TPU kernel `_path_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:946): the
// level that point evaluation (`evaluate_at`), resumed hierarchical
// evaluation and the multi-key engine behind the DCF run once per tree
// level. Each 32-lane word column m of the [16, 8, G] planes hashes ONCE,
// with the left or the right PRG key as each lane's packed path bit
// `sel[m]` says; then the seed correction under the control word, plane 0
// (the seed LSB) out as the new control word and cleared, and the
// direction correction of the branch each lane took:
//   h = AES_sel(sigma(x)) ^ sigma(x) ^ (cwp & ctrl),
//   ctrl' = h[0] ^ (ctrl & ((sel & cwr) | (~sel & cwl))).
// Corrections are [16, 8, KW] planes and [KW] words read at column m % KW:
// KW = G is the per-seed mode (each lane carries its own key), KW = 1 with
// all-ones/all-zeros words is one key's shared corrections. Plain PyTorch
// version: `ops/expand_planes.py:path_level_plain`. Layout and the shared
// bodies: expand_body.cuh.
//
// What bounds it on this card: integer logic, as for K2 (one word column
// is a whole bitsliced AES, ~22k LOP3, against 1.5 KB of state traffic).
// At the widths its callers give it (G = 32 columns for 1,024 DCF keys)
// it is latency-bound: one thread's serial AES, ~34 us, with most of the
// card idle. Design: one thread per word column, the 128-word state in
// registers; the key choice goes into the generated branch-free
// `add_round_key_select` (the lanes of one column take different
// branches, and neighbouring columns of a warp different selects, so a
// branch would run both AES bodies); the MMO feed-forward re-reads the
// input column instead of holding sigma live, as K2 does. One launch per
// tree level, as the JAX package scans levels with one `pallas_call` each.
//
// Built by ops/cuda_lib.py into the same library as the other kernels;
// without __CUDACC__ the same body builds into a host entry point that the
// CPU tests hold against the plain version.

#include "expand_body.cuh"

namespace {

__device__ __forceinline__ void path_column(
    const uint32_t* state, const uint32_t* ctrl, const uint32_t* sel,
    const uint32_t* cwp, const uint32_t* cwl, const uint32_t* cwr,
    uint32_t* out_state, uint32_t* out_ctrl, int64_t g, int64_t kw,
    int64_t m) {
  const int64_t k = m % kw;
  const uint32_t c = ctrl[m];
  const uint32_t sl = sel[m];
  uint32_t s[128];
  DPF_UNROLL
  for (int p = 0; p < 128; ++p) s[p] = sigma_plane(state, g, m, p);
  aes_encrypt_select(s, sl);
  uint32_t t = 0;
  DPF_UNROLL
  for (int p = 0; p < 128; ++p) {
    const uint32_t v = s[p] ^ sigma_plane(state, g, m, p) ^ (cwp[p * kw + k] & c);
    if (p == 0) {
      t = v;
      out_state[m] = 0u;
    } else {
      out_state[p * g + m] = v;
    }
  }
  const uint32_t dir = (sl & cwr[k]) | (~sl & cwl[k]);
  out_ctrl[m] = t ^ (c & dir);
}

#ifdef __CUDACC__
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
path_level_kernel(const uint32_t* __restrict__ state,
                  const uint32_t* __restrict__ ctrl,
                  const uint32_t* __restrict__ sel,
                  const uint32_t* __restrict__ cwp,
                  const uint32_t* __restrict__ cwl,
                  const uint32_t* __restrict__ cwr,
                  uint32_t* __restrict__ out_state,
                  uint32_t* __restrict__ out_ctrl, int64_t g, int64_t kw) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= g) return;
  path_column(state, ctrl, sel, cwp, cwl, cwr, out_state, out_ctrl, g, kw, m);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int dpf_path_level(const uint32_t* state, const uint32_t* ctrl,
                              const uint32_t* sel, const uint32_t* cwp,
                              const uint32_t* cwl, const uint32_t* cwr,
                              uint32_t* out_state, uint32_t* out_ctrl,
                              long long g, long long kw, void* stream) {
  const long long blocks = (g + kThreads - 1) / kThreads;
  path_level_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      state, ctrl, sel, cwp, cwl, cwr, out_state, out_ctrl, g, kw);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int dpf_path_level_host(const uint32_t* state, const uint32_t* ctrl,
                                   const uint32_t* sel, const uint32_t* cwp,
                                   const uint32_t* cwl, const uint32_t* cwr,
                                   uint32_t* out_state, uint32_t* out_ctrl,
                                   long long g, long long kw) {
  for (long long m = 0; m < g; ++m) {
    path_column(state, ctrl, sel, cwp, cwl, cwr, out_state, out_ctrl, g, kw, m);
  }
  return 0;
}
#endif
