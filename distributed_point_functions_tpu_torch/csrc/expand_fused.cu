// Hand-written CUDA for the fused expansion kernels (sm_90a).
//
// K4 `walk_descend` replaces the TPU kernel `_walk_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:649): r
// levels at the constant width W = G0 << r with the select-key AES, an
// optional leaf value hash, leaves in natural order. K5 `expand_tail`
// replaces `_tail_kernel` (same file, :392): the last r doubling levels and
// the value hash, children in the tiled order of `tail_node_permutation`.
// K6 `expand_head` replaces `_head_kernel` (:453): the first r doubling
// levels over the whole narrow width, one tile. Plain PyTorch versions:
// `ops/expand_planes.py:walk_descend_plain`, `expand_tail_plain`,
// `expand_head_plain`. Layout and per-column bodies: expand_body.cuh.
//
// What bounds them on this card: integer logic, as for K2 and K3 (one
// child of a word column is a whole bitsliced AES against 1.5 KB of state
// traffic).
//
// K4: one thread per output column L. It reads its ancestor's entry
// column by index (node = L / (node_lanes << r), key word L % node_lanes,
// offset (L / node_lanes) % 2^r), so the replicated entry is never
// materialised, and runs the r levels in registers. Bit r-1-i of the
// offset selects the left or right key at level i: the select word goes
// into a branch-free AddRoundKey (neighbouring columns of one warp take
// different offsets, so a branch would run both AES bodies). The MMO
// feed-forward needs sigma of the thread's own previous state, which no
// input column holds after the first level: it is stashed in shared
// memory, [plane][thread], 512 B a thread, without bank conflicts.
//
// K5/K6: a level of G columns is 2G child columns, one AES each (K2's
// body), and the widths (up to 2,048 columns for the head, 32,768 for the
// tail at 128 keys) hold far more than one block's shared memory. So one
// cooperative launch runs every level: a grid-stride loop over the
// level's children, a grid-wide barrier between levels, and the states in
// two ping-pong scratch buffers in device memory (L2-resident at these
// widths). Each child is written at its tiled-order position. The value
// hash (K5) runs after the last barrier over the leaf columns.
//
// Built by ops/cuda_lib.py like expand_planes.cu; without __CUDACC__ the
// same bodies build into host entry points that the CPU tests run.

#include "expand_body.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

namespace {

// Output position of child `child` of column m at level i of a doubling
// expansion whose entry width g0 is cut into tiles of `tile` columns: each
// tile doubles on its own ([all-left; all-right] inside the tile) and the
// tiles stay in entry order. The last tile may be narrower.
__device__ __forceinline__ int64_t tiled_child(int64_t m, int child, int64_t g0,
                                               int64_t tile, int i) {
  const int64_t tw = tile << i;
  const int64_t t = m / tw;
  const int64_t rest = (g0 - t * tile) << i;
  const int64_t width = rest < tw ? rest : tw;
  return 2 * t * tw + child * width + (m - t * tw);
}

// Output column L of an r-level walk descent at width W = g0 << r. `stash`
// points at this thread's first word of a [128][stride] scratch.
__device__ __forceinline__ void walk_column(
    const uint32_t* __restrict__ state, const uint32_t* __restrict__ ctrl,
    const uint32_t* __restrict__ cwp, const uint32_t* __restrict__ cwl,
    const uint32_t* __restrict__ cwr, const uint32_t* __restrict__ vc,
    uint32_t* __restrict__ out, uint32_t* __restrict__ out_ctrl,
    uint32_t* stash, int64_t stride, int64_t g0, int64_t kg, int64_t nl,
    int r, int value_hash, int64_t L) {
  const int64_t w = g0 << r;
  const int64_t e = (L / (nl << r)) * nl + L % nl;
  const uint32_t off = static_cast<uint32_t>((L / nl) & ((int64_t{1} << r) - 1));
  const int64_t k = L % kg;
  uint32_t s[128];
  DPF_UNROLL
  for (int p = 0; p < 128; ++p) s[p] = state[p * g0 + e];
  uint32_t c = ctrl[e];
  DPF_NO_UNROLL
  for (int i = 0; i < r; ++i) {
    const uint32_t sel = 0u - ((off >> (r - 1 - i)) & 1u);
    sigma_regs(s);
    DPF_UNROLL
    for (int p = 0; p < 128; ++p) stash[p * stride] = s[p];
    aes_encrypt_select(s, sel);
    const uint32_t* cw = cwp + static_cast<int64_t>(i) * 128 * kg;
    DPF_UNROLL
    for (int p = 0; p < 128; ++p) s[p] ^= stash[p * stride] ^ (cw[p * kg + k] & c);
    const uint32_t t = s[0];
    s[0] = 0u;
    const uint32_t dir = (cwl[i * kg + k] & ~sel) | (cwr[i * kg + k] & sel);
    c = t ^ (c & dir);
  }
  if (value_hash) {
    sigma_regs(s);
    DPF_UNROLL
    for (int p = 0; p < 128; ++p) stash[p * stride] = s[p];
    aes_encrypt_fixed(s, kKeyValue);
    DPF_UNROLL
    for (int p = 0; p < 128; ++p) {
      out[p * w + L] = s[p] ^ stash[p * stride] ^ (vc[p * kg + k] & c);
    }
  } else {
    DPF_UNROLL
    for (int p = 0; p < 128; ++p) out[p * w + L] = s[p];
  }
  out_ctrl[L] = c;
}

// The r doubling levels (and, with value_hash, the leaf value hash) of
// K5/K6. This thread takes the columns first, first + step, ...; `sync`
// waits until every thread has finished the level.
template <typename Sync>
__device__ __forceinline__ void doubling_levels(
    const uint32_t* state, const uint32_t* ctrl, const uint32_t* cwp,
    const uint32_t* cwl, const uint32_t* cwr, const uint32_t* vc,
    uint32_t* buf0, uint32_t* cbuf0, uint32_t* buf1, uint32_t* cbuf1,
    uint32_t* out, uint32_t* out_ctrl, int64_t g0, int64_t kg, int64_t tile,
    int r, int value_hash, int64_t first, int64_t step, Sync sync) {
  const uint32_t* in = state;
  const uint32_t* cin = ctrl;
  for (int i = 0; i < r; ++i) {
    const int64_t g = g0 << i;
    const bool last = i == r - 1;
    uint32_t* o = (last && !value_hash) ? out : (i % 2 ? buf1 : buf0);
    uint32_t* oc = last ? out_ctrl : (i % 2 ? cbuf1 : cbuf0);
    const int64_t lvl = static_cast<int64_t>(i);
    for (int64_t j = first; j < 2 * g; j += step) {
      const int child = j >= g ? 1 : 0;
      const int64_t m = j - child * g;
      expand_column(in, cin, cwp + lvl * 128 * kg, cwl + lvl * kg,
                    cwr + lvl * kg, o, oc, g, kg, m, child,
                    tiled_child(m, child, g0, tile, i));
    }
    sync();
    in = o;
    cin = oc;
  }
  if (value_hash) {
    const int64_t w = g0 << r;
    for (int64_t m = first; m < w; m += step) value_column(in, cin, vc, out, w, kg, m);
  }
}

#ifdef __CUDACC__
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
walk_descend_kernel(const uint32_t* __restrict__ state,
                    const uint32_t* __restrict__ ctrl,
                    const uint32_t* __restrict__ cwp,
                    const uint32_t* __restrict__ cwl,
                    const uint32_t* __restrict__ cwr,
                    const uint32_t* __restrict__ vc, uint32_t* __restrict__ out,
                    uint32_t* __restrict__ out_ctrl, int64_t g0, int64_t kg,
                    int64_t nl, int r, int value_hash) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t L = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (L >= (g0 << r)) return;
  walk_column(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl,
              stash + threadIdx.x, kThreads, g0, kg, nl, r, value_hash, L);
}

// No __restrict__ here: the scratch buffers are written and read again
// by other blocks within the launch.
__global__ void __launch_bounds__(kThreads)
expand_levels_kernel(const uint32_t* state, const uint32_t* ctrl,
                     const uint32_t* cwp, const uint32_t* cwl,
                     const uint32_t* cwr, const uint32_t* vc, uint32_t* buf0,
                     uint32_t* cbuf0, uint32_t* buf1, uint32_t* cbuf1,
                     uint32_t* out, uint32_t* out_ctrl, int64_t g0, int64_t kg,
                     int64_t tile, int r, int value_hash) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  doubling_levels(state, ctrl, cwp, cwl, cwr, vc, buf0, cbuf0, buf1, cbuf1,
                  out, out_ctrl, g0, kg, tile, r, value_hash, first, step,
                  [&grid]() { grid.sync(); });
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int dpf_walk_descend(const uint32_t* state, const uint32_t* ctrl,
                                const uint32_t* cwp, const uint32_t* cwl,
                                const uint32_t* cwr, const uint32_t* vc,
                                uint32_t* out, uint32_t* out_ctrl, long long g0,
                                long long kg, long long nl, int r,
                                int value_hash, void* stream) {
  const long long blocks = ((g0 << r) + kThreads - 1) / kThreads;
  walk_descend_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, nl, r,
      value_hash);
  return static_cast<int>(cudaGetLastError());
}

// One cooperative launch of as many blocks as the leaf width needs, at
// most as many as the card holds at once (a grid barrier needs every
// block resident).
extern "C" int dpf_expand_levels(const uint32_t* state, const uint32_t* ctrl,
                                 const uint32_t* cwp, const uint32_t* cwl,
                                 const uint32_t* cwr, const uint32_t* vc,
                                 uint32_t* buf0, uint32_t* cbuf0,
                                 uint32_t* buf1, uint32_t* cbuf1,
                                 uint32_t* out, uint32_t* out_ctrl,
                                 long long g0, long long kg, long long tile,
                                 int r, int value_hash, void* stream) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, expand_levels_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = ((g0 << r) + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t g0_ = g0, kg_ = kg, tile_ = tile;
  int r_ = r, value_hash_ = value_hash;
  void* args[] = {&state, &ctrl, &cwp, &cwl, &cwr, &vc, &buf0, &cbuf0,
                  &buf1, &cbuf1, &out, &out_ctrl, &g0_, &kg_, &tile_,
                  &r_, &value_hash_};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(expand_levels_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int dpf_walk_descend_host(const uint32_t* state, const uint32_t* ctrl,
                                     const uint32_t* cwp, const uint32_t* cwl,
                                     const uint32_t* cwr, const uint32_t* vc,
                                     uint32_t* out, uint32_t* out_ctrl,
                                     long long g0, long long kg, long long nl,
                                     int r, int value_hash) {
  uint32_t stash[128];
  for (long long L = 0; L < (g0 << r); ++L) {
    walk_column(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, stash, 1, g0,
                kg, nl, r, value_hash, L);
  }
  return 0;
}

extern "C" int dpf_expand_levels_host(const uint32_t* state, const uint32_t* ctrl,
                                      const uint32_t* cwp, const uint32_t* cwl,
                                      const uint32_t* cwr, const uint32_t* vc,
                                      uint32_t* buf0, uint32_t* cbuf0,
                                      uint32_t* buf1, uint32_t* cbuf1,
                                      uint32_t* out, uint32_t* out_ctrl,
                                      long long g0, long long kg, long long tile,
                                      int r, int value_hash) {
  doubling_levels(state, ctrl, cwp, cwl, cwr, vc, buf0, cbuf0, buf1, cbuf1,
                  out, out_ctrl, g0, kg, tile, r, value_hash, 0, 1, []() {});
  return 0;
}
#endif
