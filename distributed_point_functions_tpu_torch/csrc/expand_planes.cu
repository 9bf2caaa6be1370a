// Hand-written CUDA for the plane-resident DPF expansion (sm_90a).
//
// K2 `expand_level` replaces the TPU kernel `_level_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:134):
// one [all-left; all-right] expansion level. K3 `value_hash` replaces
// `_value_kernel` (same file, :333): the leaf MMO hash with the value key
// plus the value correction. Plain PyTorch versions:
// `ops/expand_planes.py:expand_level_plain` / `value_hash_plain`. The
// layout and K3's per-column body are in expand_body.cuh.
//
// What bounds them on this card: integer logic. One child of one word
// column is a whole AES-128 on 128 words (~22k LOP3s: 160 S-boxes,
// MixColumns, AddRoundKey) against 1.5 KB of state traffic, far above the
// card's ops:byte balance. At the narrow levels (32-512 columns) it is the
// latency of one AES, with most of the card idle.
//
// K2 (redesigned for this card). The first design ran one thread's AES per
// (child, column): 255 registers with 196 / 436 B of spills, and ~31 us of
// serial latency, so every level took 0.032-0.039 ms whatever its width.
// Here each child's AES runs on the split body of split_aes.cuh: a group
// of 16 threads, one state byte each, the fixed round keys as plane masks
// in shared memory (indexed by round and lane only: the constant-time rule
// of split_aes.cuh). A block of 128 threads owns a tile of 4 input columns
// at a time (grid-stride over the tiles, so the key tables fill once a
// block): the tile's planes come in through shared memory, consecutive
// threads on consecutive columns of one plane; group gi hashes child
// gi / 4 of column gi % 4 (sigma, the AES with that child's key, the
// feed-forward, the seed correction under the parent control word read at
// column m % KG, plane 0 out as the child control word, the direction
// correction); the children go out through the same tile, the left ones
// to columns m0.., the right ones to G + m0... Groups past the width
// compute column G - 1 and store nothing, so a warp always runs whole.
//
// The choices, measured on an H100 80GB HBM3 at 700 W by
// tools/torch_level_leaf_probe.py on variants of this source (PERF.md):
// - a group a child, not a group a column computing sigma once and both
//   children from it (the JAX kernel's way): the latter ran two AES in a
//   row, 0.0097-0.0109 ms a narrow level against 0.0067-0.0092, and won
//   only 4-7% at 4,096 and 16,384 columns; it was removed;
// - 128 threads a block, not 256: 0.0067-0.0077 against 0.0083-0.0086 ms
//   at the narrow levels (likely because a 256-thread block puts two warps
//   on each scheduler of one SM, or idle groups beside the busy ones at 4
//   columns), within 3% from 1,024 columns up.
// Narrow levels (up to 512 columns) take one AES chain plus the launch,
// 0.0069-0.0078 ms; the widest (16,384 columns) 1.75x its operation
// bound, 0.077 against the one-thread body's 0.062 ms: the split AES
// issues more instructions (24 shuffles and 8 shared-memory key loads a
// round a thread beside its logic; reckoned, not counted). `nvcc -Xptxas
// -v` (CUDA 12.8, sm_90a):
// expand_level_kernel 72 registers, no spills, 16,432 B static shared
// memory.
//
// K3 keeps the one-thread body (expand_body.cuh:value_column): one thread
// per word column, the 128-word state in registers, the rounds as a loop,
// the input column re-read for the feed-forward. value_hash_kernel: 255
// registers, 248 B stack, 248 B / 488 B spills.
//
// Built by ops/cuda_lib.py with nvcc for sm_90a into a library with a
// plain C interface. Without __CUDACC__ (a host C++ compiler) the same
// bodies build into host entry points that the CPU tests run: K2's host
// twin runs a group's 16 slices in lockstep (split::HostLanes) and a
// block's phases in the kernel's barrier order.

#include "split_aes.cuh"

#ifndef __CUDACC__
#include <memory>
#include <vector>
#endif

namespace {

constexpr int kLevelThreads = 128;
constexpr int kLevelGroups = kLevelThreads / split::kGroup;
constexpr int kLevelCols = kLevelGroups / 2;  // input columns a tile
// Words a tile row takes: at least the 2 kLevelCols output columns and
// congruent to 2 mod 4, so that the two groups of a warp writing their
// slices into neighbouring columns hit 32 different banks.
constexpr int kLevelStride = 2 * kLevelCols + 2;

struct LevelArgs {
  const uint32_t* state;
  const uint32_t* ctrl;
  const uint32_t* cwp;
  const uint32_t* cwl;
  const uint32_t* cwr;
  uint32_t* out;
  uint32_t* out_ctrl;
  int64_t g, kg, tiles;
};

struct LevelSmem {
  uint32_t keys[2 * split::kKeyWords];  // kKeyLeft, kKeyRight
  uint32_t tile[128 * kLevelStride];    // kLevelCols columns in, 2x out
  uint32_t ctrl_in[kLevelCols];
  uint32_t ctrl_out[2 * kLevelCols];
};

template <class Ln>
struct LevelRegs {
  uint32_t s[Ln::K][split::kSlice];
  uint32_t c[Ln::K];
};

// The input columns m0.. of a tile in, coalesced (threads `first`, `first`
// + `step`, ...); columns past G read column G - 1.
__device__ __forceinline__ void level_load(const LevelArgs& a, LevelSmem& sm, int64_t m0,
                                           int first, int step) {
  for (int i = first; i < 128 * kLevelCols; i += step) {
    const int plane = i / kLevelCols;
    const int col = i % kLevelCols;
    const int64_t m = m0 + col < a.g ? m0 + col : a.g - 1;
    sm.tile[split::tile_row(plane) * kLevelStride + col] = a.state[plane * a.g + m];
  }
  for (int col = first; col < kLevelCols; col += step) {
    sm.ctrl_in[col] = a.ctrl[m0 + col < a.g ? m0 + col : a.g - 1];
  }
}

// Group gi's input column into its registers.
template <class Ln>
__device__ __forceinline__ void level_enter(const Ln& ln, LevelRegs<Ln>& R,
                                            const LevelSmem& sm, int gi) {
  const int col = gi % kLevelCols;
  split::load_slice(ln, R.s, sm.tile, kLevelStride, col);
  ln.each([&](int, int x) { R.c[x] = sm.ctrl_in[col]; });
}

// Group gi's child (gi / kLevelCols: 0 left, 1 right) of input column
// m0 + gi % kLevelCols, into output column gi of the tile.
template <class Ln>
__device__ __forceinline__ void level_child(const Ln& ln, LevelRegs<Ln>& R,
                                            const LevelArgs& a, LevelSmem& sm,
                                            int64_t m0, int gi) {
  const int child = gi / kLevelCols;
  int64_t m = m0 + gi % kLevelCols;
  if (m >= a.g) m = a.g - 1;
  const int64_t k = m % a.kg;
  const uint32_t* key = sm.keys + child * split::kKeyWords;
  const uint32_t dir = child ? a.cwr[k] : a.cwl[k];
  const uint32_t sel[Ln::K] = {};
  split::mmo<false>(ln, R.s, key, key, sel, a.cwp + k, a.kg, R.c);
  uint32_t t[Ln::K];
  split::take_control(ln, R.s, t);
  split::store_slice(ln, R.s, sm.tile, kLevelStride, gi);
  ln.each([&](int j, int x) {
    if (j == 0) sm.ctrl_out[gi] = t[x] ^ (R.c[x] & dir);
  });
}

// The tile's children out: output column c < kLevelCols is the left child
// of input column m0 + c (at m0 + c), the rest the right children (at G +
// m0 + c - kLevelCols); consecutive threads on consecutive columns.
__device__ __forceinline__ void level_store(const LevelArgs& a, const LevelSmem& sm,
                                            int64_t m0, int first, int step) {
  constexpr int kOut = 2 * kLevelCols;
  for (int i = first; i < 128 * kOut; i += step) {
    const int plane = i / kOut;
    const int col = i % kOut;
    const int64_t m = m0 + col % kLevelCols;
    if (m < a.g) {
      a.out[plane * 2 * a.g + (col / kLevelCols) * a.g + m] =
          sm.tile[split::tile_row(plane) * kLevelStride + col];
    }
  }
  for (int col = first; col < kOut; col += step) {
    const int64_t m = m0 + col % kLevelCols;
    if (m < a.g) a.out_ctrl[(col / kLevelCols) * a.g + m] = sm.ctrl_out[col];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kLevelThreads) expand_level_kernel(const LevelArgs a) {
  __shared__ LevelSmem sm;
  const int tid = threadIdx.x;
  const int gi = tid / split::kGroup;
  const split::DeviceLanes ln{tid % split::kGroup};
  split::fill_keys(sm.keys, 0, 2, tid, kLevelThreads);
  LevelRegs<split::DeviceLanes> R;
  for (int64_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t m0 = tile * kLevelCols;
    __syncthreads();  // the keys are in; the last tile's children are out
    level_load(a, sm, m0, tid, kLevelThreads);
    __syncthreads();
    level_enter(ln, R, sm, gi);
    __syncthreads();  // every group has read its column
    level_child(ln, R, a, sm, m0, gi);
    __syncthreads();
    level_store(a, sm, m0, tid, kLevelThreads);
  }
}

constexpr int kThreads = 64;

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
// One block a tile up to as many blocks as the card holds at once; each
// block walks its tiles grid-stride.
extern "C" int dpf_expand_level(const uint32_t* state, const uint32_t* ctrl,
                                const uint32_t* cwp, const uint32_t* cwl,
                                const uint32_t* cwr, uint32_t* out_state,
                                uint32_t* out_ctrl, long long g, long long kg,
                                void* stream) {
  if (g == 0) return 0;
  if (kg < 1 || g % kg) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64] = {};  // blocks the card holds at once, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_level_kernel,
                                                          kLevelThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * per_sm;
  }
  const LevelArgs a{state, ctrl, cwp, cwl, cwr, out_state, out_ctrl, g, kg,
                    (g + kLevelCols - 1) / kLevelCols};
  const long long blocks = a.tiles < resident[dev] ? a.tiles : resident[dev];
  expand_level_kernel<<<static_cast<unsigned>(blocks), kLevelThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
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
// K2's host twin: the tiles one after another, each phase over all of a
// block's groups before the next (the barriers of the kernel).
extern "C" int dpf_expand_level_host(const uint32_t* state, const uint32_t* ctrl,
                                     const uint32_t* cwp, const uint32_t* cwl,
                                     const uint32_t* cwr, uint32_t* out_state,
                                     uint32_t* out_ctrl, long long g,
                                     long long kg) {
  if (g == 0) return 0;
  if (kg < 1 || g % kg) return 1;
  const LevelArgs a{state, ctrl, cwp, cwl, cwr, out_state, out_ctrl, g, kg,
                    (g + kLevelCols - 1) / kLevelCols};
  auto sm = std::make_unique<LevelSmem>();
  std::vector<LevelRegs<split::HostLanes>> R(kLevelGroups);
  const split::HostLanes ln;
  split::fill_keys(sm->keys, 0, 2, 0, 1);
  for (int64_t tile = 0; tile < a.tiles; ++tile) {
    const int64_t m0 = tile * kLevelCols;
    level_load(a, *sm, m0, 0, 1);
    for (int gi = 0; gi < kLevelGroups; ++gi) level_enter(ln, R[gi], *sm, gi);
    for (int gi = 0; gi < kLevelGroups; ++gi) level_child(ln, R[gi], a, *sm, m0, gi);
    level_store(a, *sm, m0, 0, 1);
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
