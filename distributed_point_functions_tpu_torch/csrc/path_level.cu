// Hand-written CUDA for the DPF's path walk (sm_90a).
//
// K8 `path_level` replaces the TPU kernel `_path_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:946): the
// level that point evaluation (`evaluate_at`), resumed hierarchical
// evaluation, the multi-key engine behind the DCF and the chunked PIR tier
// run once per tree level. Each 32-lane word column m of the [16, 8, G]
// planes hashes ONCE, with the left or the right PRG key as each lane's
// packed path bit `sel[m]` says; then the seed correction under the
// control word, plane 0 (the seed LSB) out as the new control word and
// cleared, and the direction correction of the branch each lane took:
//   h = AES_sel(sigma(x)) ^ sigma(x) ^ (cwp & ctrl),
//   ctrl' = h[0] ^ (ctrl & ((sel & cwr) | (~sel & cwl))).
// Corrections are [16, 8, KW] planes and [KW] words read at column m % KW:
// KW = G is the per-seed mode (each lane carries its own key), KW = 1 with
// all-ones/all-zeros words is one key's shared corrections. Plain PyTorch
// version: `ops/expand_planes.py:path_walk_plain`.
//
// One launch walks L levels (`path_walk`): a column's next level depends
// on its own previous level only, so its state and control stay in its
// group's registers from level to level (the JAX package scans the levels
// with one `pallas_call` each). At each of S requested stops (a level
// count, 0..L, non-decreasing) the block writes every column's state and
// control into column s * G + m of one int32[16, 8, S * G] output and one
// [S * G] control output. `path_level` is the L = 1, S = 1 case.
//
// What bounds it on this card: at its callers' widths (32 word columns for
// the DCF's 1,024 keys and a chunk's walk, 2 for 64 prefixes) the latency
// of one AES, level after level, with most of the card idle. So a column's
// AES is split over a group of 16 threads (split_aes.cuh), a sixteenth of
// the one-thread AES's serial work, and the state plus sigma take 16
// registers instead of 255 with spills. A block of 64 threads holds 4
// columns; its entry planes come in and each stop's planes go out through
// a shared-memory tile, consecutive threads on consecutive columns of one
// plane. The round keys are plane masks in shared memory, the select-key
// AddRoundKey `(kl & ~sel) | (kr & sel)`: no branch and no lookup on the
// path bits (split_aes.cuh, the constant-time rule).
//
// Built by ops/cuda_lib.py into the same library as the other kernels;
// without __CUDACC__ the same bodies build into host entry points that the
// CPU tests hold against the plain versions and the JAX package (and
// `dpf_split_aes_host`, the split AES alone, against the one-thread AES).

#include "split_aes.cuh"

#ifndef __CUDACC__
#include <memory>
#include <vector>
#endif

namespace {

constexpr int kPathThreads = 64;
constexpr int kPathCols = kPathThreads / split::kGroup;
constexpr int kPathStride = split::tile_stride(kPathCols);
// Stops a launch can take (a DCF over a 128-bit domain has 128).
constexpr int kMaxStops = 128;

struct PathArgs {
  const uint32_t* state;
  const uint32_t* ctrl;
  const uint32_t* sel;
  const uint32_t* cwp;
  const uint32_t* cwl;
  const uint32_t* cwr;
  uint32_t* out;
  uint32_t* out_ctrl;
  int64_t g, kw;
  int levels, num_stops;
  int stops[kMaxStops];
};

struct PathSmem {
  uint32_t keys[2 * split::kKeyWords];  // kKeyLeft, kKeyRight
  uint32_t tile[128 * kPathStride];
  uint32_t ctrl[kPathCols];
};

template <class Ln>
struct PathRegs {
  uint32_t s[Ln::K][split::kSlice];
  uint32_t c[Ln::K];
};

// The block's columns m0.. into the tile, coalesced (threads `first`,
// `first` + `step`, ...); columns past G read column G - 1.
__device__ __forceinline__ void path_load(const PathArgs& a, PathSmem& sm, int64_t m0,
                                          int first, int step) {
  for (int i = first; i < 128 * kPathCols; i += step) {
    const int plane = i / kPathCols;
    const int64_t m = m0 + i % kPathCols < a.g ? m0 + i % kPathCols : a.g - 1;
    sm.tile[split::tile_row(plane) * kPathStride + i % kPathCols] = a.state[plane * a.g + m];
  }
  for (int col = first; col < kPathCols; col += step) {
    sm.ctrl[col] = a.ctrl[m0 + col < a.g ? m0 + col : a.g - 1];
  }
}

template <class Ln>
__device__ __forceinline__ void path_enter(const Ln& ln, PathRegs<Ln>& R,
                                           const PathSmem& sm, int gi) {
  split::load_slice(ln, R.s, sm.tile, kPathStride, gi);
  ln.each([&](int, int x) { R.c[x] = sm.ctrl[gi]; });
}

// Level `lvl` of column m (group gi's).
template <class Ln>
__device__ __forceinline__ void path_step(const Ln& ln, PathRegs<Ln>& R,
                                          const PathArgs& a, const PathSmem& sm,
                                          int64_t m, int lvl) {
  if (m >= a.g) m = a.g - 1;
  const int64_t k = m % a.kw;
  const uint32_t sl = a.sel[lvl * a.g + m];
  const uint32_t dir = (sl & a.cwr[lvl * a.kw + k]) | (~sl & a.cwl[lvl * a.kw + k]);
  uint32_t sel[Ln::K];
  ln.each([&](int, int x) { sel[x] = sl; });
  split::mmo<true>(ln, R.s, sm.keys, sm.keys + split::kKeyWords, sel,
                   a.cwp + static_cast<int64_t>(lvl) * 128 * a.kw + k, a.kw, R.c);
  uint32_t t[Ln::K];
  split::take_control(ln, R.s, t);
  ln.each([&](int, int x) { R.c[x] = t[x] ^ (R.c[x] & dir); });
}

template <class Ln>
__device__ __forceinline__ void path_stage(const Ln& ln, const PathRegs<Ln>& R,
                                           PathSmem& sm, int gi) {
  split::store_slice(ln, R.s, sm.tile, kPathStride, gi);
  ln.each([&](int j, int x) {
    if (j == 0) sm.ctrl[gi] = R.c[x];
  });
}

// The tile out as stop `stop`: column stop * G + m of the outputs.
__device__ __forceinline__ void path_store(const PathArgs& a, const PathSmem& sm,
                                           int64_t m0, int stop, int first, int step) {
  const int64_t w = a.num_stops * a.g;
  for (int i = first; i < 128 * kPathCols; i += step) {
    const int plane = i / kPathCols;
    const int64_t m = m0 + i % kPathCols;
    if (m < a.g) {
      a.out[plane * w + stop * a.g + m] =
          sm.tile[split::tile_row(plane) * kPathStride + i % kPathCols];
    }
  }
  for (int col = first; col < kPathCols; col += step) {
    if (m0 + col < a.g) a.out_ctrl[stop * a.g + m0 + col] = sm.ctrl[col];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kPathThreads) path_walk_kernel(const PathArgs a) {
  __shared__ PathSmem sm;
  const int tid = threadIdx.x;
  const int gi = tid / split::kGroup;
  const split::DeviceLanes ln{tid % split::kGroup};
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kPathCols;
  split::fill_keys(sm.keys, 0, 2, tid, kPathThreads);
  path_load(a, sm, m0, tid, kPathThreads);
  __syncthreads();
  PathRegs<split::DeviceLanes> R;
  path_enter(ln, R, sm, gi);
  int stop = 0;
  for (int lvl = 0;; ++lvl) {
    for (; stop < a.num_stops && a.stops[stop] == lvl; ++stop) {
      __syncthreads();  // every group has read the tile
      path_stage(ln, R, sm, gi);
      __syncthreads();
      path_store(a, sm, m0, stop, tid, kPathThreads);
    }
    if (lvl == a.levels) break;
    path_step(ln, R, a, sm, m0 + gi, lvl);
  }
}
#else
// The blocks one after another, each phase over all of the block's groups
// before the next (the barriers of the kernel).
void path_walk_host(const PathArgs& a) {
  auto sm = std::make_unique<PathSmem>();
  std::vector<PathRegs<split::HostLanes>> R(kPathCols);
  const split::HostLanes ln;
  split::fill_keys(sm->keys, 0, 2, 0, 1);
  for (int64_t m0 = 0; m0 < a.g; m0 += kPathCols) {
    path_load(a, *sm, m0, 0, 1);
    for (int gi = 0; gi < kPathCols; ++gi) path_enter(ln, R[gi], *sm, gi);
    int stop = 0;
    for (int lvl = 0;; ++lvl) {
      for (; stop < a.num_stops && a.stops[stop] == lvl; ++stop) {
        for (int gi = 0; gi < kPathCols; ++gi) path_stage(ln, R[gi], *sm, gi);
        path_store(a, *sm, m0, stop, 0, 1);
      }
      if (lvl == a.levels) break;
      for (int gi = 0; gi < kPathCols; ++gi) path_step(ln, R[gi], a, *sm, m0 + gi, lvl);
    }
  }
}
#endif

// Checks what the kernel takes; 0 or an error code.
int path_args(PathArgs& a, const uint32_t* state, const uint32_t* ctrl,
              const uint32_t* sel, const uint32_t* cwp, const uint32_t* cwl,
              const uint32_t* cwr, const int* stops, int num_stops,
              uint32_t* out, uint32_t* out_ctrl, long long g, long long kw,
              int levels) {
  if (num_stops < 1 || num_stops > kMaxStops || levels < 0 || g < 1 || kw < 1) {
    return 1;
  }
  a = PathArgs{state, ctrl, sel, cwp, cwl, cwr, out, out_ctrl, g, kw, levels,
               num_stops, {}};
  for (int i = 0; i < num_stops; ++i) {
    if (stops[i] < (i ? stops[i - 1] : 0) || stops[i] > levels) return 1;
    a.stops[i] = stops[i];
  }
  return 0;
}

}  // namespace

#ifdef __CUDACC__
extern "C" int dpf_path_walk(const uint32_t* state, const uint32_t* ctrl,
                             const uint32_t* sel, const uint32_t* cwp,
                             const uint32_t* cwl, const uint32_t* cwr,
                             const int* stops, int num_stops, uint32_t* out,
                             uint32_t* out_ctrl, long long g, long long kw,
                             int levels, void* stream) {
  PathArgs a;
  if (path_args(a, state, ctrl, sel, cwp, cwl, cwr, stops, num_stops, out,
                out_ctrl, g, kw, levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (g + kPathCols - 1) / kPathCols;
  path_walk_kernel<<<static_cast<unsigned>(blocks), kPathThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int dpf_path_walk_host(const uint32_t* state, const uint32_t* ctrl,
                                  const uint32_t* sel, const uint32_t* cwp,
                                  const uint32_t* cwl, const uint32_t* cwr,
                                  const int* stops, int num_stops, uint32_t* out,
                                  uint32_t* out_ctrl, long long g, long long kw,
                                  int levels) {
  PathArgs a;
  if (path_args(a, state, ctrl, sel, cwp, cwl, cwr, stops, num_stops, out,
                out_ctrl, g, kw, levels)) {
    return 1;
  }
  path_walk_host(a);
  return 0;
}

// One level (L = 1, S = 1).
extern "C" int dpf_path_level_host(const uint32_t* state, const uint32_t* ctrl,
                                   const uint32_t* sel, const uint32_t* cwp,
                                   const uint32_t* cwl, const uint32_t* cwr,
                                   uint32_t* out_state, uint32_t* out_ctrl,
                                   long long g, long long kw) {
  const int stop = 1;
  return dpf_path_walk_host(state, ctrl, sel, cwp, cwl, cwr, &stop, 1, out_state,
                            out_ctrl, g, kw, 1);
}

// The split select-key AES alone (no MMO) on every word column of the
// [128, g] planes `in`: kKeyLeft where a lane's `sel` bit is 0, kKeyRight
// where it is 1.
extern "C" int dpf_split_aes_host(const uint32_t* in, const uint32_t* sel,
                                  uint32_t* out, long long g) {
  std::vector<uint32_t> keys(2 * split::kKeyWords);
  split::fill_keys(keys.data(), 0, 2, 0, 1);
  const split::HostLanes ln;
  for (int64_t m = 0; m < g; ++m) {
    uint32_t s[split::kGroup][split::kSlice];
    uint32_t sl[split::kGroup];
    ln.each([&](int j, int x) {
      sl[x] = sel[m];
      for (int b = 0; b < split::kSlice; ++b) s[x][b] = in[(j * split::kSlice + b) * g + m];
    });
    split::aes<true>(ln, s, keys.data(), keys.data() + split::kKeyWords, sl);
    ln.each([&](int j, int x) {
      for (int b = 0; b < split::kSlice; ++b) out[(j * split::kSlice + b) * g + m] = s[x][b];
    });
  }
  return 0;
}
#endif
