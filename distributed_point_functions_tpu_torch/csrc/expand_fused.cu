// Hand-written CUDA for the fused expansion kernels (sm_90a).
//
// K4 `walk_descend` replaces the TPU kernel `_walk_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:649): r
// levels below each entry column, out at the width W = G0 << r, an
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
// traffic); at the narrow widths of K4's heads, the latency of r AES in a
// row.
//
// K4 (redesigned for this card): the constant-width walk recomputes every
// shared ancestor (r select-key AES per leaf column, the TPU's answer to
// Mosaic refusing a doubling-width concatenation), and one thread carried
// a whole AES (~31 us of serial latency, 255 registers with spills). Here
// a block owns one subtree: subtree t = (node * 2^(r-d) + p) * nl + kw is
// the node at depth r - d along prefix p below entry column node * nl + kw.
// One group walks its root down the top r - d levels with the select-key
// AES; then the block doubles the last d = min(r, 4) levels in shared
// memory with the fixed-key AES, each parent hashing its two children once
// (a subtree's 2^d leaves of 512 B each), and hashes the leaf values.
// Each AES is split over a group of 16 threads (split_aes.cuh), one group
// per leaf slot: a block of 2^d groups. A doubling level's
// tasks read their parents, a barrier, then write their children (the left
// child over its parent), another barrier. The block's leaves leave
// through the tile, consecutive threads on consecutive output columns of
// one plane (natural leaf order, column ((node << r) + (p << d) + q) * nl
// + kw). At the main path's tail (r = d = 4) that is 2,048 x (2 + 4 + 8 +
// 16 + 16) = 94,208 AES instead of the walk's 163,840.
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

#include "split_aes.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#else
#include <memory>
#include <vector>
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


// ---------------------------------------------------------------------
// K4: the walk descent on the split AES.

// A subtree's doubling levels (d <= kMaxDouble): 2^d leaves of 512 B of
// state each in the block's tile, one group a leaf slot (a block of up to
// 256 threads).
constexpr int kMaxDouble = 4;
constexpr int kWalkCols = 1 << kMaxDouble;
constexpr int kWalkStride = split::tile_stride(kWalkCols);

struct WalkSmem {
  uint32_t keys[3 * split::kKeyWords];  // kKeyLeft, kKeyRight, kKeyValue
  uint32_t tile[128 * kWalkStride];
  uint32_t ctrl[kWalkCols];
};

struct WalkArgs {
  const uint32_t* state;
  const uint32_t* ctrl;
  const uint32_t* cwp;
  const uint32_t* cwl;
  const uint32_t* cwr;
  const uint32_t* vc;
  uint32_t* out;
  uint32_t* out_ctrl;
  int64_t g0, kg, nl;
  int r, d, value_hash;
  int64_t subtrees;  // g0 << (r - d)
};

// Subtree t = (node * 2^(r-d) + p) * nl + kw: entry column node * nl + kw,
// prefix p (the top r - d offset bits). Its leaf q is output column
// ((node << r) + (p << d) + q) * nl + kw, natural leaf order.
struct Subtree {
  int64_t node, p, kw;
};

WalkArgs walk_args(const uint32_t* state, const uint32_t* ctrl, const uint32_t* cwp,
                   const uint32_t* cwl, const uint32_t* cwr, const uint32_t* vc,
                   uint32_t* out, uint32_t* out_ctrl, int64_t g0, int64_t kg,
                   int64_t nl, int r, int value_hash) {
  const int d = r < kMaxDouble ? r : kMaxDouble;
  return {state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, nl, r, d,
          value_hash, g0 << (r - d)};
}

__device__ __forceinline__ Subtree subtree_of(const WalkArgs& a, int64_t t) {
  const int rw = a.r - a.d;
  return {t / (a.nl << rw), (t / a.nl) & ((int64_t{1} << rw) - 1), t % a.nl};
}

__device__ __forceinline__ int64_t leaf_column(const WalkArgs& a, const Subtree& st,
                                               int64_t q) {
  return ((st.node << a.r) + (st.p << a.d) + q) * a.nl + st.kw;
}

template <class Ln>
struct GroupRegs {
  uint32_t s[Ln::K][split::kSlice];
  uint32_t c[Ln::K];
};

// The subtree's entry column into leaf slot 0, coalesced: the threads
// `first`, `first` + `step`, ...
__device__ __forceinline__ void walk_load(const WalkArgs& a, WalkSmem& sm,
                                          const Subtree& st, int first, int step) {
  for (int plane = first; plane < 128; plane += step) {
    sm.tile[split::tile_row(plane) * kWalkStride] = a.state[plane * a.g0 + st.node * a.nl + st.kw];
  }
  if (first == 0) sm.ctrl[0] = a.ctrl[st.node * a.nl + st.kw];
}

// One level of the hash chain on a group's column: child `bit` (key and
// direction correction of that side) at level `lvl`, correction column k.
template <class Ln>
__device__ __forceinline__ void walk_child(const Ln& ln, GroupRegs<Ln>& R,
                                           const WalkArgs& a, const WalkSmem& sm,
                                           int lvl, int64_t k, uint32_t bit) {
  const uint32_t* key = sm.keys + (bit ? split::kKeyWords : 0);
  const uint32_t dir = bit ? a.cwr[lvl * a.kg + k] : a.cwl[lvl * a.kg + k];
  const uint32_t sel[Ln::K] = {};
  split::mmo<false>(ln, R.s, key, key, sel,
                    a.cwp + static_cast<int64_t>(lvl) * 128 * a.kg + k, a.kg, R.c);
  uint32_t t[Ln::K];
  split::take_control(ln, R.s, t);
  ln.each([&](int, int x) { R.c[x] = t[x] ^ (R.c[x] & dir); });
}

// The subtree's root, walked from the entry column down the top r - d
// levels with the select-key AES (the key each offset bit selects), back
// into slot 0 (with `store`).
template <class Ln>
__device__ __forceinline__ void walk_root(const Ln& ln, GroupRegs<Ln>& R,
                                          const WalkArgs& a, WalkSmem& sm,
                                          const Subtree& st, bool store) {
  const int rw = a.r - a.d;
  split::load_slice(ln, R.s, sm.tile, kWalkStride, 0);
  ln.each([&](int, int x) { R.c[x] = sm.ctrl[0]; });
  for (int i = 0; i < rw; ++i) {
    walk_child(ln, R, a, sm, i, st.kw % a.kg,
               static_cast<uint32_t>((st.p >> (rw - 1 - i)) & 1));
  }
  if (!store) return;
  split::store_slice(ln, R.s, sm.tile, kWalkStride, 0);
  ln.each([&](int j, int x) {
    if (j == 0) sm.ctrl[0] = R.c[x];
  });
}

// Group gi's part in a phase of n tasks run by the groups lo .. lo + n - 1:
// false if its warp sits the phase out; else its task x and whether it
// stores. A warp with one of the tasks runs whole (its shuffles take every
// lane): its other group repeats the nearest task and stores nothing.
__device__ __forceinline__ bool walk_task(int gi, int lo, int n, int& x, bool& store) {
  const int first = gi - gi % (32 / split::kGroup);  // the warp's first group
  if (first + 32 / split::kGroup <= lo || first >= lo + n) return false;
  const int raw = gi - lo;
  store = raw >= 0 && raw < n;
  x = raw < 0 ? 0 : (raw < n ? raw : n - 1);
  return true;
}

// Doubling level k (children at depth k + 1 of the subtree) has 2 << k
// tasks: task c is child c. Its parent sits in slot (c >> 1) << (d - k);
// the child goes to slot c << (d - k - 1), the left child over its parent,
// so every parent is read before any child is written (the barrier between
// the two phases). The tasks take the first groups at even k and the last
// at odd k, so that the narrow levels' warps fall on different schedulers
// of the SM.
__device__ __forceinline__ bool level_task(const WalkArgs& a, int k, int gi, int& x,
                                           bool& store) {
  const int n = 2 << k;
  return walk_task(gi, (k & 1) ? (1 << a.d) - n : 0, n, x, store);
}

template <class Ln>
__device__ __forceinline__ void walk_read_parent(const Ln& ln, GroupRegs<Ln>& R,
                                                 const WalkArgs& a, const WalkSmem& sm,
                                                 int k, int c) {
  const int col = (c >> 1) << (a.d - k);
  split::load_slice(ln, R.s, sm.tile, kWalkStride, col);
  ln.each([&](int, int x) { R.c[x] = sm.ctrl[col]; });
}

template <class Ln>
__device__ __forceinline__ void walk_write_child(const Ln& ln, GroupRegs<Ln>& R,
                                                 const WalkArgs& a, WalkSmem& sm,
                                                 const Subtree& st, int k, int c,
                                                 bool store) {
  const int64_t kc = st.kw % a.kg;
  walk_child(ln, R, a, sm, a.r - a.d + k, kc, static_cast<uint32_t>(c & 1));
  if (k == a.d - 1 && a.value_hash) {
    const uint32_t* key = sm.keys + 2 * split::kKeyWords;
    const uint32_t sel[Ln::K] = {};
    split::mmo<false>(ln, R.s, key, key, sel, a.vc + kc, a.kg, R.c);
  }
  if (!store) return;
  const int col = c << (a.d - k - 1);
  split::store_slice(ln, R.s, sm.tile, kWalkStride, col);
  ln.each([&](int j, int x) {
    if (j == 0) sm.ctrl[col] = R.c[x];
  });
}

// The subtree's leaves out of the tile in natural order: consecutive
// threads on consecutive columns of one plane.
__device__ __forceinline__ void walk_store(const WalkArgs& a, const WalkSmem& sm,
                                           const Subtree& st, int first, int step) {
  const int cols = 1 << a.d;
  const int64_t w = a.g0 << a.r;
  for (int i = first; i < 128 * cols; i += step) {
    const int plane = i / cols;
    const int col = i % cols;
    a.out[plane * w + leaf_column(a, st, col)] =
        sm.tile[split::tile_row(plane) * kWalkStride + col];
  }
  for (int col = first; col < cols; col += step) {
    a.out_ctrl[leaf_column(a, st, col)] = sm.ctrl[col];
  }
}

#ifdef __CUDACC__
constexpr int kThreads = 64;

// One block a subtree, 2^d groups.
__global__ void __launch_bounds__(kWalkCols * split::kGroup)
walk_descend_kernel(WalkArgs a) {
  __shared__ WalkSmem sm;
  const int tid = threadIdx.x;
  const int gi = tid / split::kGroup;
  const split::DeviceLanes ln{tid % split::kGroup};
  const Subtree st = subtree_of(a, blockIdx.x);
  split::fill_keys(sm.keys, 0, 3, tid, blockDim.x);
  walk_load(a, sm, st, tid, blockDim.x);
  __syncthreads();
  GroupRegs<split::DeviceLanes> R;
  int x;
  bool store;
  // Whether the warp runs a phase comes from a warp vote, a value the
  // compiler knows to be the same on every lane: the shuffles inside then
  // need no warp-synchronisation sequence around each.
  if (a.r > a.d) {
    if (__any_sync(0xffffffffu, walk_task(gi, 0, 1, x, store))) {
      walk_root(ln, R, a, sm, st, store);
    }
    __syncthreads();
  }
  for (int k = 0; k < a.d; ++k) {
    const bool runs = __any_sync(0xffffffffu, level_task(a, k, gi, x, store));
    if (runs) walk_read_parent(ln, R, a, sm, k, x);
    __syncthreads();
    if (runs) walk_write_child(ln, R, a, sm, st, k, x, store);
    __syncthreads();
  }
  walk_store(a, sm, st, tid, blockDim.x);
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
// One block of 2^d groups a subtree (d >= 1: a whole warp or more).
extern "C" int dpf_walk_descend(const uint32_t* state, const uint32_t* ctrl,
                                const uint32_t* cwp, const uint32_t* cwl,
                                const uint32_t* cwr, const uint32_t* vc,
                                uint32_t* out, uint32_t* out_ctrl, long long g0,
                                long long kg, long long nl, int r,
                                int value_hash, void* stream) {
  const WalkArgs a = walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl,
                               g0, kg, nl, r, value_hash);
  walk_descend_kernel<<<static_cast<unsigned>(a.subtrees), (1 << a.d) * split::kGroup, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
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
// K4's host twin: the blocks one after another, each phase over all of a
// block's groups before the next (the barriers of the kernel).
extern "C" int dpf_walk_descend_host(const uint32_t* state, const uint32_t* ctrl,
                                     const uint32_t* cwp, const uint32_t* cwl,
                                     const uint32_t* cwr, const uint32_t* vc,
                                     uint32_t* out, uint32_t* out_ctrl,
                                     long long g0, long long kg, long long nl,
                                     int r, int value_hash) {
  const WalkArgs a = walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl,
                               g0, kg, nl, r, value_hash);
  auto sm = std::make_unique<WalkSmem>();
  std::vector<GroupRegs<split::HostLanes>> R(kWalkCols);
  const split::HostLanes ln;
  const int groups = 1 << a.d;
  split::fill_keys(sm->keys, 0, 3, 0, 1);
  for (int64_t t = 0; t < a.subtrees; ++t) {
    const Subtree st = subtree_of(a, t);
    walk_load(a, *sm, st, 0, 1);
    int x;
    bool store;
    if (a.r > a.d) {
      for (int gi = 0; gi < groups; ++gi) {
        if (walk_task(gi, 0, 1, x, store)) walk_root(ln, R[gi], a, *sm, st, store);
      }
    }
    for (int k = 0; k < a.d; ++k) {
      for (int gi = 0; gi < groups; ++gi) {
        if (level_task(a, k, gi, x, store)) walk_read_parent(ln, R[gi], a, *sm, k, x);
      }
      for (int gi = 0; gi < groups; ++gi) {
        if (level_task(a, k, gi, x, store)) walk_write_child(ln, R[gi], a, *sm, st, k, x, store);
      }
    }
    walk_store(a, *sm, st, 0, 1);
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
