// Hand-written CUDA for the fused expansion kernels (sm_90a).
//
// K4 `walk_descend` replaces the TPU kernel `_walk_kernel`
// (distributed_point_functions_tpu/ops/expand_planes_pallas.py:649): r
// levels below each entry column, out at the width W = G0 << r, an
// optional leaf value hash, leaves in natural order. K5 `expand_tail`
// replaces `_tail_kernel` (same file, :392): the last r doubling levels and
// the value hash, leaves in the tiled order of `tail_node_permutation`.
// K6 `expand_head` replaces `_head_kernel` (:453): the first r doubling
// levels over the whole narrow width, one tile. Plain PyTorch versions:
// `ops/expand_planes.py:walk_descend_plain`, `expand_tail_plain`,
// `expand_head_plain`. Layout: expand_body.cuh.
//
// What bounds them on this card: integer logic, as for K2 and K3 (one
// child of a word column is a whole bitsliced AES against 1.5 KB of state
// traffic); at the narrow widths of the heads, the latency of r AES in a
// row.
//
// One body serves all three (`subtree_kernel`). A block owns one subtree:
// the node at depth r - d below an entry column, along prefix p (the top
// r - d bits of the leaf offset, the first level's bit the most
// significant). One group walks the subtree's root down the top r - d
// levels from the entry column, each level's AES keyed by its bit of p;
// then the block doubles the last d = min(r, 4) levels in shared memory
// with the fixed-key AES, each parent hashing its two children once (a
// subtree's 2^d leaves of 512 B each), and (K4 with the value hash, K5)
// hashes the leaf values. Each AES is split over a group of 16 threads
// (split_aes.cuh), one group per leaf slot: a block of 2^d groups. A
// doubling level's tasks read their parents, a barrier, then write their
// children (the left child over its parent), another barrier. The leaves
// leave through the tile, consecutive threads on consecutive leaves of
// one plane. At the main path's tail (r = d = 4) that is 2,048 x (2 + 4 +
// 8 + 16 + 16) = 94,208 AES instead of the constant-width walk's 163,840.
//
// Doubling a subtree in walk order or in tiled order is the same set of
// AES calls; only where a leaf goes differs. A leaf-order policy says
// that: the subtree of a block index (its entry column, correction column
// and prefix) and the output column of its leaf q.
// - `NaturalOrder` (K4): subtree t = (node * 2^(r-d) + p) * nl + kw, entry
//   column node * nl + kw; leaf q at ((node << r) + (p << d) + q) * nl +
//   kw.
// - `TiledOrder` (K5, K6 with one tile of T = G0): subtree t = p * G0 + e,
//   entry column e, in tile e / T of width W_t (T, or what is left of G0
//   for the last tile), local column e' = e % T. After r [all-left;
//   all-right] levels inside the tile, the leaf of offset x = (p << d) + q
//   sits at (tile start << r) + e' + W_t * rev_r(x), rev_r reversing r
//   bits; rev_r(x) = rev_d(q) * 2^(r-d) + rev_(r-d)(p). The positions
//   depend on public indices only (the constant-time rule of
//   split_aes.cuh).
// Adjacent blocks take adjacent entry columns in both orders, so the
// blocks in flight together fill the same 32-byte sectors of each plane.
//
// K5 and K6 were first one cooperative launch of one thread's AES per
// child column (255 registers with 1,072 / 1,092 B of spills, ~31 us of
// serial latency a level), a grid barrier between levels and the levels
// in two ping-pong scratch buffers in device memory, each as wide as the
// leaves for K5. Now they hold no scratch: a subtree's levels live in its
// block's shared memory, and the wrappers allocate only the outputs.
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a): subtree_kernel<NaturalOrder> and
// <TiledOrder> 64 registers, no spills, 34,368 B static shared memory
// (four blocks an SM by registers). A subtree keeps only its entry
// column, correction column and prefix live through the AES phases: with
// the leaf positions live as well, K4 took 78 registers, three blocks an
// SM, and its widest tail ran 6.88 against 6.59 ms; with the block index
// split in 64-bit divisions its main-path head ran 0.0301 against 0.0290
// ms (the head is a chain of AES latencies). Measured on an H100
// 80GB HBM3 at 700 W (tools/torch_split_aes_probe.py, PERF.md): a block
// of two adjacent subtrees (512 threads, each leaf's two entry columns
// stored side by side) lost at every serving shape (K5's main-path tail
// 0.227 against 0.209 ms; it spilled under its launch bounds) and was
// removed. At KG = 4 K5 stays ~10% behind K4's tail (0.209 against
// 0.190): its tiled stores put one word of a block in each 32-byte
// sector, K4's natural ones two (reckoned, not counted).
//
// Built by ops/cuda_lib.py like expand_planes.cu; without __CUDACC__ the
// same bodies build into host entry points that the CPU tests run.

#include "split_aes.cuh"

#ifndef __CUDACC__
#include <memory>
#include <vector>
#endif

namespace {

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
  int64_t g0, kg;
  int64_t nl;    // NaturalOrder: word columns of one tree node
  int64_t tile;  // TiledOrder: entry columns of a tile, at most g0
  int r, d, value_hash;
  int64_t subtrees;  // g0 << (r - d), below 2^31 (one block each)
};

WalkArgs walk_args(const uint32_t* state, const uint32_t* ctrl, const uint32_t* cwp,
                   const uint32_t* cwl, const uint32_t* cwr, const uint32_t* vc,
                   uint32_t* out, uint32_t* out_ctrl, int64_t g0, int64_t kg,
                   int64_t nl, int64_t tile, int r, int value_hash) {
  const int d = r < kMaxDouble ? r : kMaxDouble;
  return {state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, nl, tile < g0 ? tile : g0,
          r, d, value_hash, g0 << (r - d)};
}

// A block's subtree: its entry column, its correction column and its
// prefix. These three stay live through the AES phases; the leaf columns
// (`Leaves`) are reckoned from them only at the store. Block indices and
// widths fit in 32 bits (the grid has fewer than 2^31 blocks), so the
// divisions that split them run in 32 bits.
struct Subtree {
  int64_t entry, kc, p;
};

// Leaf q of a subtree goes to column base + step * Order::rank(a, q).
struct Leaves {
  int64_t base, step;
};

__device__ __forceinline__ int64_t reverse_bits(int64_t x, int n) {
  int64_t y = 0;
  for (int i = 0; i < n; ++i) y |= ((x >> i) & 1) << (n - 1 - i);
  return y;
}

struct NaturalOrder {
  static __device__ __forceinline__ Subtree subtree(const WalkArgs& a, int64_t t) {
    const int rw = a.r - a.d;
    const uint32_t nl = static_cast<uint32_t>(a.nl);
    const uint32_t kw = static_cast<uint32_t>(t) % nl;
    const uint32_t np = static_cast<uint32_t>(t) / nl;  // node * 2^(r-d) + p
    return {static_cast<int64_t>(np >> rw) * a.nl + kw,
            kw % static_cast<uint32_t>(a.kg), np & ((1u << rw) - 1)};
  }
  // ((node << r) + (p << d) + q) * nl + kw, node * nl + kw the entry column.
  static __device__ __forceinline__ Leaves leaves(const WalkArgs& a, const Subtree& st) {
    const uint32_t kw = static_cast<uint32_t>(st.entry) % static_cast<uint32_t>(a.nl);
    return {((st.entry - kw) << a.r) + (st.p << a.d) * a.nl + kw, a.nl};
  }
  static __device__ __forceinline__ int rank(const WalkArgs&, int q) { return q; }
};

struct TiledOrder {
  static __device__ __forceinline__ Subtree subtree(const WalkArgs& a, int64_t t) {
    const uint32_t g0 = static_cast<uint32_t>(a.g0);
    const uint32_t e = static_cast<uint32_t>(t) % g0;
    return {e, e % static_cast<uint32_t>(a.kg), static_cast<uint32_t>(t) / g0};
  }
  // (tile start << r) + e' + W_t * (rev_d(q) * 2^(r-d) + rev_(r-d)(p)).
  static __device__ __forceinline__ Leaves leaves(const WalkArgs& a, const Subtree& st) {
    const int rw = a.r - a.d;
    const uint32_t e = static_cast<uint32_t>(st.entry);
    const int64_t lo = e - e % static_cast<uint32_t>(a.tile);  // the tile's first entry column
    const int64_t wt = a.g0 - lo < a.tile ? a.g0 - lo : a.tile;
    return {(lo << a.r) + (st.entry - lo) + wt * reverse_bits(st.p, rw), wt << rw};
  }
  static __device__ __forceinline__ int rank(const WalkArgs& a, int q) {
    return static_cast<int>(reverse_bits(q, a.d));
  }
};

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
    sm.tile[split::tile_row(plane) * kWalkStride] = a.state[plane * a.g0 + st.entry];
  }
  if (first == 0) sm.ctrl[0] = a.ctrl[st.entry];
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
// levels, each with the key its bit of the prefix selects, back into slot
// 0 (with `store`).
template <class Ln>
__device__ __forceinline__ void walk_root(const Ln& ln, GroupRegs<Ln>& R,
                                          const WalkArgs& a, WalkSmem& sm,
                                          const Subtree& st, bool store) {
  const int rw = a.r - a.d;
  split::load_slice(ln, R.s, sm.tile, kWalkStride, 0);
  ln.each([&](int, int x) { R.c[x] = sm.ctrl[0]; });
  for (int i = 0; i < rw; ++i) {
    walk_child(ln, R, a, sm, i, st.kc, static_cast<uint32_t>((st.p >> (rw - 1 - i)) & 1));
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
  walk_child(ln, R, a, sm, a.r - a.d + k, st.kc, static_cast<uint32_t>(c & 1));
  if (k == a.d - 1 && a.value_hash) {
    const uint32_t* key = sm.keys + 2 * split::kKeyWords;
    const uint32_t sel[Ln::K] = {};
    split::mmo<false>(ln, R.s, key, key, sel, a.vc + st.kc, a.kg, R.c);
  }
  if (!store) return;
  const int col = c << (a.d - k - 1);
  split::store_slice(ln, R.s, sm.tile, kWalkStride, col);
  ln.each([&](int j, int x) {
    if (j == 0) sm.ctrl[col] = R.c[x];
  });
}

// The subtree's leaves out of the tile (slot q holds leaf q) to the columns
// the order gives: consecutive threads on consecutive leaves of one plane.
template <class Order>
__device__ __forceinline__ void walk_store(const WalkArgs& a, const WalkSmem& sm,
                                           const Subtree& st, int first, int step) {
  const int cols = 1 << a.d;
  const int64_t w = a.g0 << a.r;
  const Leaves lv = Order::leaves(a, st);
  for (int i = first; i < 128 * cols; i += step) {
    const int plane = i / cols;
    const int col = i % cols;
    a.out[plane * w + lv.base + lv.step * Order::rank(a, col)] =
        sm.tile[split::tile_row(plane) * kWalkStride + col];
  }
  for (int col = first; col < cols; col += step) {
    a.out_ctrl[lv.base + lv.step * Order::rank(a, col)] = sm.ctrl[col];
  }
}

#ifdef __CUDACC__
// One block a subtree, 2^d groups.
template <class Order>
__global__ void __launch_bounds__(kWalkCols * split::kGroup)
subtree_kernel(WalkArgs a) {
  __shared__ WalkSmem sm;
  const int tid = threadIdx.x;
  const int gi = tid / split::kGroup;
  const split::DeviceLanes ln{tid % split::kGroup};
  const Subtree st = Order::subtree(a, blockIdx.x);
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
  walk_store<Order>(a, sm, st, tid, blockDim.x);
}

template <class Order>
int launch_subtrees(const WalkArgs& a, void* stream) {
  subtree_kernel<Order><<<static_cast<unsigned>(a.subtrees), (1 << a.d) * split::kGroup, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
// The host twin: the blocks one after another, each phase over all of a
// block's groups before the next (the barriers of the kernel).
template <class Order>
int run_subtrees_host(const WalkArgs& a) {
  auto sm = std::make_unique<WalkSmem>();
  std::vector<GroupRegs<split::HostLanes>> R(kWalkCols);
  const split::HostLanes ln;
  const int groups = 1 << a.d;
  split::fill_keys(sm->keys, 0, 3, 0, 1);
  for (int64_t t = 0; t < a.subtrees; ++t) {
    const Subtree st = Order::subtree(a, t);
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
    walk_store<Order>(a, *sm, st, 0, 1);
  }
  return 0;
}
#endif

}  // namespace

// Every entry launches one block of 2^d groups a subtree (d >= 1: a whole
// warp or more); the host twins run the same body on the CPU.
#ifdef __CUDACC__
extern "C" int dpf_walk_descend(const uint32_t* state, const uint32_t* ctrl,
                                const uint32_t* cwp, const uint32_t* cwl,
                                const uint32_t* cwr, const uint32_t* vc,
                                uint32_t* out, uint32_t* out_ctrl, long long g0,
                                long long kg, long long nl, int r,
                                int value_hash, void* stream) {
  return launch_subtrees<NaturalOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, nl, 0, r,
                value_hash), stream);
}

extern "C" int dpf_expand_head(const uint32_t* state, const uint32_t* ctrl,
                               const uint32_t* cwp, const uint32_t* cwl,
                               const uint32_t* cwr, uint32_t* out, uint32_t* out_ctrl,
                               long long g0, long long kg, int r, void* stream) {
  return launch_subtrees<TiledOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, nullptr, out, out_ctrl, g0, kg, 0, g0, r, 0),
      stream);
}

extern "C" int dpf_expand_tail(const uint32_t* state, const uint32_t* ctrl,
                               const uint32_t* cwp, const uint32_t* cwl,
                               const uint32_t* cwr, const uint32_t* vc, uint32_t* out,
                               uint32_t* out_ctrl, long long g0, long long kg,
                               long long tile, int r, void* stream) {
  return launch_subtrees<TiledOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, 0, tile, r, 1),
      stream);
}
#else
extern "C" int dpf_walk_descend_host(const uint32_t* state, const uint32_t* ctrl,
                                     const uint32_t* cwp, const uint32_t* cwl,
                                     const uint32_t* cwr, const uint32_t* vc,
                                     uint32_t* out, uint32_t* out_ctrl,
                                     long long g0, long long kg, long long nl,
                                     int r, int value_hash) {
  return run_subtrees_host<NaturalOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, nl, 0, r,
                value_hash));
}

extern "C" int dpf_expand_head_host(const uint32_t* state, const uint32_t* ctrl,
                                    const uint32_t* cwp, const uint32_t* cwl,
                                    const uint32_t* cwr, uint32_t* out,
                                    uint32_t* out_ctrl, long long g0, long long kg,
                                    int r) {
  return run_subtrees_host<TiledOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, nullptr, out, out_ctrl, g0, kg, 0, g0, r, 0));
}

extern "C" int dpf_expand_tail_host(const uint32_t* state, const uint32_t* ctrl,
                                    const uint32_t* cwp, const uint32_t* cwl,
                                    const uint32_t* cwr, const uint32_t* vc,
                                    uint32_t* out, uint32_t* out_ctrl, long long g0,
                                    long long kg, long long tile, int r) {
  return run_subtrees_host<TiledOrder>(
      walk_args(state, ctrl, cwp, cwl, cwr, vc, out, out_ctrl, g0, kg, 0, tile, r, 1));
}
#endif
