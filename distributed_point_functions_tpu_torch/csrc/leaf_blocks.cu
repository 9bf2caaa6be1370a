// Hand-written CUDA that leaves plane layout for dense PIR's selections
// (sm_90a).
//
// `leaf_blocks` turns the leaf values of one expansion, int32[16, 8, G] bit
// planes in node-major word columns (column c = node * KG + key group, bit
// i of a word = key 32 * group + i), into the selection blocks the inner
// product reads, int32[32 KG, B, 4] key-major:
//
//   out[32 g + i, b, l] bit t = bit i of plane 32 l + t,
//                               column block_node[b] * KG + g
//
// and zero where block_node[b] is -1 (a block that no leaf holds). The
// host gives block_node, the inverse of the expansion's exit order; it
// depends on the shape only and is public, so indexing by it leaks
// nothing. It is the 32x32 bit transpose, the exit gather and the
// key-major transpose of the plain version (`ops/expand_planes.py:
// leaf_blocks_plain`) in one pass, so the only selection-sized buffers
// alive are the leaf values and the result. It has no TPU kernel of its
// own: the JAX package does the same in XLA (`planes_to_limbs` and a
// gather, `pir/dense_eval_planes.py:1630-1647`).
//
// What bounds it on this card: bytes (each plane word read once, each
// selection word written once, zero blocks included). The first design
// (one warp a word column, 32 ballots a limb, each lane storing its key's
// 16 B at rows B x 16 B apart, a memset first) ran at 17% of that bound:
// ~96 warp instructions per 32 words, half-used sectors on every store,
// and an extra pass for the zeros.
//
// Design: the launch is driven by output blocks. A thread block of 256
// threads owns a tile of T consecutive blocks across KGt key groups (T *
// KGt word columns: 32 at KG < 32, where a node's plane row is narrow, so
// the main path's tiles (KG = 4) hold 8 blocks; 64 from KG = 32, two
// blocks of 128-byte rows):
// 1. it gathers the tile's plane rows into shared memory, consecutive
//    threads on consecutive words of a node's row, 16 bytes a thread where
//    KG is a multiple of 4 (zeros for a block that no node holds, or past
//    B);
// 2. each warp transposes its columns' 32x32 bit squares (one square a
//    limb) with a 5-stage `__shfl_xor_sync` butterfly (~25 instructions per
//    32 words), holding the results in registers;
// 3. after a barrier it writes them into the same shared memory as
//    key-major rows of T x 16 B (padded so the 16-byte writes hit
//    distinct banks);
// 4. it stores each key row's 16 * T contiguous bytes, 16 B a thread,
//    neighbouring threads on neighbouring addresses.
// Every output word is written by the kernel: the wrapper allocates with
// torch.empty.
//
// Measured on an H100 80GB HBM3 at 700 W (the tile widths and the block
// size chosen among 16-128 columns and 128-512 threads by
// tools/torch_level_leaf_probe.py on variants of this source; then
// chip_smoke.py; PERF.md): 1.41x the byte bound at the
// main path (0.0142 ms), 1.72x at a chunk (0.0173), 1.41x at the
// materialized tier (0.453); 2.01x (0.0201) in the main path's
// bit-reversed orders (tail and level modes), where a node's 16-byte row
// fills half a 32-byte sector and the other half belongs to a tile half a
// launch away, so the loads move twice the bytes through L2 (reckoned from
// the layout, not counted). `nvcc
// -Xptxas -v` (CUDA 12.8, sm_90a): 32 registers (32-column tiles) and 48
// (64-column), no spills.
//
// Built by ops/cuda_lib.py with nvcc for sm_90a into the kernel library.
// Without __CUDACC__ (a host C++ compiler) the same phases build into
// `dpf_leaf_blocks_host`: a warp's 32 lanes run in lockstep, an array
// standing in for the shuffles, and a block's phases run in the kernel's
// barrier order, so the CPU tests hold the code the card runs.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LB_UNROLL _Pragma("unroll")
#else
#include <vector>
#define __device__
#define __forceinline__ inline
#define LB_UNROLL
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 128;

// Word columns a tile, at most: 32 where a node's plane row is narrow (KG
// < 32: the main path's tiles hold 8 blocks of 16-byte rows), 64 where it
// is 128 bytes (KG = 32: two blocks). Each was the faster at its shapes
// on the H100 (PERF.md).
int tile_cols(int64_t kg) { return kg >= 32 ? 64 : 32; }

// Columns a warp transposes, at most, in a tile of kMaxCols.
template <int kMaxCols>
constexpr int kHeldCols = (kMaxCols + kWarps - 1) / kWarps;

struct LeafArgs {
  const uint32_t* planes;
  const int32_t* block_node;
  uint32_t* out;
  int64_t g, kg, num_blocks, nodes;
  int kgt, t, cols;  // key groups, blocks and word columns of a tile
};

LeafArgs leaf_args(const uint32_t* planes, const int32_t* block_node, uint32_t* out,
                   int64_t g, int64_t kg, int64_t num_blocks) {
  const int max_cols = tile_cols(kg);
  const int kgt = static_cast<int>(kg < max_cols / 2 ? kg : max_cols / 2);
  const int t = max_cols / kgt;
  return {planes, block_node, out, g, kg, num_blocks, g / kg, kgt, t, kgt * t};
}

// Words of the tile in each layout: [128][cols + 1] planes, then [32 KGt]
// key rows of 4 (T + 1) words.
__device__ __forceinline__ int in_stride(const LeafArgs& a) { return a.cols + 1; }
__device__ __forceinline__ int row_stride(const LeafArgs& a) { return 4 * (a.t + 1); }
int64_t tile_words(const LeafArgs& a) {
  const int64_t in = int64_t{kPlanes} * (a.cols + 1);
  const int64_t rows = int64_t{32} * a.kgt * 4 * (a.t + 1);
  return in > rows ? in : rows;
}

// The lanes of one warp: on the card one thread, lane `lane`; on the host
// all 32 in lockstep.
#ifdef __CUDACC__
struct DeviceWarp {
  static constexpr int K = 1;
  int lane;
  template <class F>
  __device__ __forceinline__ void each(F&& f) const { f(lane, 0); }
  // dst = src of lane ^ s.
  __device__ __forceinline__ void xor_pull(uint32_t (&dst)[1], const uint32_t (&src)[1],
                                           int s) const {
    dst[0] = __shfl_xor_sync(0xffffffffu, src[0], s);
  }
};
#endif

struct HostWarp {
  static constexpr int K = 32;
  template <class F>
  void each(F&& f) const {
    for (int t = 0; t < 32; ++t) f(t, t);
  }
  void xor_pull(uint32_t (&dst)[32], const uint32_t (&src)[32], int s) const {
    for (int t = 0; t < 32; ++t) dst[t] = src[t ^ s];
  }
};

// Lane t holds row t of a 32x32 bit square (bit i = column i); after it,
// lane i holds column i (bit t = row t's bit i). Stage s swaps the
// off-diagonal s x s blocks of every 2s x 2s block: the lower lane of a
// pair keeps its low halves and takes its partner's low halves shifted
// up, the upper lane keeps its high halves and takes its partner's high
// halves shifted down.
template <class Wp>
__device__ __forceinline__ void transpose32(const Wp& wp, uint32_t (&x)[Wp::K]) {
  LB_UNROLL
  for (int stage = 0; stage < 5; ++stage) {
    const int s = 16 >> stage;
    const uint32_t low = 0xffffffffu / ((1u << s) + 1u);  // 0x0000ffff .. 0x55555555
    uint32_t send[Wp::K], got[Wp::K];
    wp.each([&](int t, int k) { send[k] = (t & s) ? x[k] << s : x[k] >> s; });
    wp.xor_pull(got, send, s);
    wp.each([&](int t, int k) {
      const uint32_t keep = (t & s) ? ~low : low;
      x[k] = (x[k] & keep) | (got[k] & ~keep);
    });
  }
}

// 0. The tile's nodes: -1 for a block that no node holds or past B.
__device__ __forceinline__ void leaf_nodes(const LeafArgs& a, int* node, int64_t b0,
                                           int first, int step) {
  for (int j = first; j < a.t; j += step) {
    const int64_t b = b0 + j;
    const int32_t n = b < a.num_blocks ? a.block_node[b] : -1;
    node[j] = n >= 0 && n < a.nodes ? n : -1;
  }
}

// 1. The plane rows in: thread `tid` takes column tid % cols of the planes
// tid / cols, tid / cols + threads / cols, ...
__device__ __forceinline__ void leaf_load(const LeafArgs& a, uint32_t* tile,
                                          const int* node, int64_t g0, int tid,
                                          int threads) {
  const int col = tid % a.cols;
  const int step = threads / a.cols;
  const int n = node[col / a.kgt];
  const int64_t grp = g0 + col % a.kgt;
  const bool held = n >= 0 && grp < a.kg;
  const uint32_t* src = a.planes + (held ? n * a.kg + grp : 0);
  const int s = in_stride(a);
  for (int p = tid / a.cols; p < kPlanes; p += step) {
    tile[p * s + col] = held ? src[p * a.g] : 0u;
  }
}

// 1, with 16-byte loads (KG and KGt multiples of 4): thread `tid` takes
// the four columns 4 (tid % (cols / 4)) .. of the planes tid / (cols / 4),
// ...
__device__ __forceinline__ void leaf_load4(const LeafArgs& a, uint32_t* tile,
                                           const int* node, int64_t g0, int tid,
                                           int threads) {
  const int quads = a.cols / 4;
  const int col = 4 * (tid % quads);
  const int step = threads / quads;
  const int n = node[col / a.kgt];
  const int64_t grp = g0 + col % a.kgt;
  const bool held = n >= 0 && grp < a.kg;
  const uint32_t* src = a.planes + (held ? n * a.kg + grp : 0);
  const int s = in_stride(a);
  for (int p = tid / quads; p < kPlanes; p += step) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (held) {
#ifdef __CUDACC__
      const uint4 v = *reinterpret_cast<const uint4*>(src + p * a.g);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
#else
      for (int e = 0; e < 4; ++e) w[e] = src[p * a.g + e];
#endif
    }
    LB_UNROLL
    for (int e = 0; e < 4; ++e) tile[p * s + col + e] = w[e];
  }
}

__device__ __forceinline__ bool leaf_quads(const LeafArgs& a) {
  return a.kg % 4 == 0 && a.kgt % 4 == 0;
}

// 2. Warp w transposes columns w, w + warps, ... (four squares each, one a
// limb) into `held`: lane i then holds key i's four limbs of the column.
template <int kMaxCols, class Wp>
__device__ __forceinline__ void leaf_transpose(
    const LeafArgs& a, const Wp& wp, const uint32_t* tile, int w,
    uint32_t (&held)[kHeldCols<kMaxCols>][4][Wp::K]) {
  const int s = in_stride(a);
  LB_UNROLL
  for (int h = 0; h < kHeldCols<kMaxCols>; ++h) {
    const int col = w + h * kWarps;
    if (col >= a.cols) break;
    LB_UNROLL
    for (int l = 0; l < 4; ++l) {
      uint32_t x[Wp::K];
      wp.each([&](int t, int k) { x[k] = tile[(32 * l + t) * s + col]; });
      transpose32(wp, x);
      wp.each([&](int, int k) { held[h][l][k] = x[k]; });
    }
  }
}

// 3. The held limbs out as key rows: key i of group column % KGt, block
// column / KGt, 16 bytes at word 4 * block of its row.
template <int kMaxCols, class Wp>
__device__ __forceinline__ void leaf_rows(
    const LeafArgs& a, const Wp& wp, uint32_t* tile, int w,
    const uint32_t (&held)[kHeldCols<kMaxCols>][4][Wp::K]) {
  const int r = row_stride(a);
  LB_UNROLL
  for (int h = 0; h < kHeldCols<kMaxCols>; ++h) {
    const int col = w + h * kWarps;
    if (col >= a.cols) break;
    const int j = col / a.kgt;
    const int grp = col % a.kgt;
    wp.each([&](int i, int k) {
      uint32_t* dst = tile + (32 * grp + i) * r + 4 * j;
#ifdef __CUDACC__
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(held[h][0][k], held[h][1][k], held[h][2][k], held[h][3][k]);
#else
      for (int l = 0; l < 4; ++l) dst[l] = held[h][l][k];
#endif
    });
  }
}

// 4. The key rows out: thread `tid` takes block tid % T of the rows
// tid / T, tid / T + threads / T, ...; a row's T blocks are 16 T
// contiguous bytes of the output.
__device__ __forceinline__ void leaf_store(const LeafArgs& a, const uint32_t* tile,
                                           int64_t b0, int64_t g0, int tid, int threads) {
  const int j = tid % a.t;
  const int step = threads / a.t;
  if (tid >= step * a.t || b0 + j >= a.num_blocks) return;
  const int r = row_stride(a);
  const int64_t kg_left = a.kg - g0;
  const int rows = 32 * static_cast<int>(kg_left < a.kgt ? kg_left : a.kgt);
  for (int row = tid / a.t; row < rows; row += step) {
    const int64_t key = 32 * g0 + row;
    const uint32_t* src = tile + row * r + 4 * j;
    uint32_t* dst = a.out + (key * a.num_blocks + b0 + j) * 4;
#ifdef __CUDACC__
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
    for (int l = 0; l < 4; ++l) dst[l] = src[l];
#endif
  }
}

#ifdef __CUDACC__
template <int kMaxCols>
__global__ void __launch_bounds__(kThreads) leaf_blocks_kernel(const LeafArgs a) {
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ int node[kMaxCols];
  const int tid = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * a.t;
  const int64_t g0 = static_cast<int64_t>(blockIdx.y) * a.kgt;
  leaf_nodes(a, node, b0, tid, kThreads);
  __syncthreads();
  if (leaf_quads(a)) {
    if (tid < kThreads / (a.cols / 4) * (a.cols / 4)) leaf_load4(a, tile, node, g0, tid, kThreads);
  } else if (tid < kThreads / a.cols * a.cols) {
    leaf_load(a, tile, node, g0, tid, kThreads);
  }
  __syncthreads();
  const DeviceWarp wp{tid % 32};
  uint32_t held[kHeldCols<kMaxCols>][4][1];
  leaf_transpose<kMaxCols>(a, wp, tile, tid / 32, held);
  __syncthreads();
  leaf_rows<kMaxCols>(a, wp, tile, tid / 32, held);
  __syncthreads();
  leaf_store(a, tile, b0, g0, tid, kThreads);
}
#endif

}  // namespace

#ifdef __CUDACC__
// planes: [128, g] words; block_node: [num_blocks]; out: [32 kg,
// num_blocks, 4].
extern "C" int dpf_leaf_blocks(const uint32_t* planes, const int32_t* block_node,
                               uint32_t* out, long long g, long long kg,
                               long long num_blocks, void* stream) {
  if (g == 0 || num_blocks == 0) return 0;
  if (kg < 1 || g % kg) return static_cast<int>(cudaErrorInvalidValue);
  const LeafArgs a = leaf_args(planes, block_node, out, g, kg, num_blocks);
  const bool wide = tile_cols(kg) == 64;
  const void* kernel = wide ? reinterpret_cast<const void*>(leaf_blocks_kernel<64>)
                            : reinterpret_cast<const void*>(leaf_blocks_kernel<32>);
  const size_t smem = static_cast<size_t>(tile_words(a)) * 4;
  if (smem + 64 * sizeof(int) > 48 * 1024) {  // past the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((num_blocks + a.t - 1) / a.t),
                  static_cast<unsigned>((kg + a.kgt - 1) / a.kgt));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    leaf_blocks_kernel<64><<<grid, kThreads, smem, st>>>(a);
  } else {
    leaf_blocks_kernel<32><<<grid, kThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
#else
namespace {

// The blocks one after another, each phase over all of a block's threads
// or warps before the next (the barriers of the kernel).
template <int kMaxCols>
void leaf_blocks_host(const LeafArgs& a) {
  std::vector<uint32_t> tile(tile_words(a));
  std::vector<int> node(kMaxCols);
  struct Held {
    uint32_t v[kHeldCols<kMaxCols>][4][HostWarp::K];
  };
  std::vector<Held> held(kWarps);
  const HostWarp wp;
  for (int64_t g0 = 0; g0 < a.kg; g0 += a.kgt) {
    for (int64_t b0 = 0; b0 < a.num_blocks; b0 += a.t) {
      leaf_nodes(a, node.data(), b0, 0, 1);
      if (leaf_quads(a)) {
        for (int tid = 0; tid < kThreads / (a.cols / 4) * (a.cols / 4); ++tid) {
          leaf_load4(a, tile.data(), node.data(), g0, tid, kThreads);
        }
      } else {
        for (int tid = 0; tid < kThreads / a.cols * a.cols; ++tid) {
          leaf_load(a, tile.data(), node.data(), g0, tid, kThreads);
        }
      }
      for (int w = 0; w < kWarps; ++w) leaf_transpose<kMaxCols>(a, wp, tile.data(), w, held[w].v);
      for (int w = 0; w < kWarps; ++w) leaf_rows<kMaxCols>(a, wp, tile.data(), w, held[w].v);
      for (int tid = 0; tid < kThreads; ++tid) leaf_store(a, tile.data(), b0, g0, tid, kThreads);
    }
  }
}

}  // namespace

extern "C" int dpf_leaf_blocks_host(const uint32_t* planes, const int32_t* block_node,
                                    uint32_t* out, long long g, long long kg,
                                    long long num_blocks) {
  if (g == 0 || num_blocks == 0) return 0;
  if (kg < 1 || g % kg) return 1;
  const LeafArgs a = leaf_args(planes, block_node, out, g, kg, num_blocks);
  if (tile_cols(kg) == 64) {
    leaf_blocks_host<64>(a);
  } else {
    leaf_blocks_host<32>(a);
  }
  return 0;
}
#endif
