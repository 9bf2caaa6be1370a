// Hand-written CUDA that leaves plane layout for dense PIR's selections
// (sm_90a).
//
// `leaf_blocks` turns the leaf values of one expansion, int32[16, 8, G] bit
// planes in node-major word columns (column c = node * KG + key group, bit
// i of a word = key 32 * group + i), into the selection blocks the inner
// product reads, int32[32 KG, B, 4] key-major:
//
//   out[32 g + i, node_block[n], l] bit t = bit i of plane 32 l + t,
//                                           column n * KG + g
//
// for every node n with 0 <= node_block[n] < B (the expansion's exit
// order: node n holds natural block node_block[n]; -1 drops a leaf past
// the block count). Blocks that no node holds keep the zeros the wrapper
// writes. It is the 32x32 bit transpose, the exit gather and the
// key-major transpose of the plain version in one pass, so the only
// selection-sized buffers alive are the leaf values and the result. It has
// no TPU kernel of its own: the JAX package does the same in XLA
// (`planes_to_limbs` and a gather in `pir/dense_eval_planes.py`).
//
// Design: a block of 32 warps stages the 128 planes of 32 consecutive
// columns in shared memory (coalesced 128-byte rows), then warp w
// transposes column w: lane t holds plane 32 l + t, and ballot j of bit j
// is key j's limb l. Lane j stores its key's four limbs as one 16-byte
// word. Bound on this card: bytes (each plane word read once, each
// selection word written once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;    // word columns per block, one per warp
constexpr int kPlanes = 128;

__global__ void __launch_bounds__(kCols * 32)
leaf_blocks_kernel(const uint32_t* __restrict__ planes,
                   const int32_t* __restrict__ node_block,
                   uint32_t* __restrict__ out, long long g, long long kg,
                   long long num_blocks) {
  __shared__ uint32_t tile[kPlanes][kCols + 1];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kCols;
  if (c0 + lane < g) {
    for (int p = warp; p < kPlanes; p += kCols) {
      tile[p][lane] = planes[p * g + c0 + lane];
    }
  }
  __syncthreads();
  const long long c = c0 + warp;
  if (c >= g) return;
  const int block = node_block[c / kg];
  if (block < 0 || block >= num_blocks) return;
  uint32_t limb[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const uint32_t v = tile[32 * l + lane][warp];
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t bits = __ballot_sync(0xffffffffu, (v >> j) & 1u);
      if (lane == j) mine = bits;
    }
    limb[l] = mine;
  }
  const long long key = (c % kg) * 32 + lane;
  reinterpret_cast<uint4*>(out)[key * num_blocks + block] =
      make_uint4(limb[0], limb[1], limb[2], limb[3]);
}

}  // namespace

// planes: [128, g] words; node_block: [g / kg]; out: [32 kg, num_blocks, 4].
extern "C" int dpf_leaf_blocks(const uint32_t* planes, const int32_t* node_block,
                               uint32_t* out, long long g, long long kg,
                               long long num_blocks, void* stream) {
  if (g == 0) return 0;
  const long long blocks = (g + kCols - 1) / kCols;
  leaf_blocks_kernel<<<static_cast<unsigned>(blocks), dim3(32, kCols), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      planes, node_block, out, g, kg, num_blocks);
  return static_cast<int>(cudaGetLastError());
}
