// Hand-written CUDA for dense PIR's inner products (sm_90a): one count
// product of 0/1 matrices on the tensor cores' single-bit path, with two
// epilogues.
//
// Both kernels compute, over the records r = 32g + b of a bit-major staging,
//
//   C[q, j, w] = #{ r : bit b of sel[q, g] is 1 and bit j of db[b, g, w] is 1 }
//
// sel is uint32 [nq, G] packed (bit b of word g selects record 32g+b); db
// is the bit-major staging uint32 [32, G, W] (db[b, g] = record 32g+b,
// `ops/inner_product_kernels.py:permute_db_bitmajor`), bit row b starting
// b_stride words after row 0, so a span may be a group range of a larger
// staging.
//
// * K1 `xor_inner_product` replaces the TPU kernel `_ip_kernel_v2`
//   (distributed_point_functions_tpu/ops/inner_product_pallas.py:285), and
//   its accumulate entry `xor_inner_product_pallas2_accumulate` (:502):
//   out[q, w] bit j = C[q, j, w] & 1, XORed into out (zeroed first on the
//   stream unless the caller accumulates). Plain PyTorch version:
//   `ops/inner_product.py:xor_inner_product`.
// * K7 `xor_counts` replaces `_ip_kernel` (inner_product_pallas.py:130):
//   counts[q, j, w] = C[q, j, w], int32, added into counts (zeroed first).
//   Plain version: `ops/inner_product.py:xor_counts_plain`.
//
// What bounds them on this card. [nq, R] x [R, 32W] is 2 nq R 32W
// operations: as an int8 product at 1.979e15/s, 0.278 ms at 128 queries x
// 2^20 records x 256 B and at 1,024 x 2^17 x 256 B. The single-bit form
// (an AND and a count per bit pair) takes packed bits as its operands, so
// it needs no byte expansion; `tools/torch_b1_mma_probe.py` measured
// `wgmma.m64n256k256.b1` at 1.57e16/s, 7.9x the int8 peak, and
// `mma.sync.m16n8k256.b1` at 1.03e16/s. So the bound is 0.035 ms of
// products at either shape, or the packed bytes read once where more
// (0.085 ms at the first shape).
//
// Design. A block of two warpgroups owns a tile of 128 queries x 8 record
// words (256 value-bit columns, column n = 8j + w) and a span of record
// groups, walked 32 groups (1,024 records, 4 k256 steps) a stage:
//
// * Both operands sit in shared memory K-major, a row (query or column) of
//   128 bytes a stage (group g's word at byte 4g), in the 128-byte swizzle
//   `wgmma` reads: 16-byte chunk c of row r is stored at chunk c ^ (r % 8).
//   The same layout on both sides pairs each record of A with its record
//   of B, whatever order along K the hardware takes.
// * Copies: a ring of 3 slots in shared memory, two stages ahead of the
//   products, takes each stage's selection words as they are (bit b of
//   word g is record 32g+b; straight into their swizzled tile) and its
//   raw database words, [bit row 32][group 32][word 8], with `cp.async`,
//   16 bytes a copy where W, b_stride and the addresses allow, else 4
//   (zeros past the ragged edges). A warp's copies take whole 32-byte
//   runs: the 16 selection words of one query row are one run.
// * Database side: thread (group, word) reads the 32 words of its group
//   (records b = 0..31) from its slot and transposes them in registers
//   (`__byte_perm` for the 16- and 8-bit stages, shift-and-XOR swaps for
//   the rest), so that word j holds value bit j of the 32 records, and
//   stores them to column 8j + word of the columns' tile (conflict-free:
//   a warp's stores cover the 32 banks). Nothing unpacked reaches device
//   memory.
// * Products: warpgroup m owns queries 64m .. + 63 and all 256 columns,
//   one `wgmma.m64n256k256.s32.b1.b1.and.popc` a k256 step from the two
//   tiles' descriptors, 128 int32 accumulators a thread. A stage's
//   products run while the threads transpose the next stage's words; two
//   barriers a stage (the next stage's copies landed; its tiles written
//   and this stage's products waited for).
// * Spans: about one block per SM (the grid's z), combined with atomicAdd
//   (K7) or atomicXor of packed parity words (K1: a thread holds all 32
//   value bits of its 2 words in 2 rows): exact in any order, and the
//   parity of a sum is the XOR of the partial sums' parities, so K1 needs
//   no count bound (int32 wraps modulo 2^32).
//
// Why this form. An int8 `wgmma` design on operands expanded to 0/1 bytes
// on chip was built first: its byte expansion cost as much as its
// products. `mma.sync` b1 on the packed words, with fragments loaded by
// `ldmatrix`, came next (K1 0.236 ms): its products with their fragment
// loads ran at a third of that form's rate. `wgmma` b1 reads both tiles
// from shared memory itself, with no fragments in registers.
//
// What sets its pace (`tools/torch_count_product_probe.py`, PERF.md): the
// copies and the transposes, not the products. At the first shape K1
// takes 0.147 ms; without the products 0.136; with the products and the
// selection copies alone 0.070, twice the products' 0.035 ms at the b1
// `wgmma` rate; the database copies add 0.034 ms to the rest and the
// transposes 0.022. Copies of 4 bytes, or a copier that reads back only
// its own words (no barrier), took 0.25 ms; an L2 prefetch hint on the
// copies changed nothing.
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a): xor_ip_kernel 236 registers,
// xor_counts_kernel 232, no spills; 214,016 B of dynamic shared memory (2
// columns' tiles of 32 KB, 3 ring slots of 48 KB, and 1 KB to align
// them), one block per SM.
//
// The macros DPF_PACE_NO_PRODUCTS, DPF_PACE_NO_TRANSPOSES and
// DPF_PACE_NO_DB_LOADS take one part out, for
// `tools/torch_count_product_probe.py`, which times what sets the pace;
// the library's build defines none of them.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 2 warpgroups of 64 queries
constexpr int kTq = 128;       // queries per block tile
constexpr int kWt = 8;         // record words per block tile (256 columns)
constexpr int kGs = 32;        // record groups per stage: 4 k256 steps
constexpr int kRowWords = kGs;                 // a row of 128 bytes
constexpr int kBsWords = 32 * kWt * kRowWords;  // [column 256][group 32]
constexpr int kAsWords = kTq * kRowWords;       // [query 128][group 32]
constexpr int kRawWords = 32 * kGs * kWt;       // [bit 32][group 32][word 8]
// A ring slot holds a stage's selections (swizzled) and raw database words.
constexpr int kSlotWords = kAsWords + kRawWords;
constexpr int kSlots = 3;
constexpr int kSmemBytes = (2 * kBsWords + kSlots * kSlotWords) * 4 + 1024;

// Word (row r, group g) of a stage tile in the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int r, int g) {
  return r * kRowWords + ((((g >> 2) ^ r) & 7) << 2) + (g & 3);
}

// `wgmma`'s descriptor of a K-major tile in the 128-byte swizzle at a
// 1,024-byte boundary: 8-row atoms 1,024 bytes apart.
__device__ __forceinline__ uint64_t descriptor(const uint32_t* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// A 4-byte asynchronous copy into shared memory; zeros when !ok.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// A 16-byte asynchronous copy into shared memory; zeros when !ok.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += popc(A AND B) over 256 bits: A 64 x 256 and B 256 x 256 from their
// descriptors; d[4i + 2h + e] is row 16 (warp % 4) + lane / 4 + 8h, column
// 8i + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_b1(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
        "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
        "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving accesses to d across `wgmma`'s waits.
__device__ __forceinline__ void pin(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// x[i] bit j -> x[j] bit i: the 16- and 8-bit block swaps as byte
// permutations, the 4-, 2- and 1-bit ones as masked XOR swaps.
__device__ __forceinline__ void transpose32(uint32_t (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t a = x[i], b = x[i + 16];
    x[i] = __byte_perm(a, b, 0x5410u);
    x[i + 16] = __byte_perm(a, b, 0x7632u);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & 8) continue;
    const uint32_t a = x[i], b = x[i + 8];
    x[i] = __byte_perm(a, b, 0x6240u);
    x[i + 8] = __byte_perm(a, b, 0x7351u);
  }
  constexpr uint32_t kMasks[3] = {0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int s = 4 >> k;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & s) continue;
      const uint32_t t = ((x[i] >> s) ^ x[i + s]) & kMasks[k];
      x[i + s] ^= t;
      x[i] ^= t << s;
    }
  }
}

// One block: queries [q0, q0 + 128), words [w0, w0 + 8), groups
// [g_begin, g_end). kParity selects K1's epilogue, else K7's. db_vec:
// the database's words may be copied 16 bytes at a time (W, b_stride and
// db's address multiples of 4 words); sel_vec: the selections' (G and
// sel's address).
template <bool kParity>
__device__ __forceinline__ void count_product(
    const uint32_t* __restrict__ sel, const uint32_t* __restrict__ db,
    uint32_t* __restrict__ out, int nq, int g_total, int w_total,
    int64_t b_stride, int groups_per_block, bool db_vec, bool sel_vec) {
  extern __shared__ __align__(16) uint32_t smem_raw[];
  // [2][columns' tile], then [kSlots][queries' tile, raw words], at a
  // 1,024-byte boundary.
  uint32_t* const smem =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023) / 4;
  uint32_t* const slots = smem + 2 * kBsWords;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = blockIdx.x * kWt;
  const int q0 = blockIdx.y * kTq;
  const int g_begin = blockIdx.z * groups_per_block;
  const int g_end = min(g_total, g_begin + groups_per_block);
  const int stages = (g_end - g_begin + kGs - 1) / kGs;

  // Copying: stage s's selections (row q, groups along the lanes) and raw
  // database words ([b][g][w], w fastest) into ring slot s % kSlots, 16
  // bytes a copy where the operands allow.
  auto copy_stage = [&](int s) {
    uint32_t* const slot = slots + (s % kSlots) * kSlotWords;
    const int gs = g_begin + s * kGs;
    if (sel_vec) {
#pragma unroll
      for (int i = 0; i < kAsWords / 4 / kThreads; ++i) {
        const int c = tid + kThreads * i;  // groups 4 (c % 8) .. + 3 of row c / 8
        const int q = c >> 3, g = gs + 4 * (c & 7);
        const bool ok = q0 + q < nq && g < g_end;
        cp_async16(slot + swizzled(q, 4 * (c & 7)),
                   ok ? sel + static_cast<int64_t>(q0 + q) * g_total + g : sel, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAsWords / kThreads; ++i) {
        const int c = tid + kThreads * i;
        const int q = c >> 5, g = gs + (c & 31);
        const bool ok = q0 + q < nq && g < g_end;
        cp_async4(slot + swizzled(q, c & 31),
                  ok ? sel + static_cast<int64_t>(q0 + q) * g_total + g : sel, ok);
      }
    }
#ifndef DPF_PACE_NO_DB_LOADS
    uint32_t* const raw = slot + kAsWords;
    if (db_vec) {
#pragma unroll
      for (int i = 0; i < kRawWords / 4 / kThreads; ++i) {
        const int c = tid + kThreads * i;  // words 4c .. 4c + 3
        const int w = 4 * (c & 1), g = gs + ((c >> 1) & 31), b = c >> 6;
        const bool ok = g < g_end && w0 + w < w_total;
        cp_async16(raw + 4 * c,
                   ok ? db + b * b_stride + static_cast<int64_t>(g) * w_total + w0 + w : db,
                   ok);
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < kRawWords / kThreads; ++i) {
        const int c = tid + kThreads * i;
        const int w = c & 7, g = gs + ((c >> 3) & 31), b = c >> 8;
        const bool ok = g < g_end && w0 + w < w_total;
        cp_async4(raw + c,
                  ok ? db + b * b_stride + static_cast<int64_t>(g) * w_total + w0 + w : db,
                  ok);
      }
    }
#endif
    cp_async_commit();
  };
  // Transposing: thread (group t_g, word t_w) turns the 32 words of its
  // group (records b = 0..31) into value bits j and stores them to
  // column 8j + t_w of stage s's columns' tile (conflict-free: a warp's
  // lanes cover the 32 banks).
  const int t_w = tid & 7;
  const int t_g = tid >> 3;
  auto transpose_stage = [&](int s) {
    const uint32_t* const raw = slots + (s % kSlots) * kSlotWords + kAsWords;
    uint32_t x[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) x[b] = raw[b * kGs * kWt + tid];
#ifndef DPF_PACE_NO_TRANSPOSES
    transpose32(x);
#endif
    uint32_t* const bs = smem + (s & 1) * kBsWords;
#pragma unroll
    for (int j = 0; j < 32; ++j) bs[swizzled(8 * j + t_w, t_g)] = x[j];
  };
  // Shared-memory writes made visible to `wgmma` (the async proxy) by the
  // barrier that follows.
  auto fence_async = []() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };

  // Products: warpgroup wg owns queries 64 wg .. + 63, all columns.
  const int wg = tid / 128;
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  pin(d);

  // Two stages' copies ahead of the products; a stage's transposes run
  // while the previous stage's products do.
  copy_stage(0);
  if (stages > 1) {
    copy_stage(1);
  } else {
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();
  transpose_stage(0);
  fence_async();
  __syncthreads();
  for (int it = 0; it < stages; ++it) {
    // Slot (it + 2) % kSlots was last read by stage it - 1's transposes
    // and products, both before the last barrier.
    if (it + 2 < stages) {
      copy_stage(it + 2);
    } else {
      cp_async_commit();
    }
    const uint64_t a =
        descriptor(slots + (it % kSlots) * kSlotWords + 64 * wg * kRowWords);
    const uint64_t b = descriptor(smem + (it & 1) * kBsWords);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#ifndef DPF_PACE_NO_PRODUCTS
#pragma unroll
    for (int kk = 0; kk < kGs / 8; ++kk) {
      // k256 step kk: bytes 32 kk .. + 31 of every row (groups 8 kk .. + 7);
      // the descriptor's address counts 16 bytes.
      wgmma_b1(d, a + 2 * kk, b + 2 * kk);
    }
#endif
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it + 1 < stages) {
      cp_async_wait<1>();  // stage it + 1's copies, from every thread
      __syncthreads();
      transpose_stage(it + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(d);
    fence_async();
    __syncthreads();
  }

  // Epilogue: d[4j + 2h + e] is query 64 wg + 16 (warp % 4) + lane / 4 + 8h,
  // value bit j of word w0 + 2 (lane % 4) + e.
  const int q_base = q0 + 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
  const int w_base = w0 + 2 * (lane % 4);
  if (kParity) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q_base + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          word |= (static_cast<uint32_t>(d[4 * j + 2 * h + e]) & 1u) << j;
        }
        const int w = w_base + e;
        if (q < nq && w < w_total && word != 0u) {
          atomicXor(out + static_cast<int64_t>(q) * w_total + w, word);
        }
      }
    }
  } else {
    int32_t* const counts = reinterpret_cast<int32_t*>(out);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = q_base + 8 * (r / 2);
        const int w = w_base + r % 2;
        if (q < nq && w < w_total && d[4 * j + r] != 0) {
          atomicAdd(counts + (static_cast<int64_t>(q) * 32 + j) * w_total + w,
                    d[4 * j + r]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
xor_ip_kernel(const uint32_t* __restrict__ sel, const uint32_t* __restrict__ db,
              uint32_t* __restrict__ out, int nq, int g_total, int w_total,
              int64_t b_stride, int groups_per_block, bool db_vec, bool sel_vec) {
  count_product<true>(sel, db, out, nq, g_total, w_total, b_stride,
                      groups_per_block, db_vec, sel_vec);
}

__global__ void __launch_bounds__(kThreads, 1)
xor_counts_kernel(const uint32_t* __restrict__ sel, const uint32_t* __restrict__ db,
                  uint32_t* __restrict__ counts, int nq, int g_total, int w_total,
                  int64_t b_stride, int groups_per_block, bool db_vec, bool sel_vec) {
  count_product<false>(sel, db, counts, nq, g_total, w_total, b_stride,
                       groups_per_block, db_vec, sel_vec);
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, int, int,
                        int, int64_t, int, bool, bool);

// Allows kKernel its dynamic shared memory, above the 48 KB default, once
// per device.
template <Kernel kKernel>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];  // zeroed: static storage
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && device < kMaxDevices) {
    done[device].store(true, std::memory_order_relaxed);
  }
  return err;
}

// Zeroes out (out_words words) unless accumulating, then launches one
// block per (word tile, query tile, group span), with about one block per
// SM over all tiles.
template <Kernel kKernel>
int launch(const uint32_t* sel, const uint32_t* db, uint32_t* out, long long nq,
           long long g_total, long long w_total, long long b_stride,
           long long out_words, bool accumulate, int num_sms, cudaStream_t st) {
  if (!accumulate) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(out_words) * sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nq <= 0 || g_total <= 0 || w_total <= 0) return 0;
  cudaError_t err = allow_smem<kKernel>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long w_tiles = (w_total + kWt - 1) / kWt;
  const long long q_tiles = (nq + kTq - 1) / kTq;
  long long spans = num_sms / (w_tiles * q_tiles);
  const long long max_spans = (g_total + kGs - 1) / kGs;
  if (spans < 1) spans = 1;
  if (spans > max_spans) spans = max_spans;
  long long per = (g_total + spans - 1) / spans;
  per = ((per + kGs - 1) / kGs) * kGs;
  spans = (g_total + per - 1) / per;
  const bool db_vec = w_total % 4 == 0 && b_stride % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(db) % 16 == 0;
  const bool sel_vec = g_total % 4 == 0 && reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  dim3 grid(static_cast<unsigned>(w_tiles), static_cast<unsigned>(q_tiles),
            static_cast<unsigned>(spans));
  kKernel<<<grid, kThreads, kSmemBytes, st>>>(
      sel, db, out, static_cast<int>(nq), static_cast<int>(g_total),
      static_cast<int>(w_total), static_cast<int64_t>(b_stride),
      static_cast<int>(per), db_vec, sel_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. out must hold nq * w_total words. Unless `accumulate` is set it is
// zeroed here on `stream` first; with it, the product is XORed into out as
// it is. sel holds at least nq rows of g_total words; db's bit row b
// starts at db + b * b_stride.
extern "C" int dpf_xor_inner_product(const uint32_t* sel, const uint32_t* db,
                                     uint32_t* out, long long nq,
                                     long long g_total, long long w_total,
                                     long long b_stride, int accumulate,
                                     int num_sms, void* stream) {
  return launch<xor_ip_kernel>(sel, db, out, nq, g_total, w_total, b_stride,
                               nq * w_total, accumulate != 0, num_sms,
                               static_cast<cudaStream_t>(stream));
}

// K7. counts must hold nq * 32 * w_total int32; it is zeroed here on
// `stream` first. sel holds nq rows of g_total words; db is
// [32, g_total, w_total].
extern "C" int dpf_xor_counts(const uint32_t* sel, const uint32_t* db,
                              int32_t* counts, long long nq, long long g_total,
                              long long w_total, int num_sms, void* stream) {
  return launch<xor_counts_kernel>(sel, db, reinterpret_cast<uint32_t*>(counts),
                                   nq, g_total, w_total, g_total * w_total,
                                   nq * 32 * w_total, false, num_sms,
                                   static_cast<cudaStream_t>(stream));
}
