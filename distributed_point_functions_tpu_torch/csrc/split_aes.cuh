// The split AES of K4 (expand_fused.cu) and K8 (path_level.cu): the
// bitsliced AES-128 of one 32-lane word column carried by a group of 16
// threads instead of one.
//
// Thread j of a group holds state byte j: planes 8j .. 8j + 7, slice index
// b = plane - 8j. SubBytes is its S-box in registers; ShiftRows+MixColumns
// gather the column's bytes with 24 shuffles inside the group
// (`mix_byte`); sigma swaps bytes j and j ^ 8. The serial chain of one AES
// is a sixteenth of the one-thread AES's, and the state plus sigma take 16
// registers.
//
// Why 16 threads: a group of 4 (one AES column a thread, MixColumns
// local) was slower at every width K4 and K8 launch, from 1 to 2^20 word
// columns on the H100 (PERF.md): its chain is four times as long, and its
// larger slice a thread halves the warps an SM holds.
//
// Constant time: the AES stays bitsliced and branch-free. A round key
// enters as plane masks (every plane of a lane XORs its key bit), read
// from a shared-memory table indexed by round, plane and the thread's
// place in its group only; the select-key form mixes the left and right
// masks with the lane's select word, `(kl & ~sel) | (kr & sel)`. No table
// is ever indexed by seed, path or control data: the seeds are secret
// shares, and a lookup at a secret index (a T-table AES in shared memory)
// leaks them through bank conflicts and timing. Every later change to
// these kernels keeps that rule.
//
// The same code runs on the host (no __CUDACC__): a `HostLanes` group runs
// its 16 slices in lockstep, an array standing in for `__shfl_sync`, so
// the CPU tests hold the split body against the one-thread AES and the JAX
// package. Every step is written once, over a lanes policy `Ln`: `Ln::K`
// slices are held (1 on the card, 16 on the host), `each` runs a step on
// each held slice and `pull` is the exchange.

#pragma once

#include "expand_body.cuh"

namespace split {

constexpr int kGroup = 16;  // threads a word column
constexpr int kSlice = 8;   // planes a thread: one state byte

// A shared-memory table of plane masks per key: [round][row] words, row =
// tile_row(plane) so that a group's threads read consecutive words.
constexpr int kKeyWords = 11 * 128;

// The row of `plane` in a group-ordered table or tile: thread j's slice
// index b at row b * 16 + j.
__device__ __forceinline__ int tile_row(int plane) {
  return (plane % kSlice) * kGroup + plane / kSlice;
}

// Words a row of a tile of `cols` columns takes: at least `cols`, and
// congruent to 2 mod 32, so that the two groups of a warp writing their
// slices into consecutive columns hit 32 different banks.
__host__ __device__ constexpr int tile_stride(int cols) {
  return ((cols - 2 + 31) / 32) * 32 + 2;
}

#ifdef __CUDACC__
// On the card: one thread, lane j of its group; its slice in registers.
// Every lane of the warp takes part in every exchange (a full-warp
// shuffle: a partial mask costs a warp-synchronisation sequence around
// each one), so a warp runs its groups together or not at all.
struct DeviceLanes {
  static constexpr int K = 1;
  int j;  // the thread's index in its group
  template <class F>
  __device__ __forceinline__ void each(F&& f) const { f(j, 0); }
  // dst[b] = src[b] of lane from(j).
  template <int N, class F>
  __device__ __forceinline__ void pull(uint32_t (&dst)[1][N],
                                       const uint32_t (&src)[1][N], F from) const {
    const int lane = from(j);
    DPF_UNROLL
    for (int b = 0; b < N; ++b) {
      dst[0][b] = __shfl_sync(0xffffffffu, src[0][b], lane, kGroup);
    }
  }
};
#endif

// On the host: the 16 lanes of one group in lockstep.
struct HostLanes {
  static constexpr int K = kGroup;
  template <class F>
  void each(F&& f) const {
    for (int j = 0; j < kGroup; ++j) f(j, j);
  }
  template <int N, class F>
  void pull(uint32_t (&dst)[kGroup][N], const uint32_t (&src)[kGroup][N],
            F from) const {
    for (int j = 0; j < kGroup; ++j) {
      for (int b = 0; b < N; ++b) dst[j][b] = src[from(j)][b];
    }
  }
};

// Fill `keys` with the plane masks of key ids `first`, `first` + 1, ...
// (`count` tables of kKeyWords): the threads of a block, thread `t` of
// `step`.
__device__ __forceinline__ void fill_keys(uint32_t* keys, int first, int count,
                                          int t, int step) {
  for (int i = t; i < count * 11 * 16; i += step) {  // one key byte each
    const int rnd = (i / 16) % 11;
    const uint32_t byte = kRoundKeyBytes[first + i / (11 * 16)][rnd][i % 16];
    uint32_t* table = keys + (i / (11 * 16)) * kKeyWords + rnd * 128;
    DPF_UNROLL
    for (int bit = 0; bit < 8; ++bit) {
      table[tile_row(8 * (i % 16) + bit)] = 0u - ((byte >> bit) & 1u);
    }
  }
}

template <bool kSelect, class Ln>
__device__ __forceinline__ void add_round_key(
    const Ln& ln, uint32_t (&s)[Ln::K][kSlice], const uint32_t* kl,
    const uint32_t* kr, const uint32_t (&sel)[Ln::K], int rnd) {
  ln.each([&](int j, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) {
      const int w = rnd * 128 + b * kGroup + j;
      if constexpr (kSelect) {
        s[x][b] ^= (kl[w] & ~sel[x]) | (kr[w] & sel[x]);
      } else {
        s[x][b] ^= kl[w];
      }
    }
  });
}

template <class Ln>
__device__ __forceinline__ void sub_bytes(const Ln& ln, uint32_t (&s)[Ln::K][kSlice]) {
  ln.each([&](int, int x) {
    sbox_tower(s[x][0], s[x][1], s[x][2], s[x][3], s[x][4], s[x][5], s[x][6], s[x][7]);
  });
}

// ShiftRows, then MixColumns unless `last`: thread j = 4c + r pulls its
// shifted byte a and a_{r+1}, then the pair sum of row r + 2.
template <class Ln>
__device__ __forceinline__ void shift_rows_mix(const Ln& ln, uint32_t (&s)[Ln::K][kSlice],
                                               bool last) {
  uint32_t a[Ln::K][kSlice], a1[Ln::K][kSlice], v[Ln::K][kSlice], v2[Ln::K][kSlice];
  ln.pull(a, s, [](int j) { return shift_rows_source(j); });
  if (last) {
    ln.each([&](int, int x) {
      DPF_UNROLL
      for (int b = 0; b < kSlice; ++b) s[x][b] = a[x][b];
    });
    return;
  }
  ln.pull(a1, s, [](int j) { return shift_rows_source((j & 12) | ((j + 1) & 3)); });
  ln.each([&](int, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) v[x][b] = a[x][b] ^ a1[x][b];
  });
  ln.pull(v2, v, [](int j) { return (j & 12) | ((j + 2) & 3); });
  ln.each([&](int, int x) {
    uint32_t o[kSlice];
    mix_byte(a[x], v[x], v2[x], o);
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) s[x][b] = o[b];
  });
}

// AES-128 of the column: kl's key where a lane's `sel` bit is 0 and kr's
// where it is 1 (kSelect), or kl's key alone. kl, kr: plane-mask tables
// (`fill_keys`). The rounds are written out (no loop-carried moves, the
// key offsets and the last round fixed at compile time: 7-18% faster on
// the H100).
template <bool kSelect, class Ln>
__device__ __forceinline__ void aes(const Ln& ln, uint32_t (&s)[Ln::K][kSlice],
                                    const uint32_t* kl, const uint32_t* kr,
                                    const uint32_t (&sel)[Ln::K]) {
  add_round_key<kSelect>(ln, s, kl, kr, sel, 0);
  DPF_UNROLL
  for (int rnd = 1; rnd <= 10; ++rnd) {
    sub_bytes(ln, s);
    shift_rows_mix(ln, s, rnd == 10);
    add_round_key<kSelect>(ln, s, kl, kr, sel, rnd);
  }
}

// sig = sigma(s) = (hi ^ lo, hi): the slice of lane j ^ 8 is the other
// half of the block.
template <class Ln>
__device__ __forceinline__ void sigma(const Ln& ln, const uint32_t (&s)[Ln::K][kSlice],
                                      uint32_t (&sig)[Ln::K][kSlice]) {
  ln.pull(sig, s, [](int j) { return j ^ (kGroup / 2); });
  ln.each([&](int j, int x) {
    if (j >= kGroup / 2) {
      DPF_UNROLL
      for (int b = 0; b < kSlice; ++b) sig[x][b] ^= s[x][b];
    }
  });
}

// The MMO hash of the column with its correction:
//   s := AES(sigma(s)) ^ sigma(s) ^ (cw & c),
// cw the correction planes of this column (plane p at cw[p * cw_stride]).
template <bool kSelect, class Ln>
__device__ __forceinline__ void mmo(const Ln& ln, uint32_t (&s)[Ln::K][kSlice],
                                    const uint32_t* kl, const uint32_t* kr,
                                    const uint32_t (&sel)[Ln::K],
                                    const uint32_t* cw, int64_t cw_stride,
                                    const uint32_t (&c)[Ln::K]) {
  uint32_t sig[Ln::K][kSlice];
  sigma(ln, s, sig);
  ln.each([&](int, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) s[x][b] = sig[x][b];
  });
  aes<kSelect>(ln, s, kl, kr, sel);
  ln.each([&](int j, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) {
      s[x][b] ^= sig[x][b] ^ (cw[(j * kSlice + b) * cw_stride] & c[x]);
    }
  });
}

// Plane 0 (the seed LSB) out as every lane's t, and cleared.
template <class Ln>
__device__ __forceinline__ void take_control(const Ln& ln, uint32_t (&s)[Ln::K][kSlice],
                                             uint32_t (&t)[Ln::K]) {
  uint32_t lsb[Ln::K][1], got[Ln::K][1];
  ln.each([&](int, int x) { lsb[x][0] = s[x][0]; });
  ln.pull(got, lsb, [](int) { return 0; });
  ln.each([&](int j, int x) {
    t[x] = got[x][0];
    if (j == 0) s[x][0] = 0u;
  });
}

// A slice in and out of a group-ordered tile (`tile_row`, `stride` words a
// row), column `col`.
template <class Ln>
__device__ __forceinline__ void load_slice(const Ln& ln, uint32_t (&s)[Ln::K][kSlice],
                                           const uint32_t* tile, int stride, int col) {
  ln.each([&](int j, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) s[x][b] = tile[(b * kGroup + j) * stride + col];
  });
}

template <class Ln>
__device__ __forceinline__ void store_slice(const Ln& ln,
                                            const uint32_t (&s)[Ln::K][kSlice],
                                            uint32_t* tile, int stride, int col) {
  ln.each([&](int j, int x) {
    DPF_UNROLL
    for (int b = 0; b < kSlice; ++b) tile[(b * kGroup + j) * stride + col] = s[x][b];
  });
}

}  // namespace split
