// The one-thread AES body of K3 (expand_planes.cu) and its host twin, and
// the macros that let the kernels' sources build for the host.
//
// Layout: state int32/uint32 [16, 8, G] -- plane p = 8 * byte + bit, word
// m of a plane holds that bit for lanes 32m..32m+31 (lane = node * 32KG +
// key). Per-key corrections are packed at [16, 8, KG] and [KG] words and
// are read at column m % KG (no tiling in memory).
//
// Without __CUDACC__ (a host C++ compiler) the bodies build for the host,
// and the CPU tests hold them against the plain PyTorch versions.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DPF_UNROLL _Pragma("unroll")
#define DPF_NO_UNROLL _Pragma("unroll 1")
#else
#define __host__
#define __device__
#define __forceinline__ inline
#define DPF_UNROLL
#define DPF_NO_UNROLL
#endif

#include "aes_generated.cuh"

namespace {

__device__ __forceinline__ void aes_encrypt_fixed(uint32_t (&s)[128], int key) {
  add_round_key(s, key, 0);
  DPF_NO_UNROLL
  for (int rnd = 1; rnd <= 10; ++rnd) {
    sub_bytes(s);
    if (rnd < 10) {
      shift_rows_mix_columns(s);
    } else {
      shift_rows(s);
    }
    add_round_key(s, key, rnd);
  }
}

// Plane p of sigma(x) = (hi ^ lo, hi) for word column m of the [128, G]
// planes at `in`: planes 0-63 (bytes 0-7) take hi = planes 64-127, planes
// 64-127 take hi ^ lo.
__device__ __forceinline__ uint32_t sigma_plane(const uint32_t* in, int64_t g,
                                                int64_t m, int p) {
  return p < 64 ? in[(p + 64) * g + m] : in[p * g + m] ^ in[(p - 64) * g + m];
}

// Leaf value of word column m: MMO hash with the value key, XOR the value
// correction under the control word.
__device__ __forceinline__ void value_column(
    const uint32_t* state, const uint32_t* ctrl, const uint32_t* vc,
    uint32_t* out, int64_t g, int64_t kg, int64_t m) {
  const int64_t k = m % kg;
  const uint32_t c = ctrl[m];
  uint32_t s[128];
  DPF_UNROLL
  for (int p = 0; p < 128; ++p) s[p] = sigma_plane(state, g, m, p);
  aes_encrypt_fixed(s, kKeyValue);
  DPF_UNROLL
  for (int p = 0; p < 128; ++p) {
    out[p * g + m] = s[p] ^ sigma_plane(state, g, m, p) ^ (vc[p * kg + k] & c);
  }
}

}  // namespace
