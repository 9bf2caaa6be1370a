// AES-NI fast path for the native CPU kernels.
//
// The reference's CPU hot loop rides OpenSSL/Highway AES-NI
// (dpf/internal/aes_128_fixed_key_hash_hwy.h); this translation unit is
// the equivalent for the framework's native library: hardware AES rounds,
// 8 blocks in flight to fill the aesenc pipeline. Compiled with -maes
// (see native.py); callers must gate on AesNiSupported().
//
// Block and round-key layout match aes128.h (16-byte little-endian blocks,
// standard expanded schedule), so this slots under Aes128MmoHash as a
// drop-in accelerated body.

#include "aes128.h"

#include <cstdint>
#include <cstring>
#include <wmmintrin.h>

namespace dpf_native {

bool AesNiSupported() {
#if defined(__GNUC__)
  return __builtin_cpu_supports("aes");
#else
  return false;
#endif
}

namespace {

inline __m128i RoundKey(const Aes128Key& key, int r) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i*>(key.rk[r]));
}

template <int N>
inline void EncryptLanes(const Aes128Key& key, __m128i b[N]) {
  const __m128i k0 = RoundKey(key, 0);
  for (int j = 0; j < N; ++j) b[j] = _mm_xor_si128(b[j], k0);
  for (int r = 1; r < 10; ++r) {
    const __m128i kr = RoundKey(key, r);
    for (int j = 0; j < N; ++j) b[j] = _mm_aesenc_si128(b[j], kr);
  }
  const __m128i k10 = RoundKey(key, 10);
  for (int j = 0; j < N; ++j) b[j] = _mm_aesenclast_si128(b[j], k10);
}

}  // namespace

void Aes128EncryptBlocksNi(const Aes128Key& key, const uint8_t* in,
                           uint8_t* out, int64_t num_blocks) {
  int64_t i = 0;
  for (; i + 8 <= num_blocks; i += 8) {
    __m128i b[8];
    for (int j = 0; j < 8; ++j)
      b[j] = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(in + (i + j) * 16));
    EncryptLanes<8>(key, b);
    for (int j = 0; j < 8; ++j)
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + (i + j) * 16), b[j]);
  }
  for (; i < num_blocks; ++i) {
    __m128i b[1] = {
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + i * 16))};
    EncryptLanes<1>(key, b);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i * 16), b[0]);
  }
}

}  // namespace dpf_native
