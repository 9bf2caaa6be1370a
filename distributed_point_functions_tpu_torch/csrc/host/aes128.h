// AES-128 core for the native CPU kernels.
//
// Role: the CPU reference/oracle mirroring the reference library's OpenSSL
// `Aes128FixedKeyHash` (dpf/aes_128_fixed_key_hash.{h,cc}) and the scalar
// fallback of its Highway kernels (dpf/internal/evaluate_prg_hwy.cc:552-634).
// Table-free, constant-time-ish bytewise implementation — this path is for
// correctness oracles and host-side work, not the hot loop (the hot loop
// lives on the CUDA card, `csrc/*.cu`).
//
// Block convention: 16 bytes little-endian, matching the port's uint32[4]
// limb layout (see distributed_point_functions_tpu_torch/ops/aes.py).

#ifndef DPF_NATIVE_AES128_H_
#define DPF_NATIVE_AES128_H_

#include <cstdint>
#include <cstring>

namespace dpf_native {

struct Aes128Key {
  // Expanded round keys: 11 x 16 bytes.
  uint8_t rk[11][16];
};

// Expands a 16-byte key into round keys.
void Aes128KeyExpand(const uint8_t key[16], Aes128Key* out);

// Encrypts `num_blocks` 16-byte blocks in ECB mode (in-place allowed).
void Aes128EncryptBlocks(const Aes128Key& key, const uint8_t* in, uint8_t* out,
                         int64_t num_blocks);

// sigma(x) = (hi ^ lo, hi): the circular-correlation-robust linear map of
// the MMO construction (dpf/aes_128_fixed_key_hash.h:28-39). Bytes 0..7 are
// `lo`, bytes 8..15 `hi` (little-endian).
inline void Sigma(const uint8_t in[16], uint8_t out[16]) {
  for (int i = 0; i < 8; ++i) {
    out[i] = in[8 + i];           // low half  <- hi
    out[8 + i] = in[8 + i] ^ in[i];  // high half <- hi ^ lo
  }
}

// H(x) = AES_k(sigma(x)) ^ sigma(x), batched.
void Aes128MmoHash(const Aes128Key& key, const uint8_t* in, uint8_t* out,
                   int64_t num_blocks);


// AES-NI fast path (aesni.cc, compiled with -maes). Gate on
// AesNiSupported() before calling.
bool AesNiSupported();
void Aes128EncryptBlocksNi(const Aes128Key& key, const uint8_t* in,
                           uint8_t* out, int64_t num_blocks);

}  // namespace dpf_native

#endif  // DPF_NATIVE_AES128_H_
