// Native batched dense-PIR key generation.
//
// The reference's key generation is C++ (`GenerateKeysIncremental` /
// `GenerateNext`, dpf/distributed_point_function.cc:121-222, 642-707);
// this is the framework's native equivalent for the dense-PIR key shape
// (single hierarchy level, 128-bit XOR values): the per-level recurrence
// is run for a whole batch of keys in lockstep, with the AES-NI-batched
// MMO hash doing 2n blocks per (level, PRG key) call. Randomness (the
// root seeds) is supplied by the caller, keeping all crypto-random
// sourcing in one place (Python `secrets`).
//
// Bit/byte conventions match the Python engine exactly (16-byte
// little-endian blocks, control bit in byte 0 bit 0), so the output is
// bit-identical to `DistributedPointFunction.generate_keys_batch` given
// the same root seeds — which is how it is differentially tested.

#include <cstdint>
#include <cstring>
#include <vector>

#include "aes128.h"

namespace {

using dpf_native::Aes128Key;
using dpf_native::Aes128KeyExpand;
using dpf_native::Aes128MmoHash;

inline void Xor16(const uint8_t* a, const uint8_t* b, uint8_t* out) {
  for (int i = 0; i < 16; ++i) out[i] = a[i] ^ b[i];
}

}  // namespace

extern "C" {

// All output arrays are caller-allocated:
//   root_seeds: [2][n][16] (party-major; input)
//   alphas:     [n] (alpha < 2^levels <= 2^63)
//   betas:      [n][16]
//   cw_seeds:   [levels][n][16]  (out)
//   cw_ctrl:    [levels][n][2]   (out: left, right)
//   last_vc:    [n][16]          (out)
void dpf_keygen_batch_dense(const uint8_t key_left[16],
                            const uint8_t key_right[16],
                            const uint8_t key_value[16],
                            const uint8_t* root_seeds, const uint64_t* alphas,
                            const uint8_t* betas, int levels, int64_t n,
                            uint8_t* cw_seeds, uint8_t* cw_ctrl,
                            uint8_t* last_vc) {
  Aes128Key kl, kr, kv;
  Aes128KeyExpand(key_left, &kl);
  Aes128KeyExpand(key_right, &kr);
  Aes128KeyExpand(key_value, &kv);

  // seeds: [2n][16], parties interleaved as [party][key] (party-major).
  std::vector<uint8_t> seeds(root_seeds, root_seeds + 2 * n * 16);
  std::vector<uint8_t> control(2 * n, 0);
  for (int64_t i = 0; i < n; ++i) control[n + i] = 1;  // party 1

  std::vector<uint8_t> hl(2 * n * 16), hr(2 * n * 16);
  for (int level = 1; level <= levels; ++level) {
    Aes128MmoHash(kl, seeds.data(), hl.data(), 2 * n);
    Aes128MmoHash(kr, seeds.data(), hr.data(), 2 * n);
    const int bit_pos = levels - level;
    for (int64_t i = 0; i < n; ++i) {
      uint8_t* l0 = hl.data() + 16 * i;
      uint8_t* l1 = hl.data() + 16 * (n + i);
      uint8_t* r0 = hr.data() + 16 * i;
      uint8_t* r1 = hr.data() + 16 * (n + i);
      const uint8_t t_l0 = l0[0] & 1, t_l1 = l1[0] & 1;
      const uint8_t t_r0 = r0[0] & 1, t_r1 = r1[0] & 1;
      l0[0] &= 0xFE; l1[0] &= 0xFE; r0[0] &= 0xFE; r1[0] &= 0xFE;

      const uint8_t bit = (alphas[i] >> bit_pos) & 1;
      uint8_t* cw = cw_seeds + 16 * ((level - 1) * n + i);
      // lose = 1 - bit: XOR the two parties' hashes on the lose branch.
      if (bit) Xor16(l0, l1, cw); else Xor16(r0, r1, cw);
      const uint8_t cw_left = t_l0 ^ t_l1 ^ bit ^ 1;
      const uint8_t cw_right = t_r0 ^ t_r1 ^ bit;
      uint8_t* ctrl = cw_ctrl + 2 * ((level - 1) * n + i);
      ctrl[0] = cw_left;
      ctrl[1] = cw_right;
      const uint8_t cw_keep = bit ? cw_right : cw_left;

      for (int b = 0; b < 2; ++b) {
        const uint8_t* keep = bit ? (b ? r1 : r0) : (b ? l1 : l0);
        const uint8_t keep_t = bit ? (b ? t_r1 : t_r0) : (b ? t_l1 : t_l0);
        uint8_t* dst = seeds.data() + 16 * (b * n + i);
        if (control[b * n + i]) {
          Xor16(keep, cw, dst);
        } else {
          std::memcpy(dst, keep, 16);
        }
        control[b * n + i] = keep_t ^ (control[b * n + i] & cw_keep);
      }
    }
  }

  // Last-level value correction: H_value(s0) ^ H_value(s1) ^ beta
  // (both group ops are XOR for 128-bit XOR shares; party negation is the
  // identity — ComputeValueCorrection, distributed_point_function.cc:81-117).
  std::vector<uint8_t> ha(n * 16), hb(n * 16);
  Aes128MmoHash(kv, seeds.data(), ha.data(), n);
  Aes128MmoHash(kv, seeds.data() + 16 * n, hb.data(), n);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* out = last_vc + 16 * i;
    Xor16(ha.data() + 16 * i, hb.data() + 16 * i, out);
    Xor16(out, betas + 16 * i, out);
  }
}

}  // extern "C"
