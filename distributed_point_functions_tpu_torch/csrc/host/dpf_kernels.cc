// Native CPU kernels + C API (ctypes binding surface).
//
// The three performance-relevant primitives of the reference, as scalar C++
// oracles for the device kernels (mirroring the NoHwy role of
// dpf/internal/evaluate_prg_hwy.cc:552-634 and
// pir/internal/inner_product_hwy.cc:270-296):
//
//  * dpf_expand_level   — one breadth-first tree level (ExpandSeeds inner
//                         loop, dpf/distributed_point_function.cc:327-370)
//  * dpf_evaluate_seeds — multi-level batch point evaluation with shared or
//                         per-seed correction words
//                         (dpf/internal/evaluate_prg_hwy.h:58-77)
//  * dpf_inner_product  — packed-XOR database inner product
//                         (pir/internal/inner_product_hwy.cc:300-334)
//
// All block buffers are 16-byte little-endian AES blocks; control bits ride
// in the seeds' LSBs exactly like the reference's ExtractAndClearLowestBit
// convention (evaluate_prg_hwy.h:32-36) at the API boundary, but this C API
// keeps them in separate byte arrays for clarity.

#include <cstdint>
#include <cstring>

#include "aes128.h"

namespace {

using dpf_native::Aes128Key;

struct FixedKeys {
  Aes128Key left, right, value;
};

inline bool GetBit(const uint8_t* block, int bit_index) {
  if (bit_index < 0 || bit_index >= 128) return false;
  return (block[bit_index / 8] >> (bit_index % 8)) & 1;
}

}  // namespace

extern "C" {

// Opaque fixed-key context.
void* dpf_create_keys(const uint8_t key_left[16], const uint8_t key_right[16],
                      const uint8_t key_value[16]) {
  auto* keys = new FixedKeys();
  dpf_native::Aes128KeyExpand(key_left, &keys->left);
  dpf_native::Aes128KeyExpand(key_right, &keys->right);
  dpf_native::Aes128KeyExpand(key_value, &keys->value);
  return keys;
}

void dpf_free_keys(void* ctx) { delete static_cast<FixedKeys*>(ctx); }

void dpf_mmo_hash(void* ctx, int which, const uint8_t* in, uint8_t* out,
                  int64_t num_blocks) {
  auto* keys = static_cast<FixedKeys*>(ctx);
  const Aes128Key& k = which == 0   ? keys->left
                       : which == 1 ? keys->right
                                    : keys->value;
  dpf_native::Aes128MmoHash(k, in, out, num_blocks);
}

// One breadth-first expansion level: seeds[n] -> seeds_out[2n], interleaved
// (left_i, right_i). control bits are 0/1 bytes.
void dpf_expand_level(void* ctx, const uint8_t* seeds, const uint8_t* control,
                      const uint8_t cw_seed[16], uint8_t cw_left,
                      uint8_t cw_right, uint8_t* seeds_out,
                      uint8_t* control_out, int64_t n) {
  auto* keys = static_cast<FixedKeys*>(ctx);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* seed = seeds + 16 * i;
    for (int branch = 0; branch < 2; ++branch) {
      uint8_t* out = seeds_out + 16 * (2 * i + branch);
      dpf_native::Aes128MmoHash(branch == 0 ? keys->left : keys->right, seed,
                                out, 1);
      if (control[i]) {
        for (int j = 0; j < 16; ++j) out[j] ^= cw_seed[j];
      }
      uint8_t t = out[0] & 1;
      out[0] &= 0xFE;
      t ^= control[i] & (branch == 0 ? cw_left : cw_right);
      control_out[2 * i + branch] = t;
    }
  }
}

// Batch point evaluation: walk `num_levels` levels for each of `n` seeds.
// paths: n x 16-byte blocks; the path bit for level j is bit
// (num_levels - 1 - j + paths_rightshift) of the path.
// cw_seeds: [num_levels * cw_stride] blocks, cw_stride == 1 for shared
// correction words or == n for per-seed (the multi-key batch mode of
// evaluate_prg_hwy.h:58-65). cw_left/right: same layout, one byte each.
void dpf_evaluate_seeds(void* ctx, uint8_t* seeds, uint8_t* control,
                        const uint8_t* paths, const uint8_t* cw_seeds,
                        const uint8_t* cw_left, const uint8_t* cw_right,
                        int64_t n, int num_levels, int64_t cw_stride,
                        int paths_rightshift) {
  auto* keys = static_cast<FixedKeys*>(ctx);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* seed = seeds + 16 * i;
    uint8_t t = control[i];
    for (int level = 0; level < num_levels; ++level) {
      int bit_index = num_levels - 1 - level + paths_rightshift;
      bool path_bit = GetBit(paths + 16 * i, bit_index);
      int64_t cw_index =
          static_cast<int64_t>(level) * cw_stride + (cw_stride == 1 ? 0 : i);
      uint8_t h[16];
      dpf_native::Aes128MmoHash(path_bit ? keys->right : keys->left, seed, h,
                                1);
      if (t) {
        for (int j = 0; j < 16; ++j) h[j] ^= cw_seeds[16 * cw_index + j];
      }
      uint8_t t_new = h[0] & 1;
      h[0] &= 0xFE;
      t_new ^= t & (path_bit ? cw_right[cw_index] : cw_left[cw_index]);
      std::memcpy(seed, h, 16);
      t = t_new;
    }
    control[i] = t;
  }
}

// Value hash: out[i*blocks + j] = H_value(seed_i + j), the output PRG of
// HashExpandedSeeds (dpf/distributed_point_function.cc:523-547).
void dpf_value_hash(void* ctx, const uint8_t* seeds, uint8_t* out, int64_t n,
                    int num_blocks) {
  auto* keys = static_cast<FixedKeys*>(ctx);
  for (int64_t i = 0; i < n; ++i) {
    for (int j = 0; j < num_blocks; ++j) {
      // seed + j as a 128-bit little-endian integer.
      uint8_t block[16];
      std::memcpy(block, seeds + 16 * i, 16);
      uint64_t carry = static_cast<uint64_t>(j);
      for (int b = 0; b < 16 && carry; ++b) {
        uint64_t v = block[b] + (carry & 0xFF);
        block[b] = static_cast<uint8_t>(v);
        carry = (carry >> 8) + (v >> 8);
      }
      dpf_native::Aes128MmoHash(keys->value, block,
                                out + 16 * (i * num_blocks + j), 1);
    }
  }
}

// Packed-XOR inner product. db: num_records x record_words uint32 rows
// (little-endian); selections: nq x num_blocks x 16 bytes; the bit for
// record r is bit (r % 128) of block (r / 128). out: nq x record_words.
void dpf_inner_product(const uint32_t* db, int64_t num_records,
                       int64_t record_words, const uint8_t* selections,
                       int64_t nq, int64_t num_blocks, uint32_t* out) {
  std::memset(out, 0, sizeof(uint32_t) * nq * record_words);
  for (int64_t q = 0; q < nq; ++q) {
    const uint8_t* sel = selections + q * num_blocks * 16;
    uint32_t* acc = out + q * record_words;
    for (int64_t r = 0; r < num_records; ++r) {
      int64_t block = r / 128;
      if (block >= num_blocks) break;
      int bit = static_cast<int>(r % 128);
      if ((sel[block * 16 + bit / 8] >> (bit % 8)) & 1) {
        const uint32_t* row = db + r * record_words;
        for (int64_t w = 0; w < record_words; ++w) acc[w] ^= row[w];
      }
    }
  }
}

}  // extern "C"
