// Native cuckoo-table build for the sparse-PIR database.
//
// The Python insertion loop (hash + random eviction per key,
// `hashing/cuckoo_hash_table.py`, mirroring the reference's
// `pir/hashing/cuckoo_hash_table.cc:66-91`) takes tens of minutes at
// 2^24 keys; this build does the same job natively: per key, `num_hashes`
// bucket indices from SHA256(seed_i || key) reduced mod num_buckets
// exactly as the SHA256 hash family does (the digest as a little-endian
// 256-bit integer, `hashing/sha256_hash_family.py`), then cuckoo
// insertion with random eviction on a std::mt19937_64. The hashing runs
// on all cores (each key's buckets are independent); the insertion is
// sequential, so the slot array depends only on the inputs and
// `rng_seed`: it equals the JAX package's native build
// (`native/cuckoo_build.cc`) for the same arguments. Its layout differs
// from the Python table's (another random stream), which the protocol
// permits: any legal assignment serves.
//
// C API (ctypes, see distributed_point_functions_tpu_torch/native.py):
//   dpf_cuckoo_hash_buckets: per-key bucket indices only.
//   dpf_cuckoo_build: full build; out_slots[num_buckets] holds the key
//     index occupying each bucket, or -1. Returns 0, or -1 when a key
//     cannot be placed within max_relocations, -2 on bad arguments.

#include <algorithm>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

#include "sha256.h"

namespace {

using dpf_native::Sha256;

// Keys a thread must have before the hashing spreads over threads.
constexpr int64_t kKeysPerThread = 1 << 15;

int64_t BucketOf(const uint8_t* seed, size_t seed_len, const uint8_t* key,
                 size_t key_len, int64_t num_buckets) {
  uint8_t digest[32];
  Sha256 ctx;
  ctx.Update(seed, seed_len);
  ctx.Update(key, key_len);
  ctx.Final(digest);
  // Little-endian 256-bit value mod num_buckets, high words first:
  // value = sum_k w_k * 2^(64k), w_k = LE uint64 at digest[8k].
  unsigned __int128 r = 0;
  for (int k = 3; k >= 0; --k) {
    uint64_t w = 0;
    for (int b = 7; b >= 0; --b) {
      w = (w << 8) | digest[8 * k + b];
    }
    r = ((r << 64) | w) % (unsigned __int128)num_buckets;
  }
  return (int64_t)r;
}

void HashRange(const uint8_t* keys_concat, const uint64_t* key_offsets,
               int64_t begin, int64_t end, const uint8_t* seeds_concat,
               const uint64_t* seed_offsets, int num_hashes,
               int64_t num_buckets, int64_t* out) {
  for (int64_t k = begin; k < end; ++k) {
    const uint8_t* key = keys_concat + key_offsets[k];
    size_t key_len = key_offsets[k + 1] - key_offsets[k];
    for (int i = 0; i < num_hashes; ++i) {
      const uint8_t* seed = seeds_concat + seed_offsets[i];
      size_t seed_len = seed_offsets[i + 1] - seed_offsets[i];
      out[k * num_hashes + i] =
          BucketOf(seed, seed_len, key, key_len, num_buckets);
    }
  }
}

}  // namespace

extern "C" {

// Per-key bucket indices: out[k * num_hashes + i] = hash_i(key_k).
// seeds_concat/seed_offsets frame the per-hash seed byte strings
// (seed i = bytes [seed_offsets[i], seed_offsets[i+1])).
int dpf_cuckoo_hash_buckets(const uint8_t* keys_concat,
                            const uint64_t* key_offsets, int64_t num_keys,
                            const uint8_t* seeds_concat,
                            const uint64_t* seed_offsets, int num_hashes,
                            int64_t num_buckets, int64_t* out) {
  if (num_keys < 0 || num_hashes <= 0 || num_buckets <= 0) return -2;
  int64_t threads = std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>(1, num_keys / kKeysPerThread));
  std::vector<std::thread> pool;
  int64_t per = (num_keys + threads - 1) / threads;
  for (int64_t t = 1; t < threads; ++t) {
    int64_t begin = std::min(num_keys, t * per);
    int64_t end = std::min(num_keys, begin + per);
    pool.emplace_back(HashRange, keys_concat, key_offsets, begin, end,
                      seeds_concat, seed_offsets, num_hashes, num_buckets,
                      out);
  }
  HashRange(keys_concat, key_offsets, 0, std::min(num_keys, per),
            seeds_concat, seed_offsets, num_hashes, num_buckets, out);
  for (auto& th : pool) th.join();
  return 0;
}

int dpf_cuckoo_build(const uint8_t* keys_concat, const uint64_t* key_offsets,
                     int64_t num_keys, const uint8_t* seeds_concat,
                     const uint64_t* seed_offsets, int num_hashes,
                     int64_t num_buckets, int64_t max_relocations,
                     uint64_t rng_seed, int64_t* out_slots) {
  if (num_keys < 0 || num_hashes < 2 || num_buckets <= 0 ||
      max_relocations < 0) {
    return -2;
  }
  std::vector<int64_t> buckets((size_t)num_keys * num_hashes);
  int rc = dpf_cuckoo_hash_buckets(keys_concat, key_offsets, num_keys,
                                   seeds_concat, seed_offsets, num_hashes,
                                   num_buckets, buckets.data());
  if (rc != 0) return rc;
  for (int64_t b = 0; b < num_buckets; ++b) out_slots[b] = -1;

  std::mt19937_64 rng(rng_seed);
  for (int64_t k = 0; k < num_keys; ++k) {
    int64_t current = k;
    int64_t hops = 0;
    for (;;) {
      const int64_t* cand = &buckets[(size_t)current * num_hashes];
      bool placed = false;
      for (int i = 0; i < num_hashes; ++i) {
        if (out_slots[cand[i]] < 0) {
          out_slots[cand[i]] = current;
          placed = true;
          break;
        }
      }
      if (placed) break;
      if (hops++ >= max_relocations) return -1;
      int64_t victim_bucket = cand[rng() % num_hashes];
      int64_t evicted = out_slots[victim_bucket];
      out_slots[victim_bucket] = current;
      current = evicted;
    }
  }
  return 0;
}

}  // extern "C"
