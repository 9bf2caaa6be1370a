// SHA-256 (FIPS 180-4) — compact single-header implementation for the
// native cuckoo table build. Implemented from the spec (message schedule +
// 64-round compression with the standard K constants); no third-party
// code. The port's cuckoo table build (`cuckoo_build.cc`) uses it;
// tests/test_torch_sparse_pir.py holds its bucket indices against hashlib.
#pragma once

#include <cstdint>
#include <cstring>

namespace dpf_native {

struct Sha256 {
  uint32_t h[8];
  uint64_t bytes = 0;
  uint8_t buf[64];

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t Rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void Compress(const uint8_t* p) {
    static const uint32_t k[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
        0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
        0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
        0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
        0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
        0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
        0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
        0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i) {
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    }
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = Rotr(w[i - 15], 7) ^ Rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = Rotr(w[i - 2], 17) ^ Rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t s1 = Rotr(e, 6) ^ Rotr(e, 11) ^ Rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      uint32_t s0 = Rotr(a, 2) ^ Rotr(a, 13) ^ Rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
  }

  void Update(const uint8_t* data, size_t len) {
    size_t fill = bytes % 64;
    bytes += len;
    if (fill) {
      size_t need = 64 - fill;
      if (len < need) {
        std::memcpy(buf + fill, data, len);
        return;
      }
      std::memcpy(buf + fill, data, need);
      Compress(buf);
      data += need;
      len -= need;
    }
    while (len >= 64) {
      Compress(data);
      data += 64;
      len -= 64;
    }
    if (len) std::memcpy(buf, data, len);
  }

  void Final(uint8_t out[32]) {
    uint64_t bitlen = bytes * 8;
    uint8_t pad[72];
    size_t fill = bytes % 64;
    size_t padlen = (fill < 56) ? 56 - fill : 120 - fill;
    pad[0] = 0x80;
    std::memset(pad + 1, 0, padlen - 1);
    for (int i = 0; i < 8; ++i) {
      pad[padlen + i] = uint8_t(bitlen >> (56 - 8 * i));
    }
    Update(pad, padlen + 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

}  // namespace dpf_native
