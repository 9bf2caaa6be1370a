#include "aes128.h"
#include <vector>

namespace dpf_native {
namespace {

// S-box generated at startup from the GF(2^8) inverse + affine map, so no
// table constants are copied from anywhere.
struct SboxTable {
  uint8_t sbox[256];
  SboxTable() {
    auto gf_mul = [](int a, int b) {
      int r = 0;
      while (b) {
        if (b & 1) r ^= a;
        a <<= 1;
        if (a & 0x100) a ^= 0x11B;
        b >>= 1;
      }
      return r;
    };
    uint8_t inv[256] = {0};
    for (int x = 1; x < 256; ++x) {
      for (int y = 1; y < 256; ++y) {
        if (gf_mul(x, y) == 1) {
          inv[x] = static_cast<uint8_t>(y);
          break;
        }
      }
    }
    for (int x = 0; x < 256; ++x) {
      int b = inv[x];
      int res = 0;
      for (int i = 0; i < 8; ++i) {
        int bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8)) ^
                   (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8)) ^ (0x63 >> i)) &
                  1;
        res |= bit << i;
      }
      sbox[x] = static_cast<uint8_t>(res);
    }
  }
};

const SboxTable kTables;

inline uint8_t XTime(uint8_t b) {
  return static_cast<uint8_t>((b << 1) ^ ((b >> 7) * 0x1B));
}

inline void MixColumns(uint8_t s[16]) {
  for (int c = 0; c < 4; ++c) {
    uint8_t* col = s + 4 * c;
    uint8_t t = col[0] ^ col[1] ^ col[2] ^ col[3];
    uint8_t s0 = col[0];
    uint8_t tmp0 = col[0] ^ t ^ XTime(static_cast<uint8_t>(col[0] ^ col[1]));
    uint8_t tmp1 = col[1] ^ t ^ XTime(static_cast<uint8_t>(col[1] ^ col[2]));
    uint8_t tmp2 = col[2] ^ t ^ XTime(static_cast<uint8_t>(col[2] ^ col[3]));
    uint8_t tmp3 = col[3] ^ t ^ XTime(static_cast<uint8_t>(col[3] ^ s0));
    col[0] = tmp0;
    col[1] = tmp1;
    col[2] = tmp2;
    col[3] = tmp3;
  }
}

inline void ShiftRows(uint8_t s[16]) {
  // Flat index r + 4c; row r rotates left by r.
  uint8_t tmp[16];
  for (int c = 0; c < 4; ++c) {
    for (int r = 0; r < 4; ++r) {
      tmp[r + 4 * c] = s[r + 4 * ((c + r) % 4)];
    }
  }
  std::memcpy(s, tmp, 16);
}

inline void SubBytes(uint8_t s[16]) {
  for (int i = 0; i < 16; ++i) s[i] = kTables.sbox[s[i]];
}

inline void AddRoundKey(uint8_t s[16], const uint8_t rk[16]) {
  for (int i = 0; i < 16; ++i) s[i] ^= rk[i];
}

}  // namespace

void Aes128KeyExpand(const uint8_t key[16], Aes128Key* out) {
  static const uint8_t rcon[10] = {0x01, 0x02, 0x04, 0x08, 0x10,
                                   0x20, 0x40, 0x80, 0x1B, 0x36};
  uint8_t w[44][4];
  std::memcpy(w, key, 16);
  for (int i = 4; i < 44; ++i) {
    uint8_t temp[4];
    std::memcpy(temp, w[i - 1], 4);
    if (i % 4 == 0) {
      uint8_t t0 = temp[0];
      temp[0] = static_cast<uint8_t>(kTables.sbox[temp[1]] ^ rcon[i / 4 - 1]);
      temp[1] = kTables.sbox[temp[2]];
      temp[2] = kTables.sbox[temp[3]];
      temp[3] = kTables.sbox[t0];
    }
    for (int j = 0; j < 4; ++j) w[i][j] = w[i - 4][j] ^ temp[j];
  }
  std::memcpy(out->rk, w, 176);
}

void Aes128EncryptBlocks(const Aes128Key& key, const uint8_t* in, uint8_t* out,
                         int64_t num_blocks) {
  for (int64_t b = 0; b < num_blocks; ++b) {
    uint8_t s[16];
    std::memcpy(s, in + 16 * b, 16);
    AddRoundKey(s, key.rk[0]);
    for (int r = 1; r < 10; ++r) {
      SubBytes(s);
      ShiftRows(s);
      MixColumns(s);
      AddRoundKey(s, key.rk[r]);
    }
    SubBytes(s);
    ShiftRows(s);
    AddRoundKey(s, key.rk[10]);
    std::memcpy(out + 16 * b, s, 16);
  }
}

void Aes128MmoHash(const Aes128Key& key, const uint8_t* in, uint8_t* out,
                   int64_t num_blocks) {
  // Hardware AES when available (cached probe); the bytewise path below is
  // the oracle/fallback. Batched: sigma all blocks, one pipelined encrypt
  // pass, then the feed-forward XOR.
  static const bool have_ni = AesNiSupported();
  if (have_ni && num_blocks > 1) {
    std::vector<uint8_t> sig(16 * num_blocks);
    for (int64_t b = 0; b < num_blocks; ++b) Sigma(in + 16 * b, sig.data() + 16 * b);
    Aes128EncryptBlocksNi(key, sig.data(), out, num_blocks);
    for (int64_t i = 0; i < 16 * num_blocks; ++i) out[i] ^= sig[i];
    return;
  }
  for (int64_t b = 0; b < num_blocks; ++b) {
    uint8_t sig[16];
    Sigma(in + 16 * b, sig);
    uint8_t enc[16];
    Aes128EncryptBlocks(key, sig, enc, 1);
    for (int i = 0; i < 16; ++i) out[16 * b + i] = enc[i] ^ sig[i];
  }
}

}  // namespace dpf_native
