// bjxa-tpu native codec core — shared inline primitives.
//
// Single source of truth for the XA block semantics on the host CPU,
// included by both native libraries:
//   * bjxa_host.cc — the flat whole-buffer runtime behind the Python
//     streaming codec (ctypes);
//   * bjxa_abi.cc  — the drop-in C ABI (libbjxa-compatible symbols).
//
// Spec anchors: reference bjxa.5.rst (bit layout, gain table, recurrence);
// decode recurrence reference src/libbjxa.c:533-578.  This is a fresh
// whole-buffer implementation, not a translation: blocks are decoded from
// flat arrays with explicit state in/out, there are no callbacks and no
// per-object function pointers.

#ifndef BJXA_TPU_XA_CORE_H
#define BJXA_TPU_XA_CORE_H

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>

namespace bjxa_core {

constexpr int kBlockSamples = 32;
constexpr int kNumFactors = 5;

// Fixed-point (x256) two-tap prediction gains, indexed by profile factor.
// These five pairs ARE the file format (bjxa.5.rst:110-129).
constexpr std::array<std::array<int32_t, 2>, kNumFactors> kGain = {{
    {0, 0}, {240, 0}, {460, -208}, {392, -220}, {488, -240},
}};

inline int32_t clamp16(int32_t v) {
  return std::min<int32_t>(std::max<int32_t>(v, INT16_MIN), INT16_MAX);
}

// C-style truncating division by 256 (toward zero, not floor).
inline int32_t gain_div256(int32_t g) { return (g + ((g >> 31) & 255)) >> 8; }

inline int block_size_for(int bits) { return bits * 4 + 1; }

// Unpack one block payload into "top-bits" int16-domain values.
inline void unpack(const uint8_t* src, int bits, int32_t out[kBlockSamples]) {
  switch (bits) {
    case 4:
      for (int i = 0; i < 16; i++) {
        out[2 * i] = static_cast<int16_t>((src[i] & 0xf0u) << 8);
        out[2 * i + 1] = static_cast<int16_t>((src[i] & 0x0fu) << 12);
      }
      break;
    case 6:
      for (int i = 0; i < 8; i++) {
        const uint32_t w = (static_cast<uint32_t>(src[3 * i]) << 16) |
                           (static_cast<uint32_t>(src[3 * i + 1]) << 8) |
                           src[3 * i + 2];
        out[4 * i] = static_cast<int16_t>((w & 0x00fc0000u) >> 8);
        out[4 * i + 1] = static_cast<int16_t>((w & 0x0003f000u) >> 2);
        out[4 * i + 2] = static_cast<int16_t>((w & 0x00000fc0u) << 4);
        out[4 * i + 3] = static_cast<int16_t>((w & 0x0000003fu) << 10);
      }
      break;
    default:  // 8
      for (int i = 0; i < kBlockSamples; i++)
        out[i] = static_cast<int16_t>(src[i] << 8);
  }
}

// Pack "top-bits" int16-domain values into a block payload.
inline void pack(const int32_t in[kBlockSamples], int bits, uint8_t* dst) {
  switch (bits) {
    case 4:
      for (int i = 0; i < 16; i++) {
        const uint16_t a = static_cast<uint16_t>(in[2 * i]);
        const uint16_t b = static_cast<uint16_t>(in[2 * i + 1]);
        dst[i] = static_cast<uint8_t>(((a >> 8) & 0xf0) | (b >> 12));
      }
      break;
    case 6:
      for (int i = 0; i < 8; i++) {
        uint32_t w = 0;
        for (int j = 0; j < 4; j++)
          w |= static_cast<uint32_t>(
                   (static_cast<uint16_t>(in[4 * i + j]) >> 10))
               << (18 - 6 * j);
        dst[3 * i] = static_cast<uint8_t>(w >> 16);
        dst[3 * i + 1] = static_cast<uint8_t>(w >> 8);
        dst[3 * i + 2] = static_cast<uint8_t>(w);
      }
      break;
    default:  // 8
      for (int i = 0; i < kBlockSamples; i++)
        dst[i] = static_cast<uint8_t>(static_cast<uint16_t>(in[i]) >> 8);
  }
}

// Run the prediction filter over one unpacked block for one channel.
// Returns false on an invalid profile factor (state untouched in that case).
inline bool filter_block(const int32_t ranged_src[kBlockSamples],
                         uint8_t profile, int32_t* p0, int32_t* p1,
                         int16_t* out, int stride) {
  const int factor = profile >> 4;
  const int shift = profile & 0x0f;
  if (factor >= kNumFactors) return false;
  const int32_t k0 = kGain[factor][0];
  const int32_t k1 = kGain[factor][1];
  int32_t a = *p0, b = *p1;
  for (int n = 0; n < kBlockSamples; n++) {
    const int32_t ranged = ranged_src[n] >> shift;
    const int32_t s = clamp16(ranged + gain_div256(a * k0 + b * k1));
    b = a;
    a = s;
    out[n * stride] = static_cast<int16_t>(s);
  }
  *p0 = a;
  *p1 = b;
  return true;
}

// Exhaustive 80-profile greedy search for one block of one channel: pick
// the (factor, range) whose in-loop reconstruction minimises squared error
// against `x[kBlockSamples]`, starting from taps (*p0, *p1).  Writes the
// chosen profile byte and the coded "top-bits" values, and advances the
// taps to the end state of the winning candidate.  The host twin of the
// device kernels in bjxa_tpu/ops/encode.py and ops/pallas_encode.py
// (same ranking contract: f32 sums of exactly rounded integer squares,
// first-best tie break).
inline void search_block(const int32_t x[kBlockSamples], int bits,
                         int32_t* p0, int32_t* p1, uint8_t* profile,
                         int32_t coded_out[kBlockSamples]) {
  const int shq = 16 - bits;
  const int32_t qmin = -(1 << (bits - 1));
  const int32_t qmax = (1 << (bits - 1)) - 1;

  int32_t coded[kBlockSamples];
  float best_err = -1.0f;
  int best_profile = 0;
  int32_t best_p0 = 0, best_p1 = 0;
  for (int factor = 0; factor < kNumFactors; factor++) {
    const int32_t k0 = kGain[factor][0];
    const int32_t k1 = kGain[factor][1];
    for (int range = 0; range < 16; range++) {
      int32_t a = *p0, b = *p1;
      float err = 0.0f;
      for (int n = 0; n < kBlockSamples; n++) {
        const int32_t pred = gain_div256(a * k0 + b * k1);
        const int32_t diff = x[n] - pred;
        int32_t q;
        if (range <= shq) {
          const int sh = shq - range;
          q = (diff + ((1 << sh) >> 1)) >> sh;
        } else {
          q = diff << (range - shq);
        }
        q = std::min(std::max(q, qmin), qmax);
        const int32_t d = q << shq;
        const int32_t recon = clamp16((d >> range) + pred);
        // exact square (|e| <= 65535 fits uint32), rounded once: the
        // value of an unfused float multiply, whatever the compiler
        // contracts
        const uint32_t e = static_cast<uint32_t>(x[n] - recon);
        err += static_cast<float>(e * e);
        b = a;
        a = recon;
        coded[n] = d;
      }
      if (best_err < 0.0f || err < best_err) {
        best_err = err;
        best_profile = (factor << 4) | range;
        best_p0 = a;
        best_p1 = b;
        std::memcpy(coded_out, coded, sizeof(coded));
      }
    }
  }
  *profile = static_cast<uint8_t>(best_profile);
  *p0 = best_p0;
  *p1 = best_p1;
}

}  // namespace bjxa_core

#endif  // BJXA_TPU_XA_CORE_H
