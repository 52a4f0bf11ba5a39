// Baseline JPEG codec for the host data path, with the arithmetic of
// libjpeg-turbo's default paths, so that decoded pixels equal what Pillow
// (built on libjpeg-turbo) returns for the same file:
//
//   decode: baseline (and extended sequential) Huffman, restart markers,
//           1 or 3 components, sampling h1v1, h2v1, h1v2 and h2v2; the
//           'islow' integer IDCT (jidctint.c), fancy (triangle) chroma
//           upsampling (jdsample.c), the fixed-point YCbCr->RGB tables of
//           jdcolor.c. Progressive, arithmetic-coded, lossless,
//           hierarchical and 12-bit files are refused with an error.
//   encode: RGB only, as Pillow's Image.save writes it by default:
//           baseline, quality 75 (libjpeg's scaled tables, jcparam.c),
//           4:2:0, standard Huffman tables, the fixed-point RGB->YCbCr
//           tables of jccolor.c, edge-replicated h2v2 downsampling
//           (jcsample.c), the 'islow' forward DCT (jfdctint.c) with
//           reciprocal quantisation (jcdctmgr.c), a JFIF 1.01 header and
//           libjpeg's marker order.
//
// Plain C interface, bound with ctypes: a call holds no Python state, so
// the caller's threads decode in parallel.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// ---------------------------------------------------------------- range limit

// libjpeg's post-IDCT range-limit table (jdmaster.c
// prepare_range_limit_table), indexed by (x & 1023) for an IDCT output x
// without its +128 offset.
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      idct[i] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- islow IDCT

const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// coef: dequantised coefficients in natural order; out: 8x8 samples.
void idct_islow(const int32_t* in, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* p = in + c;
    int32_t* w = ws + c;
    if (p[8] == 0 && p[16] == 0 && p[24] == 0 && p[32] == 0 && p[40] == 0 && p[48] == 0 &&
        p[56] == 0) {
      int32_t dc = p[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int32_t z2 = p[16], z3 = p[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = p[0];
    z3 = p[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = p[56];
    tmp1 = p[40];
    tmp2 = p[24];
    tmp3 = p[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.idct[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ---------------------------------------------------------------- islow FDCT

// In place on 64 centred samples (jfdctint.c): results scaled by 8.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + r * 8;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = CONST_BITS - PASS1_BITS;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, n);
    p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, n);
    p[5] = descale(tmp5 + z2 + z4, n);
    p[3] = descale(tmp6 + z2 + z3, n);
    p[1] = descale(tmp7 + z1 + z4, n);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32],
            tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = CONST_BITS + PASS1_BITS;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, n);
    p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, n);
    p[40] = descale(tmp5 + z2 + z4, n);
    p[24] = descale(tmp6 + z2 + z3, n);
    p[8] = descale(tmp7 + z1 + z4, n);
  }
}

// ---------------------------------------------------------------- Huffman tables

struct HuffDecode {
  bool present = false;
  uint8_t fast_len[512];  // 9-bit lookahead: code length (0 = longer code)
  uint8_t fast_sym[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_decode(HuffDecode& t, const uint8_t* bits, const uint8_t* vals, int nvals) {
  memset(t.fast_len, 0, sizeof t.fast_len);
  memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        int lo = code << (9 - len), n = 1 << (9 - len);
        for (int j = 0; j < n; ++j) {
          t.fast_len[lo + j] = (uint8_t)len;
          t.fast_sym[lo + j] = vals[k];
        }
      }
    }
    t.maxcode[len] = bits[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail("bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.present = true;
}

struct HuffEncode {
  uint16_t code[256];
  uint8_t size[256];
};

void build_encode(HuffEncode& t, const uint8_t* bits, const uint8_t* vals) {
  memset(t.size, 0, sizeof t.size);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      t.code[vals[k]] = (uint16_t)code;
      t.size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

// Annex K.3 tables (libjpeg's jstdhuff.c): bits per length, then values.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantisation tables, natural order.
const int kLumQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                           14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                           18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ---------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int blocks_w = 0, blocks_h = 0;  // blocks covering the component
  int plane_w = 0, plane_h = 0;    // samples stored (whole MCUs)
  int ds_w = 0, ds_h = 0;          // downsampled size
  int pred = 0;
  std::vector<uint8_t> plane;
};

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16). Built once, by the first
// decode of a colour file: a function-local static is initialised exactly
// once even when several threads reach it together.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t ONE_HALF = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + ONE_HALF) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + ONE_HALF) >> 16);  // FIX(1.77200)
      cr_g[i] = (int32_t)(-46802 * x);                 // -FIX(0.71414)
      cb_g[i] = (int32_t)(-22554 * x + ONE_HALF);      // -FIX(0.34414)
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;
  return tables;
}

struct Decoder {
  const uint8_t* data;
  size_t size, pos = 0;
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0, restart_interval = 0;
  bool have_frame = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffDecode dc[4], ac[4];
  Component comp[3];
  // bit reader
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int byte() {
    if (pos >= size) fail("truncated JPEG data");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void fill() {
    while (bitcnt <= 56) {
      int b = 0;
      if (!hit_marker) {
        if (pos >= size) {
          hit_marker = true;
        } else {
          b = data[pos];
          if (b == 0xFF) {
            size_t p = pos + 1;
            while (p < size && data[p] == 0xFF) ++p;  // fill bytes
            if (p < size && data[p] == 0x00) {
              pos = p + 1;
            } else {
              hit_marker = true;  // leave the marker for the parser
              b = 0;
            }
          } else {
            ++pos;
          }
        }
      }
      bitbuf |= (uint64_t)b << (56 - bitcnt);
      bitcnt += 8;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (bitcnt < n) fill();
    int v = (int)(bitbuf >> (64 - n));
    bitbuf <<= n;
    bitcnt -= n;
    return v;
  }
  int huff(const HuffDecode& t) {
    if (bitcnt < 16) fill();
    int look = (int)(bitbuf >> (64 - 9));
    int len = t.fast_len[look];
    if (len) {
      bitbuf <<= len;
      bitcnt -= len;
      return t.fast_sym[look];
    }
    int code = (int)(bitbuf >> (64 - 16));
    for (len = 10; len <= 16; ++len) {
      int c = code >> (16 - len);
      if (c <= t.maxcode[len]) {
        bitbuf <<= len;
        bitcnt -= len;
        return t.vals[(c + t.valoffset[len]) & 0xFF];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void read_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq = byte(), t = pq & 15;
      if (t > 3) fail("bad DQT table id");
      for (int i = 0; i < 64; ++i) qt[t][kZigzag[i]] = (pq >> 4) ? word() : byte();
      qt_present[t] = true;
    }
  }
  void read_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc = byte(), cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("bad DHT table id");
      uint8_t nb[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += nb[i] = (uint8_t)byte();
      if (total > 256) fail("bad DHT table");
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)byte();
      build_decode(cls ? ac[id] : dc[id], nb, vals, total);
    }
  }
  void read_sof(int len) {
    if (have_frame) fail("more than one frame");
    if (byte() != 8) fail("only 8-bit JPEG is supported");
    height = word();
    width = word();
    ncomp = byte();
    if (height == 0) fail("JPEG with a DNL marker is not supported");
    if (width == 0) fail("empty JPEG image");
    if (ncomp != 1 && ncomp != 3) fail("only 1- or 3-component JPEG is supported");
    if (len != 8 + 3 * ncomp) fail("bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad SOF component");
      max_h = c.h > max_h ? c.h : max_h;
      max_v = c.v > max_v ? c.v : max_v;
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (max_h % c.h || max_v % c.v || max_h / c.h > 2 || max_v / c.v > 2)
        fail("unsupported JPEG sampling factors");
      c.ds_w = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.ds_h = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.blocks_w = (c.ds_w + 7) / 8;
      c.blocks_h = (c.ds_h + 7) / 8;
      c.plane_w = mcus_x * c.h * 8;
      c.plane_h = mcus_y * c.v * 8;
      c.plane.assign((size_t)c.plane_w * c.plane_h, 0);
    }
    have_frame = true;
  }

  void decode_block(Component& c, int bx, int by) {
    int32_t coef[64];
    memset(coef, 0, sizeof coef);
    const HuffDecode& d = dc[c.td];
    const HuffDecode& a = ac[c.ta];
    int s = huff(d);
    if (s > 16) fail("corrupt JPEG data: bad DC size");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    const int* q = qt[c.tq];
    coef[0] = c.pred * q[0];
    for (int k = 1; k < 64;) {
      int rs = huff(a), r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG data: AC index out of range");
        int z = kZigzag[k];
        coef[z] = extend(bits(s), s) * q[z];
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, &c.plane[(size_t)by * 8 * c.plane_w + bx * 8], c.plane_w);
  }

  void restart() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    // expect RSTn (possibly after fill bytes)
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 >= size) fail("corrupt JPEG data: missing restart marker");
    pos += 2;
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
  }

  void read_sos(int len) {
    if (!have_frame) fail("SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].present || !ac[c->ta].present)
        fail("SOS uses a missing Huffman table");
      if (!qt_present[c->tq]) fail("frame uses a missing quantisation table");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) fail("bad sequential scan parameters");
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    int mcu = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.blocks_h; ++by)
        for (int bx = 0; bx < c.blocks_w; ++bx) {
          if (restart_interval && mcu && mcu % restart_interval == 0) restart();
          decode_block(c, bx, by);
          ++mcu;
        }
    } else {
      for (int my = 0; my < mcus_y; ++my)
        for (int mx = 0; mx < mcus_x; ++mx) {
          if (restart_interval && mcu && mcu % restart_interval == 0) restart();
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) decode_block(c, mx * c.h + h, my * c.v + v);
          }
          ++mcu;
        }
    }
    // Skip to the next marker.
    bitbuf = 0;
    bitcnt = 0;
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                               !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) &&
                               data[pos + 1] != 0xFF))
      ++pos;
  }

  // The whole file, or with header_only up to the frame header.
  void parse(bool header_only = false) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      if (pos >= size) {
        if (scanned) break;  // tolerate a missing EOI after the scan
        fail("truncated JPEG file");
      }
      if (data[pos] != 0xFF) fail("corrupt JPEG data: expected a marker");
      while (pos < size && data[pos] == 0xFF) ++pos;
      int m = byte();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      int len = word();
      if (len < 2 || pos + len - 2 > size) fail("corrupt JPEG marker length");
      size_t next = pos + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(len);
          if (header_only) return;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG is not supported (baseline only)");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported (baseline only)");
        case 0xC5:
          fail("hierarchical JPEG is not supported (baseline only)");
        case 0xC9:
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported (baseline only)");
        case 0xC4:
          read_dht(len);
          break;
        case 0xDB:
          read_dqt(len);
          break;
        case 0xDD:
          restart_interval = word();
          break;
        case 0xDA:
          read_sos(len);
          scanned = true;
          continue;  // read_sos leaves pos at the next marker
        case 0xE0:
          if (len >= 7 && !memcmp(data + pos, "JFIF", 5)) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && !memcmp(data + pos, "Adobe", 5)) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default:
          break;
      }
      pos = next;
    }
    if (!have_frame || !scanned) fail("JPEG without image data");
  }

  bool is_rgb() const {
    // jdapimin.c default_decompress_parms for three components.
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // Upsample component c to full size into out (width x height).
  void upsample(const Component& c, uint8_t* out) const {
    int rh = max_h / c.h, rv = max_v / c.v;
    const uint8_t* p = c.plane.data();
    int pw = c.plane_w, dw = c.ds_w, dh = c.ds_h;
    auto at = [&](int x, int y) -> int {  // edge-replicated real samples
      y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
      return p[(size_t)y * pw + x];
    };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < height; ++y) memcpy(out + (size_t)y * width, p + (size_t)y * pw, width);
      return;
    }
    if (rh == 2 && dw <= 2) {
      // jdsample.c: no fancy upsampling this narrow -- plain replication.
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x)
          out[(size_t)y * width + x] = p[(size_t)(y / rv) * pw + x / 2];
      return;
    }
    std::vector<int> row((size_t)dw);
    for (int oy = 0; oy < height; ++oy) {
      int iy = oy / rv;
      if (rv == 2) {
        int ny = (oy & 1) ? iy + 1 : iy - 1;  // next nearest row
        for (int x = 0; x < dw; ++x) row[x] = 3 * at(x, iy) + at(x, ny);
      } else {
        for (int x = 0; x < dw; ++x) row[x] = at(x, iy);
      }
      uint8_t* o = out + (size_t)oy * width;
      if (rh == 1) {
        int bias = (oy & 1) ? 2 : 1;  // h1v2_fancy_upsample
        for (int x = 0; x < width; ++x) o[x] = (uint8_t)((row[x] + bias) >> 2);
      } else if (rv == 1) {  // h2v1_fancy_upsample
        for (int x = 0; x < width; ++x) {
          int ix = x >> 1;
          int nb = (x & 1) ? (ix + 1 < dw ? ix + 1 : ix) : (ix > 0 ? ix - 1 : ix);
          o[x] = (uint8_t)((3 * row[ix] + row[nb] + ((x & 1) ? 2 : 1)) >> 2);
        }
      } else {  // h2v2_fancy_upsample
        for (int x = 0; x < width; ++x) {
          int ix = x >> 1;
          int nb = (x & 1) ? (ix + 1 < dw ? ix + 1 : ix) : (ix > 0 ? ix - 1 : ix);
          o[x] = (uint8_t)((3 * row[ix] + row[nb] + ((x & 1) ? 7 : 8)) >> 4);
        }
      }
    }
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      upsample(comp[0], out);
      return;
    }
    std::vector<uint8_t> full((size_t)width * height * 3);
    for (int i = 0; i < 3; ++i) upsample(comp[i], full.data() + (size_t)i * width * height);
    const uint8_t* y = full.data();
    const uint8_t* cb = y + (size_t)width * height;
    const uint8_t* cr = cb + (size_t)width * height;
    size_t n = (size_t)width * height;
    if (is_rgb()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    // jdcolor.c ycc_rgb_convert.
    const YccTables& t = ycc_tables();
    for (size_t i = 0; i < n; ++i) {
      int Y = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp255(Y + t.cr_r[r]);
      out[3 * i + 1] = clamp255(Y + ((t.cb_g[b] + t.cr_g[r]) >> 16));
      out[3 * i + 2] = clamp255(Y + t.cb_b[b]);
    }
  }
};

// ---------------------------------------------------------------- encoder

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)(buf >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
    buf &= (1u << cnt) - 1;
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEM (libjpeg-turbo's SIMD
// build) and the quantisation it feeds.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

inline int quantize(int t, const Divisor& d) {
  if (d.recip == 1 && d.shift == 0) return t;
  uint32_t a = (uint32_t)(t < 0 ? -t : t);
  uint32_t q = (uint32_t)(((uint64_t)((a + d.corr) & 0xFFFF) * d.recip) >> d.shift);
  return t < 0 ? -(int)q : (int)q;
}

void encode_block(BitWriter& bw, const int* coef, int& pred, const HuffEncode& dc,
                  const HuffEncode& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int t = diff < 0 ? -diff : diff, nbits = 0;
  while (t) {
    ++nbits;
    t >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int a = v < 0 ? -v : v;
    nbits = 0;
    while (a) {
      ++nbits;
      a >>= 1;
    }
    int sym = (run << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), nbits);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

struct EncComp {
  int h, v, tq, tbl;
  int blocks_w, blocks_h;  // width_in_blocks, height_in_blocks
  int plane_w, plane_h;    // padded sample plane: whole MCUs
  std::vector<uint8_t> plane;
};

// RGB pixels as Pillow's Image.save writes them by default: quality 75,
// luma sampled 2x2 against the chroma (4:2:0).
std::vector<uint8_t> encode(const uint8_t* px, int width, int height) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535) fail("bad image size");
  const int ncomp = 3, max_h = 2, max_v = 2;
  // jcparam.c jpeg_quality_scaling(75) + jpeg_add_quant_table (force_baseline).
  const int scale = 200 - 75 * 2;
  int qtab[2][64];
  for (int i = 0; i < 64; ++i) {
    const int* base[2] = {kLumQuant, kChromQuant};
    for (int t = 0; t < 2; ++t) {
      long v = ((long)base[t][i] * scale + 50) / 100;
      qtab[t][i] = (int)(v <= 0 ? 1 : (v > 255 ? 255 : v));
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)qtab[t][i] << 3);

  int mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
  int mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
  // Full-size colour planes (jccolor.c rgb_ycc_convert), input padded to an
  // even number of rows and to the chroma downsampler's input width by edge
  // replication (jcprepct.c expand_bottom_edge, jcsample.c
  // expand_right_edge).
  EncComp comps[3];
  int in_h = ((height + max_v - 1) / max_v) * max_v;
  for (int ci = 0; ci < ncomp; ++ci) {
    EncComp& c = comps[ci];
    c.h = c.v = ci == 0 ? 2 : 1;
    c.tq = c.tbl = ci == 0 ? 0 : 1;
    c.blocks_w = (int)(((int64_t)width * c.h + 8 * max_h - 1) / (8 * max_h));
    c.blocks_h = (int)(((int64_t)height * c.v + 8 * max_v - 1) / (8 * max_v));
    c.plane_w = mcus_x * c.h * 8;
    c.plane_h = mcus_y * c.v * 8;
    c.plane.assign((size_t)c.plane_w * c.plane_h, 0);
  }
  int in_w = comps[0].blocks_w * 8;
  if (comps[1].blocks_w * 16 > in_w) in_w = comps[1].blocks_w * 16;
  std::vector<uint8_t> full[3];
  for (int ci = 0; ci < ncomp; ++ci) full[ci].assign((size_t)in_w * in_h, 0);
  {
    const int64_t ONE_HALF = 1 << 15, CBCR_OFFSET = (int64_t)128 << 16;
    for (int y = 0; y < in_h; ++y) {
      const uint8_t* src = px + (size_t)(y < height ? y : height - 1) * width * ncomp;
      for (int x = 0; x < in_w; ++x) {
        const uint8_t* s = src + (size_t)(x < width ? x : width - 1) * ncomp;
        size_t o = (size_t)y * in_w + x;
        int64_t r = s[0], g = s[1], b = s[2];
        full[0][o] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + ONE_HALF) >> 16);
        full[1][o] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
        full[2][o] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
      }
    }
  }
  // Luma is copied, chroma downsampled 2x2 (jcsample.c fullsize_downsample,
  // h2v2_downsample); then the last row is replicated to the full plane
  // height (jcprepct.c).
  for (int ci = 0; ci < ncomp; ++ci) {
    EncComp& c = comps[ci];
    int out_w = c.blocks_w * 8, out_rows = in_h / (max_v / c.v);
    const std::vector<uint8_t>& f = full[ci];
    for (int oy = 0; oy < out_rows; ++oy) {
      uint8_t* o = &c.plane[(size_t)oy * c.plane_w];
      if (ci == 0) {
        memcpy(o, &f[(size_t)oy * in_w], out_w);
        continue;
      }
      const uint8_t* r0 = &f[(size_t)(2 * oy) * in_w];
      const uint8_t* r1 = r0 + in_w;
      int bias = 1;
      for (int x = 0; x < out_w; ++x) {
        o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int oy = out_rows; oy < c.plane_h; ++oy)
      memcpy(&c.plane[(size_t)oy * c.plane_w], &c.plane[(size_t)(out_rows - 1) * c.plane_w],
             out_w);
  }

  std::vector<uint8_t> out;
  out.reserve((size_t)width * height * ncomp / 2 + 1024);
  out.push_back(0xFF);
  out.push_back(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), app0, app0 + sizeof app0);
  for (int t = 0; t < 2; ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) out.push_back((uint8_t)qtab[t][kZigzag[i]]);
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * ncomp);
  out.push_back(8);
  put16(out, height);
  put16(out, width);
  out.push_back((uint8_t)ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    out.push_back((uint8_t)(ci + 1));
    out.push_back((uint8_t)((comps[ci].h << 4) | comps[ci].v));
    out.push_back((uint8_t)comps[ci].tq);
  }
  const uint8_t* dht_bits[2][2] = {{kDcLumBits, kAcLumBits}, {kDcChromBits, kAcChromBits}};
  const uint8_t* dht_vals[2][2] = {{kDcVals, kAcLumVals}, {kDcVals, kAcChromVals}};
  HuffEncode henc[2][2];
  for (int t = 0; t < 2; ++t)
    for (int cls = 0; cls < 2; ++cls) {
      int nvals = 0;
      for (int i = 0; i < 16; ++i) nvals += dht_bits[t][cls][i];
      out.push_back(0xFF);
      out.push_back(0xC4);
      put16(out, 2 + 1 + 16 + nvals);
      out.push_back((uint8_t)((cls << 4) | t));
      out.insert(out.end(), dht_bits[t][cls], dht_bits[t][cls] + 16);
      out.insert(out.end(), dht_vals[t][cls], dht_vals[t][cls] + nvals);
      build_encode(henc[t][cls], dht_bits[t][cls], dht_vals[t][cls]);
    }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * ncomp);
  out.push_back((uint8_t)ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    out.push_back((uint8_t)(ci + 1));
    out.push_back((uint8_t)((comps[ci].tbl << 4) | comps[ci].tbl));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // jccoefct.c compress_data: real blocks through the FDCT; dummy blocks
  // past the right or bottom edge of a component carry only a DC, copied
  // from the block before them.
  BitWriter bw(out);
  int pred[3] = {0, 0, 0};
  int blocks[8][64];
  for (int my = 0; my < mcus_y; ++my)
    for (int mx = 0; mx < mcus_x; ++mx)
      for (int ci = 0; ci < ncomp; ++ci) {
        EncComp& c = comps[ci];
        int n = 0;
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h, ++n) {
            int bx = mx * c.h + h, by = my * c.v + v;
            int* blk = blocks[n];
            if (by >= c.blocks_h) {
              memset(blk, 0, sizeof(int) * 64);
              blk[0] = blocks[v * c.h - 1][0];
            } else if (bx >= c.blocks_w) {
              memset(blk, 0, sizeof(int) * 64);
              blk[0] = blocks[n - 1][0];
            } else {
              int32_t ws[64];
              for (int r = 0; r < 8; ++r)
                for (int x = 0; x < 8; ++x)
                  ws[r * 8 + x] = (int32_t)c.plane[(size_t)(by * 8 + r) * c.plane_w + bx * 8 + x] - 128;
              fdct_islow(ws);
              for (int i = 0; i < 64; ++i) blk[i] = quantize(ws[i], div[c.tq][i]);
            }
          }
        for (int i = 0; i < n; ++i)
          encode_block(bw, blocks[i], pred[ci], henc[c.tbl][0], henc[c.tbl][1]);
      }
  if (bw.cnt) bw.put(0x7F, 8 - bw.cnt);  // jchuff.c flush_bits: pad with 1s
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Header only: width, height and output channels (1 or 3). 0 on success.
int jpeg_info(const uint8_t* data, int64_t size, int* width, int* height, int* channels,
              char* err, int errlen) {
  try {
    Decoder d(data, (size_t)size);
    d.parse(true);
    *width = d.width;
    *height = d.height;
    *channels = d.ncomp;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

// Decode into out (height x width x channels, uint8). 0 on success.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err,
                int errlen) {
  try {
    Decoder d(data, (size_t)size);
    d.parse();
    if ((int64_t)d.width * d.height * d.ncomp != out_size) fail("output buffer size mismatch");
    d.output(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

// Encode RGB pixels (height x width x 3, uint8) as a baseline JFIF file at
// quality 75 and 4:2:0. Writes at most cap bytes into out; returns the
// file's size (more than cap: call again with a larger buffer), or -1 on
// error.
int64_t jpeg_encode(const uint8_t* pixels, int width, int height, uint8_t* out, int64_t cap,
                    char* err, int errlen) {
  try {
    std::vector<uint8_t> f = encode(pixels, width, height);
    if ((int64_t)f.size() <= cap) memcpy(out, f.data(), f.size());
    return (int64_t)f.size();
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

}  // extern "C"
