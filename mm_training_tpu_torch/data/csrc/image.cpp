// Host image library of the port: JPEG decode and encode, the bilinear
// remap of camera virtualization, the HSV round trip of the image
// augmentation, a per-channel lookup table and the bilinear resize of the
// synthetic writer.
//
// The JAX package does this work with OpenCV on the host
// (mm_training_tpu/data/loaders.py:95-99 cv2.imread,
// data/sensor_models/cameras.py:136-166 cv2.convertMaps + cv2.remap,
// data/aimotive_dataset.py:60-79 cv2.cvtColor + cv2.LUT,
// data/synthetic.py:168-189 cv2.resize + cv2.imwrite). Each function here
// gives the bytes of its OpenCV counterpart, so the port's batches equal
// the JAX loader's without OpenCV:
//   * jpeg_decode: libjpeg-turbo's default decode as cv2.imread asks for
//     it (baseline sequential Huffman, 8-bit, 1 or 3 components, sampling
//     4:4:4, 4:2:2 or 4:2:0, restart markers): the ISLOW integer IDCT of
//     jidctint.c with its range limit, "fancy" triangle upsampling of the
//     chroma (jdsample.c h2v1/h2v2_fancy_upsample) and the fixed-point
//     YCbCr->RGB tables of jdcolor.c; grey is replicated to BGR. Anything
//     else (progressive, arithmetic, 12-bit, lossless, CMYK, RGB-coded,
//     other samplings, an EXIF orientation that cv2 would apply) is
//     refused with a code naming the feature, never decoded differently.
//   * jpeg_encode: a baseline 4:2:0 encoder with the Annex K tables scaled
//     as libjpeg's jpeg_quality_scaling (its files are not cv2's; any
//     decoder reads them).
//   * convert_maps + remap_linear_u8: cv2.convertMaps(CV_16SC2) and
//     cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0): 5 fractional bits
//     (INTER_TAB_SIZE 32) rounded half to even, the 15-bit weight table of
//     initInterTab2D, every tap outside the source weighted as 0.
//   * bgr_to_hsv_u8 / hsv_to_bgr_u8: cv2.cvtColor BGR2HSV / HSV2BGR on
//     uint8, H in [0, 180): the hsv_shift 12 division tables one way; the
//     other OpenCV's vector path in float32 (two fused multiply-adds,
//     truncation).
//   * lut_u8: cv2.LUT with one table a channel.
//   * resize_linear_u8: cv2.resize(INTER_LINEAR) on uint8: 11-bit fixed
//     point weights at half-pixel centres.
//
// Built by g++ at first use (ops/build.py::load_host) and bound with ctypes
// (data/image.py), which releases the GIL for the length of each call.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ JPEG

// error codes, named in data/image.py
enum {
  kNotJpeg = -1,
  kCorrupt = -2,
  kProgressive = -3,
  kArithmetic = -4,
  kPrecision = -5,
  kLossless = -6,
  kSampling = -7,
  kOrientation = -8,
  kComponents = -9,
  kRgbCoded = -10,
  kBufferSmall = -11,
  kNoHeight = -12,
};

// zigzag -> natural order, 16 guard entries for a run past the block end
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 = longer code

  bool derive() {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        if (p >= 256) return false;
        huffsize[p++] = l;
      }
    }
    huffsize[p] = 0;
    int n = p, code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    for (int i = 0; i < n; ++i) {
      int l = huffsize[i];
      if (l > kLookBits) continue;
      int lo = huffcode[i] << (kLookBits - l);
      for (int j = 0; j < (1 << (kLookBits - l)); ++j)
        look[lo + j] = static_cast<uint16_t>((l << 8) | vals[i]);
    }
    return true;
  }
};

// MSB-first bit reader over entropy-coded data: 0xFF00 is a data 0xFF;
// at a marker it stops and feeds zero bits (libjpeg's behaviour on a
// truncated segment)
struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          uint8_t next = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int k) {
    if (nbits < k) fill();
    return static_cast<int>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    if (nbits < 16) fill();
    int e = t.look[acc >> (64 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    if (l > 16) {  // corrupt: libjpeg fakes a zero
      skip(16);
      return 0;
    }
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // restart: drop the buffered bits and consume the next RSTn marker
  bool restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (pos + 1 < n) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
        pos += 2;
        return true;
      }
      ++pos;
    }
    return false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // Huffman tables of the current scan
  int bw = 0, bh = 0;              // blocks of the coefficient plane
  int dw = 0, dh = 0;              // downsampled width and height
  int pred = 0;
  std::vector<int16_t> coef;       // bw * bh blocks of 64, natural order
};

struct Jpeg {
  const uint8_t* data;
  size_t n;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64] = {};         // natural order
  bool qt_defined[4] = {};
  HuffTable dc[4], ac[4];
  Component comp[3];
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// EXIF orientation of an APP1 segment body, 0 when absent
int exif_orientation(const uint8_t* p, int len) {
  if (len < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return 0;
  const uint8_t* t = p + 6;
  int tlen = len - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 0;
  auto u16 = [&](int o) -> int {
    return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
  };
  auto u32 = [&](int o) -> uint32_t {
    return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) |
                    ((uint32_t)t[o + 3] << 24)
              : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) |
                    ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3];
  };
  uint32_t ifd = u32(4);
  if (ifd + 2 > static_cast<uint32_t>(tlen)) return 0;
  int count = u16(ifd);
  for (int i = 0; i < count; ++i) {
    uint32_t e = ifd + 2 + 12 * i;
    if (e + 12 > static_cast<uint32_t>(tlen)) return 0;
    if (u16(e) == 0x0112) return u16(e + 8);
  }
  return 0;
}

int read_frame(Jpeg& j, const uint8_t* p, int len, int marker) {
  if (marker == 0xC2 || marker == 0xC6) return kProgressive;
  if (marker == 0xC3 || marker == 0xC7) return kLossless;
  if (marker == 0xC5) return kProgressive;
  if (marker >= 0xC9) return kArithmetic;
  if (len < 6) return kCorrupt;
  if (p[0] != 8) return kPrecision;
  j.height = be16(p + 1);
  j.width = be16(p + 3);
  j.ncomp = p[5];
  if (j.height == 0) return kNoHeight;
  if (j.width == 0 || static_cast<int64_t>(j.width) * j.height > (int64_t(1) << 28))
    return kCorrupt;
  if (j.ncomp != 1 && j.ncomp != 3) return kComponents;
  if (len < 6 + 3 * j.ncomp) return kCorrupt;
  j.hmax = j.vmax = 1;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c] & 3;
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) return kCorrupt;
    j.hmax = std::max(j.hmax, k.h);
    j.vmax = std::max(j.vmax, k.v);
  }
  if (j.ncomp == 1) {
    j.comp[0].h = j.comp[0].v = j.hmax = j.vmax = 1;
  } else {
    // luma (1,1), (2,1) or (2,2) over chroma (1,1): 4:4:4, 4:2:2, 4:2:0
    const Component* k = j.comp;
    bool ok = k[1].h == 1 && k[1].v == 1 && k[2].h == 1 && k[2].v == 1 &&
              ((k[0].h == 1 && k[0].v == 1) || (k[0].h == 2 && k[0].v == 1) ||
               (k[0].h == 2 && k[0].v == 2));
    if (!ok) return kSampling;
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.bw = j.mcux * k.h;
    k.bh = j.mcuy * k.v;
    k.dw = (j.width * k.h + j.hmax - 1) / j.hmax;
    k.dh = (j.height * k.v + j.vmax - 1) / j.vmax;
  }
  j.frame = true;
  return 0;
}

int read_dht(Jpeg& j, const uint8_t* p, int len) {
  int o = 0;
  while (o < len) {
    if (o + 17 > len) return kCorrupt;
    int tc = p[o] >> 4, th = p[o] & 15;
    if (tc > 1 || th > 3) return kCorrupt;
    HuffTable& t = tc == 0 ? j.dc[th] : j.ac[th];
    int total = 0;
    t.bits[0] = 0;
    for (int l = 1; l <= 16; ++l) {
      t.bits[l] = p[o + l];
      total += t.bits[l];
    }
    if (total > 256 || o + 17 + total > len) return kCorrupt;
    std::memset(t.vals, 0, sizeof(t.vals));
    std::memcpy(t.vals, p + o + 17, total);
    if (!t.derive()) return kCorrupt;
    t.defined = true;
    o += 17 + total;
  }
  return 0;
}

int read_dqt(Jpeg& j, const uint8_t* p, int len) {
  int o = 0;
  while (o < len) {
    int pq = p[o] >> 4, tq = p[o] & 15;
    if (tq > 3 || pq > 1) return kCorrupt;
    int need = 1 + 64 * (pq + 1);
    if (o + need > len) return kCorrupt;
    for (int k = 0; k < 64; ++k) {
      int v = pq ? be16(p + o + 1 + 2 * k) : p[o + 1 + k];
      j.qt[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
    }
    j.qt_defined[tq] = true;
    o += need;
  }
  return 0;
}

void decode_block(BitReader& br, Component& k, const HuffTable& dct, const HuffTable& act,
                  int16_t* blk) {
  int s = std::min(br.decode(dct), 16);   // more is corrupt: keep the shift defined
  int diff = s ? extend(br.get(s), s) : 0;
  k.pred += diff;
  blk[0] = static_cast<int16_t>(k.pred);
  for (int i = 1; i < 64; ++i) {
    int rs = br.decode(act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      blk[kNaturalOrder[i]] = static_cast<int16_t>(extend(br.get(s), s));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

// one scan: entropy-decode its blocks into the coefficient planes;
// returns the offset just past the scan's entropy-coded data
int decode_scan(Jpeg& j, const uint8_t* p, int len, size_t data_start, size_t* end) {
  if (!j.frame) return kCorrupt;
  int ns = p[0];
  if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) return kCorrupt;
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = p[1 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == id) k = &j.comp[c];
    if (!k) return kCorrupt;
    k->td = p[2 + 2 * i] >> 4;
    k->ta = p[2 + 2 * i] & 15;
    if (k->td > 3 || k->ta > 3 || !j.dc[k->td].defined || !j.ac[k->ta].defined)
      return kCorrupt;
    if (k->coef.empty()) k->coef.assign(static_cast<size_t>(k->bw) * k->bh * 64, 0);
    k->pred = 0;
    sc[i] = k;
  }
  int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahal = p[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) return kProgressive;

  BitReader br{j.data, j.n, data_start};
  int mx, my;
  if (ns == 1) {  // non-interleaved: one block an MCU over the component's own extent
    mx = (sc[0]->dw + 7) / 8;
    my = (sc[0]->dh + 7) / 8;
  } else {
    mx = j.mcux;
    my = j.mcuy;
  }
  int64_t total = static_cast<int64_t>(mx) * my;
  int todo = j.restart_interval;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart_interval) {
      if (todo == 0) {
        br.restart();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        todo = j.restart_interval;
      }
      --todo;
    }
    int bx = static_cast<int>(m % mx), by = static_cast<int>(m / mx);
    if (ns == 1) {
      Component& k = *sc[0];
      decode_block(br, k, j.dc[k.td], j.ac[k.ta],
                   &k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64]);
    } else {
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        for (int v = 0; v < k.v; ++v)
          for (int h = 0; h < k.h; ++h) {
            size_t b = static_cast<size_t>(by * k.v + v) * k.bw + bx * k.h + h;
            decode_block(br, k, j.dc[k.td], j.ac[k.ta], &k.coef[b * 64]);
          }
      }
    }
  }
  // past the entropy-coded data: the next marker that is not RSTn
  size_t q = br.pos;
  while (q + 1 < j.n) {
    if (j.data[q] == 0xFF && j.data[q + 1] != 0x00 && j.data[q + 1] != 0xFF &&
        !(j.data[q + 1] >= 0xD0 && j.data[q + 1] <= 0xD7))
      break;
    ++q;
  }
  *end = q;
  return 0;
}

// Parse the markers up to the first SOS (the header, !decode) or through
// EOI, entropy-decoding every scan into the coefficient planes (decode).
int parse(Jpeg& j, bool decode) {
  if (j.n < 4 || j.data[0] != 0xFF || j.data[1] != 0xD8) return kNotJpeg;
  size_t pos = 2;
  bool scanned = false;
  while (true) {
    while (pos < j.n && j.data[pos] != 0xFF) ++pos;    // tolerate junk between segments
    while (pos < j.n && j.data[pos] == 0xFF) ++pos;     // fill bytes
    if (pos >= j.n) return scanned ? 0 : kCorrupt;      // truncated after the data
    int marker = j.data[pos++];
    if (marker == 0xD9) return scanned || !decode ? 0 : kCorrupt;
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (pos + 2 > j.n) return kCorrupt;
    int seglen = be16(j.data + pos);
    if (seglen < 2 || pos + seglen > j.n) return kCorrupt;
    const uint8_t* p = j.data + pos + 2;
    int len = seglen - 2;
    pos += seglen;
    int rc = 0;
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
      if (j.frame) return kCorrupt;
      rc = read_frame(j, p, len, marker);
    } else if (marker == 0xCC) {
      return kArithmetic;
    } else if (marker == 0xC4) {
      rc = read_dht(j, p, len);
    } else if (marker == 0xDB) {
      rc = read_dqt(j, p, len);
    } else if (marker == 0xDD) {
      if (len < 2) return kCorrupt;
      j.restart_interval = be16(p);
    } else if (marker == 0xE0) {
      if (len >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) j.jfif = true;
    } else if (marker == 0xE1) {
      int o = exif_orientation(p, len);
      if (o >= 2 && o <= 8) return kOrientation;
    } else if (marker == 0xEE) {
      if (len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        j.adobe = true;
        j.adobe_transform = p[11];
      }
    } else if (marker == 0xDA) {
      if (j.ncomp == 3 && !j.jfif) {
        // jdapimin.c default_decompress_parms: RGB when an Adobe marker
        // says transform 0, or without one when the ids are 'R','G','B'
        bool rgb = j.adobe ? j.adobe_transform == 0
                           : (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B');
        if (rgb) return kRgbCoded;
      }
      if (!decode) return j.frame ? 0 : kCorrupt;
      size_t end;
      rc = decode_scan(j, p, len, pos, &end);
      if (rc) return rc;
      pos = end;
      scanned = true;
    }
    if (rc) return rc;
  }
}

// ISLOW inverse DCT of jidctint.c into 8 rows of `out` (stride `stride`)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                  F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                  F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

// the post-IDCT range limit: the sum wraps as a 10-bit signed value, then
// +128 and clamps to [0, 255] (jdmaster.c prepare_range_limit_table)
inline uint8_t range_limit(int32_t x) {
  int32_t w = ((x + 512) & 1023) - 512 + 128;
  return static_cast<uint8_t>(w < 0 ? 0 : (w > 255 ? 255 : w));
}

// the 8-point butterfly of jidctint.c: out[k] is the k-th sample of the
// inverse DCT of in[0..7], before its descale
inline void idct_1d(const int64_t* in, int64_t* out) {
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * F_0_541;
  int64_t tmp2 = z1 + z3 * (-F_1_847);
  int64_t tmp3 = z1 + z2 * F_0_765;
  int64_t tmp0 = (in[0] + in[4]) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (in[0] - in[4]) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7];
  tmp1 = in[5];
  tmp2 = in[3];
  tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * F_1_175;
  tmp0 *= F_0_298;
  tmp1 *= F_2_053;
  tmp2 *= F_3_072;
  tmp3 *= F_1_501;
  z1 *= -F_0_899;
  z2 *= -F_2_562;
  z3 = z3 * -F_1_961 + z5;
  z4 = z4 * -F_0_390 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// jidctint.c's jpeg_idct_islow: columns (dequantized) into a work block
// descaled by 11 bits, then rows descaled by 18 and range-limited into 8
// rows of `out` (stride `stride`). A column of zero AC coefficients takes
// the same values without the butterfly.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  int64_t v[8], o[8];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (static_cast<int32_t>(ip[0]) * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    for (int k = 0; k < 8; ++k) v[k] = int64_t(ip[8 * k]) * qp[8 * k];
    idct_1d(v, o);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = descale(o[r], kConstBits - kPass1Bits);
  }
  for (int r = 0; r < 8; ++r) {
    for (int k = 0; k < 8; ++k) v[k] = ws[8 * r + k];
    idct_1d(v, o);
    uint8_t* row = out + static_cast<size_t>(r) * stride;
    for (int k = 0; k < 8; ++k) row[k] = range_limit(descale(o[k], kConstBits + kPass1Bits + 3));
  }
}

// jdcolor.c build_ycc_rgb_table: 16-bit fixed point
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int sb = 16;
    const int32_t half = 1 << (sb - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> sb);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> sb);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jdsample.c h2v1_fancy_upsample of one row of `dw` samples into 2*dw
void h2v1_fancy(const uint8_t* in, int dw, uint8_t* out) {
  int v = in[0];
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
  for (int c = 1; c < dw - 1; ++c) {
    v = in[c] * 3;
    out[2 * c] = static_cast<uint8_t>((v + in[c - 1] + 1) >> 2);
    out[2 * c + 1] = static_cast<uint8_t>((v + in[c + 1] + 2) >> 2);
  }
  v = in[dw - 1];
  out[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = static_cast<uint8_t>(v);
}

// jdsample.c h2v2_fancy_upsample of one output row from the nearer input
// row `near` and the farther `far` (above for even rows, below for odd)
void h2v2_fancy(const uint8_t* near, const uint8_t* far, int dw, uint8_t* out) {
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int c = 1; c < dw - 1; ++c) {
    next_sum = near[c + 1] * 3 + far[c + 1];
    out[2 * c] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * c + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

// ---------------------------------------------------------- JPEG encoder

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int code_v = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        code[vals[p]] = static_cast<uint16_t>(code_v++);
        size[vals[p]] = static_cast<uint8_t>(l);
      }
      code_v <<= 1;
    }
  }
};

struct ByteSink {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;
  void byte(int b) { buf.push_back(static_cast<uint8_t>(b)); }
  void word(int w) { byte(w >> 8); byte(w & 0xFF); }
  void bits(uint32_t v, int k) {
    if (!k) return;
    acc = (acc << k) | (v & ((1u << k) - 1));
    nbits += k;
    while (nbits >= 8) {
      int b = static_cast<int>((acc >> (nbits - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) bits(0x7F, 8 - nbits);  // pad with ones
  }
};

int quality_scale(int quality) {
  quality = std::min(100, std::max(1, quality));
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

void scaled_table(const uint8_t* base, int scale, uint16_t* out) {
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint16_t>(std::min(255L, std::max(1L, t)));
  }
}

// forward DCT (orthonormal, float) of a level-shifted 8x8 block, quantized
void fdct_quantize(const float* blk, const uint16_t* q, int16_t* out) {
  static float cosm[8][8];
  static bool init = [] {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        cosm[u][x] = static_cast<float>((u == 0 ? std::sqrt(0.125) : 0.5) *
                                        std::cos((2 * x + 1) * u * M_PI / 16.0));
    return true;
  }();
  (void)init;
  float tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += cosm[u][x] * blk[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += cosm[v][y] * tmp[y * 8 + u];
      long c = std::lround(s / q[v * 8 + u]);
      out[v * 8 + u] = static_cast<int16_t>(std::min(1023L, std::max(-1023L, c)));
    }
}

int bit_length(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(ByteSink& s, const int16_t* coef, int& pred, const EncTable& dc,
                  const EncTable& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int n = bit_length(diff);
  s.bits(dc.code[n], dc.size[n]);
  s.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNaturalOrder[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      s.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = bit_length(v);
    int rs = (run << 4) | n;
    s.bits(ac.code[rs], ac.size[rs]);
    s.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) s.bits(ac.code[0], ac.size[0]);
}

void write_dht(ByteSink& s, int tc_th, const uint8_t* bits, const uint8_t* vals, int nvals) {
  s.word(0xFFC4);
  s.word(2 + 1 + 16 + nvals);
  s.byte(tc_th);
  for (int l = 1; l <= 16; ++l) s.byte(bits[l]);
  for (int i = 0; i < nvals; ++i) s.byte(vals[i]);
}

// OpenCV's saturate_cast<int>(float) rounding: to nearest, ties to even
inline int round_even(double x) { return static_cast<int>(std::nearbyint(x)); }

}  // namespace

extern "C" {

// Header of a JPEG held in memory: dims = {height, width, components}.
// Returns 0 or a negative code (data/image.py names them).
int jpeg_header(const uint8_t* data, int64_t n, int32_t* dims) {
  Jpeg j;
  j.data = data;
  j.n = static_cast<size_t>(n);
  int rc = parse(j, false);
  if (rc) return rc;
  dims[0] = j.height;
  dims[1] = j.width;
  dims[2] = j.ncomp;
  return 0;
}

// Decode to BGR: out holds height * width * 3 bytes.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width) {
  Jpeg j;
  j.data = data;
  j.n = static_cast<size_t>(n);
  int rc = parse(j, true);
  if (rc) return rc;
  if (j.height != height || j.width != width) return kBufferSmall;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (!j.qt_defined[k.tq]) return kCorrupt;
    if (k.coef.empty()) k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
  }
  // the IDCT of every block into its component plane
  std::vector<uint8_t> plane[3];
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    int stride = k.bw * 8;
    plane[c].resize(static_cast<size_t>(stride) * k.bh * 8);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64], j.qt[k.tq],
                   &plane[c][static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  }
  const size_t W = static_cast<size_t>(width);
  if (j.ncomp == 1) {
    int stride = j.comp[0].bw * 8;
    for (int y = 0; y < height; ++y) {
      const uint8_t* yp = &plane[0][static_cast<size_t>(y) * stride];
      uint8_t* o = out + y * W * 3;
      for (size_t x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yp[x];
    }
    return 0;
  }
  static const YccTables tab;
  const Component& luma = j.comp[0];
  const Component& cb = j.comp[1];
  int ys = luma.bw * 8, cs = cb.bw * 8;
  int dw = cb.dw, dh = cb.dh;
  std::vector<uint8_t> up[2];
  for (int i = 0; i < 2; ++i) up[i].resize(2 * static_cast<size_t>(cs) + 16);
  for (int y = 0; y < height; ++y) {
    const uint8_t* yp = &plane[0][static_cast<size_t>(y) * ys];
    const uint8_t* ch[2];
    for (int i = 0; i < 2; ++i) {
      const std::vector<uint8_t>& p = plane[1 + i];
      if (luma.h == 1) {                       // 4:4:4
        ch[i] = &p[static_cast<size_t>(y) * cs];
      } else if (luma.v == 1) {                // 4:2:2
        const uint8_t* row = &p[static_cast<size_t>(y) * cs];
        if (dw > 2) {
          h2v1_fancy(row, dw, up[i].data());
        } else {
          for (int x = 0; x < dw; ++x) up[i][2 * x] = up[i][2 * x + 1] = row[x];
        }
        ch[i] = up[i].data();
      } else {                                 // 4:2:0
        int r = y / 2;
        const uint8_t* near = &p[static_cast<size_t>(r) * cs];
        if (dw > 2) {
          int fr = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
          h2v2_fancy(near, &p[static_cast<size_t>(fr) * cs], dw, up[i].data());
        } else {
          for (int x = 0; x < dw; ++x) up[i][2 * x] = up[i][2 * x + 1] = near[x];
        }
        ch[i] = up[i].data();
      }
    }
    uint8_t* o = out + y * W * 3;
    for (size_t x = 0; x < W; ++x) {
      int Y = yp[x], Cb = ch[0][x], Cr = ch[1][x];
      o[3 * x + 0] = clamp255(Y + tab.cb_b[Cb]);
      o[3 * x + 1] = clamp255(Y + static_cast<int>((tab.cb_g[Cb] + tab.cr_g[Cr]) >> 16));
      o[3 * x + 2] = clamp255(Y + tab.cr_r[Cr]);
    }
  }
  return 0;
}

// Encode BGR [height, width, 3] as a baseline 4:2:0 JPEG into out
// (capacity cap). Returns the byte count, or -(bytes needed) when cap is
// too small.
int64_t jpeg_encode(const uint8_t* bgr, int32_t height, int32_t width, int32_t quality,
                    uint8_t* out, int64_t cap) {
  uint16_t q[2][64];
  int scale = quality_scale(quality);
  scaled_table(kStdLumaQ, scale, q[0]);
  scaled_table(kStdChromaQ, scale, q[1]);
  static const EncTable dc_l(kDcLumaBits, kDcVals), dc_c(kDcChromaBits, kDcVals),
      ac_l(kAcLumaBits, kAcLumaVals), ac_c(kAcChromaBits, kAcChromaVals);

  int mx = (width + 15) / 16, my = (height + 15) / 16;
  int pw = mx * 16, ph = my * 16;
  // YCbCr planes of the edge-replicated padded image, chroma averaged 2x2
  std::vector<float> Y(static_cast<size_t>(pw) * ph), Cb(static_cast<size_t>(pw / 2) * (ph / 2)),
      Cr(Cb.size());
  std::vector<float> cbf(static_cast<size_t>(pw) * ph), crf(cbf.size());
  for (int y = 0; y < ph; ++y) {
    int sy = std::min(y, height - 1);
    for (int x = 0; x < pw; ++x) {
      int sx = std::min(x, width - 1);
      const uint8_t* p = bgr + (static_cast<size_t>(sy) * width + sx) * 3;
      float b = p[0], g = p[1], r = p[2];
      size_t i = static_cast<size_t>(y) * pw + x;
      Y[i] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
      cbf[i] = -0.168736f * r - 0.331264f * g + 0.5f * b;
      crf[i] = 0.5f * r - 0.418688f * g - 0.081312f * b;
    }
  }
  for (int y = 0; y < ph / 2; ++y)
    for (int x = 0; x < pw / 2; ++x) {
      size_t a = static_cast<size_t>(2 * y) * pw + 2 * x;
      size_t i = static_cast<size_t>(y) * (pw / 2) + x;
      Cb[i] = 0.25f * (cbf[a] + cbf[a + 1] + cbf[a + pw] + cbf[a + pw + 1]);
      Cr[i] = 0.25f * (crf[a] + crf[a + 1] + crf[a + pw] + crf[a + pw + 1]);
    }

  ByteSink s;
  s.word(0xFFD8);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  s.word(0xFFE0);
  s.word(16);
  for (uint8_t b : jfif) s.byte(b);
  for (int t = 0; t < 2; ++t) {
    s.word(0xFFDB);
    s.word(67);
    s.byte(t);
    for (int k = 0; k < 64; ++k) s.byte(q[t][kNaturalOrder[k]]);
  }
  s.word(0xFFC0);
  s.word(17);
  s.byte(8);
  s.word(height);
  s.word(width);
  s.byte(3);
  const int comp_spec[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (const auto& c : comp_spec) {
    s.byte(c[0]);
    s.byte(c[1]);
    s.byte(c[2]);
  }
  write_dht(s, 0x00, kDcLumaBits, kDcVals, 12);
  write_dht(s, 0x10, kAcLumaBits, kAcLumaVals, 162);
  write_dht(s, 0x01, kDcChromaBits, kDcVals, 12);
  write_dht(s, 0x11, kAcChromaBits, kAcChromaVals, 162);
  s.word(0xFFDA);
  s.word(12);
  s.byte(3);
  const int scan_spec[3][2] = {{1, 0x00}, {2, 0x11}, {3, 0x11}};
  for (const auto& c : scan_spec) {
    s.byte(c[0]);
    s.byte(c[1]);
  }
  s.byte(0);
  s.byte(63);
  s.byte(0);

  int pred[3] = {0, 0, 0};
  float blk[64];
  int16_t coef[64];
  for (int by = 0; by < my; ++by)
    for (int bx = 0; bx < mx; ++bx) {
      for (int v = 0; v < 2; ++v)
        for (int h = 0; h < 2; ++h) {
          for (int r = 0; r < 8; ++r)
            std::memcpy(blk + 8 * r,
                        &Y[static_cast<size_t>(by * 16 + v * 8 + r) * pw + bx * 16 + h * 8],
                        8 * sizeof(float));
          fdct_quantize(blk, q[0], coef);
          encode_block(s, coef, pred[0], dc_l, ac_l);
        }
      for (int c = 0; c < 2; ++c) {
        const std::vector<float>& p = c == 0 ? Cb : Cr;
        for (int r = 0; r < 8; ++r)
          std::memcpy(blk + 8 * r, &p[static_cast<size_t>(by * 8 + r) * (pw / 2) + bx * 8],
                      8 * sizeof(float));
        fdct_quantize(blk, q[1], coef);
        encode_block(s, coef, pred[1 + c], dc_c, ac_c);
      }
    }
  s.flush();
  s.word(0xFFD9);
  int64_t size = static_cast<int64_t>(s.buf.size());
  if (size > cap) return -size;
  std::memcpy(out, s.buf.data(), s.buf.size());
  return size;
}

// cv2.convertMaps(map_x, map_y, CV_16SC2): the source position times 32,
// rounded half to even, split into its integer part (xy, int16 pairs) and
// the 5+5 fractional bits (fxy = (y & 31) * 32 + (x & 31)).
void convert_maps(const float* map_x, const float* map_y, int64_t n, int16_t* xy,
                  uint16_t* fxy) {
  for (int64_t i = 0; i < n; ++i) {
    int ix = round_even(static_cast<double>(map_x[i] * 32.0f));
    int iy = round_even(static_cast<double>(map_y[i] * 32.0f));
    int sx = ix >> 5, sy = iy >> 5;
    xy[2 * i] = static_cast<int16_t>(std::min(32767, std::max(-32768, sx)));
    xy[2 * i + 1] = static_cast<int16_t>(std::min(32767, std::max(-32768, sy)));
    fxy[i] = static_cast<uint16_t>((iy & 31) * 32 + (ix & 31));
  }
}

// cv2.remap(src, xy, fxy, INTER_LINEAR, BORDER_CONSTANT, 0) on uint8 with
// cn channels: out[p] = (sum of the four taps times their 15-bit weights
// + 2^14) >> 15, a tap outside the source counting as 0. The weights of
// initInterTab2D for the bilinear kernel are exact in float: (32 - fx) *
// (32 - fy) * 32 and its three siblings, summing to 1 << 15.
void remap_linear_u8(const uint8_t* src, int32_t sh, int32_t sw, int32_t cn, const int16_t* xy,
                     const uint16_t* fxy, int32_t dh, int32_t dw, uint8_t* dst) {
  const ptrdiff_t sstep = static_cast<ptrdiff_t>(sw) * cn;
  for (int y = 0; y < dh; ++y)
    for (int x = 0; x < dw; ++x) {
      size_t i = static_cast<size_t>(y) * dw + x;
      int sx = xy[2 * i], sy = xy[2 * i + 1];
      int f = fxy[i] & 1023;
      int fx = f & 31, fy = f >> 5;
      int w0 = (32 - fx) * (32 - fy) * 32, w1 = fx * (32 - fy) * 32, w2 = (32 - fx) * fy * 32,
          w3 = fx * fy * 32;
      uint8_t* o = dst + i * cn;
      if (static_cast<unsigned>(sx) < static_cast<unsigned>(sw - 1) &&
          static_cast<unsigned>(sy) < static_cast<unsigned>(sh - 1)) {   // all four taps inside
        const uint8_t* p = src + sy * sstep + static_cast<ptrdiff_t>(sx) * cn;
        for (int c = 0; c < cn; ++c)
          o[c] = static_cast<uint8_t>(
              (p[c] * w0 + p[c + cn] * w1 + p[c + sstep] * w2 + p[c + sstep + cn] * w3 +
               (1 << 14)) >> 15);
        continue;
      }
      bool in_x0 = sx >= 0 && sx < sw, in_x1 = sx + 1 >= 0 && sx + 1 < sw;
      bool in_y0 = sy >= 0 && sy < sh, in_y1 = sy + 1 >= 0 && sy + 1 < sh;
      for (int c = 0; c < cn; ++c) {
        int v0 = in_x0 && in_y0 ? src[sy * sstep + static_cast<ptrdiff_t>(sx) * cn + c] : 0;
        int v1 = in_x1 && in_y0 ? src[sy * sstep + static_cast<ptrdiff_t>(sx + 1) * cn + c] : 0;
        int v2 = in_x0 && in_y1 ? src[(sy + 1) * sstep + static_cast<ptrdiff_t>(sx) * cn + c] : 0;
        int v3 =
            in_x1 && in_y1 ? src[(sy + 1) * sstep + static_cast<ptrdiff_t>(sx + 1) * cn + c] : 0;
        o[c] = static_cast<uint8_t>((v0 * w0 + v1 * w1 + v2 * w2 + v3 * w3 + (1 << 14)) >> 15);
      }
    }
}

// cv2.cvtColor(COLOR_BGR2HSV) on uint8 (H in [0, 180)): RGB2HSV_b's
// hsv_shift 12 division tables.
void bgr_to_hsv_u8(const uint8_t* src, int64_t npix, uint8_t* dst) {
  static int sdiv[256], hdiv[256];
  static bool init = [] {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = round_even((255 << 12) / (1.0 * i));
      hdiv[i] = round_even((180 << 12) / (6.0 * i));
    }
    return true;
  }();
  (void)init;
  for (int64_t i = 0; i < npix; ++i) {
    int b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
    int v = std::max(b, std::max(g, r));
    int vmin = std::min(b, std::min(g, r));
    int diff = v - vmin;
    int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    int s = (diff * sdiv[v] + (1 << 11)) >> 12;
    int h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
    h = (h * hdiv[diff] + (1 << 11)) >> 12;
    h += h < 0 ? 180 : 0;
    dst[3 * i] = clamp255(h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// cv2.cvtColor(COLOR_HSV2BGR) on uint8 (H in [0, 180)) as OpenCV's vector
// path computes it (every pixel of a row whose width is a multiple of its
// vector block): float32, 1 - s*h and 1 - s*(1-h) as fused multiply-adds
// (one rounding; here exact products in double, one rounding to float),
// the result times 255 truncated. OpenCV's scalar tail of other widths
// rounds instead (data/image.py says how often that differs).
void hsv_to_bgr_u8(const uint8_t* src, int64_t npix, uint8_t* dst) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.0f / 180.0f, inv255 = 1.0f / 255.0f;
  for (int64_t i = 0; i < npix; ++i) {
    float h = static_cast<float>(src[3 * i]) * hscale;
    float s = static_cast<float>(src[3 * i + 1]) * inv255;
    float v = static_cast<float>(src[3 * i + 2]) * inv255;
    // every operand is non-negative: an int cast truncates
    float pre = static_cast<float>(static_cast<int>(h));
    h -= pre;
    float sector = pre - static_cast<float>(static_cast<int>(pre * (1.0f / 6.0f))) * 6.0f;
    float tab[4];
    tab[0] = v;
    tab[1] = v * (1.0f - s);
    tab[2] = v * static_cast<float>(-static_cast<double>(s) * h + 1.0);
    tab[3] = v * static_cast<float>(-static_cast<double>(s) * (1.0f - h) + 1.0);
    const int* sd = sector_data[static_cast<int>(sector)];
    for (int c = 0; c < 3; ++c) dst[3 * i + c] = clamp255(static_cast<int>(tab[sd[c]] * 255.0f));
  }
}

// cv2.LUT(src, lut) with one 256-entry table a channel: lut[256 * cn]
// laid out as [256, cn].
void lut_u8(const uint8_t* src, int64_t npix, int32_t cn, const uint8_t* lut, uint8_t* dst) {
  for (int64_t i = 0; i < npix; ++i)
    for (int c = 0; c < cn; ++c) dst[i * cn + c] = lut[src[i * cn + c] * cn + c];
}

// cv2.resize(src, (dw, dh), INTER_LINEAR) on uint8: half-pixel centres,
// 11-bit weights (rounded half to even), a horizontal pass into int rows
// and the vertical ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2)
// >> 2. As in resize.cpp, a column outside the source is clamped with its
// weight (one tap of 2048), while a row outside is clamped alone: its
// weights stay those of the unclamped position, both taps on the edge row.
void resize_linear_u8(const uint8_t* src, int32_t sh, int32_t sw, int32_t cn, uint8_t* dst,
                      int32_t dh, int32_t dw) {
  auto coeffs = [](int dsize, int ssize, bool clamp_weights, std::vector<int>& ofs,
                   std::vector<int>& alpha) {
    double scale = 1.0 / (static_cast<double>(dsize) / ssize);   // as cv2.resize derives it
    ofs.resize(dsize);
    alpha.resize(2 * dsize);
    for (int d = 0; d < dsize; ++d) {
      float f = static_cast<float>((d + 0.5) * scale - 0.5);
      int s = static_cast<int>(std::floor(f));
      f -= s;
      if (clamp_weights && s < 0) {
        f = 0;
        s = 0;
      }
      if (clamp_weights && s >= ssize - 1) {
        f = 0;
        s = ssize - 1;
      }
      ofs[d] = s;
      alpha[2 * d] = round_even((1.0f - f) * 2048.0f);
      alpha[2 * d + 1] = round_even(f * 2048.0f);
    }
  };
  std::vector<int> xofs, xa, yofs, ya;
  coeffs(dw, sw, true, xofs, xa);
  coeffs(dh, sh, false, yofs, ya);
  const int rw = dw * cn;
  std::vector<int> rows(2 * static_cast<size_t>(rw));
  auto hresize = [&](int sy, int* row) {
    const uint8_t* s = src + static_cast<size_t>(sy) * sw * cn;
    for (int x = 0; x < dw; ++x) {
      int sx = xofs[x];
      int sx1 = std::min(sx + 1, sw - 1);
      for (int c = 0; c < cn; ++c)
        row[x * cn + c] = s[sx * cn + c] * xa[2 * x] + s[sx1 * cn + c] * xa[2 * x + 1];
    }
  };
  for (int y = 0; y < dh; ++y) {
    int sy0 = std::min(std::max(yofs[y], 0), sh - 1);
    int sy1 = std::min(std::max(yofs[y] + 1, 0), sh - 1);
    hresize(sy0, rows.data());
    hresize(sy1, rows.data() + rw);
    int b0 = ya[2 * y], b1 = ya[2 * y + 1];
    uint8_t* o = dst + static_cast<size_t>(y) * rw;
    for (int i = 0; i < rw; ++i)
      o[i] = static_cast<uint8_t>(
          (((b0 * (rows[i] >> 4)) >> 16) + ((b1 * (rows[rw + i] >> 4)) >> 16) + 2) >> 2);
  }
}

}  // extern "C"
