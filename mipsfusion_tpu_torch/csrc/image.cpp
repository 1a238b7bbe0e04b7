// Host image decoding for the file readers (no image library needed).
//
// PNG: Python inflates the IDAT stream (zlib); png_unfilter undoes the
// per-row filters 0-4 (None, Sub, Up, Average, Paeth). Sub and Paeth run
// serially along a row, which is why this part is native.
//
// JPEG: a baseline (and extended sequential, 8-bit) Huffman decoder that
// computes what libjpeg-turbo computes with its default decompression
// settings, so the frames equal what cv2.imread gives:
//   - the "islow" integer IDCT (jidctint.c: 13-bit constants, 2 extra
//     bits after the column pass, descale with rounding), its output
//     clamped to [0, 255] after the +128 level shift;
//   - "fancy" upsampling of subsampled components (jdsample.c: triangle
//     filters h2v1, h1v2 and h2v2 with their alternating rounding biases
//     and edge columns, the rows above the first and below the last real
//     row replicated), plain replication where a component is at most 2
//     samples wide;
//   - YCbCr -> RGB through the fixed-point tables of jdcolor.c (16
//     fraction bits, ONE_HALF rounding), grey replicated to RGB.
// Interleaved and single-component scans, restart intervals, sampling
// 4:4:4, 4:2:2, 4:4:0 and 4:2:0. Progressive, lossless, arithmetic-coded
// and 12-bit files, CMYK, RGB-coded (Adobe transform 0) files and an EXIF
// orientation other than 1 (cv2.imread would rotate the image) are
// refused with a message.
//
// Build: c++ -O3 -fPIC -std=c++17 -shared (ops/_build.image_lib).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---------------------------------------------------------------- JPEG

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0: longer code

  void build(const uint8_t counts[16], const uint8_t* v, int n) {
    std::memcpy(vals, v, n);
    int sizes[257], codes[257], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l - 1]; ++i) sizes[p++] = l;
    sizes[p] = 0;
    int code = 0, si = sizes[0];
    p = 0;
    while (sizes[p]) {
      while (sizes[p] == si) codes[p++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l - 1]) {
        valptr[l] = p;
        mincode[l] = codes[p];
        p += counts[l - 1];
        maxcode[l] = codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l)
      for (int i = 0; i < counts[l - 1]; ++i, ++p) {
        int lo = codes[p] << (kLookBits - l);
        for (int k = 0; k < (1 << (kLookBits - l)); ++k)
          look[lo + k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    present = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  bool at_marker = false;  // stopped before a marker: feed zero bits

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;  // a marker: leave it for the parser
          }
        } else {
          b = *p++;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  int bits(int k) {  // k in 1..16
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (n < 16) fill();
    int look = h.look[acc >> (64 - kLookBits)];
    if (look) {
      int len = look >> 8;
      acc <<= len;
      n -= len;
      return look & 0xFF;
    }
    int l = kLookBits + 1;
    int code = static_cast<int>(acc >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) fail("corrupt entropy-coded data (bad Huffman code)");
      code = static_cast<int>(acc >> (64 - l));
    }
    acc <<= l;
    n -= l;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c (jpeg_idct_islow)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// coef: natural order, already dequantized; out: 8 rows of `stride`
void idct_islow(const int32_t* coef, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = in[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int d = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = descale(tmp10 + tmp3, d);
    ws[7 * 8 + c] = descale(tmp10 - tmp3, d);
    ws[1 * 8 + c] = descale(tmp11 + tmp2, d);
    ws[6 * 8 + c] = descale(tmp11 - tmp2, d);
    ws[2 * 8 + c] = descale(tmp12 + tmp1, d);
    ws[5 * 8 + c] = descale(tmp12 - tmp1, d);
    ws[3 * 8 + c] = descale(tmp13 + tmp0, d);
    ws[4 * 8 + c] = descale(tmp13 - tmp0, d);
  }
  const int d = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = clamp255(descale(tmp10 + tmp3, d) + 128);
    o[7] = clamp255(descale(tmp10 - tmp3, d) + 128);
    o[1] = clamp255(descale(tmp11 + tmp2, d) + 128);
    o[6] = clamp255(descale(tmp11 - tmp2, d) + 128);
    o[2] = clamp255(descale(tmp12 + tmp1, d) + 128);
    o[5] = clamp255(descale(tmp12 - tmp1, d) + 128);
    o[3] = clamp255(descale(tmp13 + tmp0, d) + 128);
    o[4] = clamp255(descale(tmp13 - tmp0, d) + 128);
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // the current scan's table selectors
  int bw = 0, bh = 0;       // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;       // real (downsampled) width and height
  int pred = 0;             // DC predictor
  bool decoded = false;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

struct Jpeg {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool have_frame = false, adobe_rgb = false;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* d, int64_t len) : data(d), end(d + len), p(d) {}

  int u8() {
    if (p >= end) fail("truncated file");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // next marker code; skips fill bytes (and, after a scan, any bytes
  // before the marker)
  int next_marker() {
    while (p < end) {
      if (*p == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF) {
        int m = p[1];
        p += 2;
        return m;
      }
      ++p;
    }
    fail("truncated file (no EOI marker)");
  }

  void read_exif(const uint8_t* s, int len) {
    if (len < 14 || std::memcmp(s, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = s + 6;
    int tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](int o) -> int {
      if (o + 2 > tl) fail("corrupt EXIF block");
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](int o) -> uint32_t {
      if (o + 4 > tl) fail("corrupt EXIF block");
      return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                   (uint32_t(t[o + 3]) << 24))
                : ((uint32_t(t[o]) << 24) | (t[o + 1] << 16) |
                   (t[o + 2] << 8) | t[o + 3]);
    };
    uint32_t ifd = rd32(4);
    if (ifd + 2 > uint32_t(tl)) return;
    int n = rd16(ifd);
    for (int i = 0; i < n; ++i) {
      int e = ifd + 2 + 12 * i;
      if (rd16(e) == 0x0112) {
        int orient = rd16(e + 8);
        if (orient != 1)
          fail("EXIF orientation " + std::to_string(orient) +
               " (cv2.imread would rotate the image; only 1 is read)");
      }
    }
  }

  void read_frame(int marker, int len) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
        marker == 0xCE)
      fail("progressive JPEG is not read (baseline only)");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCF)
      fail("lossless JPEG is not read (baseline only)");
    if (marker >= 0xC9)
      fail("arithmetic-coded JPEG is not read (Huffman only)");
    if (marker == 0xC5) fail("hierarchical JPEG is not read");
    if (have_frame) fail("two frame headers");
    int prec = u8();
    if (prec != 8)
      fail(std::to_string(prec) + "-bit JPEG is not read (8-bit only)");
    height = u16();
    width = u16();
    int nc = u8();
    if (height == 0) fail("height given by a DNL marker is not read");
    if (width == 0) fail("zero width");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + " components (1 or 3 are read)");
    if (len != 8 + 3 * nc) fail("bad frame header length");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component in the frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 3 && comps[0].id == 'R' && comps[1].id == 'G' &&
        comps[2].id == 'B')
      fail("RGB-coded JPEG is not read (YCbCr only)");
    if (nc == 1) {  // a single component is never subsampled
      comps[0].h = comps[0].v = hmax = vmax = 1;
    }
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      if (hmax % c.h || vmax % c.v || rh > 2 || rv > 2)
        fail("chroma sampling " + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " of " + std::to_string(hmax) + "x" +
             std::to_string(vmax) +
             " (4:4:4, 4:2:2, 4:4:0 and 4:2:0 are read)");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
    }
    have_frame = true;
  }

  void read_dqt(int len) {
    const uint8_t* stop = p + len - 2;
    while (p < stop) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) fail("bad quantisation table");
      for (int k = 0; k < 64; ++k)
        quant[t][kZigzag[k]] = static_cast<uint16_t>(prec ? u16() : u8());
      quant_present[t] = true;
    }
  }

  void read_dht(int len) {
    const uint8_t* stop = p + len - 2;
    while (p < stop) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad Huffman table header");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = u8();
      if (total > 256 || p + total > end) fail("bad Huffman table");
      (cls ? ac[t] : dc[t]).build(counts, p, total);
      p += total;
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    const uint16_t* q = quant[c.tq];
    int32_t coef[64] = {0};
    int s = br.decode(hd);
    if (s > 11) fail("corrupt entropy-coded data (DC size)");
    int diff = s ? extend(br.bits(s), s) : 0;
    c.pred += diff;
    coef[0] = c.pred * q[0];
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy-coded data (AC run)");
        int z = kZigzag[k];
        coef[z] = extend(br.bits(s), s) * q[z];
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, c.plane.data() + size_t(by) * 8 * stride + bx * 8,
               stride);
  }

  void read_scan() {
    if (!have_frame) fail("scan before the frame header");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > int(comps.size()) || len != 6 + 2 * ns)
      fail("bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad table selector");
      if (!dc[found->td].present || !ac[found->ta].present)
        fail("scan uses an undefined Huffman table");
      if (!quant_present[found->tq])
        fail("component uses an undefined quantisation table");
      if (found->decoded) fail("a component in two scans");
      found->decoded = true;
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("scan is not sequential (progressive JPEG is not read)");
    for (auto* c : sc) c->pred = 0;
    BitReader br{p, end};
    // MCU grid: the frame's for an interleaved scan, one block at a time
    // over the component's own extent for a single-component scan
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int64_t done = 0;
    int rst = 0;
    for (int my = 0; my < ny; ++my) {
      for (int mx = 0; mx < nx; ++mx) {
        if (restart && done > 0 && done % restart == 0) {
          // the bits left before the marker are padding
          p = br.p;
          while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
          if (p + 1 >= end || p[0] != 0xFF || p[1] != (0xD0 + rst))
            fail("missing or out-of-order restart marker");
          p += 2;
          rst = (rst + 1) & 7;
          br = BitReader{p, end};
          for (auto* c : sc) c->pred = 0;
        }
        if (ns == 1) {
          decode_block(br, *sc[0], mx, my);
        } else {
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                decode_block(br, *c, mx * c->h + h, my * c->v + v);
        }
        ++done;
      }
    }
    p = br.p;
  }

  void parse() {
    if (end - data < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    p = data + 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                            // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;            // stray RST
      if (m == 0xDA) {
        read_scan();
        continue;
      }
      int len = u16();
      if (len < 2) fail("bad marker segment length");
      if (p + len - 2 > end) fail("truncated file (in a marker segment)");
      const uint8_t* seg = p;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_frame(m, len);
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG is not read (Huffman only)");
      } else if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xDD) {
        if (len != 4) fail("bad restart interval");
        restart = u16();
      } else if (m == 0xDC) {
        fail("DNL marker is not read");
      } else if (m == 0xE1) {
        read_exif(seg, len - 2);
      } else if (m == 0xEE) {
        // Adobe: transform 0 means RGB-coded components
        if (len - 2 >= 12 && std::memcmp(seg, "Adobe", 5) == 0 &&
            seg[11] == 0 && comps.size() != 1)
          adobe_rgb = true;
      }
      p = seg + len - 2;
    }
    if (!have_frame) fail("no frame header");
    for (auto& c : comps)
      if (!c.decoded) fail("a component has no scan");
    if (adobe_rgb && comps.size() == 3)
      fail("RGB-coded JPEG (Adobe transform 0) is not read");
  }

  // jdsample.c: the component upsampled to its share of the frame, one
  // output row (of width >= `width`) at a time
  void upsample_row(const Component& c, int y, uint8_t* out) const {
    const int stride = c.bw * 8;
    const int rh = hmax / c.h, rv = vmax / c.v;
    const bool fancy = (rh == 2) ? c.dw > 2 : true;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return c.plane.data() + size_t(r) * stride;
    };
    if (rh == 1 && rv == 1) {
      std::memcpy(out, row(y), c.dw);
      return;
    }
    if (!fancy) {  // replication (h2v1 / h2v2 when at most 2 wide)
      const uint8_t* in = row(y / rv);
      for (int x = 0; x < c.dw * rh; ++x) out[x] = in[x / rh];
      return;
    }
    if (rh == 2 && rv == 1) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      int o = 0;
      int iv = in[0];
      out[o++] = static_cast<uint8_t>(iv);
      out[o++] = static_cast<uint8_t>((iv * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < c.dw - 1; ++x) {
        iv = in[x] * 3;
        out[o++] = static_cast<uint8_t>((iv + in[x - 1] + 1) >> 2);
        out[o++] = static_cast<uint8_t>((iv + in[x + 1] + 2) >> 2);
      }
      iv = in[c.dw - 1];
      out[o++] = static_cast<uint8_t>((iv * 3 + in[c.dw - 2] + 1) >> 2);
      out[o++] = static_cast<uint8_t>(iv);
      return;
    }
    // vertical triangle: the nearer row 3/4, the farther 1/4
    const int inrow = y / 2;
    const bool upper = (y % 2) == 0;
    const uint8_t* in0 = row(inrow);
    const uint8_t* in1 = row(upper ? inrow - 1 : inrow + 1);
    if (rh == 1) {  // h1v2_fancy_upsample
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < c.dw; ++x)
        out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    // h2v2_fancy_upsample
    int o = 0;
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    out[o++] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
    out[o++] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 2; x < c.dw; ++x) {
      nextcol = in0[x] * 3 + in1[x];
      out[o++] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      out[o++] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    out[o++] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    out[o++] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
  }

  // jdcolor.c: ycc_rgb_convert's tables, gray_rgb_convert
  void to_rgb(uint8_t* rgb) const {
    const int W = width;
    if (comps.size() == 1) {
      std::vector<uint8_t> g(W + 16);
      for (int y = 0; y < height; ++y) {
        upsample_row(comps[0], y, g.data());
        uint8_t* o = rgb + size_t(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << kScale) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    const int pad = 2 * (W + 16) + 16;
    std::vector<uint8_t> ry(pad), rcb(pad), rcr(pad);
    for (int y = 0; y < height; ++y) {
      upsample_row(comps[0], y, ry.data());
      upsample_row(comps[1], y, rcb.data());
      upsample_row(comps[2], y, rcr.data());
      uint8_t* o = rgb + size_t(y) * W * 3;
      for (int x = 0; x < W; ++x) {
        int yy = ry[x], cb = rcb[x], cr = rcr[x];
        o[3 * x] = clamp255(yy + cr_r[cr]);
        o[3 * x + 1] =
            clamp255(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
        o[3 * x + 2] = clamp255(yy + cb_b[cb]);
      }
    }
  }
};

void copy_error(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Undo the PNG row filters. `raw` holds height rows of 1 filter byte and
// row_bytes data bytes; `bpp` is the bytes of one pixel (at least 1).
// Returns 0, or 1 on an unknown filter type, 2 on short data.
int png_unfilter(const uint8_t* raw, int64_t raw_len, int64_t height,
                 int64_t row_bytes, int bpp, uint8_t* out) {
  if (raw_len < height * (row_bytes + 1)) return 2;
  std::vector<uint8_t> zero(row_bytes, 0);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (row_bytes + 1);
    int ft = in[0];
    ++in;
    uint8_t* o = out + y * row_bytes;
    const uint8_t* up = y ? out + (y - 1) * row_bytes : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(o, in, row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0;
          int c = i >= bpp ? up[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(in[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return 1;
    }
  }
  return 0;
}

// The frame size and component count of a JPEG; 0, or -1 with a message.
int jpeg_info(const uint8_t* data, int64_t len, int* width, int* height,
              int* ncomp, char* err, int errlen) {
  try {
    Jpeg j(data, len);
    j.parse();
    *width = j.width;
    *height = j.height;
    *ncomp = static_cast<int>(j.comps.size());
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
    return -1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return -1;
  }
}

// Decode a JPEG into `rgb` (height x width x 3, RGB order); 0, or -1 with
// a message (also when the size is not width x height).
int jpeg_decode(const uint8_t* data, int64_t len, int width, int height,
                uint8_t* rgb, char* err, int errlen) {
  try {
    Jpeg j(data, len);
    j.parse();
    if (j.width != width || j.height != height)
      fail("size differs from the buffer's");
    j.to_rgb(rgb);
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
    return -1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return -1;
  }
}

}  // extern "C"
