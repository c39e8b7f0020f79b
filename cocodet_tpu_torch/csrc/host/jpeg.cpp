// Baseline JPEG decoder and encoder for cocodet_tpu_torch/data/image_io.py,
// the port's counterparts of cv2.imread and cv2.imwrite on JPEG files. Both
// compute what libjpeg-turbo computes under OpenCV's settings, so their
// output equals cv2's bit for bit:
//
// Decoder (cv2.imread, IMREAD_COLOR): sequential Huffman scans (SOF0, SOF1),
// 8-bit, 1 or 3 components, any integral sampling factors, restart
// intervals; coefficients dequantised and inverted by libjpeg's `islow`
// integer IDCT (jidctint.c) with its range-limit table and mask;
// `do_fancy_upsampling` as jdsample.c does it (h2v1, h2v2 and h1v2
// triangle filters with their alternating biases, box replication for
// other integral factors and for components at most 2 samples wide); the
// fixed-point YCbCr->RGB tables of jdcolor.c, written out as BGR. The
// colour space is guessed as jdapimin.c guesses it (JFIF, Adobe transform,
// component ids). The first APP1 segment's EXIF orientation is returned
// for the caller to apply, as OpenCV reads it.
//
// Encoder (cv2.imwrite with no parameters): JFIF APP0, the Annex K tables
// scaled to quality 95 (jcparam.c), jccolor.c's RGB->YCbCr tables,
// jcsample.c's h2v2 downsampling (bias 1, 2 alternating, edges replicated
// to whole blocks), the `islow` forward DCT (jfdctint.c) quantised by
// libjpeg-turbo's reciprocal multiply (jcdctmgr.c), the standard Huffman
// tables (Annex K.3), 0xFF stuffing and 1-padding; a grey image is one
// component.
//
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
// and 4-component (CMYK/YCCK) files, are refused by name; truncated or
// corrupt data is refused, never guessed at. The plain versions, which the
// tests hold this file against, are in cocodet_tpu_torch/data/jpeg_plain.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {  // natural order of the i-th zigzag coefficient
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // runs past coefficient 63 of a corrupt block land here (jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Error {
  int status = kOk;
  char msg[160] = {0};
  int fail(int s, const char* text) {
    if (status == kOk) {
      status = s;
      std::snprintf(msg, sizeof msg, "%s", text);
    }
    return s;
  }
};

// ---------------------------------------------------------------- Huffman
struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << 9];  // (length << 8) | value for codes of <= 9 bits, 0 = slow
};

bool build_huff(HuffTable& t) {
  int code = 0, k = 0;
  int huffcode[257];
  uint8_t huffsize[257];
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.bits[l]; ++i) huffsize[k++] = static_cast<uint8_t>(l);
  const int n = k;
  k = 0;
  int si = n ? huffsize[0] : 0;
  while (k < n) {
    while (k < n && huffsize[k] == si) huffcode[k++] = code++;
    if (code > (1 << si)) return false;  // codes overflow their length
    code <<= 1;
    ++si;
  }
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= 9; ++l)
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      const int base = huffcode[p] << (9 - l);
      for (int j = 0; j < (1 << (9 - l)); ++j)
        t.look[base + j] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  return true;
}

// ------------------------------------------------------------ bit reader
struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t acc = 0;
  int cnt = 0;    // bits in acc (its low bits)
  int fake = 0;   // trailing bits of acc that were fed past a marker or the end
  bool corrupt = false;

  void fill() {
    while (cnt <= 56) {
      uint8_t b = 0;
      if (pos < n && data[pos] != 0xFF) {
        b = data[pos++];
      } else if (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] == 0x00) {
        b = 0xFF;
        pos += 2;
      } else {
        fake += 8;  // a marker or the end of the data: feed zeros, as libjpeg does
      }
      acc = (acc << 8) | b;
      cnt += 8;
    }
  }
  int peek(int k) {
    if (cnt < k) fill();
    return static_cast<int>((acc >> (cnt - k)) & ((1u << k) - 1));
  }
  void skip(int k) {
    cnt -= k;
    if (cnt < fake) corrupt = true;  // consumed bits that are not in the file
  }
  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    const int look = t.look[peek(9)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int l = 10;
    int code = peek(l);
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = peek(l);
    }
    if (l > 16) {
      corrupt = true;
      skip(0);
      return 0;
    }
    skip(l);
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  void reset() {
    acc = 0;
    cnt = 0;
    fake = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ----------------------------------------------------------- the decoder
struct Component {
  int id, h, v, tq;
  int dw, dh;           // downsampled_width, downsampled_height
  int wib, hib;         // width_in_blocks, height_in_blocks
  int bw, bh;           // blocks allocated (the MCU grid of an interleaved scan)
  bool latched = false;
  bool scanned = false;
  uint16_t q[64];       // quantisation table latched at the first scan, natural order
  std::vector<int16_t> coef;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  Error err;
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1, restart = 0;
  int orientation = 0;
  bool frame = false, jfif = false, adobe = false, saw_app1 = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[4];

  int u16(size_t p) const { return (data[p] << 8) | data[p + 1]; }

  int parse_exif(size_t p, size_t len) {
    // OpenCV's ExifReader on the first APP1 segment: skip the 6 bytes of
    // "Exif\0\0", read the TIFF header and IFD0, tag 0x0112 as a short.
    if (len <= 6) return 0;
    const uint8_t* d = data + p + 6;
    const size_t m = len - 6;
    bool intel;
    if (m >= 2 && d[0] == 'I' && d[1] == 'I') intel = true;
    else if (m >= 2 && d[0] == 'M' && d[1] == 'M') intel = false;
    else return 0;
    auto g16 = [&](size_t o, bool& ok) -> int {
      if (o + 1 >= m) { ok = false; return 0; }
      return intel ? d[o] | (d[o + 1] << 8) : (d[o] << 8) | d[o + 1];
    };
    auto g32 = [&](size_t o, bool& ok) -> uint32_t {
      if (o + 3 >= m) { ok = false; return 0; }
      return intel ? d[o] | (d[o + 1] << 8) | (d[o + 2] << 16) | (uint32_t(d[o + 3]) << 24)
                   : (uint32_t(d[o]) << 24) | (d[o + 1] << 16) | (d[o + 2] << 8) | d[o + 3];
    };
    bool ok = true;
    if (g16(2, ok) != 0x2A || !ok) return 0;
    size_t off = g32(4, ok);
    if (!ok) return 0;
    const int entries = g16(off, ok);
    if (!ok) return 0;
    off += 2;
    int found = 0;
    for (int e = 0; e < entries; ++e, off += 12) {
      const int tag = g16(off, ok);
      if (!ok) return found;
      if (tag == 0x0112) {
        const int v = g16(off + 8, ok);
        if (!ok) return found;
        found = v;
      }
    }
    return found;
  }

  int parse_sof(size_t p, size_t len) {
    if (frame) return err.fail(kCorrupt, "JPEG with two frame headers");
    if (len < 6) return err.fail(kCorrupt, "JPEG frame header too short");
    const int precision = data[p];
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = data[p + 5];
    if (precision != 8)
      return err.fail(kUnsupported, precision == 12 ? "12-bit JPEG" : "JPEG sample precision other than 8 bits");
    if (ncomp == 4) return err.fail(kUnsupported, "4-component (CMYK/YCCK) JPEG");
    if (ncomp != 1 && ncomp != 3) return err.fail(kUnsupported, "JPEG with other than 1 or 3 components");
    if (len < static_cast<size_t>(6 + 3 * ncomp)) return err.fail(kCorrupt, "JPEG frame header too short");
    if (height == 0) return err.fail(kUnsupported, "JPEG with its height in a DNL marker");
    if (width == 0) return err.fail(kCorrupt, "JPEG of width 0");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = data[p + 6 + 3 * c];
      k.h = data[p + 7 + 3 * c] >> 4;
      k.v = data[p + 7 + 3 * c] & 15;
      k.tq = data[p + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        return err.fail(kCorrupt, "JPEG component with bad sampling factors or table");
      max_h = std::max(max_h, k.h);
      max_v = std::max(max_v, k.v);
    }
    const int mcux = (width + 8 * max_h - 1) / (8 * max_h);
    const int mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (max_h % k.h || max_v % k.v)
        return err.fail(kUnsupported, "JPEG with fractional sampling factors");
      k.dw = static_cast<int>((static_cast<long>(width) * k.h + max_h - 1) / max_h);
      k.dh = static_cast<int>((static_cast<long>(height) * k.v + max_v - 1) / max_v);
      k.wib = (k.dw + 7) / 8;
      k.hib = (k.dh + 7) / 8;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
    }
    frame = true;
    return kOk;
  }

  int parse_dht(size_t p, size_t len) {
    size_t e = p + len;
    while (p < e) {
      const int tc = data[p] >> 4, th = data[p] & 15;
      if (tc > 1 || th > 3 || p + 17 > e) return err.fail(kCorrupt, "bad JPEG Huffman table");
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += t.bits[l] = data[p + l];
      if (total > 256 || p + 17 + total > e) return err.fail(kCorrupt, "bad JPEG Huffman table");
      std::memcpy(t.vals, data + p + 17, total);
      if (!build_huff(t)) return err.fail(kCorrupt, "bad JPEG Huffman table");
      t.defined = true;
      p += 17 + total;
    }
    return kOk;
  }

  int parse_dqt(size_t p, size_t len) {
    size_t e = p + len;
    while (p < e) {
      const int pq = data[p] >> 4, tq = data[p] & 15;
      if (pq > 1 || tq > 3 || p + 1 + 64 * (pq + 1) > e) return err.fail(kCorrupt, "bad JPEG quantisation table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigzag[i]] = static_cast<uint16_t>(pq ? u16(p + 1 + 2 * i) : data[p + 1 + i]);
      qt_defined[tq] = true;
      p += 1 + 64 * (pq + 1);
    }
    return kOk;
  }

  // Decodes the scan whose header starts at p; returns the position after its data.
  size_t decode_scan(size_t p, size_t len) {
    if (!frame) { err.fail(kCorrupt, "JPEG scan before the frame header"); return n; }
    const int ns = data[p];
    if (ns < 1 || ns > 4 || len < static_cast<size_t>(4 + 2 * ns)) { err.fail(kCorrupt, "bad JPEG scan header"); return n; }
    Component* sc[4];
    int tdc[4], tac[4];
    for (int i = 0; i < ns; ++i) {
      const int id = data[p + 1 + 2 * i];
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      tdc[i] = data[p + 2 + 2 * i] >> 4;
      tac[i] = data[p + 2 + 2 * i] & 15;
      if (!sc[i] || tdc[i] > 3 || tac[i] > 3 || !dc[tdc[i]].defined || !ac[tac[i]].defined) {
        err.fail(kCorrupt, "JPEG scan names an unknown component or table");
        return n;
      }
      Component& k = *sc[i];
      if (!k.latched) {
        if (!qt_defined[k.tq]) { err.fail(kCorrupt, "JPEG component without a quantisation table"); return n; }
        std::memcpy(k.q, qt[k.tq], sizeof k.q);
        k.latched = true;
        k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      }
      k.scanned = true;
    }
    const int ss = data[p + 1 + 2 * ns], se = data[p + 2 + 2 * ns], a = data[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || a != 0) { err.fail(kCorrupt, "bad spectral selection in a sequential JPEG scan"); return n; }

    int mcux, mcuy;
    if (ns == 1) {
      mcux = sc[0]->wib;
      mcuy = sc[0]->hib;
    } else {
      mcux = (width + 8 * max_h - 1) / (8 * max_h);
      mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    }
    BitReader br{data, n, p + len};
    int pred[4] = {0, 0, 0, 0};
    const long total = static_cast<long>(mcux) * mcuy;
    int next_rst = 0;
    long left = restart;
    for (long m = 0; m < total; ++m) {
      if (restart && left == 0) {
        // discard the padding bits and read RSTn
        br.reset();
        size_t q = br.pos;
        while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF)) ++q;
        if (q + 1 >= n || data[q + 1] != 0xD0 + next_rst) {
          err.fail(kCorrupt, "JPEG restart marker missing or out of order");
          return n;
        }
        br.pos = q + 2;
        next_rst = (next_rst + 1) & 7;
        left = restart;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      const int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwid; ++bx) {
            const int row = my * bh + by, col = mx * bwid + bx;
            int16_t* blk = k.coef.data() + (static_cast<size_t>(row) * k.bw + col) * 64;
            const int s = br.decode(dc[tdc[i]]);
            if (s > 15) br.corrupt = true;
            pred[i] += s ? extend(br.get(s & 15), s & 15) : 0;
            blk[0] = static_cast<int16_t>(pred[i]);
            const HuffTable& at = ac[tac[i]];
            for (int kk = 1; kk < 64; ++kk) {
              const int rs = br.decode(at);
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                kk += r;
                const int v = extend(br.get(sz), sz);
                blk[kZigzag[kk]] = static_cast<int16_t>(v);
                if (kk > 63) br.corrupt = true;
              } else {
                if (r != 15) break;
                kk += 15;
              }
            }
          }
      }
      if (br.corrupt) {
        err.fail(kCorrupt, "truncated or corrupt JPEG entropy-coded data");
        return n;
      }
      --left;
    }
    // the position of the next marker
    size_t q = br.pos;
    while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF)) ++q;
    return q;
  }

  // Walks the markers; with header_only, stops at the first scan.
  int run(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return err.fail(kCorrupt, "not a JPEG file");
    size_t p = 2;
    bool scanned = false;
    while (true) {
      while (p < n && data[p] != 0xFF) ++p;  // libjpeg skips garbage before a marker
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n) return scanned ? kOk : err.fail(kCorrupt, "truncated JPEG file");
      const int marker = data[p++];
      if (marker == 0xD9) return scanned ? kOk : err.fail(kCorrupt, "JPEG file without a scan");
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // a stray RSTn
      if (p + 2 > n) return err.fail(kCorrupt, "truncated JPEG file");
      const size_t len = u16(p);
      if (len < 2 || p + len > n) return err.fail(kCorrupt, "truncated JPEG marker segment");
      const size_t body = p + 2, blen = len - 2;
      p += len;
      switch (marker) {
        case 0xC0: case 0xC1:
          if (parse_sof(body, blen)) return err.status;
          break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE:
          return err.fail(kUnsupported, "progressive JPEG");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          return err.fail(kUnsupported, "lossless JPEG");
        case 0xC5:
          return err.fail(kUnsupported, "hierarchical (differential) JPEG");
        case 0xC9: case 0xCC: case 0xCD:
          return err.fail(kUnsupported, "arithmetic-coded JPEG");
        case 0xC4:
          if (parse_dht(body, blen)) return err.status;
          break;
        case 0xDB:
          if (parse_dqt(body, blen)) return err.status;
          break;
        case 0xDD:
          if (blen < 2) return err.fail(kCorrupt, "bad JPEG restart interval");
          restart = u16(body);
          break;
        case 0xDC:
          return err.fail(kUnsupported, "JPEG with a DNL marker");
        case 0xE0:
          if (blen >= 5 && std::memcmp(data + body, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xE1:
          if (!saw_app1) {
            saw_app1 = true;
            orientation = parse_exif(body, blen);
          }
          break;
        case 0xEE:
          if (blen >= 12 && std::memcmp(data + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[body + 11];
          }
          break;
        case 0xDA:
          if (!frame) return err.fail(kCorrupt, "JPEG scan before the frame header");
          if (header_only) return kOk;
          p = decode_scan(body, blen);
          if (err.status) return err.status;
          scanned = true;
          break;
        default:
          break;  // APPn, COM and the rest carry nothing the decoder needs
      }
    }
  }

  bool is_rgb() const {
    if (ncomp != 3 || jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }
};

// ---------------------------------------------------------- islow IDCT
const int kConstBits = 13, kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's prepare_range_limit_table, seen from the IDCT: index
// (value & 1023) of a sample that is 128 too low
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      int v;
      if (x < 128) v = x + 128;
      else if (x < 512) v = 255;
      else if (x < 896) v = 0;
      else v = x - 896;
      idct[x] = static_cast<uint8_t>(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dcval = static_cast<int>(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = kRange.idct[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = kRange.idct[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ------------------------------------------------------------ upsampling
// One component plane (dh x dw samples, row stride `stride`) to the full
// size (height x width) as jdsample.c does it under do_fancy_upsampling.
void upsample(const uint8_t* in, int stride, int dw, int dh, int hx, int vx, uint8_t* out,
              int width, int height) {
  std::vector<uint8_t> row(static_cast<size_t>(dw) * hx + 2);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * width;
    const int iy = y / vx;
    const uint8_t* r0 = in + static_cast<size_t>(iy) * stride;
    if (hx == 1 && vx == 1) {
      std::memcpy(o, r0, width);
      continue;
    }
    if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
      uint8_t* t = row.data();
      t[0] = r0[0];
      t[1] = static_cast<uint8_t>((r0[0] * 3 + r0[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        const int v = r0[i] * 3;
        t[2 * i] = static_cast<uint8_t>((v + r0[i - 1] + 1) >> 2);
        t[2 * i + 1] = static_cast<uint8_t>((v + r0[i + 1] + 2) >> 2);
      }
      t[2 * dw - 2] = static_cast<uint8_t>((r0[dw - 1] * 3 + r0[dw - 2] + 1) >> 2);
      t[2 * dw - 1] = r0[dw - 1];
      std::memcpy(o, t, width);
      continue;
    }
    if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      const bool upper = (y & 1) == 0;
      const int ny = upper ? std::max(iy - 1, 0) : std::min(iy + 1, dh - 1);
      const uint8_t* r1 = in + static_cast<size_t>(ny) * stride;
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((r0[x] * 3 + r1[x] + bias) >> 2);
      continue;
    }
    if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
      const bool upper = (y & 1) == 0;
      const int ny = upper ? std::max(iy - 1, 0) : std::min(iy + 1, dh - 1);
      const uint8_t* r1 = in + static_cast<size_t>(ny) * stride;
      uint8_t* t = row.data();
      int this_sum = r0[0] * 3 + r1[0];
      int next_sum = r0[1] * 3 + r1[1];
      t[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      t[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 1; i < dw - 1; ++i) {
        next_sum = r0[i + 1] * 3 + r1[i + 1];
        t[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        t[2 * i + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      t[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      t[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      std::memcpy(o, t, width);
      continue;
    }
    for (int x = 0; x < width; ++x) o[x] = r0[x / hx];  // box replication
  }
}

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------ the encoder
const uint8_t kStdLuma[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(code_v++);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int k) {
    acc = (acc << k) | (v & ((1u << k) - 1));
    cnt += k;
    while (cnt >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {
    if (cnt) put(0x7F, 7);  // pad with 1-bits to a whole byte
    cnt = 0;
  }
};

void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * stride;
      const int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      const int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      const int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      const int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = static_cast<int>((t10 + t11) * (1 << kPass1Bits));
        p[4 * step] = static_cast<int>((t10 - t11) * (1 << kPass1Bits));
      } else {
        p[0] = static_cast<int>(descale(t10 + t11, kPass1Bits));
        p[4 * step] = static_cast<int>(descale(t10 - t11, kPass1Bits));
      }
      int64_t z1 = (t12 + t13) * FIX_0_541196100;
      p[2 * step] = static_cast<int>(descale(z1 + t13 * FIX_0_765366865, sh));
      p[6 * step] = static_cast<int>(descale(z1 + t12 * -FIX_1_847759065, sh));
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
      const int64_t a4 = t4 * FIX_0_298631336, a5 = t5 * FIX_2_053119869,
                    a6 = t6 * FIX_3_072711026, a7 = t7 * FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = static_cast<int>(descale(a4 + z1 + z3, sh));
      p[5 * step] = static_cast<int>(descale(a5 + z2 + z4, sh));
      p[3 * step] = static_cast<int>(descale(a6 + z2 + z3, sh));
      p[step] = static_cast<int>(descale(a7 + z1 + z4, sh));
    }
  }
}

// jcdctmgr.c's compute_reciprocal for a 16-bit DCTELEM
struct Divisor {
  uint32_t recip, corr;
  int shift;
};
Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

const int kQuality = 95;  // cv2.imwrite's default

// jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
void quant_table(const uint8_t* base, uint16_t* out) {
  const long scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (base[i] * scale + 50L) / 100L;
    t = std::min(std::max(t, 1L), 255L);  // force_baseline
    out[i] = static_cast<uint16_t>(t);
  }
}

struct Plane {
  int w, h;  // padded to whole blocks of the component (and whole MCU rows)
  std::vector<uint8_t> s;
};

void encode_block(const uint8_t* src, int stride, const Divisor* div, int16_t* coef) {
  int d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[8 * r + c] = src[static_cast<size_t>(r) * stride + c] - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int t = static_cast<int16_t>(d[i]);  // DCTELEM is 16 bits
    const bool neg = t < 0;
    if (neg) t = -t;
    uint32_t prod = static_cast<uint32_t>(t + static_cast<int>(div[i].corr)) * div[i].recip;
    prod >>= div[i].shift;
    const int v = static_cast<int16_t>(prod);
    coef[i] = static_cast<int16_t>(neg ? -v : v);
  }
}

void emit_block(BitWriter& bw, const int16_t* coef, int& pred, const EncTable& dct, const EncTable& act) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int t = diff < 0 ? -diff : diff, nb = 0;
  while (t) { ++nb; t >>= 1; }
  bw.put(dct.code[nb], dct.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (v == 0) { ++run; continue; }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    int a = v < 0 ? -v : v;
    nb = 0;
    while (a) { ++nb; a >>= 1; }
    const int sym = (run << 4) | nb;
    bw.put(act.code[sym], act.size[sym]);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) bw.put(act.code[0], act.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void encode(const uint8_t* img, int h, int w, int cn, std::vector<uint8_t>& out) {
  const int ncomp = cn == 1 ? 1 : 3;
  const int max_s = ncomp == 1 ? 1 : 2;  // 4:2:0 for colour
  uint16_t q[2][64];
  quant_table(kStdLuma, q[0]);
  quant_table(kStdChroma, q[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint32_t>(q[t][i]) << 3);

  // colour conversion at full size, padded right and down by replication to
  // whole MCUs (jcprepro.c and jcsample.c's expand_* edges)
  const int mcu = 8 * max_s;
  const int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;
  const int fw = mcux * mcu, fh = mcuy * mcu;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < ncomp; ++c) full[c].resize(static_cast<size_t>(fw) * fh);
  if (ncomp == 1) {
    for (int y = 0; y < h; ++y) std::memcpy(&full[0][static_cast<size_t>(y) * fw], img + static_cast<size_t>(y) * w, w);
  } else {
    const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int64_t tab[8][256];
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + one_half;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + cbcr_off + one_half - 1;
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint8_t* px = img + (static_cast<size_t>(y) * w + x) * 3;
        const int b = px[0], g = px[1], r = px[2];
        const size_t o = static_cast<size_t>(y) * fw + x;
        full[0][o] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
        full[1][o] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
        full[2][o] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
      }
  }
  for (int c = 0; c < ncomp; ++c) {
    for (int y = 0; y < h; ++y) {
      uint8_t* row = &full[c][static_cast<size_t>(y) * fw];
      std::memset(row + w, row[w - 1], fw - w);
    }
    for (int y = h; y < fh; ++y)
      std::memcpy(&full[c][static_cast<size_t>(y) * fw], &full[c][static_cast<size_t>(h - 1) * fw], fw);
  }
  // chroma: h2v2_downsample with alternating bias. Rows of the padding
  // below the image repeat the last real row of each component, as
  // jcprepro.c's expand_bottom_edge does after downsampling.
  Plane pl[3];
  pl[0].w = fw;
  pl[0].h = fh;
  pl[0].s.swap(full[0]);
  for (int c = 1; c < ncomp; ++c) {
    Plane& p = pl[c];
    p.w = fw / 2;
    p.h = fh / 2;
    p.s.resize(static_cast<size_t>(p.w) * p.h);
    const int wib = ((w + 1) / 2 + 7) / 8;  // blocks of the downsampled width
    const int cols = wib * 8;                            // output_cols of jcsample.c
    const int rows_real = (h + 1) / 2;
    for (int y = 0; y < p.h; ++y) {
      uint8_t* o = &p.s[static_cast<size_t>(y) * p.w];
      if (y < rows_real) {
        const uint8_t* r0 = &full[c][static_cast<size_t>(2 * y) * fw];
        const uint8_t* r1 = r0 + fw;
        int bias = 1;
        for (int x = 0; x < cols; ++x) {
          o[x] = static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
        for (int x = cols; x < p.w; ++x) o[x] = o[cols - 1];
      } else {
        std::memcpy(o, &p.s[static_cast<size_t>(rows_real - 1) * p.w], p.w);
      }
    }
  }

  // headers (jcmarker.c)
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), soi_app0, soi_app0 + sizeof soi_app0);
  for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) out.push_back(static_cast<uint8_t>(q[t][kZigzag[i]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * ncomp);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    out.push_back(static_cast<uint8_t>(c + 1));
    out.push_back(static_cast<uint8_t>(c == 0 ? (max_s << 4) | max_s : 0x11));
    out.push_back(static_cast<uint8_t>(c == 0 ? 0 : 1));
  }
  auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(out, 2 + 1 + 16 + total);
    out.push_back(static_cast<uint8_t>((cls << 4) | id));
    out.insert(out.end(), bits + 1, bits + 17);
    out.insert(out.end(), vals, vals + total);
  };
  dht(0, 0, kDcLumaBits, kDcVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (ncomp == 3) {
    dht(0, 1, kDcChromaBits, kDcVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * ncomp);
  out.push_back(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    out.push_back(static_cast<uint8_t>(c + 1));
    out.push_back(static_cast<uint8_t>(c == 0 ? 0x00 : 0x11));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // entropy-coded data (jccoefct.c compress_data, jchuff.c)
  static const EncTable dc0(kDcLumaBits, kDcVals), ac0(kAcLumaBits, kAcLumaVals);
  static const EncTable dc1(kDcChromaBits, kDcVals), ac1(kAcChromaBits, kAcChromaVals);
  BitWriter bw(out);
  int pred[3] = {0, 0, 0};
  int16_t blk[4][64];
  if (ncomp == 1) {
    const int wib = (w + 7) / 8, hib = (h + 7) / 8;
    for (int by = 0; by < hib; ++by)
      for (int bx = 0; bx < wib; ++bx) {
        encode_block(&pl[0].s[static_cast<size_t>(8 * by) * pl[0].w + 8 * bx], pl[0].w, div[0], blk[0]);
        emit_block(bw, blk[0], pred[0], dc0, ac0);
      }
  } else {
    const int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        int16_t yb[4][64];
        for (int k = 0; k < 4; ++k) {
          const int by = 2 * my + (k >> 1), bx = 2 * mx + (k & 1);
          const bool real_row = by < yhib;
          if (!real_row) {  // a row of dummy blocks at the bottom
            std::memset(yb[k], 0, sizeof yb[k]);
            yb[k][0] = yb[k - 1][0];  // the last block of the MCU before it
            if (k == 3) yb[3][0] = yb[1][0];
            continue;
          }
          if (bx >= ywib) {  // a dummy block at the right edge
            std::memset(yb[k], 0, sizeof yb[k]);
            yb[k][0] = yb[k - 1][0];
            continue;
          }
          encode_block(&pl[0].s[static_cast<size_t>(8 * by) * pl[0].w + 8 * bx], pl[0].w, div[0], yb[k]);
        }
        for (int k = 0; k < 4; ++k) emit_block(bw, yb[k], pred[0], dc0, ac0);
        for (int c = 1; c < 3; ++c) {
          encode_block(&pl[c].s[static_cast<size_t>(8 * my) * pl[c].w + 8 * mx], pl[c].w, div[1], blk[c]);
          emit_block(bw, blk[c], pred[c], dc1, ac1);
        }
      }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

}  // namespace

extern "C" {

// Reads the headers up to the first scan. info: height, width, components,
// EXIF orientation (0 when absent). Returns 0, 1 (unsupported; msg names
// the feature) or 2 (corrupt).
int jpeg_header(const uint8_t* data, size_t n, int* info, char* msg, int msg_len) {
  Decoder d;
  d.data = data;
  d.n = n;
  d.run(true);
  if (d.err.status == kOk && !d.frame) d.err.fail(kCorrupt, "JPEG file without a frame header");
  info[0] = d.height;
  info[1] = d.width;
  info[2] = d.ncomp;
  info[3] = d.orientation;
  std::snprintf(msg, msg_len, "%s", d.err.msg);
  return d.err.status;
}

// Decodes to (height, width, 3) BGR, as libjpeg-turbo does for OpenCV.
int jpeg_decode(const uint8_t* data, size_t n, uint8_t* bgr, char* msg, int msg_len) {
  Decoder d;
  d.data = data;
  d.n = n;
  if (d.run(false) == kOk) {
    for (int c = 0; c < d.ncomp; ++c)
      if (!d.comp[c].scanned) d.err.fail(kCorrupt, "JPEG component missing from every scan");
  }
  if (d.err.status != kOk) {
    std::snprintf(msg, msg_len, "%s", d.err.msg);
    return d.err.status;
  }
  const int W = d.width, H = d.height;
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < d.ncomp; ++c) {
    Component& k = d.comp[c];
    const int pw = k.wib * 8;
    std::vector<uint8_t> samp(static_cast<size_t>(pw) * k.hib * 8);
    for (int by = 0; by < k.hib; ++by)
      for (int bx = 0; bx < k.wib; ++bx)
        idct_islow(k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64, k.q,
                   samp.data() + static_cast<size_t>(8 * by) * pw + 8 * bx, pw);
    planes[c].resize(static_cast<size_t>(W) * H);
    upsample(samp.data(), pw, k.dw, k.dh, d.max_h / k.h, d.max_v / k.v, planes[c].data(), W, H);
  }
  const size_t npx = static_cast<size_t>(W) * H;
  if (d.ncomp == 1) {
    for (size_t i = 0; i < npx; ++i) bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = planes[0][i];
  } else if (d.is_rgb()) {
    for (size_t i = 0; i < npx; ++i) {
      bgr[3 * i] = planes[2][i];
      bgr[3 * i + 1] = planes[1][i];
      bgr[3 * i + 2] = planes[0][i];
    }
  } else {
    for (size_t i = 0; i < npx; ++i) {
      const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      bgr[3 * i] = clamp255(y + kYcc.cb_b[cb]);
      bgr[3 * i + 1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      bgr[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
    }
  }
  return kOk;
}

// Encodes an (h, w, cn) uint8 image (cn 3: BGR, cn 1: grey) as cv2.imwrite
// does with no parameters. Writes at most cap bytes to out and returns the size of
// the file (larger than cap when out was too small).
long jpeg_encode(const uint8_t* img, int h, int w, int cn, uint8_t* out, long cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(h) * w * cn / 4 + 1024);
  encode(img, h, w, cn, buf);
  const long size = static_cast<long>(buf.size());
  if (size <= cap) std::memcpy(out, buf.data(), buf.size());
  return size;
}

}  // extern "C"
