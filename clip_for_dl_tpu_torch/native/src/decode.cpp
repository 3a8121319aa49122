// JPEG and BMP decoding to RGB uint8, byte for byte what OpenCV's
// cv2.imdecode(buf, IMREAD_COLOR) (or, for a file, cv2.imread) returns with
// its channels reversed. OpenCV reads JPEG through libjpeg-turbo with its
// defaults and BMP with its own reader; this file follows both.
//
// JPEG: baseline, extended sequential (8-bit Huffman) and progressive frames,
// 1 or 3 components, any integral sampling ratios, restart intervals, EXIF
// orientation as OpenCV applies it. The bits are decided where libjpeg-turbo
// decides them:
//   - Huffman decoding with libjpeg's bit reader: past a marker the stream
//     reads as zero bits, and once a block needs such bits the rest of the
//     segment is left zero (grey); a code longer than 16 bits decodes as 0;
//   - the islow IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) as the SIMD
//     build computes it (16-bit operands, saturated outputs), which equals
//     the C code wherever no value overflows 16 bits;
//   - fancy upsampling (jdsample.c): the h2v1 and h2v2 triangle filters with
//     their alternating biases when the component is wider than 2 samples,
//     h1v2 (libjpeg-turbo >= 2.1), replication for every other ratio;
//   - YCbCr -> RGB with jdcolor.c's fixed-point tables (SCALEBITS 16).
// The colour space is guessed as libjpeg guesses it: JFIF marker, then
// Adobe's transform, then the component ids.
//
// Two ways to end early, as OpenCV's two sources do: a buffer (imdecode)
// suspends when the data runs out, and the image is refused (status 1),
// unless every MCU of a single-scan image was read before (OpenCV ignores
// what jpeg_finish_decompress meets after them); a file (imread) reads on
// as an endless run of fake EOI markers.
//
// Status 2 (with a message naming ROADMAP A2c) is what OpenCV reads but this
// decoder does not: arithmetic coding, lossless and 12-bit JPEG, 4-component
// (CMYK/YCCK) JPEG, and a progressive image libjpeg would finish by block
// smoothing (some of the first ten coefficients never fully sent).
//
// Memory: the caller allocates the output, and nothing else grows with the
// image but what libjpeg keeps. A single-scan JPEG is decoded one MCU row at
// a time (one row of coefficients, three of samples, as libjpeg's one-pass
// decoder); a progressive or multi-scan JPEG keeps every coefficient, as
// libjpeg does, in zeroed pages that are touched only as scans reach them.
// A body whose header declares a huge image and whose data ends at once
// touches no more than its first rows.
//
// C interface (ctypes): cxr_open(data, n, file, &handle, &h, &w, msg, len)
// reads the headers and returns the status; on 0 the image is h x w x 3
// (after EXIF orientation), and cxr_finish(handle, dst, msg, len) decodes it
// into dst, returns the status and frees the handle (cxr_close frees it
// without decoding). The data must stay alive until then. TIFF (tiff.cpp)
// and Netpbm (pnm.cpp) go through the same two calls.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "common.h"

namespace {

using namespace cxr;

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

// zigzag position -> natural position, with 16 extra entries so that a
// corrupt run past the end of a block lands on coefficient 63 (jutils.c)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K's tables, which libjpeg-turbo's sequential decoder uses for a
// table slot 0 or 1 that a stream never defines (Motion-JPEG); its
// progressive decoder has no such fallback
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},           // DC 0
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},           // DC 1
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},        // AC 0
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};       // AC 1
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAc0Vals[162] = {
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
const uint8_t kStdAc1Vals[162] = {
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

enum Marker {
  kSOF0 = 0xC0, kSOF1 = 0xC1, kSOF2 = 0xC2, kSOF3 = 0xC3, kDHT = 0xC4, kSOF9 = 0xC9,
  kSOF10 = 0xCA, kSOF11 = 0xCB, kDAC = 0xCC, kRST0 = 0xD0, kRST7 = 0xD7, kSOI = 0xD8,
  kEOI = 0xD9, kSOS = 0xDA, kDQT = 0xDB, kDNL = 0xDC, kDRI = 0xDD, kAPP0 = 0xE0,
  kAPP1 = 0xE1, kAPP14 = 0xEE, kAPP15 = 0xEF, kCOM = 0xFE, kTEM = 0x01
};

// The bytes of a stream. A buffer ends where its data does (reading past it
// is a suspension, which OpenCV's imdecode turns into no image); a file reads
// on as FF D9 FF D9 ..., the fake EOI that libjpeg's stdio source inserts.
class Source {
 public:
  Source(const uint8_t* data, size_t n, bool file) : data_(data), n_(n), file_(file) {}

  int byte() {
    if (pos_ < n_) return data_[pos_++];
    if (!file_) throw Suspended{};
    return ((pos_++ - n_) & 1) ? kEOI : 0xFF;
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long count) {
    if (count <= 0) return;
    if (!file_ && pos_ + static_cast<size_t>(count) > n_) throw Suspended{};
    pos_ += static_cast<size_t>(count);
  }

  // the byte at the read position, not consumed
  int peek() {
    size_t at = pos_;
    int b = byte();
    pos_ = at;
    return b;
  }
  size_t remaining() const { return pos_ < n_ ? n_ - pos_ : 0; }
  size_t pos() const { return pos_; }
  void seek(size_t pos) { pos_ = pos; }

  int unread_marker = 0;  // libjpeg's cinfo->unread_marker

 private:
  const uint8_t* data_;
  size_t n_;
  bool file_;
  size_t pos_ = 0;
};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jdhuff.c's derived table: bit-serial limits and an 8-bit lookahead
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t lookup[256];  // (length << 8) | symbol; length 9 = longer code
};

HuffTable derive(const HuffSpec* given, bool dc, int slot, bool fallback) {
  HuffSpec std_spec;
  const HuffSpec* spec = given;
  if (spec == nullptr || !spec->defined) {
    if (slot > 1 || !fallback) undecodable("a Huffman table is missing");
    std_spec.defined = true;
    std::memcpy(std_spec.bits, kStdBits[(dc ? 0 : 2) + slot], 17);
    if (dc)
      std::memcpy(std_spec.vals, kStdDcVals, sizeof kStdDcVals);
    else
      std::memcpy(std_spec.vals, slot ? kStdAc1Vals : kStdAc0Vals, 162);
    spec = &std_spec;
  }
  HuffTable t;
  char size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int count = spec->bits[l];
    if (p + count > 256) undecodable("a bad Huffman table");
    while (count--) size[p++] = static_cast<char>(l);
  }
  size[p] = 0;
  int num = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) undecodable("a bad Huffman table");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec->bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += spec->bits[l];
      t.maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memcpy(t.vals, spec->vals, 256);
  for (int i = 0; i < 256; ++i) t.lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= spec->bits[l]; ++i, ++p) {
      int look = static_cast<int>(code[p]) << (8 - l);
      for (int k = 1 << (8 - l); k > 0; --k) t.lookup[look++] = (l << 8) | spec->vals[p];
    }
  }
  if (dc)
    for (int i = 0; i < num; ++i)
      if (spec->vals[i] > 15) undecodable("a bad Huffman table");
  return t;
}

// libjpeg's bit reader. The slow path (jpeg_fill_bit_buffer) fills to 57
// bits, stops at a marker, and past it supplies zero bits, flagging the
// segment short of data the first time a request needs them. The fast path
// (decode_mcu_fast, taken for an MCU while 512 bytes a block remain) reads six
// bytes whenever 16 bits or fewer are left, and pads a marker with zero bytes;
// the two decode the same values but read ahead differently, which decides
// whether a buffer that ends without EOI is read past its end.
class BitReader {
 public:
  explicit BitReader(Source& src) : src_(src) {}

  struct State {
    uint64_t buf;
    int left;
    size_t pos;
  };
  State save() const { return State{buf_, left_, src_.pos()}; }
  void restore(const State& s) {
    buf_ = s.buf;
    left_ = s.left;
    src_.seek(s.pos);
  }

  void reset() { left_ = 0; }  // a restart throws the buffered bits away
  bool insufficient = false;
  bool fast = false;

  int bits(int n) {
    if (fast)
      fill_fast();
    else if (left_ < n)
      fill(n);
    left_ -= n;
    return static_cast<int>((buf_ >> left_) & ((1u << n) - 1));
  }

  int decode(const HuffTable& t) {
    int nb;
    if (fast) {
      fill_fast();
      int e = t.lookup[(buf_ >> (left_ - 8)) & 0xFF];
      nb = e >> 8;
      left_ -= nb;
      if (nb <= 8) return e & 0xFF;
      int32_t code = static_cast<int32_t>((buf_ >> left_) & ((1u << nb) - 1));
      while (code > t.maxcode[nb]) {
        --left_;
        code = (code << 1) | static_cast<int32_t>((buf_ >> left_) & 1);
        ++nb;
      }
      if (nb > 16) return 0;
      return t.vals[(code + t.valoffset[nb]) & 0xFF];
    }
    if (left_ < 8) {
      fill(0);
      if (left_ < 8) {
        nb = 1;
        return slow(t, nb);
      }
    }
    int e = t.lookup[(buf_ >> (left_ - 8)) & 0xFF];
    nb = e >> 8;
    if (nb <= 8) {
      left_ -= nb;
      return e & 0xFF;
    }
    return slow(t, nb);
  }

 private:
  int slow(const HuffTable& t, int l) {
    int32_t code = bits(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      ++l;
    }
    if (l > 16) return 0;  // a bad code decodes as 0
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  void fill_fast() {
    if (left_ > 16) return;
    for (int i = 0; i < 6; ++i) {
      int c0 = src_.byte();
      int c1 = src_.peek();
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c0);
      left_ += 8;
      if (c0 == 0xFF) {
        src_.byte();
        if (c1 != 0) {
          src_.unread_marker = c1;
          src_.seek(src_.pos() - 2);
          buf_ &= ~uint64_t(0xFF);
        }
      }
    }
  }

  void fill(int nbits) {
    if (src_.unread_marker == 0) {
      while (left_ < 57) {
        int c = src_.byte();
        if (c == 0xFF) {
          do c = src_.byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            src_.unread_marker = c;
            goto no_more;
          }
        }
        buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
        left_ += 8;
      }
      return;
    }
  no_more:
    if (nbits > left_) {
      insufficient = true;
      buf_ <<= 57 - left_;
      left_ = 57;
    }
  }

  Source& src_;
  uint64_t buf_ = 0;
  int left_ = 0;
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + 1 - (1 << s) : r; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int wib = 0, hib = 0;          // width and height in blocks
  int bw = 0, bh = 0;            // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;            // downsampled width and height in samples
  bool latched = false;
  uint16_t quant[64] = {};       // natural order, latched at the first scan
  int band_rows = 0;             // block rows of a band (an MCU row)
  int coef_rows = 0;             // block rows held: a band's, or bh
  std::unique_ptr<int16_t[], Free> coef;  // coef_rows * bw blocks of 64
  std::vector<uint8_t> ring;     // samples of three bands, bw * 8 a row
  int coef_bits[64];             // progressive: -1 never sent, else Al so far
  int16_t* block(int bx, int by) {
    return &coef[(static_cast<size_t>(by % coef_rows) * bw + bx) * 64];
  }
};

// OpenCV's ExifReader: byte order, tag mark, IFD0's entries; the orientation
// is the 16-bit value at the entry's offset 8
int exif_orientation(const std::vector<uint8_t>& app1) {
  if (app1.size() <= 6) return 1;
  const uint8_t* d = app1.data() + 6;
  size_t n = app1.size() - 6;
  if (n < 2 || d[0] != d[1] || (d[0] != 'I' && d[0] != 'M')) return 1;
  bool intel = d[0] == 'I';
  auto u16 = [&](size_t off, bool& ok) -> uint32_t {
    if (off + 1 >= n) {
      ok = false;
      return 0;
    }
    return intel ? d[off] | (d[off + 1] << 8) : (d[off] << 8) | d[off + 1];
  };
  auto u32 = [&](size_t off, bool& ok) -> uint32_t {
    if (off + 3 >= n) {
      ok = false;
      return 0;
    }
    return intel ? d[off] | (d[off + 1] << 8) | (d[off + 2] << 16) | (uint32_t(d[off + 3]) << 24)
                 : (uint32_t(d[off]) << 24) | (d[off + 1] << 16) | (d[off + 2] << 8) | d[off + 3];
  };
  bool ok = true;
  if (u16(2, ok) != 0x2A || !ok) return 1;
  size_t off = u32(4, ok);
  if (!ok) return 1;
  size_t entries = u16(off, ok);
  if (!ok) return 1;
  off += 2;
  int orientation = 1;
  for (size_t e = 0; e < entries; ++e, off += 12) {
    uint32_t tag = u16(off, ok);
    if (!ok) return orientation;
    if (tag == 0x0112) {
      uint32_t v = u16(off + 8, ok);
      if (!ok) return orientation;
      orientation = static_cast<int>(v);
    }
  }
  return orientation;
}

// One component's samples upsampled to output row y (jdsample.c), into out
// (at least width entries). Its samples lie in a ring of three bands of
// band_h rows.
struct Upsampler {
  const uint8_t* ring;
  int stride, dw, dh, band_h, hx, vx;  // expansion factors
  bool fancy;
  mutable std::vector<uint8_t> full;

  const uint8_t* at(int r) const {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return ring + (static_cast<size_t>(r / band_h % 3) * band_h + r % band_h) * stride;
  }

  void row(int y, int width, uint8_t* out) const {
    if (hx == 1 && vx == 1) {
      std::memcpy(out, at(y), width);
    } else if (hx == 2 && vx == 1 && fancy) {
      const uint8_t* p = at(y);
      full.resize(2 * dw);
      full[0] = p[0];
      full[1] = static_cast<uint8_t>((p[0] * 3 + p[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        int v = p[c] * 3;
        full[2 * c] = static_cast<uint8_t>((v + p[c - 1] + 1) >> 2);
        full[2 * c + 1] = static_cast<uint8_t>((v + p[c + 1] + 2) >> 2);
      }
      int c = dw - 1;
      full[2 * c] = static_cast<uint8_t>((p[c] * 3 + p[c - 1] + 1) >> 2);
      full[2 * c + 1] = p[c];
      std::memcpy(out, full.data(), width);
    } else if (hx == 2 && vx == 2 && fancy) {
      int r = y >> 1;
      const uint8_t* p0 = at(r);
      const uint8_t* p1 = (y & 1) ? at(r + 1) : at(r - 1);
      full.resize(2 * dw);
      int thiscol = p0[0] * 3 + p1[0], nextcol = p0[1] * 3 + p1[1], lastcol;
      full[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      full[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int c = 1; c < dw - 1; ++c) {
        nextcol = p0[c + 1] * 3 + p1[c + 1];
        full[2 * c] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        full[2 * c + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      int c = dw - 1;
      full[2 * c] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      full[2 * c + 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      std::memcpy(out, full.data(), width);
    } else if (hx == 1 && vx == 2 && fancy) {
      int r = y >> 1;
      const uint8_t* p0 = at(r);
      const uint8_t* p1 = (y & 1) ? at(r + 1) : at(r - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
    } else {
      const uint8_t* p = at(y / vx);
      for (int x = 0; x < width; ++x) out[x] = p[x / hx];
    }
  }
};


class Jpeg : public Decoder {
 public:
  Jpeg(const uint8_t* data, size_t n, bool file) : src_(data, n, file), bits_(src_) {}

  // the headers up to the first scan; the frame's size and orientation
  void open(Sink* sink) override;
  // every scan, into sink.dst
  void run(const Sink& sink) override;

  // a stream inside a TIFF takes its colour transform from the container:
  // -1 guessed from the markers, 0 YCbCr -> RGB, 1 none
  int colour = -1;
  int height() const { return height_; }
  int width() const { return width_; }
  int precision() const { return precision_; }
  const std::vector<Component>& components() const { return comps_; }

 private:
  void first_marker();
  void next_marker();
  int read_markers();  // returns kSOS or kEOI
  void get_sof(int marker);
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_app(int marker);
  void setup();
  void scan();
  void restart();
  void resync(int desired);
  void decode_sequential_mcu(int mx, int my);
  void decode_progressive_mcu(int mx, int my);
  bool smoothing_ok() const;
  void allocate(bool whole);
  void prepare_output();
  void idct_band(Component& c, int band) const;
  void band_ready(int band);
  void emit(int band);

  Source src_;
  BitReader bits_;
  bool saw_sof_ = false, progressive_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, precision_ = 8;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  HuffSpec dc_specs_[4], ac_specs_[4];
  bool quant_defined_[4] = {};
  uint16_t quant_[4][64] = {};
  int restart_interval_ = 0;
  std::vector<uint8_t> exif_;
  bool saw_app1_ = false;
  // the scan in hand
  std::vector<int> scan_comps_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int next_restart_ = 0, restarts_to_go_ = 0, eobrun_ = 0;
  int last_dc_[4] = {};
  HuffTable dc_tables_[4], ac_tables_[4];
  // the output: bands of out_band_ rows, each emitted once the next band's
  // samples are in the ring (the fancy upsamplers read a row either side)
  const Sink* sink_ = nullptr;
  bool streaming_ = false;  // a single scan, emitted as its MCU rows arrive
  int bands_ = 0, out_band_ = 0;
  bool rgb_ = false;
  std::vector<Upsampler> ups_;
  std::vector<uint8_t> rows_;
};

void Jpeg::first_marker() {
  int c = src_.byte(), c2 = src_.byte();
  if (c != 0xFF || c2 != kSOI) undecodable("not a JPEG stream");
  src_.unread_marker = c2;
}

void Jpeg::next_marker() {
  int c;
  for (;;) {
    c = src_.byte();
    while (c != 0xFF) c = src_.byte();
    do c = src_.byte();
    while (c == 0xFF);
    if (c != 0) break;
  }
  src_.unread_marker = c;
}

void Jpeg::get_sof(int marker) {
  int length = src_.word();
  precision_ = src_.byte();
  height_ = src_.word();
  width_ = src_.word();
  int n = src_.byte();
  length -= 8;
  if (marker == kSOF3) refused("lossless JPEG");
  if (precision_ == 12) refused("12-bit JPEG");
  if (height_ <= 0 || width_ <= 0 || n <= 0) undecodable("an empty image");
  if (length != n * 3) undecodable("a bad SOF length");
  comps_.clear();
  comps_.resize(n);
  for (auto& c : comps_) {
    c.id = src_.byte();
    int f = src_.byte();
    c.h = (f >> 4) & 15;
    c.v = f & 15;
    c.tq = src_.byte();
  }
  progressive_ = marker == kSOF2;
  saw_sof_ = true;
}

void Jpeg::get_sos() {
  if (!saw_sof_) undecodable("SOS before SOF");
  int length = src_.word();
  int n = src_.byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) undecodable("a bad SOS length");
  scan_comps_.clear();
  for (int i = 0; i < n; ++i) {
    int cc = src_.byte(), c = src_.byte();
    int found = -1;
    for (int ci = 0; ci < static_cast<int>(comps_.size()) && ci < 4; ++ci) {
      bool taken = std::find(scan_comps_.begin(), scan_comps_.end(), ci) != scan_comps_.end();
      if (cc == comps_[ci].id && !taken) {
        found = ci;
        break;
      }
    }
    if (found < 0) undecodable("a bad component id in SOS");
    comps_[found].dc_tbl = (c >> 4) & 15;
    comps_[found].ac_tbl = c & 15;
    scan_comps_.push_back(found);
  }
  ss_ = src_.byte();
  se_ = src_.byte();
  int a = src_.byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_ = 0;
}

void Jpeg::get_dht() {
  int length = src_.word() - 2;
  while (length > 16) {
    int index = src_.byte();
    HuffSpec spec;
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      spec.bits[i] = static_cast<uint8_t>(src_.byte());
      count += spec.bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length) undecodable("a bad Huffman table");
    for (int i = 0; i < count; ++i) spec.vals[i] = static_cast<uint8_t>(src_.byte());
    length -= count;
    spec.defined = true;
    HuffSpec* slot;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) undecodable("a bad DHT index");
      slot = &ac_specs_[index];
    } else {
      if (index < 0 || index >= 4) undecodable("a bad DHT index");
      slot = &dc_specs_[index];
    }
    *slot = spec;
  }
  if (length != 0) undecodable("a bad DHT length");
}

void Jpeg::get_dqt() {
  int length = src_.word() - 2;
  while (length > 0) {
    int n = src_.byte();
    int prec = n >> 4;
    n &= 15;
    if (n >= 4) undecodable("a bad DQT index");
    for (int i = 0; i < 64; ++i)
      quant_[n][kNatural[i]] = static_cast<uint16_t>(prec ? src_.word() : src_.byte());
    quant_defined_[n] = true;
    length -= 64 + 1;
    if (prec) length -= 64;
  }
  if (length != 0) undecodable("a bad DQT length");
}

void Jpeg::get_dri() {
  if (src_.word() != 4) undecodable("a bad DRI length");
  restart_interval_ = src_.word();
}

void Jpeg::get_app(int marker) {
  int length = src_.word() - 2;
  if (marker == kAPP1 && !saw_app1_) {
    // OpenCV keeps every APP1 marker and reads EXIF from the first
    saw_app1_ = true;
    for (int i = 0; i < length; ++i) exif_.push_back(static_cast<uint8_t>(src_.byte()));
    return;
  }
  if (marker == kAPP1) {
    for (int i = 0; i < length; ++i) src_.byte();
    return;
  }
  if (marker != kAPP0 && marker != kAPP14) {
    src_.skip(length);
    return;
  }
  uint8_t b[14];
  int num = length >= 14 ? 14 : (length > 0 ? length : 0);
  for (int i = 0; i < num; ++i) b[i] = static_cast<uint8_t>(src_.byte());
  length -= num;
  if (marker == kAPP0 && num >= 14 && !std::memcmp(b, "JFIF", 5)) saw_jfif_ = true;
  if (marker == kAPP14 && num >= 12 && !std::memcmp(b, "Adobe", 5)) {
    saw_adobe_ = true;
    adobe_transform_ = b[11];
  }
  src_.skip(length);
}

int Jpeg::read_markers() {
  for (;;) {
    if (src_.unread_marker == 0) next_marker();
    int m = src_.unread_marker;
    switch (m) {
      case kSOI:
        undecodable("a second SOI marker");
      case kSOF0: case kSOF1: case kSOF2: case kSOF3: case kSOF9: case kSOF10: case kSOF11:
        if (saw_sof_) undecodable("a second SOF marker");
        if (m >= kSOF9) refused("arithmetic-coded JPEG");
        get_sof(m);
        break;
      case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCD: case 0xCE: case 0xCF:
        undecodable("an unsupported SOF type");
      case kSOS:
        get_sos();
        src_.unread_marker = 0;
        return kSOS;
      case kEOI:
        src_.unread_marker = 0;
        return kEOI;
      case kDAC:
        src_.skip(src_.word() - 2);
        break;
      case kDHT:
        get_dht();
        break;
      case kDQT:
        get_dqt();
        break;
      case kDRI:
        get_dri();
        break;
      case kCOM: case kDNL:
        src_.skip(src_.word() - 2);
        break;
      case kTEM:
        break;
      default:
        if (m >= kRST0 && m <= kRST7) break;
        if (m >= kAPP0 && m <= kAPP15) {
          get_app(m);
          break;
        }
        undecodable("an unknown marker");
    }
    src_.unread_marker = 0;
  }
}

// jdinput.c initial_setup: sampling factors and the block layout
void Jpeg::setup() {
  if (width_ > 65500 || height_ > 65500 ||
      static_cast<uint64_t>(width_) * height_ > (uint64_t(1) << 30))
    undecodable("an image too large");
  if (precision_ != 8) undecodable("a bad sample precision");
  int n = static_cast<int>(comps_.size());
  if (n == 4) refused("4-component (CMYK or YCCK) JPEG");
  if (n != 1 && n != 3) undecodable("an unsupported number of components");
  for (auto& c : comps_) {
    if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) undecodable("bad sampling factors");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  mcux_ = (width_ + hmax_ * 8 - 1) / (hmax_ * 8);
  mcuy_ = (height_ + vmax_ * 8 - 1) / (vmax_ * 8);
  for (auto& c : comps_) {
    c.wib = static_cast<int>((static_cast<long>(width_) * c.h + hmax_ * 8 - 1) / (hmax_ * 8));
    c.hib = static_cast<int>((static_cast<long>(height_) * c.v + vmax_ * 8 - 1) / (vmax_ * 8));
    c.dw = static_cast<int>((static_cast<long>(width_) * c.h + hmax_ - 1) / hmax_);
    c.dh = static_cast<int>((static_cast<long>(height_) * c.v + vmax_ - 1) / vmax_);
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    std::fill(c.coef_bits, c.coef_bits + 64, -1);
  }
}

// Coefficient storage: a band's (an MCU row, or a block row of a
// one-component image) for a single scan, else the whole image's, zeroed by
// calloc (untouched pages stay uncommitted)
void Jpeg::allocate(bool whole) {
  const bool one = comps_.size() == 1;
  for (auto& c : comps_) {
    c.band_rows = one ? 1 : c.v;
    c.coef_rows = whole ? c.bh : c.band_rows;
    size_t count = static_cast<size_t>(c.bw) * c.coef_rows * 64;
    c.coef.reset(static_cast<int16_t*>(std::calloc(count, sizeof(int16_t))));
    if (!c.coef) throw std::bad_alloc();
  }
  bands_ = one ? comps_[0].hib : mcuy_;
  out_band_ = one ? 8 : vmax_ * 8;
}

void Jpeg::resync(int desired) {
  int marker = src_.unread_marker;
  for (;;) {
    int action;
    if (marker < kSOF0) {
      action = 2;
    } else if (marker < kRST0 || marker > kRST7) {
      action = 3;
    } else if (marker == kRST0 + ((desired + 1) & 7) || marker == kRST0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == kRST0 + ((desired - 1) & 7) || marker == kRST0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      src_.unread_marker = 0;
      return;
    }
    if (action == 3) return;
    next_marker();
    marker = src_.unread_marker;
  }
}

void Jpeg::restart() {
  bits_.reset();
  if (src_.unread_marker == 0) next_marker();
  if (src_.unread_marker == kRST0 + next_restart_)
    src_.unread_marker = 0;
  else
    resync(next_restart_);
  next_restart_ = (next_restart_ + 1) & 7;
  for (int& dc : last_dc_) dc = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (src_.unread_marker == 0) bits_.insufficient = false;
}

void Jpeg::decode_sequential_mcu(int mx, int my) {
  for (size_t i = 0; i < scan_comps_.size(); ++i) {
    int ci = scan_comps_[i];
    Component& c = comps_[ci];
    bool single = scan_comps_.size() == 1;
    int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
    for (int by = 0; by < nv; ++by) {
      for (int bx = 0; bx < nh; ++bx) {
        int16_t* block = single ? c.block(mx, my) : c.block(mx * c.h + bx, my * c.v + by);
        int s = bits_.decode(dc_tables_[c.dc_tbl]);
        if (s) s = extend(bits_.bits(s), s);
        last_dc_[i] += s;
        block[0] = static_cast<int16_t>(last_dc_[i]);
        const HuffTable& ac = ac_tables_[c.ac_tbl];
        for (int k = 1; k < 64; ++k) {
          s = bits_.decode(ac);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            block[kNatural[k]] = static_cast<int16_t>(extend(bits_.bits(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      }
    }
  }
}

void Jpeg::decode_progressive_mcu(int mx, int my) {
  bool single = scan_comps_.size() == 1;
  if (ss_ == 0) {  // DC band
    for (size_t i = 0; i < scan_comps_.size(); ++i) {
      Component& c = comps_[scan_comps_[i]];
      int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          int16_t* block = single ? c.block(mx, my) : c.block(mx * c.h + bx, my * c.v + by);
          if (ah_ == 0) {
            int s = bits_.decode(dc_tables_[c.dc_tbl]);
            if (s) s = extend(bits_.bits(s), s);
            last_dc_[i] += s;
            block[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc_[i]) << al_);
          } else if (bits_.bits(1)) {
            block[0] = static_cast<int16_t>(block[0] | (1 << al_));
          }
        }
      }
    }
    return;
  }
  Component& c = comps_[scan_comps_[0]];
  int16_t* block = c.block(mx, my);
  const HuffTable& tbl = ac_tables_[c.ac_tbl];
  if (ah_ == 0) {  // AC first
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int s = bits_.decode(tbl);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        int v = extend(bits_.bits(s), s);
        block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits_.bits(r);
        --eobrun_;
        break;
      }
    }
    return;
  }
  // AC refinement
  int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int s = bits_.decode(tbl);
      int r = s >> 4;
      s &= 15;
      if (s) {
        s = bits_.bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits_.bits(r);
        break;
      }
      do {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          if (bits_.bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se_);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = block + kNatural[k];
      if (*coef != 0 && bits_.bits(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun_;
  }
}

// One scan: table and quantizer set-up (start_pass_huff_decoder,
// start_pass_phuff_decoder, latch_quant_tables), then every MCU
void Jpeg::scan() {
  for (int ci : scan_comps_) {
    Component& c = comps_[ci];
    if (!c.latched) {
      if (c.tq >= 4 || !quant_defined_[c.tq]) undecodable("a quantization table is missing");
      std::memcpy(c.quant, quant_[c.tq], sizeof c.quant);
      c.latched = true;
    }
  }
  int blocks = 0;
  for (int ci : scan_comps_)
    blocks += scan_comps_.size() == 1 ? 1 : comps_[ci].h * comps_[ci].v;
  if (blocks > 10) undecodable("too many blocks in an MCU");
  if (progressive_) {
    bool dc = ss_ == 0, bad = false;
    if (dc) {
      if (se_ != 0) bad = true;
    } else if (ss_ > se_ || se_ >= 64 || scan_comps_.size() != 1) {
      bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) undecodable("a bad progression");
    for (int ci : scan_comps_)
      for (int k = ss_; k <= se_; ++k) comps_[ci].coef_bits[k] = al_;
    for (int ci : scan_comps_) {
      Component& c = comps_[ci];
      if (dc) {
        if (ah_ == 0) {
          if (c.dc_tbl >= 4) undecodable("a Huffman table is missing");
          dc_tables_[c.dc_tbl] = derive(&dc_specs_[c.dc_tbl], true, c.dc_tbl, false);
        }
      } else {
        if (c.ac_tbl >= 4) undecodable("a Huffman table is missing");
        ac_tables_[c.ac_tbl] = derive(&ac_specs_[c.ac_tbl], false, c.ac_tbl, false);
      }
    }
  } else {
    for (int ci : scan_comps_) {
      Component& c = comps_[ci];
      if (c.dc_tbl >= 4 || c.ac_tbl >= 4) undecodable("a Huffman table is missing");
      dc_tables_[c.dc_tbl] = derive(&dc_specs_[c.dc_tbl], true, c.dc_tbl, true);
      ac_tables_[c.ac_tbl] = derive(&ac_specs_[c.ac_tbl], false, c.ac_tbl, true);
    }
  }
  for (int& dc : last_dc_) dc = 0;
  bits_.reset();
  bits_.insufficient = false;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;

  int nx, ny;
  if (scan_comps_.size() == 1) {
    nx = comps_[scan_comps_[0]].wib;
    ny = comps_[scan_comps_[0]].hib;
  } else {
    nx = mcux_;
    ny = mcuy_;
  }
  bool dc_refine = progressive_ && ss_ == 0 && ah_ != 0;
  const size_t fast_bytes = 512 * static_cast<size_t>(blocks);
  for (int my = 0; my < ny; ++my) {
    if (streaming_)
      for (int ci : scan_comps_) {
        Component& c = comps_[ci];
        std::memset(c.coef.get(), 0, static_cast<size_t>(c.bw) * c.coef_rows * 64 * sizeof(int16_t));
      }
    for (int mx = 0; mx < nx; ++mx) {
      if (restart_interval_ && restarts_to_go_ == 0) restart();
      if (!bits_.insufficient || dc_refine) {
        if (progressive_) {
          decode_progressive_mcu(mx, my);
        } else if (!restart_interval_ && src_.unread_marker == 0 &&
                   src_.remaining() >= fast_bytes) {
          BitReader::State state = bits_.save();
          int last_dc[4];
          std::memcpy(last_dc, last_dc_, sizeof last_dc);
          bits_.fast = true;
          decode_sequential_mcu(mx, my);
          bits_.fast = false;
          if (src_.unread_marker != 0) {  // hit a marker: the slow path again
            src_.unread_marker = 0;
            bits_.restore(state);
            std::memcpy(last_dc_, last_dc, sizeof last_dc);
            decode_sequential_mcu(mx, my);
          }
        } else {
          decode_sequential_mcu(mx, my);
        }
      }
      if (restart_interval_) --restarts_to_go_;
    }
    if (streaming_) band_ready(my);
  }
}

// jdcoefct.c smoothing_ok (libjpeg-turbo >= 2.1, ten saved coefficients)
bool Jpeg::smoothing_ok() const {
  if (!progressive_) return false;
  static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : comps_) {
    if (!c.latched) return false;
    for (int pos : kSaved)
      if (c.quant[pos] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// One pass of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm) over
// eight columns or rows: jidctint.c's products, regrouped into pairs of
// 16-bit operands (vpmaddwd), with 16-bit sums of the inputs, 32-bit sums of
// the products, and outputs descaled by `shift` and saturated to 16 bits. On
// any coefficients a real encoder writes this equals the C code; on corrupt
// data whose values overflow 16 bits it is what the SIMD library returns.
inline void idct_pass(const int16_t* in, int step, int16_t* out, int ostep, int shift) {
  auto wrap16 = [](int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); };
  auto add = [](int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  };
  auto sub = [](int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
  };
  const int32_t round = 1 << (shift - 1);
  auto out16 = [&](int32_t x) -> int16_t {
    int32_t v = add(x, round) >> shift;
    return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
  };
  int32_t in0 = in[0], in1 = in[step], in2 = in[2 * step], in3 = in[3 * step],
          in4 = in[4 * step], in5 = in[5 * step], in6 = in[6 * step], in7 = in[7 * step];
  // even part
  int32_t tmp3 = in2 * 10703 + in6 * 4433;   // F_0_541 + F_0_765, F_0_541
  int32_t tmp2 = in2 * 4433 + in6 * -10704;  // F_0_541, F_0_541 - F_1_847
  int32_t tmp0 = static_cast<int32_t>(wrap16(in0 + in4)) * 8192;
  int32_t tmp1 = static_cast<int32_t>(wrap16(in0 - in4)) * 8192;
  int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  int32_t tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  // odd part
  int32_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  int32_t z3p = z3 * -6436 + z4 * 9633;  // F_1_175 - F_1_961, F_1_175
  int32_t z4p = z3 * 9633 + z4 * 6437;   // F_1_175, F_1_175 - F_0_390
  int32_t t0 = add(in7 * -4927 + in1 * -7373, z3p);   // F_0_298 - F_0_899, -F_0_899
  int32_t t1 = add(in5 * -4176 + in3 * -20995, z4p);  // F_2_053 - F_2_562, -F_2_562
  int32_t t3 = add(in7 * -7373 + in1 * 4926, z4p);    // -F_0_899, F_1_501 - F_0_899
  int32_t t2 = add(in5 * -20995 + in3 * 4177, z3p);   // -F_2_562, F_3_072 - F_2_562
  out[0] = out16(add(tmp10, t3));
  out[7 * ostep] = out16(sub(tmp10, t3));
  out[ostep] = out16(add(tmp11, t2));
  out[6 * ostep] = out16(sub(tmp11, t2));
  out[2 * ostep] = out16(add(tmp12, t1));
  out[5 * ostep] = out16(sub(tmp12, t1));
  out[3 * ostep] = out16(add(tmp13, t0));
  out[4 * ostep] = out16(sub(tmp13, t0));
}

// The islow IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) of a band's
// blocks of a component, as libjpeg-turbo's SIMD build computes it:
// coefficients dequantized to 16 bits, a block whose rows 1-7 are all zero
// takes the zero-AC shortcut, and each output is its 16-bit value saturated
// to [-128, 127] plus 128. Output: the band's slot of the ring.
void Jpeg::idct_band(Component& c, int band) const {
  const int stride = c.bw * 8;
  uint8_t* slot = &c.ring[static_cast<size_t>(band % 3) * c.band_rows * 8 * stride];
  int16_t q[64];
  for (int i = 0; i < 64; ++i) q[i] = static_cast<int16_t>(c.latched ? c.quant[i] : 0);
  int16_t deq[64], ws[64], rows[64];
  const int by0 = band * c.band_rows, by1 = std::min(by0 + c.band_rows, c.hib);
  for (int by = by0; by < by1; ++by) {
    for (int bx = 0; bx < c.wib; ++bx) {
      const int16_t* in = c.block(bx, by);
      bool ac = false;
      for (int i = 8; i < 64 && !ac; ++i) ac = in[i] != 0;
      if (!ac) {  // row 0 alone: each column's dequantized value, times 4, down its column
        for (int col = 0; col < 8; ++col) {
          int16_t v = static_cast<int16_t>(static_cast<uint16_t>(in[col] * q[col]) << 2);
          for (int row = 0; row < 8; ++row) ws[row * 8 + col] = v;
        }
      } else {
        for (int i = 0; i < 64; ++i) deq[i] = static_cast<int16_t>(static_cast<uint16_t>(in[i] * q[i]));
        for (int col = 0; col < 8; ++col) idct_pass(deq + col, 8, ws + col, 8, 11);
      }
      for (int row = 0; row < 8; ++row) idct_pass(ws + row * 8, 1, rows + row * 8, 1, 18);
      for (int row = 0; row < 8; ++row) {
        uint8_t* out = slot + (static_cast<size_t>(by - by0) * 8 + row) * stride + bx * 8;
        for (int k = 0; k < 8; ++k) {
          int v = rows[row * 8 + k];
          out[k] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
        }
      }
    }
  }
}

// The sample rings, the upsamplers and the colour space (libjpeg's guess)
void Jpeg::prepare_output() {
  int n = static_cast<int>(comps_.size());
  ups_.resize(n);
  for (int i = 0; i < n; ++i) {
    Component& c = comps_[i];
    int hx = hmax_ / c.h, vx = vmax_ / c.v;
    if (hmax_ % c.h || vmax_ % c.v) undecodable("fractional sampling");
    bool fancy;
    if (hx == 2 && (vx == 1 || vx == 2))
      fancy = c.dw > 2;
    else
      fancy = hx == 1 && vx == 2;
    c.ring.assign(static_cast<size_t>(3) * c.band_rows * 8 * c.bw * 8, 0);
    ups_[i] = Upsampler{c.ring.data(), c.bw * 8, c.dw, c.dh, c.band_rows * 8, hx, vx, fancy, {}};
  }
  rgb_ = false;
  if (n == 3) {
    if (colour >= 0)
      rgb_ = colour == 1;
    else if (saw_jfif_)
      rgb_ = false;
    else if (saw_adobe_)
      rgb_ = adobe_transform_ == 0;
    else
      rgb_ = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
  }
  rows_.assign(static_cast<size_t>(n) * (width_ + 16), 0);
}

// A band's samples are in (band - 1's and band's too): emit the band before
void Jpeg::band_ready(int band) {
  for (auto& c : comps_) idct_band(c, band);
  if (band > 0) emit(band - 1);
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((int64_t(91881) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((int64_t(116130) * x + one_half) >> 16);
      cr_g[i] = -int64_t(46802) * x;
      cb_g[i] = -int64_t(22554) * x + one_half;
    }
  }
};
const YccTables kYcc;

// The output rows of one band, upsampled and converted, into the sink
void Jpeg::emit(int band) {
  auto clamp = [](int v) -> uint8_t { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  const int n = static_cast<int>(comps_.size());
  const int y1 = std::min((band + 1) * out_band_, height_);
  for (int y = band * out_band_; y < y1; ++y) {
    long step;
    uint8_t* out = sink_->row(y, &step);
    if (n == 1) {  // grey: the plane's row, copied to three channels
      const uint8_t* c0 = ups_[0].at(y);
      for (int x = 0; x < width_; ++x, out += step) out[0] = out[1] = out[2] = c0[x];
      continue;
    }
    for (int i = 0; i < n; ++i) ups_[i].row(y, width_, &rows_[static_cast<size_t>(i) * (width_ + 16)]);
    const uint8_t* c0 = rows_.data();
    const uint8_t* c1 = c0 + width_ + 16;
    const uint8_t* c2 = c1 + width_ + 16;
    if (rgb_) {
      for (int x = 0; x < width_; ++x, out += step) {
        out[0] = c0[x];
        out[1] = c1[x];
        out[2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < width_; ++x, out += step) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      out[0] = clamp(yy + kYcc.cr_r[cr]);
      out[1] = clamp(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[2] = clamp(yy + kYcc.cb_b[cb]);
    }
  }
}

void Jpeg::open(Sink* sink) {
  first_marker();
  src_.unread_marker = 0;
  // headers up to the first scan
  if (read_markers() != kSOS) undecodable("no image before EOI");
  setup();
  // OpenCV reads EXIF from the APP1 markers before the first scan
  sink->h = height_;
  sink->w = width_;
  sink->orientation = exif_orientation(exif_);
  if (sink->orientation < 2 || sink->orientation > 8) sink->orientation = 1;
}

void Jpeg::run(const Sink& sink) {
  sink_ = &sink;
  const bool whole = progressive_ || scan_comps_.size() < comps_.size();
  allocate(whole);
  if (!whole) {
    // a single-scan image is complete once its MCUs are: OpenCV ignores
    // what jpeg_finish_decompress meets on its way to EOI (the buffer's end,
    // a bad marker, a second scan)
    prepare_output();
    streaming_ = true;
    scan();
    try {
      read_markers();
    } catch (const Suspended&) {
    } catch (const Failure&) {
    }
    emit(bands_ - 1);
    return;
  }
  scan();
  while (read_markers() != kEOI) scan();
  if (smoothing_ok())
    refused("a progressive JPEG whose scans leave coefficients that libjpeg estimates by "
            "block smoothing");
  prepare_output();
  for (int band = 0; band < bands_; ++band) band_ready(band);
  emit(bands_ - 1);
}


// ---------------------------------------------------------------------------
// BMP (OpenCV's BmpDecoder)
// ---------------------------------------------------------------------------

class Stream {
 public:
  Stream(const uint8_t* data, size_t n) : data_(data), n_(n) {}
  int byte() {
    if (pos_ >= n_) undecodable("the BMP data ends early");
    return data_[pos_++];
  }
  int word() {
    int lo = byte();
    return lo | (byte() << 8);
  }
  int32_t dword() {
    uint32_t lo = static_cast<uint32_t>(word());
    return static_cast<int32_t>(lo | (static_cast<uint32_t>(word()) << 16));
  }
  void bytes(uint8_t* dst, size_t count) {
    if (pos_ > n_ || n_ - pos_ < count) undecodable("the BMP data ends early");
    std::memcpy(dst, data_ + pos_, count);
    pos_ += count;
  }
  void skip(long count) { pos_ = static_cast<size_t>(static_cast<long>(pos_) + count); }
  void seek(size_t pos) { pos_ = pos; }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
};

struct Bgr {
  uint8_t b, g, r;
};

class Bmp : public Decoder {
 public:
  Bmp(const uint8_t* data, size_t n) : s(data, n) {}
  void open(Sink* sink) override;       // the headers and the palette
  void run(const Sink& sink) override;  // the pixels, RGB, into sink.dst

 private:
  enum { kRGB = 0, kRLE8 = 1, kRLE4 = 2, kBitfields = 3 };
  Stream s;
  int32_t offset = 0, width = 0, height = 0;
  int bpp = 0, rle = kRGB;
  bool bottom_up = true;
  Bgr palette[256] = {};
  // 32-bit BITFIELDS with a header of 56 bytes or more: each of red, green
  // and blue is (pixel & mask) >> shift, scaled to 0..255 (rounded down)
  uint32_t masks[3] = {0, 0, 0};
  int shifts[3] = {0, 0, 0};
  bool masked = false;
};

void Bmp::open(Sink* sink) {
  s.skip(10);
  offset = s.dword();
  int32_t size = s.dword();
  if (size <= 0) undecodable("a bad BMP header size");
  bool ok = false;
  if (size >= 36) {
    width = s.dword();
    height = s.dword();
    bpp = static_cast<int>(static_cast<uint32_t>(s.dword()) >> 16);
    int32_t code = s.dword();
    if (code < 0 || code > kBitfields) undecodable("an unknown BMP compression");
    rle = code;
    s.skip(12);
    int32_t clrused = s.dword();
    if (bpp == 32 && rle == kBitfields && size >= 56) {
      s.skip(4);
      masked = true;
      for (int i = 0; i < 3; ++i) {
        masks[i] = static_cast<uint32_t>(s.dword());
        masked = masked && masks[i] != 0;
        while (masks[i] && !((masks[i] >> shifts[i]) & 1)) ++shifts[i];
      }
      s.skip(4 + (size - 56));
    } else {
      s.skip(size - 36);
    }
    if (width > 0 && height != 0 &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 16 || bpp == 24 || bpp == 32) &&
          rle == kRGB) ||
         ((bpp == 16 || bpp == 32) && rle == kBitfields) || (bpp == 4 && rle == kRLE4) ||
         (bpp == 8 && rle == kRLE8))) {
      ok = true;
      if (bpp <= 8) {
        if (clrused < 0 || clrused > 256) undecodable("a bad BMP palette size");
        int entries = clrused == 0 ? 1 << bpp : clrused;
        std::vector<uint8_t> raw(static_cast<size_t>(entries) * 4);
        s.bytes(raw.data(), raw.size());
        for (int i = 0; i < entries; ++i) palette[i] = Bgr{raw[4 * i], raw[4 * i + 1], raw[4 * i + 2]};
      } else if (bpp == 16 && rle == kBitfields) {
        int32_t red = s.dword(), green = s.dword(), blue = s.dword();
        if (blue == 0x1f && green == 0x3e0 && red == 0x7c00)
          bpp = 15;
        else if (!(blue == 0x1f && green == 0x7e0 && red == 0xf800))
          ok = false;
      } else if (bpp == 16 && rle == kRGB) {
        bpp = 15;
      }
    }
  } else if (size == 12) {
    width = s.word();
    height = s.word();
    bpp = static_cast<int>(static_cast<uint32_t>(s.dword()) >> 16);
    rle = kRGB;
    if (width > 0 && height != 0 && (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)) {
      if (bpp <= 8) {
        int entries = 1 << bpp;
        std::vector<uint8_t> raw(static_cast<size_t>(entries) * 3);
        s.bytes(raw.data(), raw.size());
        for (int i = 0; i < entries; ++i) palette[i] = Bgr{raw[3 * i], raw[3 * i + 1], raw[3 * i + 2]};
      }
      ok = true;
    }
  }
  if (!ok) undecodable("an unsupported BMP");
  bottom_up = height > 0;
  if (height < 0) height = -height;
  if (width > (1 << 20) || height > (1 << 20) ||
      static_cast<uint64_t>(width) * height * 3 >= (uint64_t(1) << 30))
    undecodable("a BMP too large");
  if (offset < 0) undecodable("a bad BMP offset");
  sink->h = height;
  sink->w = width;
}

void Bmp::run(const Sink& sink) {
  uint8_t* const dst = sink.dst;
  const int width3 = width * 3;
  const long src_pitch = ((static_cast<long>(width) * (bpp != 15 ? bpp : 16) + 7) / 8 + 3) & -4;
  std::vector<uint8_t> src(static_cast<size_t>(src_pitch) + 32);
  s.seek(static_cast<size_t>(offset));
  // file row y lands on memory row (bottom_up ? height - 1 - y : y)
  auto row_ptr = [&](int y) {
    return &dst[static_cast<size_t>(bottom_up ? height - 1 - y : y) * width3];
  };
  auto put = [](uint8_t* p, const Bgr& c) {
    p[0] = c.r;
    p[1] = c.g;
    p[2] = c.b;
  };

  if (rle == kRLE4 || rle == kRLE8) {
    std::memset(dst, 0, static_cast<size_t>(height) * width3);  // what no run reaches
    // OpenCV's run-length decoders: a run past its line is bad data; end of
    // line, delta and end of bitmap fill what they skip with palette[0], and
    // the data must last until the bitmap's last line is done
    int y = 0;
    size_t x = 0;  // in bytes of the line (3 per pixel)
    int line_end_flag = 0;
    // FillUniColor: count3 bytes of colour c, wrapping to the next line
    auto fill_uni = [&](long count3, const Bgr& c) {
      do {
        long room = width3 - static_cast<long>(x);
        long take = count3 < room ? count3 : room;
        count3 -= take;
        uint8_t* p = row_ptr(y);
        for (long k = 0; k < take; k += 3) put(p + x + k, c);
        x += static_cast<size_t>(take);
        if (static_cast<long>(x) >= width3) {
          x = 0;
          if (++y >= height) break;
        }
      } while (count3 > 0);
    };
    for (;;) {
      int code = s.word();
      int len = code & 255;
      code >>= 8;
      if (len != 0) {
        if (x + static_cast<size_t>(len) * 3 > static_cast<size_t>(width3))
          undecodable("a bad BMP run");
        if (rle == kRLE8) {
          int prev_y = y;
          fill_uni(static_cast<long>(len) * 3, palette[code]);
          line_end_flag = y - prev_y;
          if (y >= height) break;
        } else {
          Bgr clr[2] = {palette[code >> 4], palette[code & 15]};
          uint8_t* p = row_ptr(y);
          for (int k = 0; k < len; ++k) put(p + x + 3 * k, clr[k & 1]);
          x += static_cast<size_t>(len) * 3;
        }
      } else if (code > 2) {
        if (x + static_cast<size_t>(code) * 3 > static_cast<size_t>(width3))
          undecodable("a bad BMP run");
        int sz = rle == kRLE8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
        s.bytes(src.data(), static_cast<size_t>(sz));
        uint8_t* p = row_ptr(y);
        for (int k = 0; k < code; ++k) {
          int idx = rle == kRLE8 ? src[k] : (k & 1 ? src[k >> 1] & 15 : src[k >> 1] >> 4);
          put(p + x + 3 * k, palette[idx]);
        }
        x += static_cast<size_t>(code) * 3;
        if (rle == kRLE8) line_end_flag = 0;
      } else {
        long x_shift3 = width3 - static_cast<long>(x);
        long y_shift = height - y;
        if (rle == kRLE4 || code || !line_end_flag || x_shift3 < width3) {
          if (code == 2) {
            x_shift3 = s.byte() * 3;
            y_shift = s.byte();
          }
          // RLE8 skips dy lines (the rest of the bitmap for an end of
          // bitmap); cv2's RLE4 reader reads dy and skips only along the line
          if (code != 0 && rle == kRLE8) x_shift3 += y_shift * width3;
          if (rle == kRLE8 && y >= height) break;
          fill_uni(x_shift3, palette[0]);
          if (y >= height) break;
        }
        line_end_flag = 0;
        if (y >= height) break;
      }
    }
  } else {
    for (int y = 0; y < height; ++y) {
      s.bytes(src.data(), static_cast<size_t>(src_pitch));
      uint8_t* p = row_ptr(y);
      for (int x = 0; x < width; ++x) {
        uint8_t* q = p + 3 * x;
        switch (bpp) {
          case 1:
            put(q, palette[(src[x >> 3] >> (7 - (x & 7))) & 1]);
            break;
          case 4:
            put(q, palette[x & 1 ? src[x >> 1] & 15 : src[x >> 1] >> 4]);
            break;
          case 8:
            put(q, palette[src[x]]);
            break;
          case 15: {
            int t = src[2 * x] | (src[2 * x + 1] << 8);
            q[2] = static_cast<uint8_t>(t << 3);
            q[1] = static_cast<uint8_t>((t >> 2) & ~7);
            q[0] = static_cast<uint8_t>((t >> 7) & ~7);
            break;
          }
          case 16: {
            int t = src[2 * x] | (src[2 * x + 1] << 8);
            q[2] = static_cast<uint8_t>(t << 3);
            q[1] = static_cast<uint8_t>((t >> 3) & ~3);
            q[0] = static_cast<uint8_t>((t >> 8) & ~7);
            break;
          }
          case 24:
          case 32:
            if (masked) {
              uint32_t px = src[4 * x] | (src[4 * x + 1] << 8) | (src[4 * x + 2] << 16) |
                            (static_cast<uint32_t>(src[4 * x + 3]) << 24);
              for (int i = 0; i < 3; ++i) {  // masks[0] red .. masks[2] blue
                uint64_t top = masks[i] >> shifts[i];
                q[i] = static_cast<uint8_t>(((px & masks[i]) >> shifts[i]) * 255 / top);
              }
            } else {
              const uint8_t* b = &src[(bpp / 8) * x];  // stored B, G, R
              q[0] = b[2];
              q[1] = b[1];
              q[2] = b[0];
            }
            break;
        }
      }
    }
  }
}

// A decode in hand between cxr_open and cxr_finish
struct Handle {
  std::unique_ptr<Decoder> decoder;
  Sink sink;
};

// Runs f, turning what it throws into a status and a message
template <class F>
int guarded(F&& f, char* message, int message_len) {
  auto say = [&](const char* what) {
    if (message_len <= 0) return;
    std::strncpy(message, what, static_cast<size_t>(message_len) - 1);
    message[message_len - 1] = 0;
  };
  say("");
  try {
    f();
    return kOk;
  } catch (const Suspended&) {
    say("the stream ends before its EOI marker");
    return kUndecodable;
  } catch (const Failure& failure) {
    say(failure.message.c_str());
    return failure.status;
  } catch (const std::bad_alloc&) {
    say("out of memory");
    return kUndecodable;
  }
}

}  // namespace

namespace cxr {

struct JpegPart::Impl {
  Impl(const uint8_t* data, size_t n) : jpeg(data, n, true) {}
  Jpeg jpeg;
  Sink sink;
};

JpegPart::JpegPart(const uint8_t* data, size_t n) : impl_(new Impl(data, n)) {}
JpegPart::~JpegPart() = default;

void JpegPart::header() {
  impl_->jpeg.open(&impl_->sink);
  impl_->sink.orientation = 1;  // a TIFF's orientation is its own tag's
}

int JpegPart::height() const { return impl_->jpeg.height(); }
int JpegPart::width() const { return impl_->jpeg.width(); }
int JpegPart::components() const { return static_cast<int>(impl_->jpeg.components().size()); }
int JpegPart::precision() const { return impl_->jpeg.precision(); }
int JpegPart::h_sampling(int c) const { return impl_->jpeg.components()[c].h; }
int JpegPart::v_sampling(int c) const { return impl_->jpeg.components()[c].v; }

bool JpegPart::decode(bool ycbcr, uint8_t* rgb) {
  impl_->jpeg.colour = ycbcr ? 0 : 1;
  impl_->sink.dst = rgb;
  try {
    impl_->jpeg.run(impl_->sink);
  } catch (const Failure& failure) {
    if (failure.status == kRefused) throw;
    return false;
  } catch (const Suspended&) {
    return false;
  }
  return true;
}

}  // namespace cxr

extern "C" {

int cxr_open(const uint8_t* data, size_t n, int file, void** handle, int* h, int* w,
             char* message, int message_len) {
  *handle = nullptr;
  std::unique_ptr<Handle> hd(new Handle);
  int status = guarded([&] {
    if (n >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
      hd->decoder.reset(new Jpeg(data, n, file != 0));
    else if (n >= 2 && data[0] == 'B' && data[1] == 'M')
      hd->decoder.reset(new Bmp(data, n));
    else if (is_tiff(data, n))
      hd->decoder = make_tiff(data, n, file != 0);
    else if (is_pnm(data, n))
      hd->decoder = make_pnm(data, n);
    else
      throw Failure{kUndecodable, "not JPEG, BMP, TIFF or Netpbm"};
    hd->decoder->open(&hd->sink);
  }, message, message_len);
  if (status != kOk) return status;
  *h = static_cast<int>(hd->sink.out_h());
  *w = static_cast<int>(hd->sink.out_w());
  *handle = hd.release();
  return kOk;
}

int cxr_finish(void* handle, uint8_t* dst, char* message, int message_len) {
  std::unique_ptr<Handle> hd(static_cast<Handle*>(handle));
  hd->sink.dst = dst;
  return guarded([&] { hd->decoder->run(hd->sink); }, message, message_len);
}

void cxr_close(void* handle) { delete static_cast<Handle*>(handle); }

}  // extern "C"
