// TIFF decoding to RGB uint8, byte for byte what OpenCV's cv2.imread (a
// file) or cv2.imdecode(buf, IMREAD_COLOR) (a buffer) returns with its
// channels reversed. OpenCV 5 reads an 8-bit colour image through libtiff's
// TIFFReadRGBAStrip / TIFFReadRGBATile (tif_getimage.c), one strip or tile
// a call, and places the rows itself; this file follows both.
//
// The container: classic TIFF and BigTIFF in either byte order, the first
// IFD only, strips or tiles, PlanarConfiguration 1 or 2, BitsPerSample 1, 8
// and 16 (4 for a palette), SamplesPerPixel 1-4 with ExtraSamples, FillOrder
// 2. Codecs: none, PackBits, LZW (with the old LSB-first bit order), Deflate
// (zlib), JPEG (decode.cpp's Jpeg, with the JPEGTables spliced in front);
// Predictor 2 after LZW and Deflate. Samples become RGB as libtiff's put
// routines make them:
//   - grey (MinIsBlack, MinIsWhite) in one plane: 1-bit 0/255, 8-bit as
//     is, 16-bit the high byte (put16bitbwtile), inverted for MinIsWhite;
//     in separate planes (putRGBseparate*) not inverted, 16-bit rounded;
//   - RGB: 8-bit as is, 16-bit rounded ((v + 128) / 257, Bitdepth16To8);
//     unassociated alpha premultiplies ((v * a + 127) / 255, UaToAa);
//   - palette: the colormap's high byte, unless every entry is below 256;
//   - YCbCr under JPEG: converted by the JPEG decoder (JPEGCOLORMODE_RGB).
// What libtiff and OpenCV do wrong is done so here too:
//   - 16-bit grey tiles clipped at the right edge skip (tile width - clip)
//     bytes a row instead of twice that (put16bitbwtile's fromskew);
//   - a horizontal flip of the Orientation tag (2, 3, 6, 7) turns each tile
//     in place, the tiles staying where they are (whole strips turn right);
//   - a buffer (imdecode) refuses an uncompressed tile unless its byte
//     count rounded up to 1024 is the tile's size; a file reads it;
//   - a file (imread) gives no image for Orientation 5-8 unless the image
//     is square; a buffer turns it.
// A strip or tile whose data a codec cannot finish keeps what was decoded,
// the rest zero (libtiff's stop_on_error is off), and gets no predictor; one
// whose data lies outside the buffer, or whose JPEG header is bad, gives no
// image. Status 2 (naming ROADMAP A2c) is what OpenCV reads and this file
// does not: CCITT, NeXT, ThunderScan and SGILog compression, CMYK, CIELab,
// LogLuv, YCbCr without JPEG. What OpenCV gives no image for gives none:
// 32-bit, float, 2-bit and 12-bit samples, and the codecs its libtiff is
// built without (old-style JPEG, PixarLog, JBIG, LERC, LZMA, ZSTD, WebP); a
// compression code libtiff has no codec for decodes to zeros, as there.
//
// Memory: the caller's output, plus one strip or tile at a time (each plane
// of it when planes are separate), zeroed by calloc so that pages no decoded
// data reaches are never touched; a codec's output is capped at its block's
// declared size.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include "common.h"

namespace cxr {
namespace {

enum Compression {
  kNone = 1, kCcitt2 = 2, kCcitt3 = 3, kCcitt4 = 4, kLzw = 5, kOldJpeg = 6, kJpeg = 7,
  kDeflate = 8, kNext = 32766, kCcittRlew = 32771, kPackBits = 32773, kThunderScan = 32809,
  kPixarLog = 32909, kOldDeflate = 32946, kJbig = 34661, kSgiLog = 34676, kSgiLog24 = 34677,
  kLerc = 34887, kLzma = 34925, kZstd = 50000, kWebp = 50001
};
enum Photometric {
  kMinIsWhite = 0, kMinIsBlack = 1, kRgb = 2, kPalette = 3, kSeparated = 5, kYCbCr = 6,
  kCieLab = 8, kIccLab = 9, kItuLab = 10, kLogL = 32844, kLogLuv = 32845
};

// ---------------------------------------------------------------------------
// codecs: each writes at most `occ` bytes into a zeroed buffer and says
// whether it finished (libtiff's decodestrip returning 1)
// ---------------------------------------------------------------------------

// tif_packbits.c PackBitsDecode
bool packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  size_t i = 0, o = 0;
  while (i < n && o < occ) {
    int c = static_cast<int8_t>(in[i++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = std::min<size_t>(static_cast<size_t>(1 - c), occ - o);
      if (i >= n) break;
      std::memset(out + o, in[i++], run);
      o += run;
    } else {
      size_t run = std::min<size_t>(static_cast<size_t>(c) + 1, occ - o);
      if (n - i < run) break;
      std::memcpy(out + o, in + i, run);
      o += run;
      i += run;
    }
  }
  return o == occ;
}

// tif_lzw.c LZWDecode (MSB-first codes, the width growing one code early)
// and LZWDecodeCompat (the old LSB-first order, growing on time), chosen per
// strip by its first two bytes as LZWPreDecode chooses. Running out of data
// is an EOI; a code past the table is corrupt data. A table entry is the
// previous code's string and one more byte, which is where that string was
// written in the output followed by the next one's first byte: so an entry
// is an offset into the output and a length, and a code's string a copy
// (forward, byte by byte where it overlaps its own end).
bool lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  const bool compat = n >= 2 && in[0] == 0 && (in[1] & 1);
  const int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  struct Entry {
    size_t at;
    uint32_t length;  // 0: not in the table
  };
  std::vector<Entry> table(kSize);
  uint64_t acc = 0;
  int bits = 0;
  size_t pos = 0;
  auto next = [&](int width) -> int {
    while (bits < width) {
      if (pos >= n) return kEoi;
      if (compat)
        acc |= static_cast<uint64_t>(in[pos++]) << bits;
      else
        acc = (acc << 8) | in[pos++];
      bits += 8;
    }
    int code;
    if (compat) {
      code = static_cast<int>(acc & ((1u << width) - 1));
      acc >>= width;
    } else {
      code = static_cast<int>((acc >> (bits - width)) & ((1u << width) - 1));
      acc &= (uint64_t(1) << (bits - width)) - 1;
    }
    bits -= width;
    return code;
  };
  const int grow = compat ? 1 : 2;  // free_ent past 2^width - grow widens the codes
  int width = 9, free_ent = -1;
  size_t o = 0, old_at = 0, old_length = 0;
  while (o < occ) {
    int code = next(width);
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        width = 9;
        for (int i = kFirst; i < kSize; ++i) table[i].length = 0;
        code = next(width);
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return false;
      old_at = o;
      old_length = 1;
      out[o++] = static_cast<uint8_t>(code);
      continue;
    }
    if (free_ent < 0 || free_ent >= kSize) return false;
    table[free_ent] = Entry{old_at, static_cast<uint32_t>(old_length + 1)};
    if (++free_ent > (1 << width) - grow) {
      width = std::min(width + 1, 12);
      if (!compat && free_ent >= kSize) free_ent = -1;
    }
    old_at = o;
    if (code < 256) {
      old_length = 1;
      out[o++] = static_cast<uint8_t>(code);
      continue;
    }
    const Entry e = table[code];
    if (e.length == 0) return false;
    old_length = e.length;
    const size_t take = std::min<size_t>(e.length, occ - o);
    if (e.at + take <= o) {
      std::memcpy(out + o, out + e.at, take);
    } else {
      for (size_t k = 0; k < take; ++k) out[o + k] = out[e.at + k];
    }
    o += take;
  }
  return o == occ;
}

// tif_zip.c ZIPDecode on zlib: inflate until the block is full, the stream
// ends, or the data does
bool deflate(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  z_stream z;
  std::memset(&z, 0, sizeof z);
  if (inflateInit(&z) != Z_OK) throw std::bad_alloc();
  z.next_in = const_cast<Bytef*>(in);
  z.next_out = out;
  size_t in_left = n, out_left = occ;
  bool ok = true;
  do {
    uInt in_now = static_cast<uInt>(std::min<size_t>(in_left, 0xFFFFFFFFu));
    uInt out_now = static_cast<uInt>(std::min<size_t>(out_left, 0xFFFFFFFFu));
    z.avail_in = in_now;
    z.avail_out = out_now;
    int state = inflate(&z, Z_PARTIAL_FLUSH);
    in_left -= in_now - z.avail_in;
    out_left -= out_now - z.avail_out;
    if (state == Z_STREAM_END) break;
    if (state != Z_OK) {
      ok = false;
      break;
    }
  } while (out_left > 0 && in_left > 0);
  inflateEnd(&z);
  if (!ok) std::memset(out + (occ - out_left), 0, out_left);
  return ok && out_left == 0;
}

// ---------------------------------------------------------------------------
// the directory
// ---------------------------------------------------------------------------

class Tiff : public Decoder {
 public:
  Tiff(const uint8_t* data, size_t n, bool file) : d_(data), n_(n), file_(file) {}
  void open(Sink* sink) override;
  void run(const Sink& sink) override;

 private:
  struct Entry {
    uint16_t tag, type;
    uint64_t count, at;  // at: where the values lie
  };
  uint64_t get(uint64_t at, int bytes) const;
  bool values(const Entry& e, std::vector<uint64_t>* out) const;
  uint64_t one(const Entry& e) const;
  void read_directory();
  void check();
  size_t row_bytes(uint64_t width, int samples) const {
    return static_cast<size_t>((width * samples * bps_ + 7) / 8);
  }
  bool decode_block(size_t index, int rows, int width, int samples, bool last_strip,
                    uint8_t* out);
  void decode_jpeg(const uint8_t* raw, size_t count, int rows, int width, int samples,
                   bool last_strip, uint8_t* out);
  void put(const Sink& sink, uint8_t* const* planes, int y0, int x0, int rows, int cols,
           int block_width);

  const uint8_t* d_;
  size_t n_;
  bool file_, le_ = true, big_ = false;
  // the fields, libtiff's defaults where a tag may be missing
  uint64_t width_ = 0, height_ = 0, rps_ = 0xFFFFFFFFu, tw_ = 0, th_ = 0;
  int bps_ = 1, spp_ = 1, compression_ = kNone, photometric_ = -1, planar_ = 1;
  int predictor_ = 1, fill_order_ = 1, orientation_ = 1, sample_format_ = 1;
  bool tiled_ = false, have_width_ = false, have_height_ = false, have_offsets_ = false;
  bool have_counts_ = false, have_subsampling_ = false, bps_mixed_ = false;
  std::vector<uint64_t> offsets_, counts_, extra_, colormap_;
  int sub_h_ = 1, sub_v_ = 1;  // YCbCr subsampling that the JPEG data must have
  const uint8_t* tables_ = nullptr;
  size_t tables_n_ = 0;
  // what open() decides
  int alpha_ = 0;        // 0 none, 1 associated, 2 unassociated (premultiplied)
  bool separate_ = false;
  bool ycbcr_jpeg_ = false;
};

uint64_t Tiff::get(uint64_t at, int bytes) const {
  if (at > n_ || n_ - at < static_cast<uint64_t>(bytes)) undecodable("a TIFF read past its end");
  uint64_t v = 0;
  for (int i = 0; i < bytes; ++i) {
    uint64_t b = d_[at + i];
    v |= le_ ? b << (8 * i) : b << (8 * (bytes - 1 - i));
  }
  return v;
}

int type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

// an entry's integer values (BYTE, SHORT, LONG, LONG8, their signed forms
// and IFD offsets), false when its type is not an integer one or its values
// lie outside the data
bool Tiff::values(const Entry& e, std::vector<uint64_t>* out) const {
  int size = type_size(e.type);
  if (size == 0 || e.type == 2 || e.type == 5 || e.type == 10 || e.type == 11 || e.type == 12)
    return false;
  if (e.count > n_ / size + 1 || e.at > n_ || (n_ - e.at) / size < e.count) return false;
  out->resize(static_cast<size_t>(e.count));
  for (size_t i = 0; i < out->size(); ++i) (*out)[i] = get(e.at + i * size, size);
  return true;
}

uint64_t Tiff::one(const Entry& e) const {
  std::vector<uint64_t> v;
  if (!values(e, &v) || v.empty()) undecodable("a bad TIFF tag");
  return v[0];
}

void Tiff::read_directory() {
  le_ = d_[0] == 'I';
  big_ = get(2, 2) == 43;
  uint64_t at;
  if (big_) {
    if (get(4, 2) != 8 || get(6, 2) != 0) undecodable("a bad BigTIFF header");
    at = get(8, 8);
  } else {
    at = get(4, 4);
  }
  const uint64_t count = get(at, big_ ? 8 : 2);
  if (count > 4096) undecodable("a TIFF directory of too many entries");
  const int entry_size = big_ ? 20 : 12, inline_size = big_ ? 8 : 4;
  at += big_ ? 8 : 2;
  std::vector<uint16_t> seen;
  for (uint64_t i = 0; i < count; ++i, at += entry_size) {
    Entry e;
    e.tag = static_cast<uint16_t>(get(at, 2));
    e.type = static_cast<uint16_t>(get(at + 2, 2));
    e.count = get(at + 4, big_ ? 8 : 4);
    uint64_t bytes = type_size(e.type) * e.count;
    e.at = (type_size(e.type) && e.count <= 64 && bytes <= static_cast<uint64_t>(inline_size))
               ? at + (big_ ? 12 : 8)
               : get(at + (big_ ? 12 : 8), inline_size);
    if (std::find(seen.begin(), seen.end(), e.tag) != seen.end()) continue;  // libtiff keeps the first
    seen.push_back(e.tag);
    std::vector<uint64_t> v;
    switch (e.tag) {
      case 256: width_ = one(e); have_width_ = true; break;
      case 257: height_ = one(e); have_height_ = true; break;
      case 258:
        if (!values(e, &v) || v.empty()) undecodable("a bad BitsPerSample");
        bps_ = static_cast<int>(std::min<uint64_t>(v[0], 65535));
        for (uint64_t b : v) bps_mixed_ = bps_mixed_ || b != v[0];
        break;
      case 259: compression_ = static_cast<int>(one(e)); break;
      case 262: photometric_ = static_cast<int>(one(e)); break;
      case 266: fill_order_ = one(e) == 2 ? 2 : 1; break;
      case 273: case 324:
        if (!values(e, &offsets_)) undecodable("bad TIFF data offsets");
        have_offsets_ = true;
        tiled_ = e.tag == 324;
        break;
      case 274: {
        uint64_t o = one(e);
        orientation_ = o >= 1 && o <= 8 ? static_cast<int>(o) : 1;
        break;
      }
      case 277: spp_ = static_cast<int>(std::min<uint64_t>(one(e), 65535)); break;
      case 278: rps_ = one(e); break;
      case 279: case 325:
        if (!values(e, &counts_)) undecodable("bad TIFF byte counts");
        have_counts_ = true;
        break;
      case 284: planar_ = static_cast<int>(one(e)); break;
      case 317: predictor_ = static_cast<int>(one(e)); break;
      case 320:
        if (!values(e, &colormap_)) undecodable("a bad TIFF colormap");
        break;
      case 322: tw_ = one(e); break;
      case 323: th_ = one(e); break;
      case 338:
        if (!values(e, &extra_)) undecodable("bad TIFF ExtraSamples");
        break;
      case 339: sample_format_ = static_cast<int>(one(e)); break;
      case 347:
        if (e.type != 7 && e.type != 1) break;
        if (e.at > n_ || n_ - e.at < e.count) undecodable("bad JPEGTables");
        tables_ = d_ + e.at;
        tables_n_ = static_cast<size_t>(e.count);
        break;
      case 530:
        if (!values(e, &v) || v.size() < 2) undecodable("a bad YCbCrSubsampling");
        sub_h_ = static_cast<int>(v[0]);
        sub_v_ = static_cast<int>(v[1]);
        have_subsampling_ = true;
        break;
      default:
        break;
    }
  }
}

// what OpenCV's readHeader and libtiff's TIFFRGBAImageOK / Begin accept,
// after what the port refuses
void Tiff::check() {
  // the codecs of OpenCV's libtiff that this file lacks, then those it was
  // built without (OpenCV gives no image); a code of no codec at all decodes
  // every strip to zeros (decode_block)
  switch (compression_) {
    case kCcitt2: case kCcitt3: case kCcitt4: case kCcittRlew:
      refused("CCITT-compressed TIFF");
    case kNext: refused("NeXT-compressed TIFF");
    case kThunderScan: refused("ThunderScan-compressed TIFF");
    case kSgiLog: case kSgiLog24: refused("SGILog-compressed TIFF");
    case kOldJpeg: case kPixarLog: case kJbig: case kLerc: case kLzma: case kZstd: case kWebp:
      undecodable("a TIFF compression OpenCV's libtiff is built without");
    default: break;
  }
  switch (photometric_) {
    case kSeparated: refused("CMYK (separated) TIFF");
    case kCieLab: case kIccLab: case kItuLab: refused("CIELab TIFF");
    case kLogL: case kLogLuv: refused("LogLuv TIFF");
    case kYCbCr:
      if (compression_ != kJpeg || planar_ == 2)
        refused("YCbCr TIFF other than JPEG in one plane");
      break;
    default: break;
  }
  if (!have_width_ || !have_height_ || !have_offsets_ || !have_counts_ || photometric_ < 0)
    undecodable("a TIFF field missing");
  if (too_large(height_, width_)) undecodable("a TIFF too large");
  if (spp_ < 1 || spp_ > 4) undecodable("a TIFF of more than 4 samples");
  if (bps_mixed_) undecodable("BitsPerSample differs between samples");
  if (sample_format_ == 3) undecodable("floating-point TIFF samples");
  if (bps_ != 1 && bps_ != 8 && bps_ != 16 && !(bps_ == 4 && photometric_ == kPalette))
    undecodable("TIFF samples of an unsupported depth");
  if (compression_ == kJpeg && bps_ != 8) undecodable("a JPEG TIFF not of 8-bit samples");
  if (planar_ != 1 && planar_ != 2) undecodable("a bad PlanarConfiguration");
  separate_ = planar_ == 2 && spp_ > 1;
  if (compression_ == kLzw || compression_ == kDeflate || compression_ == kOldDeflate) {  // TIFFPredictorInit
    if (predictor_ == 2 && bps_ != 8 && bps_ != 16) undecodable("Predictor 2 at this depth");
    if (predictor_ != 1 && predictor_ != 2) undecodable("an unsupported Predictor");
  }
  // TIFFReadDirectory: samples beyond the photometric's colours are extra
  // ones (of unspecified kind), then a palette without a colormap of
  // 3 x 2^bps entries is read as RGB (3 samples) or grey
  if (extra_.size() > static_cast<size_t>(spp_)) extra_.clear();
  const int colours_of = photometric_ == kRgb || photometric_ == kYCbCr ? 3 : 1;
  if (spp_ - static_cast<int>(extra_.size()) > colours_of) extra_.resize(spp_ - colours_of, 0);
  if (photometric_ == kPalette && colormap_.size() != 3 * (size_t(1) << std::min(bps_, 16))) {
    if (bps_ < 8) undecodable("a palette TIFF without a colormap");
    photometric_ = spp_ == 3 ? kRgb : kMinIsBlack;
  }
  // TIFFRGBAImageBegin's alpha and colour channels
  int extras = static_cast<int>(extra_.size());
  if (extras >= 1) {
    if (extra_[0] == 0 && spp_ > 3) alpha_ = 1;
    if (extra_[0] == 1 || extra_[0] == 2) alpha_ = static_cast<int>(extra_[0]);
  } else if (spp_ == 4 && photometric_ == kRgb) {
    alpha_ = 1;
    extras = 1;
  }
  const int colour = spp_ - extras;
  switch (photometric_) {
    case kMinIsWhite: case kMinIsBlack:
      if (!separate_ && spp_ != 1 && bps_ < 8) undecodable("packed grey samples with extras");
      if (separate_ && bps_ < 8) undecodable("separate grey planes below 8 bits");
      break;
    case kPalette:  // put8bitcmaptile takes the first of several 8-bit samples
      if (bps_ > 8 || (spp_ != 1 && (bps_ != 8 || separate_)))
        undecodable("a palette TIFF libtiff cannot read");
      break;
    case kRgb:
      if (colour < 3 || bps_ < 8) undecodable("an RGB TIFF that libtiff cannot read");
      break;
    case kYCbCr:  // JPEG-compressed: libjpeg converts it
      ycbcr_jpeg_ = true;
      if (spp_ != 3) undecodable("a YCbCr TIFF not of 3 samples");
      if (!have_subsampling_) sub_h_ = sub_v_ = 0;  // JPEGFixupTags: the first strip's
      break;
    default:
      undecodable("an unsupported TIFF photometric interpretation");
  }
  // OpenCV's tile bounds (a strip is a tile the width of the image)
  uint64_t bw = tiled_ ? tw_ : width_;
  uint64_t bh = tiled_ ? th_ : (rps_ == 0xFFFFFFFFu || rps_ == 0 ? height_ : rps_);
  if (bw == 0 || bh == 0 || bw > (1u << 24) || bh > (1u << 24) ||
      bw * bh * spp_ * std::max(1, bps_ / 8) >= (uint64_t(1) << 30))
    undecodable("a TIFF tile too large");
  if (!tiled_ && rps_ == 0) undecodable("zero rows per strip");
  if (!tiled_ && rps_ > height_) rps_ = height_;
  const uint64_t across = tiled_ ? (width_ + tw_ - 1) / tw_ : 1;
  const uint64_t down = tiled_ ? (height_ + th_ - 1) / th_ : (height_ + rps_ - 1) / rps_;
  const uint64_t blocks = across * down * (separate_ ? spp_ : 1);
  if (offsets_.size() < blocks || counts_.size() < blocks) undecodable("too few TIFF strips");
}

void Tiff::open(Sink* sink) {
  read_directory();
  check();
  // cv2.imread sizes its output as the file's frame, not the turned one
  if (file_ && orientation_ >= 5 && width_ != height_)
    undecodable("a TIFF turned by 90 degrees, read as a file");
  sink->h = static_cast<int>(height_);
  sink->w = static_cast<int>(width_);
  // the horizontal part of a flip is done on each block as it is placed
  static const int kPlaced[9] = {1, 1, 1, 4, 4, 5, 7, 6, 8};
  sink->orientation = kPlaced[orientation_];
}

// libjpeg through tif_jpeg.c: the segment's checks (JPEGPreDecode; failing,
// no image), then the rows, cut at the first error
void Tiff::decode_jpeg(const uint8_t* raw, size_t count, int rows, int width, int samples,
                       bool last_strip, uint8_t* out) {
  std::vector<uint8_t> spliced;
  const uint8_t* stream = raw;
  size_t stream_n = count;
  if (tables_ != nullptr && tables_n_ >= 4) {
    size_t head = tables_n_;
    if (tables_[head - 2] == 0xFF && tables_[head - 1] == 0xD9) head -= 2;
    size_t skip = count >= 2 && raw[0] == 0xFF && raw[1] == 0xD8 ? 2 : 0;
    spliced.reserve(head + count - skip);
    spliced.insert(spliced.end(), tables_, tables_ + head);
    spliced.insert(spliced.end(), raw + skip, raw + count);
    stream = spliced.data();
    stream_n = spliced.size();
  }
  JpegPart jpeg(stream, stream_n);
  try {
    jpeg.header();
  } catch (const Suspended&) {
    undecodable("a TIFF JPEG header cut short");
  }
  if (jpeg.components() != samples || jpeg.precision() != 8)
    undecodable("a TIFF JPEG of the wrong components");
  if (ycbcr_jpeg_ && sub_h_ == 0) {
    sub_h_ = jpeg.h_sampling(0);
    sub_v_ = jpeg.v_sampling(0);
  }
  const int want_h = ycbcr_jpeg_ ? sub_h_ : 1, want_v = ycbcr_jpeg_ ? sub_v_ : 1;
  if (jpeg.h_sampling(0) != want_h || jpeg.v_sampling(0) != want_v)
    undecodable("TIFF JPEG sampling factors");
  for (int c = 1; c < jpeg.components(); ++c)
    if (jpeg.h_sampling(c) != 1 || jpeg.v_sampling(c) != 1)
      undecodable("TIFF JPEG sampling factors");
  int jh = jpeg.height(), jw = jpeg.width();
  if (!(jw == width && jh > rows && last_strip) && (jw > width || jh > rows))
    undecodable("a TIFF JPEG larger than its strip or tile");
  if (jh > rows && static_cast<uint64_t>(jh) * jw > height_ * width_)
    undecodable("a TIFF JPEG larger than the image");  // the last strip's, cut to its rows
  std::unique_ptr<uint8_t, Free> rgb(
      static_cast<uint8_t*>(std::calloc(static_cast<size_t>(jh) * jw * 3, 1)));
  if (!rgb) throw std::bad_alloc();
  jpeg.decode(ycbcr_jpeg_, rgb.get());  // what it decoded before an error stays
  const size_t line = row_bytes(width, samples);
  for (int r = 0; r < std::min(jh, rows); ++r)
    for (int c = 0; c < jw; ++c)
      for (int k = 0; k < samples; ++k)
        out[r * line + static_cast<size_t>(c) * samples + k] =
            rgb.get()[(static_cast<size_t>(r) * jw + c) * 3 + k];
}

// One strip or tile (of one plane when planes are separate) into `out`
// (rows x width samples, zeroed); false when no image can be made
bool Tiff::decode_block(size_t index, int rows, int width, int samples, bool last_strip,
                        uint8_t* out) {
  const size_t line = row_bytes(width, samples), occ = line * rows;
  uint64_t offset = offsets_[index], count = counts_[index];
  if (count == 0) return false;
  // TIFFFillStrip: a byte count far beyond the block's size is cut
  const uint64_t full = line * (tiled_ ? th_ : rps_);
  if (count > (1u << 20) && (count - 4096) / 10 > full) count = full * 10 + 4096;
  if (offset > n_ || count > n_ - offset) return false;
  if (compression_ == kNone && tiled_ && !file_ && ((count + 1023) & ~uint64_t(1023)) != occ)
    return false;
  const uint8_t* raw = d_ + offset;
  std::vector<uint8_t> reversed;
  if (fill_order_ == 2 && compression_ != kJpeg) {
    reversed.assign(raw, raw + count);
    for (auto& b : reversed) {
      b = static_cast<uint8_t>(((b * 0x0802u & 0x22110u) | (b * 0x8020u & 0x88440u)) * 0x10101u >> 16);
    }
    raw = reversed.data();
  }
  bool ok;
  switch (compression_) {
    case kNone:
      ok = count >= occ;
      if (ok) std::memcpy(out, raw, occ);
      break;
    case kPackBits:
      ok = packbits(raw, count, out, occ);
      break;
    case kLzw:
      ok = lzw(raw, count, out, occ);
      break;
    case kJpeg:
      decode_jpeg(raw, count, rows, width, samples, last_strip, out);
      return true;
    case kDeflate: case kOldDeflate:
      ok = deflate(raw, count, out, occ);
      break;
    default:  // "strip decoding is not implemented": the block stays zero
      ok = false;
      break;
  }
  if (ok && predictor_ == 2 && compression_ != kNone && compression_ != kPackBits) {  // LZW, Deflate
    const int stride = samples;
    for (int r = 0; r < rows; ++r) {
      uint8_t* p = out + r * line;
      if (bps_ == 8) {
        for (size_t i = stride; i < line; ++i) p[i] = static_cast<uint8_t>(p[i] + p[i - stride]);
      } else {
        for (size_t i = stride; i < line / 2; ++i) {
          uint8_t* a = p + 2 * i;
          const uint8_t* b = p + 2 * (i - stride);
          int v = le_ ? (a[0] | a[1] << 8) + (b[0] | b[1] << 8)
                      : (a[0] << 8 | a[1]) + (b[0] << 8 | b[1]);
          a[le_ ? 0 : 1] = static_cast<uint8_t>(v);
          a[le_ ? 1 : 0] = static_cast<uint8_t>(v >> 8);
        }
      }
    }
  }
  return true;
}

inline uint8_t to8(unsigned v) { return static_cast<uint8_t>((v + 128) / 257); }
inline uint8_t premultiply(unsigned v, unsigned a) { return static_cast<uint8_t>((v * a + 127) / 255); }

// A block's rows x cols pixels (of a block block_width samples wide) into
// the frame at (y0, x0), each row turned in place where the orientation
// flips horizontally
void Tiff::put(const Sink& sink, uint8_t* const* planes, int y0, int x0, int rows, int cols,
               int block_width) {
  const bool flip = orientation_ == 2 || orientation_ == 3 || orientation_ == 6 ||
                    orientation_ == 7;
  const bool white = photometric_ == kMinIsWhite;
  const bool grey = photometric_ == kMinIsWhite || photometric_ == kMinIsBlack;
  const int bytes = bps_ / 8;
  auto u16 = [&](const uint8_t* p) -> unsigned { return le_ ? p[0] | p[1] << 8 : p[0] << 8 | p[1]; };
  // the palette's bytes (checkcmap: a map with every entry below 256 is 8-bit)
  std::vector<uint8_t> pal;
  if (photometric_ == kPalette) {
    const size_t entries = size_t(1) << bps_;
    bool wide = false;
    for (size_t i = 0; i < 3 * entries; ++i) wide = wide || colormap_[i] >= 256;
    pal.resize(3 * entries);
    for (size_t i = 0; i < entries; ++i)
      for (int k = 0; k < 3; ++k) {
        uint64_t v = colormap_[k * entries + i];
        pal[3 * i + k] = static_cast<uint8_t>(wide ? v >> 8 : v);
      }
  }
  const size_t line = row_bytes(block_width, separate_ ? 1 : spp_);
  for (int r = 0; r < rows; ++r) {
    long step;
    uint8_t* o = sink.row(y0 + r, &step) + step * (flip ? x0 + cols - 1 : x0);
    if (flip) step = -step;
    if (separate_) {
      const int colours = grey ? 1 : 3;
      const uint8_t* c[3];
      for (int k = 0; k < 3; ++k) c[k] = planes[grey ? 0 : k] + r * line;
      const uint8_t* a = alpha_ ? planes[colours] + r * line : nullptr;
      for (int x = 0; x < cols; ++x, o += step) {
        unsigned alpha = 0;
        if (a) alpha = bytes == 2 ? to8(u16(a + 2 * x)) : a[x];
        for (int k = 0; k < 3; ++k) {
          uint8_t v = bytes == 2 ? to8(u16(c[k] + 2 * x)) : c[k][x];
          o[k] = alpha_ == 2 ? premultiply(v, alpha) : v;
        }
      }
      continue;
    }
    // the grey and palette put routines of 8 and 16 bits skip (block_width -
    // cols) bytes after a row of a clipped tile, not as many pixels; 16-bit
    // grey is read as native words, so an odd start straddles two words of
    // a big-endian file
    const size_t start = (grey || photometric_ == kPalette) && bps_ >= 8 && tiled_ &&
                                 cols < block_width
                             ? r * (static_cast<size_t>(bytes) * spp_ * cols + (block_width - cols))
                             : r * line;
    const uint8_t* p = planes[0] + start;
    for (int x = 0; x < cols; ++x, o += step) {
      if (grey) {
        unsigned v;
        if (bps_ == 1) {
          v = (p[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
        } else if (bps_ == 8) {
          v = p[x * spp_];
        } else {
          const size_t at = start + static_cast<size_t>(2) * x * spp_ + 1;
          v = planes[0][le_ ? at : at ^ 1];
        }
        o[0] = o[1] = o[2] = static_cast<uint8_t>(white ? 255 - v : v);
      } else if (photometric_ == kPalette) {
        unsigned i = bps_ == 8 ? p[x * spp_] : bps_ == 4 ? (p[x >> 1] >> (x & 1 ? 0 : 4)) & 15
                                                        : (p[x >> 3] >> (7 - (x & 7))) & 1;
        std::memcpy(o, &pal[3 * i], 3);
      } else {  // RGB, or YCbCr converted by the JPEG decoder
        const uint8_t* s = p + static_cast<size_t>(x) * spp_ * bytes;
        unsigned alpha = spp_ >= 4 ? (bytes == 2 ? to8(u16(s + 6)) : s[3]) : 0;
        for (int k = 0; k < 3; ++k) {
          uint8_t v = bytes == 2 ? to8(u16(s + 2 * k)) : s[k];
          o[k] = alpha_ == 2 && spp_ >= 4 ? premultiply(v, alpha) : v;
        }
      }
    }
  }
}

void Tiff::run(const Sink& sink) {
  const int w = static_cast<int>(width_), h = static_cast<int>(height_);
  const int bw = static_cast<int>(tiled_ ? tw_ : width_);
  const int bh = static_cast<int>(tiled_ ? th_ : rps_);
  const int across = (w + bw - 1) / bw, down = (h + bh - 1) / bh;
  const size_t per_plane = static_cast<size_t>(across) * down;
  const int samples = separate_ ? 1 : spp_;
  // the planes libtiff reads: the colour ones and the alpha one
  const bool grey = photometric_ == kMinIsWhite || photometric_ == kMinIsBlack;
  const int colours = separate_ ? (grey ? 1 : 3) : 1;
  const int planes = separate_ ? colours + (alpha_ ? 1 : 0) : 1;
  std::unique_ptr<uint8_t, Free> buf[4];
  uint8_t* ptr[4] = {};
  for (int ty = 0; ty < down; ++ty) {
    const int y0 = ty * bh, rows = std::min(bh, h - y0);
    const int block_rows = tiled_ ? bh : rows;
    for (int tx = 0; tx < across; ++tx) {
      const int x0 = tx * bw, cols = std::min(bw, w - x0);
      for (int p = 0; p < planes; ++p) {
        const size_t size = row_bytes(bw, samples) * block_rows;
        buf[p].reset(static_cast<uint8_t*>(std::calloc(size, 1)));
        if (!buf[p]) throw std::bad_alloc();
        ptr[p] = buf[p].get();
        const size_t index = p * per_plane + static_cast<size_t>(ty) * across + tx;
        if (!decode_block(index, block_rows, bw, samples, !tiled_ && ty == down - 1, ptr[p]))
          undecodable("a TIFF strip or tile outside the data");
      }
      put(sink, ptr, y0, x0, rows, cols, bw);
    }
  }
}

}  // namespace

bool is_tiff(const uint8_t* d, size_t n) {
  return n >= 8 && ((d[0] == 'I' && d[1] == 'I' && (d[2] == 42 || d[2] == 43) && d[3] == 0) ||
                    (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && (d[3] == 42 || d[3] == 43)));
}

std::unique_ptr<Decoder> make_tiff(const uint8_t* data, size_t n, bool file) {
  return std::unique_ptr<Decoder>(new Tiff(data, n, file));
}

}  // namespace cxr
