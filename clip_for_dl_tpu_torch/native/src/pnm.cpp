// Netpbm decoding to RGB uint8, byte for byte what OpenCV's
// cv2.imdecode(buf, IMREAD_COLOR) (or cv2.imread) returns with its channels
// reversed: P1-P6 as its PxMDecoder reads them, P7 as its PAMDecoder does.
//
// P1-P6: the header's numbers are separated by whitespace and '#' comments
// (to the end of the line); one byte ends the last of them. The samples:
//   - ASCII (P1-P3): clamped to maxval; 8-bit ones scaled to 255
//     (v * 255 / maxval), ones of a maxval above 255 keep their high byte;
//     P1's digits are read one at a time, nonzero black;
//   - binary (P4-P6): 8-bit ones as they are, never scaled (a maxval of 100
//     leaves 50 at 50), 16-bit ones (big-endian) their high byte, unscaled
//     (a maxval of 1000 makes 1000 into 3); P4's bits MSB first, 1 black.
// P7: the header's lines (WIDTH, HEIGHT, DEPTH, MAXVAL, TUPLTYPE, ENDHDR,
// '#' comments); each TUPLTYPE with its DEPTH (BLACKANDWHITE and GRAYSCALE
// 1, GRAYSCALE_ALPHA 2, RGB 3, RGB_ALPHA 4; none given, 1 or 3 of a maxval
// below 256); samples of a maxval above 255 keep their high byte. As OpenCV
// reads them, copied: a maxval of 1 reads each row's bytes as packed bits
// (FillColorRow1), 1 white; RGB is copied into OpenCV's BGR as it lies, so
// its channels come out reversed. Not copied: of GRAYSCALE_ALPHA and
// RGB_ALPHA OpenCV converts only the first ceil(width / DEPTH) pixels of a
// row and leaves the rest of its output unwritten (what memory held
// before); this file converts every pixel by the same rule (grey from the
// first sample; R, G, B from the first three). Nothing is refused: PFM
// ("Pf", "PF") is not a format of this file.
//
// Memory: the caller's output, and one row of samples.

#include <algorithm>
#include <cctype>
#include <climits>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "common.h"

namespace cxr {
namespace {

// OpenCV's RLByteStream over a buffer: reading past the end ends the decode
class Bytes {
 public:
  Bytes(const uint8_t* data, size_t n) : d_(data), n_(n) {}
  int byte() {
    if (pos_ >= n_) undecodable("the Netpbm data ends early");
    return d_[pos_++];
  }
  const uint8_t* take(size_t count) {
    if (pos_ > n_ || n_ - pos_ < count) undecodable("the Netpbm data ends early");
    pos_ += count;
    return d_ + pos_ - count;
  }
  size_t left() const { return n_ - pos_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
};

// grfmt_pxm.cpp ReadNumber: whitespace and comments skipped, then digits (at
// most maxdigits), the byte after them consumed
int read_number(Bytes& s, int maxdigits = 0) {
  int code = s.byte();
  while (!std::isdigit(code)) {
    if (code == '#') {
      do code = s.byte();
      while (code != '\n' && code != '\r');
      code = s.byte();
    } else if (std::isspace(code)) {
      while (std::isspace(code)) code = s.byte();
    } else {
      undecodable("a bad Netpbm number");
    }
  }
  int64_t val = 0;
  int digits = 0;
  do {
    val = val * 10 + (code - '0');
    if (val > INT_MAX) undecodable("a Netpbm number too large");
    if (maxdigits != 0 && ++digits >= maxdigits) break;
    code = s.byte();
  } while (std::isdigit(code));
  return static_cast<int>(val);
}

class Pnm : public Decoder {
 public:
  Pnm(const uint8_t* data, size_t n) : s_(data, n) {}
  void open(Sink* sink) override;
  void run(const Sink& sink) override;

 private:
  void open_pam();
  void run_pam(const Sink& sink);

  Bytes s_;
  int kind_ = 0;  // 1-7
  int width_ = 0, height_ = 0, maxval_ = 1, depth_ = 1;
  std::string tupltype_;
};

void Pnm::open(Sink* sink) {
  s_.byte();  // 'P'
  kind_ = s_.byte() - '0';
  if (kind_ == 7) {
    open_pam();
  } else {
    width_ = read_number(s_);
    height_ = read_number(s_);
    maxval_ = kind_ == 1 || kind_ == 4 ? 1 : read_number(s_);
    if (maxval_ <= 0 || maxval_ > 65535) undecodable("a bad Netpbm maxval");
  }
  if (width_ <= 0 || height_ <= 0 || too_large(height_, width_))
    undecodable("a Netpbm image of a bad size");
  sink->h = height_;
  sink->w = width_;
}

// grfmt_pam.cpp readHeader: lines of an identifier and a value
void Pnm::open_pam() {
  int code = s_.byte();
  if (code != '\n' && code != '\r') undecodable("a bad PAM header");
  bool seen[5] = {};  // WIDTH HEIGHT DEPTH MAXVAL TUPLTYPE
  static const char* const kNames[6] = {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE",
                                        "ENDHDR"};
  for (;;) {
    do code = s_.byte();
    while (std::isspace(code));
    if (code == '#') {
      do code = s_.byte();
      while (code != '\n' && code != '\r');
      continue;
    }
    std::string ident;
    while (ident.size() < 8 && !std::isspace(code)) {
      ident += static_cast<char>(code);
      code = s_.byte();
    }
    if (!std::isspace(code)) undecodable("a bad PAM header");
    int field = static_cast<int>(std::find(kNames, kNames + 6, ident) - kNames);
    if (field == 6) undecodable("an unknown PAM header field");
    std::string value;
    if (code != '\n' && code != '\r') {
      do code = s_.byte();
      while (std::isspace(code));
      while (value.size() < 255 && code != '\n' && code != '\r') {
        value += static_cast<char>(code);
        code = s_.byte();
      }
      if (code != '\n' && code != '\r') undecodable("a PAM header line too long");
      while (!value.empty() && std::isspace(static_cast<unsigned char>(value.back())))
        value.pop_back();
    }
    if (field == 5) break;  // ENDHDR
    if (field == 4) {
      static const char* const kTypes[6] = {"", "BLACKANDWHITE", "GRAYSCALE",
                                            "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA"};
      if (std::find(kTypes, kTypes + 6, value) == kTypes + 6) undecodable("an unknown TUPLTYPE");
      tupltype_ = value;
      continue;
    }
    if (seen[field]) undecodable("a PAM header field twice");
    seen[field] = true;
    // ParseInt: an optional minus, then digits only
    size_t pos = value[0] == '-' ? 1 : 0;
    if (pos == 1 && (value.size() < 2 || !std::isdigit(static_cast<unsigned char>(value[1]))))
      undecodable("a bad PAM number");
    int64_t number = 0;
    for (; pos < value.size(); ++pos) {
      if (!std::isdigit(static_cast<unsigned char>(value[pos]))) undecodable("a bad PAM number");
      number = number * 10 + (value[pos] - '0');
      if (number >= INT_MAX) undecodable("a PAM number too large");
    }
    if (value[0] == '-') number = -number;
    int* target[4] = {&width_, &height_, &depth_, &maxval_};
    *target[field] = static_cast<int>(number);
    if (field == 3 && maxval_ > 65535) undecodable("a bad PAM maxval");
  }
  if (!seen[0] || !seen[1] || !seen[2] || !seen[3]) undecodable("a PAM header field missing");
  if (tupltype_.empty()) {
    if (depth_ == 1 && maxval_ == 1)
      tupltype_ = "BLACKANDWHITE";
    else if (depth_ == 1 && maxval_ < 256)
      tupltype_ = "GRAYSCALE";
    else if (depth_ == 3 && maxval_ < 256)
      tupltype_ = "RGB";
    else
      undecodable("a PAM of no TUPLTYPE that OpenCV cannot guess");
  }
  // OpenCV 5 holds each TUPLTYPE to its number of samples
  const int depth = tupltype_ == "RGB_ALPHA" ? 4 : tupltype_ == "RGB" ? 3
                    : tupltype_ == "GRAYSCALE_ALPHA" ? 2 : 1;
  if (depth_ != depth) undecodable("a PAM whose DEPTH is not its TUPLTYPE's");
}

void Pnm::run(const Sink& sink) {
  if (kind_ == 7) return run_pam(sink);
  const bool binary = kind_ >= 4, colour = kind_ == 3 || kind_ == 6, bits = kind_ == 1 || kind_ == 4;
  const bool wide = maxval_ > 255;
  const int channels = colour ? 3 : 1;
  const size_t samples = static_cast<size_t>(width_) * channels;
  // each ASCII sample takes a byte at least, each binary one its width
  const size_t least = bits ? (binary ? (width_ + 7) / 8 : width_) : samples * (binary && wide ? 2 : 1);
  if (static_cast<uint64_t>(least) * height_ > s_.left()) undecodable("the Netpbm data ends early");
  std::vector<uint8_t> row(samples);
  for (int y = 0; y < height_; ++y) {
    if (bits) {
      const uint8_t* packed = binary ? s_.take((width_ + 7) / 8) : nullptr;
      for (int x = 0; x < width_; ++x) {
        bool black = binary ? (packed[x >> 3] >> (7 - (x & 7))) & 1 : read_number(s_, 1) != 0;
        row[x] = black ? 0 : 255;
      }
    } else if (binary) {
      const uint8_t* raw = s_.take(samples * (wide ? 2 : 1));
      for (size_t i = 0; i < samples; ++i) row[i] = wide ? raw[2 * i] : raw[i];
    } else {
      for (size_t i = 0; i < samples; ++i) {
        int v = std::min(read_number(s_), maxval_);
        row[i] = static_cast<uint8_t>(wide ? v >> 8 : v * 255 / maxval_);
      }
    }
    long step;
    uint8_t* o = sink.row(y, &step);
    for (int x = 0; x < width_; ++x, o += step) {
      const uint8_t* p = &row[static_cast<size_t>(x) * channels];
      o[0] = p[0];
      o[1] = p[channels - 2 > 0 ? 1 : 0];
      o[2] = p[channels - 1];
    }
  }
}

void Pnm::run_pam(const Sink& sink) {
  const bool wide = maxval_ > 255;
  const size_t samples = static_cast<size_t>(width_) * depth_;
  const size_t stride = samples * (wide ? 2 : 1);
  if (static_cast<uint64_t>(stride) * height_ > s_.left()) undecodable("the PAM data ends early");
  std::vector<uint8_t> row(samples);
  for (int y = 0; y < height_; ++y) {
    const uint8_t* raw = s_.take(stride);
    for (size_t i = 0; i < samples; ++i) row[i] = wide ? raw[2 * i] : raw[i];
    long step;
    uint8_t* o = sink.row(y, &step);
    for (int x = 0; x < width_; ++x, o += step) {
      if (maxval_ == 1) {  // FillColorRow1 over bytes of 0 and 1
        o[0] = o[1] = o[2] = (row[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
      } else if (depth_ == 3) {  // RGB, copied into OpenCV's BGR as it lies
        const uint8_t* p = &row[static_cast<size_t>(x) * 3];
        o[0] = p[2];
        o[1] = p[1];
        o[2] = p[0];
      } else {  // grey, grey and alpha, RGB and alpha
        const uint8_t* p = &row[static_cast<size_t>(x) * depth_];
        for (int k = 0; k < 3; ++k) o[k] = p[depth_ == 4 ? k : 0];
      }
    }
  }
}

}  // namespace

bool is_pnm(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 'P' && d[1] >= '1' && d[1] <= '7' && std::isspace(d[2]);
}

std::unique_ptr<Decoder> make_pnm(const uint8_t* data, size_t n) {
  return std::unique_ptr<Decoder>(new Pnm(data, n));
}

}  // namespace cxr
