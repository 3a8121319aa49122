// What the decoders of this library share: the status a decode ends with,
// the Sink a decoder writes its RGB rows into, the interface of the TIFF and
// Netpbm decoders, and a JPEG stream read from inside another container
// (a JPEG-compressed TIFF strip or tile), decoded by decode.cpp's Jpeg.

#ifndef CXR_NATIVE_COMMON_H_
#define CXR_NATIVE_COMMON_H_

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <string>

namespace cxr {

enum Status { kOk = 0, kUndecodable = 1, kRefused = 2 };

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] inline void undecodable(const char* why) { throw Failure{kUndecodable, why}; }

[[noreturn]] inline void refused(const std::string& what) {
  throw Failure{kRefused, what + " is not decoded (ROADMAP A2c)"};
}

// a buffer read past its end: libjpeg suspends
struct Suspended {};

struct Free {
  void operator()(void* p) const { std::free(p); }
};

// OpenCV's validateInputImageSize, which imdecode and imread apply to every
// header: either side at most 2^20, at most 2^30 pixels
inline bool too_large(uint64_t h, uint64_t w) {
  return h == 0 || w == 0 || h > (1u << 20) || w > (1u << 20) || h * w > (uint64_t(1) << 30);
}

// Where the decoded image goes: dst holds the h x w frame after EXIF
// orientation (as cv::ExifTransform turns it); row y of the frame starts at
// row(y) and its pixels lie `step` bytes apart
struct Sink {
  uint8_t* dst = nullptr;
  int h = 0, w = 0;
  int orientation = 1;  // 1-8, anything else 1

  bool transposed() const { return orientation >= 5; }
  long out_h() const { return transposed() ? w : h; }
  long out_w() const { return transposed() ? h : w; }
  uint8_t* row(int y, long* step) const {
    const bool flip_x = orientation == 2 || orientation == 3 || orientation == 6 || orientation == 7;
    const bool flip_y = orientation == 3 || orientation == 4 || orientation == 7 || orientation == 8;
    const long ow = out_w(), oh = out_h();
    if (!transposed()) {
      long oy = flip_y ? oh - 1 - y : y;
      *step = flip_x ? -3 : 3;
      return dst + (oy * ow + (flip_x ? ow - 1 : 0)) * 3;
    }
    long ox = flip_x ? ow - 1 - y : y;
    *step = (flip_y ? -3 : 3) * ow;
    return dst + ((flip_y ? oh - 1 : 0) * ow + ox) * 3;
  }
};

// A decoder of one format (JPEG and BMP in decode.cpp, TIFF, Netpbm): open
// reads the headers and sets the sink's size and orientation, run decodes
// into sink.dst (h x w x 3 after orientation). Both throw Failure or
// Suspended.
class Decoder {
 public:
  virtual ~Decoder() = default;
  virtual void open(Sink* sink) = 0;
  virtual void run(const Sink& sink) = 0;
};

// tiff.cpp: `file` reads as cv2.imread reads a file rather than as
// cv2.imdecode decodes a buffer (they differ on uncompressed tiles)
bool is_tiff(const uint8_t* data, size_t n);
std::unique_ptr<Decoder> make_tiff(const uint8_t* data, size_t n, bool file);

// pnm.cpp: P1-P6 (OpenCV's PxMDecoder) and P7 (its PAMDecoder)
bool is_pnm(const uint8_t* data, size_t n);
std::unique_ptr<Decoder> make_pnm(const uint8_t* data, size_t n);

// A JPEG stream inside another container, read as libjpeg reads a stream
// that libtiff hands it: past its end come fake EOI markers. header() reads
// the markers up to the first scan (throws on a bad header); decode() then
// writes height() x width() pixels of 3 bytes, the colour converted from
// YCbCr or not as `ycbcr` says (a grey stream fills all three), and stops
// at the first error, leaving what it wrote (returns false then).
class JpegPart {
 public:
  JpegPart(const uint8_t* data, size_t n);
  ~JpegPart();
  void header();
  int height() const;
  int width() const;
  int components() const;
  int precision() const;
  int h_sampling(int component) const;
  int v_sampling(int component) const;
  bool decode(bool ycbcr, uint8_t* rgb);

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace cxr

#endif  // CXR_NATIVE_COMMON_H_
