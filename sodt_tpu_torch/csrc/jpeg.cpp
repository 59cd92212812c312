// JPEG decoder of the port: the pixels cv::imread(IMREAD_UNCHANGED) gives.
//
// C++17 with the standard library alone (no libjpeg, no OpenCV), integer
// arithmetic throughout. It computes what libjpeg-turbo's default
// decompression computes, step for step, as `data/jpeg.py` (the plain
// version, which the tests hold bit-equal to cv2) does:
//   - markers: SOI; APPn and COM skipped (APP0 JFIF and APP14 Adobe noted);
//     DQT with 8- and 16-bit tables; SOF0-3, SOF9-10; DHT; DAC; DRI; SOS;
//     EOI. A marker segment cut short reads on through the FF D9 bytes
//     libjpeg's source manager feeds. 12-bit, lossless of more than 8 bits,
//     SOF11 and hierarchical files throw, naming what they are (cv2 reads
//     none of them);
//   - Huffman decode of sequential scans and of progressive ones (DC first
//     and refine, AC first and refine with EOB runs), libjpeg's QM decoder
//     for arithmetic-coded ones (jdarith.c, DAC conditioning), restart
//     intervals as libjpeg's process_restart takes them. Where the Huffman
//     data ends early (a truncated file), the MCU that runs out reads zero
//     bits and the MCUs after it are left as they are, as in libjpeg;
//   - lossless scans (jdlhuff.c, jdlossls.c): predictors 1-7, the point
//     transform, 2-8 bits, unsubsampled;
//   - block smoothing of a progressive image whose scans left some of AC
//     coefficients 1-9 unfinished (jdcoefct.c decompress_smooth_data), as
//     libjpeg-turbo 3.1 (cv2 5.0) does it, or 2.1 (OpenCV 4.6) where asked;
//   - libjpeg-turbo's SIMD ISLOW IDCT (16-bit words where its code keeps
//     them), its output saturated to [-128, 127] and offset by 128;
//   - jdsample.c's fancy upsampling (h2v1, h2v2 where the component is
//     wider than 2 samples; h1v2), replication for any other integral
//     factor; jdcolor.c's integer YCbCr -> RGB. Three components are RGB
//     when an Adobe marker with transform 0 and no JFIF marker say so, or
//     their ids are 'R', 'G', 'B' with neither marker; four are CMYK, or
//     YCCK under an Adobe transform other than 0, then OpenCV's CMYK to BGR.
// No EXIF orientation is applied (IMREAD_UNCHANGED applies none).
//
// In the library: `sodt_jpeg::decode` for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   jpeg_file_shape(path, &h, &w, &c, &components, err, err_len)
//                                                   -> 1 ok, 0 failed
//   jpeg_file_decode(path, out, h, w, c, mode, err, err_len) -> 1 ok, 0 failed
// `out` is (h, w, c) uint8, C-contiguous: c = 1 gray, c = 3 RGB (and CMYK
// through OpenCV's conversion), c = 4 the CMYK samples where mode bit 1 is
// set; mode bit 0 decodes as OpenCV 4.6 (libjpeg-turbo 2.1) does. A failure
// writes its cause, the file named, into err.

#include <algorithm>
#include <array>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "jpeg.h"

namespace sodt_jpeg {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

namespace {

// zigzag index -> natural index; 16 extra entries catch a run that
// overshoots the block (corrupt data lands on 63), as in libjpeg
constexpr std::array<int, 80> kNatural = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// libjpeg-turbo's block smoothing (jdcoefct.c, 2.1 and later): the natural
// positions of zigzag coefficients 1-9 (Q01, Q10, Q20, Q11, Q02, Q03, Q12,
// Q21, Q30) and each estimate's weights over the 5 x 5 neighbourhood's DCs
// (rows above to below, columns left to right): the K.8-like ones where some
// AC data has arrived, the Gaussian-like ones (and the DC's) where none has
constexpr int kSmoothPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
constexpr int16_t kSmoothAc[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
constexpr int16_t kSmoothDcOnly[9][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
constexpr int16_t kSmoothDc[25] = {-2, -6, -8,  -6, -2, -6, 6,  42, 6,  -6, -8, 42, 152,
                                  42, -8, -6, 6,  42, 6,  -6, -2, -6, -8, -6, -2};

// T.81 Table D.2 in libjpeg's packing (jaricom.c): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin
constexpr uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

constexpr int kLookBits = 9;

// A Huffman table: a 9-bit lookup ((length << 8) | symbol, 0 where the code
// is longer) and libjpeg's canonical tables for the rest.
struct Huffman {
  bool present = false;
  std::array<uint16_t, 1 << kLookBits> look{};
  std::array<int32_t, 18> maxcode{};
  std::array<int32_t, 17> valoffset{};
  std::array<uint8_t, 256> val{};
};

// A DC table's symbols are sizes up to `dc_top` (16 in a lossless image).
void build_huffman(const uint8_t* counts, const uint8_t* syms, int n, bool dc, int dc_top,
                   Huffman& t) {
  if (dc)
    for (int i = 0; i < n; ++i)
      if (syms[i] > dc_top) throw JpegError("broken JPEG file (bad Huffman table)");
  t = Huffman();
  std::memcpy(t.val.data(), syms, n);
  int last = 0;
  for (int l = 1; l <= 16; ++l)
    if (counts[l - 1]) last = l;
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valoffset[l] = k - code;
    int cnt = l <= last ? counts[l - 1] : 0;
    // libjpeg's check (no code of l bits may be all ones), made before the
    // codes are written: an overfull length would run past `look`
    if (code + cnt >= (1 << l))
      throw JpegError("broken JPEG file (bad Huffman table)");
    if (cnt) {
      for (int i = 0; i < cnt; ++i, ++code, ++k) {
        if (l <= kLookBits) {
          int lo = code << (kLookBits - l), hi = (code + 1) << (kLookBits - l);
          for (int j = lo; j < hi; ++j) t.look[j] = uint16_t(l << 8 | syms[k]);
        }
      }
      t.maxcode[l] = code - 1;
    } else {
      t.maxcode[l] = -1;
    }
    code <<= 1;
  }
  t.maxcode[17] = 0x7FFFFFFF;  // sentinel: a 17-bit prefix always ends
  t.present = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0, bw = 0, bh = 0, pw = 0, ph = 0;
  bool have_qt = false;
  std::array<int32_t, 64> qt{};  // latched at the component's first scan
  std::vector<int16_t> coef;     // pw * ph blocks, natural order
  std::vector<uint8_t> samples;  // a lossless image's, h x w
  std::array<int, 64> coef_bits;
  std::array<int, 64> prev_bits{};  // coef_bits before the latest scan
};

// Reads entropy-coded bytes as libjpeg's fill_bit_buffer does: FF..FF 00 is
// one FF byte; FF..FF then any other byte is a marker, which stops the data;
// past it come zero bits.
class BitReader {
 public:
  BitReader(const std::vector<uint8_t>& d, size_t pos) : d_(d), pos_(pos) {}

  void Fill() {
    while (nbits_ <= 56) {
      uint32_t c = 0;
      if (!marker_) {
        if (pos_ >= d_.size()) {
          marker_ = 0xD9;
        } else {
          c = d_[pos_++];
          if (c == 0xFF) {
            uint32_t c2;
            do {
              c2 = pos_ < d_.size() ? d_[pos_++] : 0xD9;
            } while (c2 == 0xFF);
            if (c2 != 0) {
              marker_ = int(c2);
              c = 0;
            }
          }
          if (!marker_) real_ += 8;
        }
      }
      buf_ |= uint64_t(c) << (56 - nbits_);
      nbits_ += 8;
    }
  }
  uint32_t Peek(int n) {
    if (nbits_ < n) Fill();
    return uint32_t(buf_ >> (64 - n));
  }
  void Skip(int n) {
    if (nbits_ < n) Fill();
    buf_ <<= n;
    nbits_ -= n;
    used_ += uint64_t(n);
  }
  uint32_t Get(int n) {
    if (n == 0) return 0;
    uint32_t v = Peek(n);
    Skip(n);
    return v;
  }
  int Decode(const Huffman& t) {
    uint32_t look = Peek(16);
    uint16_t e = t.look[look >> (16 - kLookBits)];
    if (e) {
      Skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = int32_t(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        Skip(l);
        return t.val[(code + t.valoffset[l]) & 0xFF];
      }
    }
    Skip(17);  // no code matches: libjpeg takes 17 bits and a zero
    return 0;
  }
  // zero bits were read: the data ended inside what was decoded
  bool Overrun() const { return marker_ && used_ > real_; }
  // libjpeg's process_restart: drop the buffered bits; at the expected RSTn
  // go on after it (true), at another marker stay on it (false)
  bool Restart(int expect) {
    buf_ = 0;
    nbits_ = 0;
    used_ = real_ = 0;
    if (!marker_) {  // skip what is left of the interval, to its marker
      for (;;) {
        while (pos_ < d_.size() && d_[pos_] != 0xFF) ++pos_;
        while (pos_ < d_.size() && d_[pos_] == 0xFF) ++pos_;
        if (pos_ >= d_.size()) {
          marker_ = 0xD9;
          break;
        }
        uint8_t c = d_[pos_++];
        if (c != 0) {
          marker_ = c;
          break;
        }
      }
    }
    if (marker_ >= 0xD0 && marker_ <= 0xD7) {
      if (marker_ != 0xD0 + expect)
        throw JpegError("broken JPEG file (restart markers out of order)");
      marker_ = 0;
      return true;
    }
    return false;
  }
  // where the marker parse goes on after the scan: at the first marker that
  // is not RSTn (libjpeg skips those between scans)
  size_t End() {
    for (;;) {
      if (!marker_) {
        while (pos_ < d_.size() && d_[pos_] != 0xFF) ++pos_;
        while (pos_ < d_.size() && d_[pos_] == 0xFF) ++pos_;
        if (pos_ >= d_.size()) return d_.size();
        uint8_t c = d_[pos_++];
        if (c == 0) continue;
        marker_ = c;
      }
      if (marker_ >= 0xD0 && marker_ <= 0xD7) {
        marker_ = 0;
        continue;
      }
      return pos_ - 2;  // on the FF before the marker code
    }
  }

 private:
  const std::vector<uint8_t>& d_;
  size_t pos_;
  uint64_t buf_ = 0;
  int nbits_ = 0;
  int marker_ = 0;
  uint64_t used_ = 0, real_ = 0;
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? int(v) - ((1 << s) - 1) : int(v);
}

enum ScanKind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

class Decoder {
 public:
  explicit Decoder(const uint8_t* p, size_t n) : d_(p, p + n), n_real_(n) {
    // libjpeg's source managers insert an EOI where the file ends
    d_.push_back(0xFF);
    d_.push_back(0xD9);
  }

  void Run(bool header_only) {
    if (n_real_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw JpegError("not a JPEG file (no SOI)");
    size_t pos = 2;
    for (;;) {
      while (pos < d_.size() && d_[pos] != 0xFF) ++pos;
      while (pos < d_.size() && d_[pos] == 0xFF) ++pos;
      if (pos >= d_.size()) throw JpegError("truncated JPEG file");
      int m = d_[pos++];
      if (m == 0xD9) break;
      if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC9 && m <= 0xCB)) {
        Segment(pos);
        Sof(m);
        if (header_only) return;
      } else if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF)) {
        throw JpegError(std::string(SofName(m)) + " JPEG: libjpeg, and so cv2, reads none");
      } else if (m == 0xCC) {
        Segment(pos);
        Dac();
      } else if (m == 0xC4) {
        Segment(pos);
        Dht();
      } else if (m == 0xDB) {
        Segment(pos);
        Dqt();
      } else if (m == 0xDD) {
        Segment(pos);
        if (seg_.size() != 2) throw JpegError("broken JPEG file (DRI)");
        restart_ = seg_[0] << 8 | seg_[1];
      } else if (m == 0xDA) {
        Segment(pos);
        pos = Sos(pos);
        ++n_scans_;
      } else if (m == 0xE0) {
        Segment(pos);
        if (seg_.size() >= 14 && !std::memcmp(seg_.data(), "JFIF\0", 5)) jfif_ = true;
      } else if (m == 0xEE) {
        Segment(pos);
        if (seg_.size() >= 12 && !std::memcmp(seg_.data(), "Adobe", 5)) adobe_ = seg_[11];
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        Segment(pos);
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn between scans, TEM: no parameters
      } else if (m == 0xD8) {
        throw JpegError("broken JPEG file (SOI inside the image)");
      } else {
        char buf[64];
        std::snprintf(buf, sizeof buf, "broken JPEG file (unknown marker 0x%02X)", m);
        throw JpegError(buf);
      }
    }
    if (!have_frame_ || !n_scans_) throw JpegError("broken JPEG file (no image)");
  }

  int width() const { return w_; }
  int height() const { return h_; }
  // 1 gray, 3 RGB (three components, or four through OpenCV's CMYK to
  // BGR), 4 the CMYK samples where raw_cmyk(true)
  int channels() const {
    return comps_.size() == 1 ? 1 : comps_.size() == 4 && raw_cmyk_ ? 4 : 3;
  }
  int components() const { return int(comps_.size()); }
  void raw_cmyk(bool on) { raw_cmyk_ = on; }
  void turbo21(bool on) { turbo21_ = on; }
  // the frame a TIFF chunk takes: its width, and from `rows` to `top` rows
  void limit(int cols, int rows, int top) { lim_cols_ = cols, lim_rows_ = rows, lim_top_ = top; }
  // each component's sampling factors (h, v)
  std::vector<std::pair<int, int>> sampling() const {
    std::vector<std::pair<int, int>> s;
    for (const auto& c : comps_) s.emplace_back(c.h, c.v);
    return s;
  }

  // (h, w, c) uint8 into out: gray, or RGB
  // ycc: -1 RGB or YCbCr as the markers say, 1 YCbCr -> RGB, 0 as stored
  void Output(uint8_t* out, int ycc = -1) {
    std::vector<std::vector<uint8_t>> planes;
    const bool smooth = SmoothingOk();
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        throw JpegError("JPEG with fractional sampling ratios is not supported");
      if (lossless_)
        planes.push_back(c.samples.empty() ? std::vector<uint8_t>(size_t(w_) * h_, 0) : c.samples);
      else
        planes.push_back(Upsample(Plane(c, smooth), c, hmax_ / c.h, vmax_ / c.v));
    }
    const size_t n = size_t(w_) * h_;
    if (comps_.size() == 1) {
      std::memcpy(out, planes[0].data(), n);
      return;
    }
    bool rgb = ycc == 0 ||
               (ycc < 0 && ((!jfif_ && adobe_ == 0) ||
                            (!jfif_ && adobe_ < 0 && comps_[0].id == 82 &&
                             comps_[1].id == 71 && comps_[2].id == 66)));
    if (comps_.size() == 4) rgb = adobe_ <= 0;  // CMYK unless YCCK
    if (lossless_ && !rgb)
      throw JpegError(std::string("lossless JPEG in ") + (comps_.size() == 4 ? "YCCK" : "YCbCr") +
                      ": cv2 reads none (libjpeg converts no colour in lossless mode)");
    if (comps_.size() == 4) {
      // CMYK, or YCCK where an Adobe marker's transform is not 0 (Y Cb Cr
      // to R G B, each inverted, K as stored: jdcolor.c's ycck_cmyk_convert)
      if (!rgb) {
        std::vector<uint8_t> rgb(n * 3);
        YccToRgb(planes[0].data(), planes[1].data(), planes[2].data(), rgb.data(), n);
        for (size_t i = 0; i < n; ++i)
          for (int k = 0; k < 3; ++k) planes[k][i] = uint8_t(255 - rgb[3 * i + k]);
      }
      for (size_t i = 0; i < n; ++i) {
        const int k = planes[3][i];
        if (raw_cmyk_) {
          for (int j = 0; j < 4; ++j) out[4 * i + j] = planes[j][i];
        } else {  // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, as RGB
          for (int j = 0; j < 3; ++j) out[3 * i + j] = uint8_t(k - (((255 - planes[j][i]) * k) >> 8));
        }
      }
      return;
    }
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
    if (rgb) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    YccToRgb(p0, p1, p2, out, n);
  }

 private:
  // jdcolor.c's ycc_rgb_convert (SCALEBITS 16 tables), n pixels into rgb
  static void YccToRgb(const uint8_t* p0, const uint8_t* p1, const uint8_t* p2, uint8_t* out,
                       size_t n) {
    // jdcolor.c's tables (SCALEBITS 16)
    static const auto tabs = [] {
      std::array<std::array<int32_t, 256>, 4> t{};
      auto fix = [](double x) { return int32_t(x * 65536 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        int x = i - 128;
        t[0][i] = (fix(1.40200) * x + 32768) >> 16;  // Cr -> R
        t[1][i] = (fix(1.77200) * x + 32768) >> 16;  // Cb -> B
        t[2][i] = -fix(0.71414) * x;                 // Cr -> G
        t[3][i] = -fix(0.34414) * x + 32768;         // Cb -> G
      }
      return t;
    }();
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < n; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + tabs[0][cr]);
      out[3 * i + 1] = clamp(y + ((tabs[3][cb] + tabs[2][cr]) >> 16));
      out[3 * i + 2] = clamp(y + tabs[1][cb]);
    }
  }

  static const char* SofName(int m) {
    switch (m) {
      case 0xC5: return "hierarchical (SOF5)";
      case 0xC6: return "hierarchical (SOF6)";
      case 0xC7: return "hierarchical lossless (SOF7)";
      case 0xCD: return "hierarchical arithmetic-coded (SOF13)";
      case 0xCE: return "hierarchical arithmetic-coded (SOF14)";
      default: return "hierarchical arithmetic-coded (SOF15)";
    }
  }

  // the marker segment at pos into seg_; pos moves past it. Past the file's
  // end libjpeg's source manager feeds FF D9 again and again, so a segment
  // cut short is read on through those bytes, and the marker after it is an
  // EOI (the one at n_real_)
  void Segment(size_t& pos) {
    auto at = [&](size_t i) -> uint8_t {
      return i < n_real_ ? d_[i] : ((i - n_real_) & 1 ? 0xD9 : 0xFF);
    };
    const size_t n = size_t(at(pos)) << 8 | at(pos + 1);
    if (n < 2) throw JpegError("broken JPEG file (marker length)");
    seg_.resize(n - 2);
    for (size_t i = 0; i < n - 2; ++i) seg_[i] = at(pos + 2 + i);
    pos = std::min(pos + n, n_real_);
  }

  void Sof(int m) {
    if (have_frame_) throw JpegError("broken JPEG file (two frames)");
    if (seg_.size() < 6) throw JpegError("broken JPEG file (SOF)");
    int prec = seg_[0];
    h_ = seg_[1] << 8 | seg_[2];
    w_ = seg_[3] << 8 | seg_[4];
    int nc = seg_[5];
    lossless_ = m == 0xC3 || m == 0xCB;
    if (m == 0xCB) throw JpegError("arithmetic-coded lossless (SOF11) JPEG: cv2 reads none");
    if (lossless_ && (prec < 2 || prec > 16))
      throw JpegError("broken JPEG file (lossless precision)");
    if (lossless_ && prec > 8)
      throw JpegError(std::to_string(prec) + "-bit lossless JPEG: cv2 reads none");
    if (!lossless_ && prec != 8)
      throw JpegError(std::to_string(prec) +
                      "-bit JPEG: cv2 reads none (libjpeg's 8-bit interface refuses it)");
    if (lossless_ && turbo21_)
      throw JpegError("lossless (SOF3) JPEG: OpenCV 4.6 (libjpeg-turbo 2.1) reads none");
    precision_ = prec;
    if (!h_ || !w_)
      throw JpegError("unsupported image size " + std::to_string(w_) + " x " +
                      std::to_string(h_));
    if (lim_cols_ && (w_ != lim_cols_ || h_ < lim_rows_ || h_ > lim_top_))
      // a TIFF chunk's frame, refused before its coefficients are allocated
      throw JpegError("broken TIFF file (a JPEG strip or tile of " + std::to_string(w_) + " x " +
                      std::to_string(h_) + " for " + std::to_string(lim_cols_) + " x " +
                      std::to_string(lim_rows_) + ")");
    if (seg_.size() != size_t(6 + 3 * nc) || nc == 0) throw JpegError("broken JPEG file (SOF)");
    if (nc != 1 && nc != 3 && nc != 4)
      throw JpegError("JPEG of " + std::to_string(nc) + " components is not supported");
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = seg_[6 + 3 * i];
      c.h = seg_[7 + 3 * i] >> 4;
      c.v = seg_[7 + 3 * i] & 15;
      c.tq = seg_[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw JpegError("broken JPEG file (SOF sampling)");
    }
    for (auto& c : comps_) {
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (w_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (h_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.dw = int((int64_t(w_) * c.h + hmax_ - 1) / hmax_);
      c.dh = int((int64_t(h_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.pw = mcux_ * c.h;
      c.ph = mcuy_ * c.v;
      c.coef_bits.fill(-1);
    }
    if (lossless_)
      for (auto& c : comps_)
        if (c.h != hmax_ || c.v != vmax_)
          throw JpegError("lossless JPEG with subsampled components is not supported");
    progressive_ = m == 0xC2 || m == 0xCA;
    arithmetic_ = m == 0xC9 || m == 0xCA;
    have_frame_ = true;
  }

  void Dqt() {
    size_t i = 0;
    while (i < seg_.size()) {
      int pq = seg_[i] >> 4, tq = seg_[i] & 15;
      size_t n = 64 * (pq ? 2 : 1);
      if (tq > 3 || pq > 1 || i + 1 + n > seg_.size()) throw JpegError("broken JPEG file (DQT)");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (seg_[i + 1 + 2 * k] << 8 | seg_[i + 2 + 2 * k]) : seg_[i + 1 + k];
        qt_[tq][kNatural[k]] = v;
      }
      have_qt_[tq] = true;
      i += 1 + n;
    }
  }

  void Dac() {
    if (seg_.size() % 2) throw JpegError("broken JPEG file (DAC)");
    for (size_t i = 0; i < seg_.size(); i += 2) {
      const int t = seg_[i], v = seg_[i + 1];
      if (t >= 32) throw JpegError("broken JPEG file (DAC table)");
      if (t >= 16) {
        ac_k_[t - 16] = v;
      } else {
        dc_l_[t] = v & 15;
        dc_u_[t] = v >> 4;
        if (dc_l_[t] > dc_u_[t]) throw JpegError("broken JPEG file (DAC value)");
      }
    }
  }

  void Dht() {
    size_t i = 0;
    while (i < seg_.size()) {
      if (i + 17 > seg_.size()) throw JpegError("broken JPEG file (DHT)");
      int tc = seg_[i] >> 4, th = seg_[i] & 15;
      int n = 0;
      for (int l = 0; l < 16; ++l) n += seg_[i + 1 + l];
      if (tc > 1 || th > 3 || n > 256 || i + 17 + n > seg_.size())
        throw JpegError("broken JPEG file (DHT)");
      // checked and built where a scan first takes it, as in libjpeg
      RawHuffman& r = raw_huff_[tc][th];
      r.present = r.pending = true;
      std::memcpy(r.counts, &seg_[i + 1], 16);
      r.n = n;
      std::memcpy(r.syms, &seg_[i + 17], n);
      i += 17 + n;
    }
  }

  const Huffman& Table(int tc, int th) {
    if (th > 3 || !raw_huff_[tc][th].present)
      throw JpegError("broken JPEG file (Huffman table missing)");
    RawHuffman& r = raw_huff_[tc][th];
    if (r.pending) {
      build_huffman(r.counts, r.syms, r.n, tc == 0, lossless_ ? 16 : 15, huff_[tc][th]);
      r.pending = false;
    }
    return huff_[tc][th];
  }

  size_t Sos(size_t pos) {
    if (!have_frame_) throw JpegError("broken JPEG file (SOS before SOF)");
    int ns = seg_.empty() ? 0 : seg_[0];
    if (ns < 1 || ns > 4 || seg_.size() != size_t(4 + 2 * ns))
      throw JpegError("broken JPEG file (SOS)");
    std::vector<int> sc(ns), td(ns), ta(ns);
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      int cid = seg_[1 + 2 * i], t = seg_[2 + 2 * i];
      int found = -1;
      for (size_t j = 0; j < comps_.size(); ++j)
        if (comps_[j].id == cid) {
          found = int(j);
          break;
        }
      if (found < 0) throw JpegError("broken JPEG file (SOS component)");
      sc[i] = found;
      td[i] = t >> 4;
      ta[i] = t & 15;
      blocks += comps_[found].h * comps_[found].v;
    }
    if (ns > 1 && blocks > 10)
      throw JpegError("broken JPEG file (more than 10 blocks in an MCU)");
    int ss = seg_[1 + 2 * ns], se = seg_[2 + 2 * ns];
    int ah = seg_[3 + 2 * ns] >> 4, al = seg_[3 + 2 * ns] & 15;
    if (lossless_) {  // Ss the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se || ah || al >= precision_)
        throw JpegError("broken JPEG file (SOS lossless parameters)");
      return LosslessScan(pos, sc, td, ss, al);
    }
    bool bad = progressive_ ? (ss > se || se > 63 || ah > 13 || al > 13 ||
                               (ss == 0 && se != 0) || (ss > 0 && ns != 1))
                            : (ss != 0 || se != 63 || ah != 0 || al != 0);
    if (bad) throw JpegError("broken JPEG file (SOS progression parameters)");
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sc[i]];
      if (!c.have_qt) {  // libjpeg latches the table at the first scan
        if (!have_qt_[c.tq]) throw JpegError("broken JPEG file (quantization table missing)");
        c.qt = qt_[c.tq];
        c.have_qt = true;
      }
      if (c.coef.empty()) c.coef.assign(size_t(c.pw) * c.ph * 64, 0);
    }
    // libjpeg's start_pass: the bits of coefficients 0 (or 1) to 9 as they
    // stood before this scan, then the scan's own
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sc[i]];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        c.prev_bits[k] = n_scans_ ? c.coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    ScanKind kind = !progressive_ ? kSeq
                    : ss == 0     ? (ah == 0 ? kDcFirst : kDcRefine)
                                  : (ah == 0 ? kAcFirst : kAcRefine);
    if (arithmetic_) {
      ArithScan(pos, sc, td, ta, ss, se, al, kind);
      // arithmetic data never runs short, so libjpeg's last_good_iMCU_row
      // reaches the scan's last iMCU row
      const Component& c0 = comps_[sc[0]];
      last_good_ = ns == 1 ? (c0.bh - 1) / c0.v : mcuy_ - 1;
      return arith_end_;
    }
    std::vector<const Huffman*> dc(ns, nullptr), ac(ns, nullptr);
    for (int i = 0; i < ns; ++i) {
      if (kind == kSeq || kind == kDcFirst) dc[i] = &Table(0, td[i]);
      if (kind == kSeq || kind == kAcFirst || kind == kAcRefine) ac[i] = &Table(1, ta[i]);
    }
    // each MCU's blocks: (component in scan, block index)
    std::vector<std::pair<int, int>> mcu_blocks;
    const int n_mcu = ns == 1 ? comps_[sc[0]].bw * comps_[sc[0]].bh : mcux_ * mcuy_;
    BitReader br(d_, pos);
    const int interval = restart_ ? restart_ : n_mcu;
    std::vector<int> last_dc(ns, 0);
    int eobrun = 0;
    bool insufficient = false;
    // each MCU's iMCU row: libjpeg notes the row at its first MCU while the
    // data has not yet run out (last_good_iMCU_row)
    auto imcu_row = [&](int m) {
      return ns == 1 ? m / comps_[sc[0]].bw / comps_[sc[0]].v : m / mcux_;
    };
    for (int m = 0; m < n_mcu; ++m) {
      if (!insufficient && (m == 0 || imcu_row(m) != imcu_row(m - 1))) last_good_ = imcu_row(m);
      if (m > 0 && m % interval == 0) {
        if (br.Restart((m / interval - 1) & 7)) insufficient = false;
        std::fill(last_dc.begin(), last_dc.end(), 0);
        eobrun = 0;
      }
      if (insufficient) continue;  // libjpeg leaves the MCU as it is
      mcu_blocks.clear();
      if (ns == 1) {
        const Component& c = comps_[sc[0]];
        mcu_blocks.emplace_back(0, (m / c.bw) * c.pw + m % c.bw);
      } else {
        int my = m / mcux_, mx = m % mcux_;
        for (int i = 0; i < ns; ++i) {
          const Component& c = comps_[sc[i]];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx)
              mcu_blocks.emplace_back(i, (my * c.v + yy) * c.pw + mx * c.h + xx);
        }
      }
      for (auto& [ci, b] : mcu_blocks) {
        int16_t* blk = comps_[sc[ci]].coef.data() + size_t(b) * 64;
        switch (kind) {
          case kSeq: BlockSeq(br, *dc[ci], *ac[ci], blk, last_dc[ci]); break;
          case kDcFirst: {
            int s = br.Decode(*dc[ci]);
            if (s) last_dc[ci] += extend(br.Get(s), s);
            blk[0] = int16_t(last_dc[ci] * (1 << al));
            break;
          }
          case kDcRefine:
            if (br.Get(1)) blk[0] = int16_t(blk[0] | (1 << al));
            break;
          case kAcFirst: BlockAcFirst(br, *ac[ci], blk, ss, se, al, eobrun); break;
          case kAcRefine: BlockAcRefine(br, *ac[ci], blk, ss, se, al, eobrun); break;
        }
      }
      if (br.Overrun()) insufficient = true;
    }
    return br.End();
  }

  // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): each sample's
  // difference, Huffman coded as a DC difference (size 16 is 32768), added to
  // its prediction modulo 2^16: the first row of the scan and of each restart
  // interval predicts from the left (its first sample from 2^(P - Pt - 1)),
  // every other row's first sample from above, its others by predictor psv.
  // Past the data's end libjpeg reads zero bits and goes on decoding.
  size_t LosslessScan(size_t pos, const std::vector<int>& sc, const std::vector<int>& td, int psv,
                      int pt) {
    const int ns = int(sc.size());
    const size_t n = size_t(w_) * h_;
    if (restart_ % w_) throw JpegError("broken JPEG file (a lossless restart interval that is not whole rows)");
    std::vector<const Huffman*> tabs(ns);
    for (int i = 0; i < ns; ++i) tabs[i] = &Table(0, td[i]);
    std::vector<std::vector<int32_t>> diffs(ns, std::vector<int32_t>(n));
    const size_t interval = restart_ ? size_t(restart_) : n;
    BitReader br(d_, pos);
    for (size_t m = 0; m < n; ++m) {
      if (m > 0 && m % interval == 0) br.Restart(int((m / interval - 1) & 7));
      for (int i = 0; i < ns; ++i) {
        const int s = br.Decode(*tabs[i]);
        diffs[i][m] = s == 16 ? 32768 : s ? extend(br.Get(s), s) : 0;
      }
    }
    const int rows = int(interval / size_t(w_));
    const int32_t init = 1 << (precision_ - pt - 1);
    std::vector<int32_t> prev(w_), cur(w_);
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sc[i]];
      c.samples.assign(n, 0);
      for (int y = 0; y < h_; ++y) {
        const int32_t* d = diffs[i].data() + size_t(y) * w_;
        int32_t ra;
        if (y % rows == 0) {  // first row
          cur[0] = ra = (d[0] + init) & 0xFFFF;
          for (int x = 1; x < w_; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
          int32_t rb = prev[0], rc;
          cur[0] = ra = (d[0] + rb) & 0xFFFF;
          for (int x = 1; x < w_; ++x) {
            rc = rb;
            rb = prev[x];
            int32_t p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            cur[x] = ra = (d[x] + p) & 0xFFFF;
          }
        }
        // the point transform undone, into an 8-bit sample
        for (int x = 0; x < w_; ++x) c.samples[size_t(y) * w_ + x] = uint8_t(cur[x] << pt);
        std::swap(prev, cur);
      }
    }
    return br.End();
  }

  // libjpeg's QM decoder (jdarith.c arith_decode) over the scan's unstuffed
  // bytes, zeros after a marker; ct -1 is its error state (a bad code)
  struct Arith {
    BitReader& br;
    int64_t c = 0, a = 0;
    int ct = -16;
    int operator()(uint8_t* st) {
      while (a < 0x8000) {
        if (--ct < 0) {
          c = (c << 8) | br.Get(8);
          if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
        }
        a <<= 1;
      }
      int sv = *st;
      uint32_t qe = kAritab[sv & 0x7F];
      const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
      qe >>= 16;
      int64_t temp = a - int64_t(qe);
      a = temp;
      temp <<= ct;
      if (c >= temp) {
        c -= temp;
        if (a < int64_t(qe)) {
          a = qe;
          *st = uint8_t((sv & 0x80) ^ nm);
        } else {
          a = qe;
          *st = uint8_t((sv & 0x80) ^ nl);
          sv ^= 0x80;
        }
      } else if (a < 0x8000) {
        if (a < int64_t(qe)) {
          *st = uint8_t((sv & 0x80) ^ nl);
          sv ^= 0x80;
        } else {
          *st = uint8_t((sv & 0x80) ^ nm);
        }
      }
      return sv >> 7;
    }
  };

  // Figures F.19-F.24: a DC difference (updating the component's context),
  // or an AC value at k; false on a bad code
  static bool ArithDc(Arith& dec, uint8_t* stats, int& ctx, int L, int U, int& v) {
    int i = ctx;
    if (!dec(stats + i)) {
      ctx = 0;
      v = 0;
      return true;
    }
    const int sign = dec(stats + i + 1);
    i += 2 + sign;
    int m = dec(stats + i);
    if (m) {
      i = 20;
      while (dec(stats + i)) {
        if ((m <<= 1) == 0x8000) return false;
        ++i;
      }
    }
    ctx = m < (1 << L) >> 1 ? 0 : m > (1 << U) >> 1 ? 12 + sign * 4 : 4 + sign * 4;
    v = m;
    i += 14;
    while (m >>= 1)
      if (dec(stats + i)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }
  static bool ArithAc(Arith& dec, uint8_t* st, uint8_t* fixed, int k, int kx, int& v) {
    const int sign = dec(fixed);
    int i = 3 * (k - 1) + 2;
    int m = dec(st + i);
    if (m && dec(st + i)) {
      m <<= 1;
      i = k <= kx ? 189 : 217;
      while (dec(st + i)) {
        if ((m <<= 1) == 0x8000) return false;
        ++i;
      }
    }
    v = m;
    i += 14;
    while (m >>= 1)
      if (dec(st + i)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }
  static bool ArithAcRefine(Arith& dec, uint8_t* st, uint8_t* fixed, int16_t* blk, int ss, int se,
                            int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      int i = 3 * (k - 1);
      if (k > kex && dec(st + i)) break;  // EOB
      for (;;) {
        int16_t& c = blk[kNatural[k]];
        if (c) {
          if (dec(st + i + 2)) c = int16_t(c + (c < 0 ? m1 : p1));
          break;
        }
        if (dec(st + i + 1)) {
          c = int16_t(dec(fixed) ? m1 : p1);
          break;
        }
        i += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // An arithmetic-coded scan (jdarith.c): the statistics of the scan's
  // tables cleared at its start and at each restart, with the DC predictions
  // and contexts; MCUs after a bad code in an interval decode nothing
  void ArithScan(size_t pos, const std::vector<int>& sc, const std::vector<int>& td,
                 const std::vector<int>& ta, int ss, int se, int al, ScanKind kind) {
    const int ns = int(sc.size());
    const int n_mcu = ns == 1 ? comps_[sc[0]].bw * comps_[sc[0]].bh : mcux_ * mcuy_;
    const bool dc_bins = kind == kSeq || kind == kDcFirst;
    const bool ac_bins = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
    const int interval = restart_ ? restart_ : n_mcu;
    BitReader br(d_, pos);
    uint8_t fixed = 113;
    std::vector<int> last(ns), ctx(ns);
    Arith dec{br};
    std::vector<std::pair<int, int>> blocks;
    for (int m = 0; m < n_mcu; ++m) {
      if (m % interval == 0) {
        if (m > 0) br.Restart((m / interval - 1) & 7);
        for (int i = 0; i < ns; ++i) {
          if (dc_bins) std::memset(dc_stats_[td[i]], 0, 64);
          if (ac_bins) std::memset(ac_stats_[ta[i]], 0, 256);
          last[i] = ctx[i] = 0;
        }
        dec.c = dec.a = 0;
        dec.ct = -16;
      }
      if (dec.ct == -1 && kind != kDcRefine) continue;
      McuBlocks(m, sc, blocks);
      for (auto& [ci, b] : blocks) {
        int16_t* blk = comps_[sc[ci]].coef.data() + size_t(b) * 64;
        if (kind == kDcRefine) {
          if (dec(&fixed)) blk[0] = int16_t(blk[0] | (1 << al));
          continue;
        }
        if (kind == kSeq || kind == kDcFirst) {
          int v;
          if (!ArithDc(dec, dc_stats_[td[ci]], ctx[ci], dc_l_[td[ci]], dc_u_[td[ci]], v)) {
            dec.ct = -1;
            break;
          }
          last[ci] = (last[ci] + v) & 0xFFFF;
          blk[0] = int16_t(uint16_t(last[ci] << al));
          if (kind == kDcFirst) continue;
        }
        uint8_t* st = ac_stats_[ta[ci]];
        if (kind == kAcRefine) {
          if (!ArithAcRefine(dec, st, &fixed, blk, ss, se, al)) {
            dec.ct = -1;
            break;
          }
          continue;
        }
        const int top = kind == kAcFirst ? se : 63;
        bool bad = false;
        for (int k = std::max(ss, 1); k <= top; ++k) {
          if (dec(st + 3 * (k - 1))) break;  // EOB
          while (!dec(st + 3 * (k - 1) + 1))
            if (++k > top) break;
          int v;
          if (k > top || !ArithAc(dec, st, &fixed, k, ac_k_[ta[ci]], v)) {
            bad = true;
            break;
          }
          blk[kNatural[k]] = int16_t(uint16_t(unsigned(v) << al));
        }
        if (bad) {
          dec.ct = -1;
          break;
        }
      }
    }
    arith_end_ = br.End();
  }

  // the blocks of MCU m of a scan: (component in scan, block index)
  void McuBlocks(int m, const std::vector<int>& sc, std::vector<std::pair<int, int>>& out) const {
    out.clear();
    if (sc.size() == 1) {
      const Component& c = comps_[sc[0]];
      out.emplace_back(0, (m / c.bw) * c.pw + m % c.bw);
      return;
    }
    const int my = m / mcux_, mx = m % mcux_;
    for (size_t i = 0; i < sc.size(); ++i) {
      const Component& c = comps_[sc[i]];
      for (int yy = 0; yy < c.v; ++yy)
        for (int xx = 0; xx < c.h; ++xx)
          out.emplace_back(int(i), (my * c.v + yy) * c.pw + mx * c.h + xx);
    }
  }

  static void BlockSeq(BitReader& br, const Huffman& dc, const Huffman& ac, int16_t* blk,
                       int& pred) {
    int s = br.Decode(dc);
    if (s) pred += extend(br.Get(s), s);
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.Decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.Get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void BlockAcFirst(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se,
                           int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.Decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.Get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += int(br.Get(r));
        --eobrun;
        break;
      }
    }
  }

  static void BlockAcRefine(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se,
                            int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& c) {
      if (br.Get(1) && !(c & p1)) c = int16_t(c >= 0 ? c + p1 : c + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.Decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.Get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += int(br.Get(r));
          break;
        }
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // one pass over 8 words (16-bit values): the sums in0 +- in4, in7 + in3 and
  // in5 + in1 wrapped to 16 bits, everything else in 32 (wrapping, as the
  // SIMD lanes do), each output descaled by kShift and saturated to 16 bits
  template <int kShift>
  static inline void IdctPass(const int32_t* d, int32_t* o) {
    using u32 = uint32_t;
    auto w16 = [](u32 v) { return u32(int32_t(int16_t(uint16_t(v)))); };
    const u32 d0 = u32(d[0]), d1 = u32(d[1]), d2 = u32(d[2]), d3 = u32(d[3]);
    const u32 d4 = u32(d[4]), d5 = u32(d[5]), d6 = u32(d[6]), d7 = u32(d[7]);
    u32 z1 = (d2 + d6) * 4433u;
    const u32 tmp2 = z1 + d6 * u32(-15137), tmp3 = z1 + d2 * 6270u;
    const u32 tmp0 = w16(d0 + d4) << 13, tmp1 = w16(d0 - d4) << 13;
    const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    u32 z3 = w16(d7 + d3), z4 = w16(d5 + d1);
    const u32 z5 = (z3 + z4) * 9633u;
    u32 t0 = d7 * 2446u, t1 = d5 * 16819u, t2 = d3 * 25172u, t3 = d1 * 12299u;
    z1 = (d7 + d1) * u32(-7373);
    const u32 z2 = (d5 + d3) * u32(-20995);
    z3 = z3 * u32(-16069) + z5;
    z4 = z4 * u32(-3196) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    constexpr u32 kHalf = u32(1) << (kShift - 1);
    const u32 v[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
    for (int i = 0; i < 8; ++i)
      o[i] = std::min(std::max(int32_t(v[i] + kHalf) >> kShift, -32768), 32767);
  }

  // libjpeg-turbo's SIMD ISLOW IDCT (jidctint-avx2.asm, what cv2 runs on
  // x86) on one block; out is 8 x 8 at `out` with row step `stride`. It is
  // jidctint.c's arithmetic with 16-bit words where the SIMD code keeps
  // them: the coefficients times the table, the sums in0 +- in4, in7 + in3
  // and in5 + in1, each pass's outputs (saturated); a block whose rows 1-7
  // are all zero takes the DC-only path (dequantised row 0 << 2, in 16 bits).
  // The output is saturated to [-128, 127] and offset by 128.
  static void Idct(const int16_t* in, const int32_t* q, uint8_t* out, size_t stride) {
    constexpr int kCb = 13, kP1 = 2;
    auto w16 = [](int32_t v) { return int32_t(int16_t(uint16_t(uint32_t(v)))); };
    auto limit = [](int32_t v) { return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128); };
    int32_t ws[64], d[8], o[8];
    int16_t col_ac[8] = {};
    for (int r = 1; r < 8; ++r)
      for (int c = 0; c < 8; ++c) col_ac[c] |= in[r * 8 + c];
    bool block_ac = false;
    for (int c = 0; c < 8; ++c) block_ac |= col_ac[c] != 0;
    for (int c = 0; c < 8; ++c) {  // columns
      const int32_t dc = w16(in[c] * q[c]) * (1 << kP1);
      if (!col_ac[c]) {  // the full pass gives dc saturated; the DC-only path wraps it
        const int32_t v = block_ac ? (dc < -32768 ? -32768 : dc > 32767 ? 32767 : dc) : w16(dc);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
        continue;
      }
      for (int r = 0; r < 8; ++r) d[r] = w16(in[r * 8 + c] * q[r * 8 + c]);
      IdctPass<kCb - kP1>(d, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = o[r];
    }
    for (int r = 0; r < 8; ++r) {  // rows
      const int32_t* w = ws + r * 8;
      uint8_t* row = out + r * stride;
      if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {  // equals the full pass
        std::memset(row, limit((w[0] + (1 << (kP1 + 2))) >> (kP1 + 3)), 8);
        continue;
      }
      IdctPass<kCb + kP1 + 3>(w, o);
      for (int c = 0; c < 8; ++c) row[c] = limit(o[c]);
    }
  }

  // libjpeg's smoothing_ok: a progressive image whose components all have
  // their tables latched (the DC and Q01-Q30 entries nonzero) and some DC
  // data, and some of whose coefficients 1-9 are not yet exact
  bool SmoothingOk() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.have_qt || !c.qt[0]) return false;
      for (int p : kSmoothPos)
        if (!c.qt[p]) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  // libjpeg-turbo's decompress_smooth_data on one component: the blocks the
  // IDCT gets. Coefficients 1-9 still zero and not known exactly are
  // estimated from the 5 x 5 neighbourhood's DCs (and, with no AC data at
  // all, the DC too); rows past the iMCU row where the last scan's data ran
  // out take the coefficient bits from before that scan. 3.1 counts a
  // neighbour row by the block row's place in the image; 2.1 (turbo21_) by
  // its place in its iMCU row or the iMCU row's in the image, and loads the
  // column two right late in a component two blocks wide.
  std::vector<int16_t> Smooth(const Component& c) const {
    std::vector<int16_t> out = c.coef;
    const int last = mcuy_ - 1;
    std::array<int, 10> cur, prev;
    for (int k = 0; k < 10; ++k) {
      cur[k] = c.coef_bits[k];
      prev[k] = n_scans_ > 1 ? c.prev_bits[k] : -1;
    }
    for (int r = 0; r < c.bh; ++r) {
      const int i = r / c.v, b = r % c.v;
      const int rows = i < last ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
      bool up1, up2, dn1, dn2;
      if (turbo21_) {
        up1 = b > 0 || i > 0, up2 = b > 1 || i > 1;
        dn1 = b < rows - 1 || i < last, dn2 = b < rows - 2 || i + 1 < last;
      } else {
        const int ibr = i * rows + b, ibrs = rows * mcuy_;
        up1 = ibr > 0, up2 = ibr > 1, dn1 = ibr < ibrs - 1, dn2 = ibr < ibrs - 2;
      }
      const int pr = up1 ? r - 1 : r, nx = dn1 ? r + 1 : r;
      const int nb[5] = {up2 ? r - 2 : pr, pr, r, nx, dn2 ? r + 2 : nx};
      const std::array<int, 10>& bits = i <= last_good_ ? cur : prev;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      for (int x = 0; x < c.bw; ++x) {
        int cols[5];
        for (int j = 0; j < 5; ++j) cols[j] = std::min(std::max(x + j - 2, 0), c.bw - 1);
        if (turbo21_ && c.bw == 2)
          for (int j = 0; j < 5; ++j) cols[j] = (x == 0 ? j == 3 : j == 2) ? 1 : 0;
        int64_t dc[25];
        for (int a = 0; a < 5; ++a)
          for (int j = 0; j < 5; ++j)
            dc[a * 5 + j] = c.coef[(size_t(nb[a]) * c.pw + cols[j]) * 64];
        int16_t* blk = out.data() + (size_t(r) * c.pw + x) * 64;
        auto pred = [&](const int16_t* w, int64_t qp, int al) {
          int64_t num = 0;
          for (int j = 0; j < 25; ++j) num += w[j] * dc[j];
          num *= c.qt[0];
          int64_t a = ((qp << 7) + (num < 0 ? -num : num)) / (qp << 8);
          if (al > 0 && a >= (int64_t(1) << al)) a = (int64_t(1) << al) - 1;
          return int16_t(num < 0 ? -a : a);
        };
        for (int k = 0; k < (change_dc ? 9 : 5); ++k) {
          const int pos = kSmoothPos[k], al = bits[k + 1];
          if (al != 0 && c.coef[(size_t(r) * c.pw + x) * 64 + pos] == 0)
            blk[pos] = pred(change_dc ? kSmoothDcOnly[k] : kSmoothAc[k], c.qt[pos], al);
        }
        if (change_dc) blk[0] = pred(kSmoothDc, c.qt[0], 0);
      }
    }
    return out;
  }

  // a component's samples, dh x dw
  std::vector<uint8_t> Plane(const Component& c, bool smooth) {
    std::vector<uint8_t> out(size_t(c.dw) * c.dh, 128);
    if (!c.have_qt) return out;  // never in a scan: libjpeg's zero multipliers
    std::vector<int16_t> smoothed;
    if (smooth) smoothed = Smooth(c);
    const int16_t* coef = smooth ? smoothed.data() : c.coef.data();
    std::array<int32_t, 64> q;
    for (int k = 0; k < 64; ++k) q[k] = int16_t(c.qt[k]);
    const size_t stride = size_t(c.pw) * 8;
    std::vector<uint8_t> full(stride * c.ph * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        Idct(coef + (size_t(by) * c.pw + bx) * 64, q.data(),
             full.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
    for (int y = 0; y < c.dh; ++y)
      std::memcpy(out.data() + size_t(y) * c.dw, full.data() + size_t(y) * stride, c.dw);
    return out;
  }

  // jdsample.c: the component's dh x dw samples to h_ x w_
  std::vector<uint8_t> Upsample(std::vector<uint8_t> x, const Component& c, int hf, int vf) {
    const int dw = c.dw, dh = c.dh;
    if (hf == 1 && vf == 1) return x;
    std::vector<uint8_t> out(size_t(w_) * h_);
    // input row j, and the nearer context row of output row y (the edge
    // rows replicated, as jdmainct.c's context pointers do)
    auto row = [&](int j) { return &x[size_t(std::min(std::max(j, 0), dh - 1)) * dw]; };
    if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy
      std::vector<int> r(2 * dw);
      for (int y = 0; y < h_; ++y) {
        const uint8_t* s = row(y);
        r[0] = s[0];
        for (int i = 0; i < dw - 1; ++i) r[2 * i + 1] = (3 * s[i] + s[i + 1] + 2) >> 2;
        for (int i = 1; i < dw; ++i) r[2 * i] = (3 * s[i] + s[i - 1] + 1) >> 2;
        r[2 * dw - 1] = s[dw - 1];
        for (int i = 0; i < w_; ++i) out[size_t(y) * w_ + i] = uint8_t(r[i]);
      }
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy
      for (int y = 0; y < h_; ++y) {
        const int j = y >> 1, bias = y & 1 ? 2 : 1;
        const uint8_t *a = row(j), *b = row(y & 1 ? j + 1 : j - 1);
        uint8_t* o = &out[size_t(y) * w_];
        for (int i = 0; i < w_; ++i) o[i] = uint8_t((3 * a[i] + b[i] + bias) >> 2);
      }
    } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy
      std::vector<int> cs(dw), r(2 * dw);
      for (int y = 0; y < h_; ++y) {
        const int j = y >> 1;
        const uint8_t *a = row(j), *b = row(y & 1 ? j + 1 : j - 1);
        for (int i = 0; i < dw; ++i) cs[i] = 3 * a[i] + b[i];
        r[0] = (cs[0] * 4 + 8) >> 4;
        for (int i = 0; i < dw - 1; ++i) r[2 * i + 1] = (cs[i] * 3 + cs[i + 1] + 7) >> 4;
        for (int i = 1; i < dw; ++i) r[2 * i] = (cs[i] * 3 + cs[i - 1] + 8) >> 4;
        r[2 * dw - 1] = (cs[dw - 1] * 4 + 7) >> 4;
        for (int i = 0; i < w_; ++i) out[size_t(y) * w_ + i] = uint8_t(r[i]);
      }
    } else {  // integral replication
      for (int y = 0; y < h_; ++y)
        for (int i = 0; i < w_; ++i) out[size_t(y) * w_ + i] = x[size_t(y / vf) * dw + i / hf];
    }
    return out;
  }

  std::vector<uint8_t> d_;
  size_t n_real_;
  std::vector<uint8_t> seg_;
  std::array<std::array<int32_t, 64>, 4> qt_{};
  std::array<bool, 4> have_qt_{};
  struct RawHuffman {
    bool present = false, pending = false;
    uint8_t counts[16], syms[256];
    int n = 0;
  };
  std::array<std::array<RawHuffman, 4>, 2> raw_huff_{};
  std::array<std::array<Huffman, 4>, 2> huff_;
  int restart_ = 0, n_scans_ = 0;
  bool jfif_ = false;
  int adobe_ = -1;
  bool have_frame_ = false, progressive_ = false;
  int last_good_ = 0;    // libjpeg's last_good_iMCU_row
  bool raw_cmyk_ = false;
  bool lossless_ = false, arithmetic_ = false;
  int precision_ = 8;
  // arithmetic conditioning (DAC) and statistics, per table
  std::array<int, 16> dc_l_{}, dc_u_ = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
                      ac_k_ = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  size_t arith_end_ = 0;
  bool turbo21_ = false;  // smooth as libjpeg-turbo 2.1 (OpenCV 4.6) does
  int w_ = 0, h_ = 0, hmax_ = 0, vmax_ = 0, mcux_ = 0, mcuy_ = 0;
  int lim_cols_ = 0, lim_rows_ = 0, lim_top_ = 0;
  std::vector<Component> comps_;
};

std::vector<uint8_t> read_all(const char* path) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path, "rb"), std::fclose);
  if (!f) throw JpegError(std::string("cannot open the file (") + std::strerror(errno) + ")");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f.get())) > 0)
    data.insert(data.end(), buf, buf + got);
  if (std::ferror(f.get())) throw JpegError("cannot read the file");
  return data;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) {
    std::strncpy(err, msg.c_str(), size_t(err_len) - 1);
    err[err_len - 1] = 0;
  }
}

}  // namespace

// Decode a whole JPEG file held in memory: (h, w) and c = 1 gray or 3 RGB,
// the pixels (h, w, c) into px, as cv2 5.0 reads them, or as OpenCV 4.6
// (libjpeg-turbo 2.1) does where `opencv46`. Throws JpegError with the cause.
void decode(const uint8_t* data, size_t n, int* h, int* w, int* c, std::vector<uint8_t>* px,
            bool opencv46) {
  Decoder dec(data, n);
  dec.turbo21(opencv46);
  dec.Run(false);
  *h = dec.height();
  *w = dec.width();
  *c = dec.channels();
  px->resize(size_t(*h) * *w * *c);
  dec.Output(px->data());
}

void decode_segment(const uint8_t* tables, size_t tn, const uint8_t* data, size_t n,
                    bool ycc, int cols, int rows, int top, int* h, int* w, int* c,
                    std::vector<uint8_t>* px, std::vector<std::pair<int, int>>* sampling) {
  std::vector<uint8_t> joined;
  if (tn) {
    if (tn < 2 || n < 2 || tables[0] != 0xFF || tables[1] != 0xD8 || data[0] != 0xFF ||
        data[1] != 0xD8)
      throw JpegError("broken JPEG strip or tile (no SOI)");
    const size_t end = tables[tn - 2] == 0xFF && tables[tn - 1] == 0xD9 ? tn - 2 : tn;
    joined.assign(tables, tables + end);
    joined.insert(joined.end(), data + 2, data + n);
    data = joined.data();
    n = joined.size();
  }
  Decoder dec(data, n);
  dec.limit(cols, rows, top);
  dec.Run(false);
  *h = dec.height();
  *w = dec.width();
  *c = dec.channels();
  px->resize(size_t(*h) * *w * *c);
  dec.Output(px->data(), ycc ? 1 : 0);
  *sampling = dec.sampling();
}

}  // namespace sodt_jpeg

extern "C" {

int jpeg_file_shape(const char* path, int* h, int* w, int* c, int* components, char* err,
                    int err_len) {
  try {
    std::vector<uint8_t> data = sodt_jpeg::read_all(path);
    sodt_jpeg::Decoder dec(data.data(), data.size());
    dec.Run(true);
    if (!dec.width()) throw sodt_jpeg::JpegError("broken JPEG file (no frame header)");
    *h = dec.height();
    *w = dec.width();
    *c = dec.channels();
    *components = dec.components();
    return 1;
  } catch (const std::exception& e) {
    sodt_jpeg::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

int jpeg_file_decode(const char* path, uint8_t* out, int h, int w, int c, int mode, char* err,
                     int err_len) {
  try {
    std::vector<uint8_t> data = sodt_jpeg::read_all(path);
    sodt_jpeg::Decoder dec(data.data(), data.size());
    dec.turbo21(mode & 1);
    dec.raw_cmyk(mode & 2);
    dec.Run(false);
    const int hh = dec.height(), ww = dec.width(), cc = dec.channels();
    std::vector<uint8_t> px(size_t(hh) * ww * cc);
    dec.Output(px.data());
    if (hh != h || ww != w || cc != c)
      throw sodt_jpeg::JpegError("the file changed between the shape query and the decode");
    std::memcpy(out, px.data(), px.size());
    return 1;
  } catch (const std::exception& e) {
    sodt_jpeg::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

}  // extern "C"
