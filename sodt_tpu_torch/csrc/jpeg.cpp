// JPEG decoder of the port: the pixels cv::imread(IMREAD_UNCHANGED) gives.
//
// C++17 with the standard library alone (no libjpeg, no OpenCV), integer
// arithmetic throughout. It computes what libjpeg-turbo's default
// decompression computes, step for step, as `data/jpeg.py` (the plain
// version, which the tests hold bit-equal to cv2) does:
//   - markers: SOI; APPn and COM skipped (APP0 JFIF and APP14 Adobe noted);
//     DQT with 8- and 16-bit tables; SOF0, SOF1, SOF2; DHT; DRI; SOS; EOI.
//     Arithmetic coding, lossless, hierarchical, 12-bit and CMYK / YCCK
//     files throw, naming what they are;
//   - Huffman decode of sequential scans and of progressive ones (DC first
//     and refine, AC first and refine with EOB runs), restart intervals as
//     libjpeg's process_restart takes them. Where the entropy data ends
//     early (a truncated file), the MCU that runs out reads zero bits and
//     the MCUs after it are left as they are, as in libjpeg; a progressive
//     file whose scans leave AC coefficients 1-9 unfinished throws, since
//     libjpeg then smooths its blocks;
//   - the ISLOW IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2), its output
//     saturated to [-128, 127] and offset by 128, as the SIMD IDCT that
//     libjpeg-turbo runs on x86 and Arm takes it;
//   - jdsample.c's fancy upsampling (h2v1, h2v2 where the component is
//     wider than 2 samples; h1v2), replication for any other integral
//     factor; jdcolor.c's integer YCbCr -> RGB. Three components are RGB
//     when an Adobe marker with transform 0 and no JFIF marker say so, or
//     their ids are 'R', 'G', 'B' with neither marker.
// No EXIF orientation is applied (IMREAD_UNCHANGED applies none).
//
// In the library: `sodt_jpeg::decode` for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   jpeg_file_shape(path, &h, &w, &c, err, err_len)   -> 1 ok, 0 failed
//   jpeg_file_decode(path, out, h, w, c, err, err_len) -> 1 ok, 0 failed
// `out` is (h, w, c) uint8, C-contiguous: c = 1 gray, c = 3 RGB. A failure
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

void build_huffman(const uint8_t* counts, const uint8_t* syms, int n, bool dc,
                   Huffman& t) {
  if (dc)
    for (int i = 0; i < n; ++i)
      if (syms[i] > 15) throw JpegError("broken JPEG file (bad Huffman table)");
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
  std::array<int, 64> coef_bits;
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

constexpr const char* kTruncatedProgressive =
    "truncated progressive JPEG (libjpeg's block smoothing of partial "
    "coefficients is not mirrored)";

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
      if (m == 0xD9) {
        if (pos - 2 >= n_real_) truncated_ = true;
        break;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        Segment(pos);
        Sof(m);
        if (header_only) return;
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
                 (m >= 0xCD && m <= 0xCF)) {
        throw JpegError(std::string(SofName(m)) + " JPEG is not supported");
      } else if (m == 0xCC) {
        throw JpegError("arithmetic-coded JPEG (DAC) is not supported");
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
    // libjpeg's smoothing_ok: a progressive image whose scans left some of
    // AC coefficients 1-9 unsent or unrefined is smoothed, block by block,
    // from its neighbours' DCs; the port does not mirror that
    if (progressive_) {
      bool dc_known = true, ac_open = false;
      for (auto& c : comps_) {
        dc_known = dc_known && c.coef_bits[0] >= 0;
        for (int k = 1; k < 10; ++k) ac_open = ac_open || c.coef_bits[k] != 0;
      }
      if (dc_known && ac_open)
        throw JpegError(truncated_ ? kTruncatedProgressive
                                   : "progressive JPEG whose scans leave AC coefficients "
                                     "incomplete (libjpeg's block smoothing is not mirrored)");
    }
  }

  int width() const { return w_; }
  int height() const { return h_; }
  int channels() const { return int(comps_.size()) == 1 ? 1 : 3; }
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
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        throw JpegError("JPEG with fractional sampling ratios is not supported");
      planes.push_back(Upsample(Plane(c), c, hmax_ / c.h, vmax_ / c.v));
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
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
    if (rgb) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
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

 private:
  static const char* SofName(int m) {
    switch (m) {
      case 0xC3: return "lossless (SOF3)";
      case 0xC5: return "hierarchical (SOF5)";
      case 0xC6: return "hierarchical (SOF6)";
      case 0xC7: return "hierarchical lossless (SOF7)";
      case 0xC9: return "arithmetic-coded (SOF9)";
      case 0xCA: return "arithmetic-coded (SOF10)";
      case 0xCB: return "arithmetic-coded lossless (SOF11)";
      case 0xCD: return "hierarchical arithmetic-coded (SOF13)";
      case 0xCE: return "hierarchical arithmetic-coded (SOF14)";
      default: return "hierarchical arithmetic-coded (SOF15)";
    }
  }

  // the marker segment at pos into seg_; pos moves past it
  void Segment(size_t& pos) {
    size_t n = pos + 2 <= n_real_ ? (size_t(d_[pos]) << 8 | d_[pos + 1]) : 0;
    if (n < 2 || pos + n > n_real_) {
      if (progressive_ && n_scans_) throw JpegError(kTruncatedProgressive);
      throw JpegError("truncated JPEG file (marker segment)");
    }
    seg_.assign(d_.begin() + pos + 2, d_.begin() + pos + n);
    pos += n;
  }

  void Sof(int m) {
    if (have_frame_) throw JpegError("broken JPEG file (two frames)");
    if (seg_.size() < 6) throw JpegError("broken JPEG file (SOF)");
    int prec = seg_[0];
    h_ = seg_[1] << 8 | seg_[2];
    w_ = seg_[3] << 8 | seg_[4];
    int nc = seg_[5];
    if (prec != 8) throw JpegError(std::to_string(prec) + "-bit JPEG is not supported");
    if (!h_ || !w_)
      throw JpegError("unsupported image size " + std::to_string(w_) + " x " +
                      std::to_string(h_));
    if (lim_cols_ && (w_ != lim_cols_ || h_ < lim_rows_ || h_ > lim_top_))
      // a TIFF chunk's frame, refused before its coefficients are allocated
      throw JpegError("broken TIFF file (a JPEG strip or tile of " + std::to_string(w_) + " x " +
                      std::to_string(h_) + " for " + std::to_string(lim_cols_) + " x " +
                      std::to_string(lim_rows_) + ")");
    if (seg_.size() != size_t(6 + 3 * nc) || nc == 0) throw JpegError("broken JPEG file (SOF)");
    if (nc == 4) throw JpegError("CMYK / YCCK JPEG (4 components) is not supported");
    if (nc != 1 && nc != 3)
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
    progressive_ = m == 0xC2;
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

  void Dht() {
    size_t i = 0;
    while (i < seg_.size()) {
      if (i + 17 > seg_.size()) throw JpegError("broken JPEG file (DHT)");
      int tc = seg_[i] >> 4, th = seg_[i] & 15;
      int n = 0;
      for (int l = 0; l < 16; ++l) n += seg_[i + 1 + l];
      if (tc > 1 || th > 3 || n > 256 || i + 17 + n > seg_.size())
        throw JpegError("broken JPEG file (DHT)");
      build_huffman(&seg_[i + 1], &seg_[i + 17], n, tc == 0, huff_[tc][th]);
      i += 17 + n;
    }
  }

  const Huffman& Table(int tc, int th) {
    if (th > 3 || !huff_[tc][th].present) throw JpegError("broken JPEG file (Huffman table missing)");
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
    ScanKind kind = !progressive_ ? kSeq
                    : ss == 0     ? (ah == 0 ? kDcFirst : kDcRefine)
                                  : (ah == 0 ? kAcFirst : kAcRefine);
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
    for (int m = 0; m < n_mcu; ++m) {
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
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sc[i]];
      if (ss == 0) c.coef_bits[0] = al;
      for (int k = std::max(ss, 1); k <= se; ++k) c.coef_bits[k] = al;
    }
    return br.End();
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

  // jidctint.c on one block; out is 8 x 8 at `out` with row step `stride`
  static void Idct(const int16_t* in, const int32_t* q, uint8_t* out, size_t stride) {
    constexpr int kCb = 13, kP1 = 2;
    int32_t ws[64];
    auto pass = [](const int64_t* d, int64_t* o, int shift) {
      int64_t z2 = d[2], z3 = d[6];
      int64_t z1 = (z2 + z3) * 4433;
      int64_t tmp2 = z1 + z3 * -15137;
      int64_t tmp3 = z1 + z2 * 6270;
      int64_t tmp0 = (d[0] + d[4]) * (int64_t(1) << kCb);
      int64_t tmp1 = (d[0] - d[4]) * (int64_t(1) << kCb);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int64_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
      z1 = t0 + t3;
      z2 = t1 + t2;
      z3 = t0 + t2;
      int64_t z4 = t1 + t3;
      int64_t z5 = (z3 + z4) * 9633;
      t0 *= 2446;
      t1 *= 16819;
      t2 *= 25172;
      t3 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      t0 += z1 + z3;
      t1 += z2 + z4;
      t2 += z2 + z3;
      t3 += z1 + z4;
      const int64_t half = int64_t(1) << (shift - 1);
      o[0] = (tmp10 + t3 + half) >> shift;
      o[7] = (tmp10 - t3 + half) >> shift;
      o[1] = (tmp11 + t2 + half) >> shift;
      o[6] = (tmp11 - t2 + half) >> shift;
      o[2] = (tmp12 + t1 + half) >> shift;
      o[5] = (tmp12 - t1 + half) >> shift;
      o[3] = (tmp13 + t0 + half) >> shift;
      o[4] = (tmp13 - t0 + half) >> shift;
    };
    auto limit = [](int64_t v) { return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128); };
    int64_t d[8], o[8];
    // a column or row whose AC terms are all zero takes libjpeg's shortcut,
    // which equals the full pass's result
    for (int c = 0; c < 8; ++c) {  // columns
      bool ac = false;
      for (int r = 1; r < 8; ++r) ac |= in[r * 8 + c] != 0;
      if (!ac) {
        const int32_t dc = int32_t(int64_t(in[c]) * q[c] * (1 << kP1));
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        continue;
      }
      for (int r = 0; r < 8; ++r) d[r] = int64_t(in[r * 8 + c]) * q[r * 8 + c];
      pass(d, o, kCb - kP1);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = int32_t(o[r]);
    }
    for (int r = 0; r < 8; ++r) {  // rows
      const int32_t* w = ws + r * 8;
      uint8_t* row = out + r * stride;
      if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
        std::memset(row, limit((int64_t(w[0]) + (1 << (kP1 + 2))) >> (kP1 + 3)), 8);
        continue;
      }
      for (int c = 0; c < 8; ++c) d[c] = w[c];
      pass(d, o, kCb + kP1 + 3);
      for (int c = 0; c < 8; ++c) row[c] = limit(o[c]);
    }
  }

  // a component's samples, dh x dw
  std::vector<uint8_t> Plane(const Component& c) {
    std::vector<uint8_t> out(size_t(c.dw) * c.dh, 128);
    if (!c.have_qt) return out;  // never in a scan: libjpeg's zero multipliers
    std::array<int32_t, 64> q;
    for (int k = 0; k < 64; ++k) q[k] = int16_t(c.qt[k]);
    const size_t stride = size_t(c.pw) * 8;
    std::vector<uint8_t> full(stride * c.ph * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        Idct(c.coef.data() + (size_t(by) * c.pw + bx) * 64, q.data(),
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
  std::array<std::array<Huffman, 4>, 2> huff_;
  int restart_ = 0, n_scans_ = 0;
  bool jfif_ = false;
  int adobe_ = -1;
  bool have_frame_ = false, progressive_ = false, truncated_ = false;
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
// the pixels (h, w, c) into px. Throws JpegError with the cause.
void decode(const uint8_t* data, size_t n, int* h, int* w, int* c, std::vector<uint8_t>* px) {
  Decoder dec(data, n);
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

int jpeg_file_shape(const char* path, int* h, int* w, int* c, char* err, int err_len) {
  try {
    std::vector<uint8_t> data = sodt_jpeg::read_all(path);
    sodt_jpeg::Decoder dec(data.data(), data.size());
    dec.Run(true);
    if (!dec.width()) throw sodt_jpeg::JpegError("broken JPEG file (no frame header)");
    *h = dec.height();
    *w = dec.width();
    *c = dec.channels();
    return 1;
  } catch (const std::exception& e) {
    sodt_jpeg::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

int jpeg_file_decode(const char* path, uint8_t* out, int h, int w, int c, char* err,
                     int err_len) {
  try {
    std::vector<uint8_t> data = sodt_jpeg::read_all(path);
    int hh, ww, cc;
    std::vector<uint8_t> px;
    sodt_jpeg::decode(data.data(), data.size(), &hh, &ww, &cc, &px);
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
