// BMP decoder of the port: `data/bmp.py`'s decoder in C++17, standard
// library only. The numpy module is its plain version and the tests hold
// the two bit-equal; its doc has the table of kinds.
//
// Headers CORE (12 bytes), INFO (40), V2-V5 (52, 56, 64, 108, 124); rows
// bottom-up or top-down; 1-, 4-, 8-bit palettes, RLE8 and RLE4 (undone as
// OpenCV's grfmt_bmp.cpp undoes them: escapes move on through pixels no run
// sets, which keep palette index 0; a run past its row or a stream that
// ends early throws); 16 bits as 5-5-5 or 5-6-5; 24 bits; 32 bits, BI_RGB
// or BITFIELDS. More than 2^30 pixels throws before any is allocated, as
// OpenCV refuses them; `decode` throws above PIL's limit (2 x 89478485) on
// PIL's branch, as PIL's open does.
//
// Two layouts of the same decode:
//   decode      what the JAX package's `_read_image` returns (cv2 5.0 for
//               24 and 32 bits, PIL for palettes and 16 bits): (h, w, c)
//               samples of kind 0 (bool, stored 0 / 1) or 1 (uint8);
//   decode_bgr  what the JAX native loader's cv::imread(IMREAD_UNCHANGED)
//               (OpenCV 4.6) and its conversions leave before the resize:
//               (h, w) B G R bytes. Palette colours; a CORE file as gray,
//               (1868 B + 9617 G + 4899 R + 8192) >> 14; 16 bits widened by
//               shifts (5 bits << 3, 6 bits << 2); a 32-bit BITFIELDS field
//               of a V3-V5 header cut to its low byte; alpha dropped.
//               Where OpenCV reads the 16-bit masks of a V3-V5 header from
//               after it and fails, the masks are read in the header.
//
// In the library: sodt_bmp::decode_bgr for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   bmp_file_shape(path, &h, &w, &c, &kind, err, err_len)    -> 1 ok, 0 failed
//   bmp_file_decode(path, out, h, w, c, kind, err, err_len)  -> 1 ok, 0 failed
// A failure writes its cause, the file named, into err; a kind out of the
// port's scope (BI_JPEG, BI_PNG) starts its cause with "not implemented:".

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace sodt_bmp {

struct BmpError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

namespace {

constexpr int kRgb = 0, kRle8 = 1, kRle4 = 2, kBitfields = 3;
constexpr uint64_t kMaxPixels = uint64_t(1) << 30;     // OpenCV's limit
constexpr uint64_t kPilMaxPixels = 2 * 89478485ull;    // PIL's decompression bomb

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | p[1] << 8); }

struct Header {
  int w = 0, h = 0, bpp = 0, comp = 0, size = 0, n_pal = 0;
  bool core = false, top_down = false;
  size_t offset = 0;
  uint32_t masks[4] = {0, 0, 0, 0};  // r, g, b, a
  uint8_t pal[256][3] = {};          // B G R, black past the palette
};

Header parse(const uint8_t* d, size_t n) {
  if (n < 18 || d[0] != 'B' || d[1] != 'M') throw BmpError("not a BMP file (signature)");
  Header hd;
  hd.offset = le32(d + 10);
  hd.size = int(le32(d + 14));
  static const int sizes[] = {12, 40, 52, 56, 64, 108, 124};
  if (!std::count(std::begin(sizes), std::end(sizes), hd.size))
    throw BmpError("broken BMP file (header size " + std::to_string(hd.size) + ")");
  if (n < size_t(14 + hd.size)) throw BmpError("truncated BMP file (header)");
  hd.core = hd.size == 12;
  uint32_t clr_used = 0;
  if (hd.core) {
    hd.w = le16(d + 18);
    hd.h = le16(d + 20);
    hd.bpp = le16(d + 24);
    hd.comp = kRgb;
  } else {
    hd.w = int32_t(le32(d + 18));
    int32_t h = int32_t(le32(d + 22));
    hd.bpp = le16(d + 28);
    hd.comp = int(le32(d + 30));
    clr_used = le32(d + 46);
    hd.top_down = h < 0;
    hd.h = h < 0 ? -h : h;
  }
  if (hd.comp == 4 || hd.comp == 5)
    throw BmpError(std::string("not implemented: a BMP image with embedded ") +
                   (hd.comp == 4 ? "JPEG data (compression 4)" : "PNG data (compression 5)") +
                   "; the port reads BI_RGB, RLE8, RLE4 and BITFIELDS bitmaps");
  bool ok;
  switch (hd.comp) {
    case kRgb: ok = hd.bpp == 1 || hd.bpp == 4 || hd.bpp == 8 || hd.bpp == 16 ||
                    hd.bpp == 24 || hd.bpp == 32; break;
    case kRle8: ok = hd.bpp == 8; break;
    case kRle4: ok = hd.bpp == 4; break;
    case kBitfields: ok = hd.bpp == 16 || hd.bpp == 24 || hd.bpp == 32; break;
    default: ok = false;
  }
  if (hd.core && hd.bpp != 1 && hd.bpp != 4 && hd.bpp != 8 && hd.bpp != 24) ok = false;
  if (hd.w <= 0 || hd.h <= 0 || hd.w > (1 << 16) || hd.h > (1 << 16) || !ok)
    throw BmpError("broken BMP file (" + std::to_string(hd.w) + " x " + std::to_string(hd.h) +
                   ", " + std::to_string(hd.bpp) + " bits, compression " +
                   std::to_string(hd.comp) + ")");
  // OpenCV's CV_IO_MAX_IMAGE_PIXELS, checked before a pixel is allocated:
  // an RLE bitmap of any size fits in a few bytes of escapes
  if (uint64_t(hd.w) * uint64_t(hd.h) > kMaxPixels)
    throw BmpError("image too large (" + std::to_string(hd.w) + " x " + std::to_string(hd.h) +
                   " pixels; OpenCV reads at most 2^30)");
  size_t pos = 14 + size_t(hd.size);
  if (hd.comp == kBitfields) {
    // offset 54: after an INFO header, inside any longer one
    if (n < 54 + 12) throw BmpError("truncated BMP file (bitfields)");
    for (int i = 0; i < 3; ++i) hd.masks[i] = le32(d + 54 + 4 * i);
    if (hd.size >= 56) hd.masks[3] = le32(d + 14 + 52);
    if (hd.size == 40) pos += 12;
  }
  if (hd.bpp <= 8) {
    hd.n_pal = clr_used ? int(clr_used) : 1 << hd.bpp;
    if (clr_used > 256) throw BmpError("broken BMP file (" + std::to_string(clr_used) + " colours)");
    const size_t step = hd.core ? 3 : 4;
    for (int i = 0; i < hd.n_pal && pos + (i + 1) * step <= n; ++i)
      std::memcpy(hd.pal[i], d + pos + i * step, 3);
  }
  if (hd.bpp == 16) {
    if (hd.comp == kRgb) {
      hd.masks[0] = 0x7C00, hd.masks[1] = 0x3E0, hd.masks[2] = 0x1F;
    }
    bool m555 = hd.masks[0] == 0x7C00 && hd.masks[1] == 0x3E0 && hd.masks[2] == 0x1F;
    bool m565 = hd.masks[0] == 0xF800 && hd.masks[1] == 0x7E0 && hd.masks[2] == 0x1F;
    if (!m555 && !m565) throw BmpError("unsupported BMP bitfields layout");
  }
  return hd;
}

// The decoded bitmap, rows top-down: one index a pixel (1-8 bits), one
// uint16 (16 bits), or the pixel's 3 or 4 bytes (24, 32 bits).
struct Pixels {
  std::vector<uint8_t> b;     // indices or bytes
  std::vector<uint16_t> v16;  // 16-bit samples
};

// OpenCV's FillUniColor in index space: `count` pixels of `value` from
// (x, y) on, wrapping to the next row.
void fill(uint8_t* out, int& x, int& y, long count, int w, int h, uint8_t value) {
  for (;;) {
    long end = std::min<long>(x + count, w);
    count -= end - x;
    std::memset(out + size_t(y) * w + x, value, size_t(end - x));
    x = int(end);
    if (x >= w) {
      x = 0;
      if (++y >= h) break;
    }
    if (count <= 0) break;
  }
}

void rle(const uint8_t* d, size_t n, const Header& hd, uint8_t* out) {
  const int w = hd.w, h = hd.h;
  const bool rle4 = hd.comp == kRle4;
  size_t pos = hd.offset;
  int x = 0, y = 0, line_end_flag = 0;
  auto take = [&](size_t k) {
    if (pos > n || n - pos < k) throw BmpError("truncated BMP file (RLE data ends before the bitmap)");
    pos += k;
    return d + pos - k;
  };
  for (;;) {
    const uint8_t* p = take(2);
    int count = p[0], code = p[1];
    if (count) {  // a run
      if (x + count > w) throw BmpError("broken BMP file (an RLE run past the end of its row)");
      if (rle4) {
        for (int i = 0; i < count; ++i)
          out[size_t(y) * w + x + i] = uint8_t(i & 1 ? code & 15 : code >> 4);
        x += count;
        continue;
      }
      int prev = y;
      fill(out, x, y, count, w, h, uint8_t(code));
      line_end_flag = y - prev;
      if (y >= h) break;
    } else if (code > 2) {  // literal pixels
      if (x + code > w)
        throw BmpError("broken BMP file (RLE literal pixels past the end of its row)");
      uint8_t* row = out + size_t(y) * w + x;
      if (rle4) {
        const uint8_t* s = take(size_t((((code + 1) >> 1) + 1) & ~1));
        for (int i = 0; i < code; ++i) row[i] = uint8_t(i & 1 ? s[i >> 1] & 15 : s[i >> 1] >> 4);
      } else {
        std::memcpy(row, take(size_t((code + 1) & ~1)), size_t(code));
      }
      x += code;
      line_end_flag = 0;
    } else {  // end of line, end of bitmap, delta
      long dx = w - x, dy = h - y;
      if (rle4 || code || !line_end_flag || dx < w) {
        if (code == 2) {
          const uint8_t* q = take(2);
          dx = q[0];
          dy = q[1];
        }
        if (y >= h) break;
        fill(out, x, y, dx + (code ? dy * w : 0), w, h, 0);
        if (y >= h) break;
      }
      line_end_flag = 0;
      if (y >= h) break;
    }
  }
}

Pixels pixels(const uint8_t* d, size_t n, const Header& hd) {
  Pixels px;
  const size_t w = size_t(hd.w), h = size_t(hd.h);
  auto row_of = [&](size_t y) { return hd.top_down ? y : h - 1 - y; };  // file row of image row y
  if (hd.comp == kRle8 || hd.comp == kRle4) {
    std::vector<uint8_t> file(w * h, 0);
    rle(d, n, hd, file.data());
    px.b.resize(w * h);
    for (size_t y = 0; y < h; ++y) std::memcpy(&px.b[y * w], &file[row_of(y) * w], w);
    return px;
  }
  const size_t stride = (w * hd.bpp + 31) / 32 * 4;
  if (hd.offset > n || (n - hd.offset) / stride < h) throw BmpError("truncated BMP file (pixel data)");
  const uint8_t* base = d + hd.offset;
  if (hd.bpp <= 8) {
    px.b.resize(w * h);
    for (size_t y = 0; y < h; ++y) {
      const uint8_t* r = base + row_of(y) * stride;
      uint8_t* o = &px.b[y * w];
      if (hd.bpp == 8) {
        std::memcpy(o, r, w);
        continue;
      }
      const int bits = hd.bpp, mask = (1 << bits) - 1;
      for (size_t x = 0; x < w; ++x) {
        size_t bit = x * bits;
        o[x] = uint8_t((r[bit >> 3] >> (8 - bits - int(bit & 7))) & mask);
      }
    }
  } else if (hd.bpp == 16) {
    px.v16.resize(w * h);
    for (size_t y = 0; y < h; ++y) {
      const uint8_t* r = base + row_of(y) * stride;
      for (size_t x = 0; x < w; ++x) px.v16[y * w + x] = le16(r + 2 * x);
    }
  } else {
    const size_t k = size_t(hd.bpp / 8);
    px.b.resize(w * h * k);
    for (size_t y = 0; y < h; ++y) std::memcpy(&px.b[y * w * k], base + row_of(y) * stride, w * k);
  }
  return px;
}

uint8_t gray_of(int b, int g, int r) {  // cv2's BGR -> gray
  return uint8_t((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14);
}

bool is_565(const Header& hd) { return hd.masks[0] == 0xF800; }

// (field of mask in v, shifted down, its largest value)
void field(uint32_t v, uint32_t mask, uint32_t* f, uint32_t* top) {
  int shift = 0;
  while (!((mask >> shift) & 1)) ++shift;
  *f = (v & mask) >> shift;
  *top = mask >> shift;
}

// 1-bit, two colours, black then white: PIL's mode "1"
bool pil_bilevel(const Header& hd) {
  static const uint8_t black[3] = {0, 0, 0}, white[3] = {255, 255, 255};
  return hd.bpp == 1 && hd.n_pal == 2 && !std::memcmp(hd.pal[0], black, 3) &&
         !std::memcmp(hd.pal[1], white, 3);
}

void shape_of(const Header& hd, int* c, int* kind) {
  if (hd.bpp <= 16 && uint64_t(hd.w) * uint64_t(hd.h) > kPilMaxPixels)  // PIL's branch
    throw BmpError("decompression bomb (" + std::to_string(hd.w) + " x " + std::to_string(hd.h) +
                   " pixels; PIL opens at most " + std::to_string(kPilMaxPixels) + ")");
  *kind = hd.bpp == 1 && pil_bilevel(hd) ? 0 : 1;
  if (hd.bpp <= 8) {
    *c = 1;
  } else if (hd.bpp == 16) {
    *c = 3;
  } else if (hd.bpp == 24) {
    if (hd.comp == kBitfields) throw BmpError("broken BMP file (24-bit BITFIELDS, which cv2 does not read)");
    *c = hd.core ? 1 : 3;
  } else {
    *c = hd.comp == kBitfields ? 4 : 3;
  }
}

std::vector<uint8_t> read_all(const char* path) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path, "rb"), std::fclose);
  if (!f) throw BmpError(std::string("cannot open the file (") + std::strerror(errno) + ")");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f.get())) > 0) data.insert(data.end(), buf, buf + got);
  if (std::ferror(f.get())) throw BmpError("cannot read the file");
  return data;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) {
    std::snprintf(err, size_t(err_len), "%s", msg.c_str());
  }
}

}  // namespace

// `_read_image`'s layout (module doc of data/bmp.py)
void decode(const uint8_t* d, size_t n, int* h, int* w, int* c, int* kind,
            std::vector<uint8_t>* out) {
  const Header hd = parse(d, n);
  shape_of(hd, c, kind);
  const Pixels px = pixels(d, n, hd);
  *h = hd.h;
  *w = hd.w;
  const size_t np = size_t(hd.h) * hd.w;
  out->resize(np * *c);
  uint8_t* o = out->data();
  if (hd.bpp <= 8) {
    for (size_t i = 0; i < np; ++i) o[i] = *kind == 0 ? px.b[i] != 0 : px.b[i];
  } else if (hd.bpp == 16) {  // PIL's BGR;15 / BGR;16 unpackers
    const bool m565 = is_565(hd);
    for (size_t i = 0; i < np; ++i, o += 3) {
      int v = px.v16[i];
      int r = m565 ? (v >> 11) & 31 : (v >> 10) & 31, g = m565 ? (v >> 5) & 63 : (v >> 5) & 31;
      o[0] = uint8_t(r * 255 / 31);
      o[1] = uint8_t(g * 255 / (m565 ? 63 : 31));
      o[2] = uint8_t((v & 31) * 255 / 31);
    }
  } else if (hd.bpp == 24) {
    for (size_t i = 0; i < np; ++i) {
      const uint8_t* s = &px.b[3 * i];
      if (hd.core) {
        o[i] = gray_of(s[0], s[1], s[2]);
      } else {
        o[3 * i] = s[2], o[3 * i + 1] = s[1], o[3 * i + 2] = s[0];
      }
    }
  } else if (*c == 3) {
    for (size_t i = 0; i < np; ++i) {
      const uint8_t* s = &px.b[4 * i];
      o[3 * i] = s[2], o[3 * i + 1] = s[1], o[3 * i + 2] = s[0];
    }
  } else {
    const bool masked = hd.size >= 56 && hd.masks[0] && hd.masks[1] && hd.masks[2];
    const uint32_t order[4] = {hd.masks[3], hd.masks[0], hd.masks[1], hd.masks[2]};
    for (size_t i = 0; i < np; ++i) {
      const uint8_t* s = &px.b[4 * i];
      for (int k = 0; k < 4; ++k) {
        if (!masked) {
          o[4 * i + k] = s[3 - k];
        } else if (!order[k]) {
          o[4 * i + k] = 255;
        } else {  // cv2 5.0 widens each field: f * 255 / max
          uint32_t f, top;
          field(le32(s), order[k], &f, &top);
          o[4 * i + k] = uint8_t(uint64_t(f) * 255 / top);
        }
      }
    }
  }
}

// the JAX native loader's pixels, B G R (header comment)
void decode_bgr(const uint8_t* d, size_t n, int* h, int* w, std::vector<uint8_t>* bgr) {
  const Header hd = parse(d, n);
  if (hd.bpp == 24 && hd.comp == kBitfields)
    throw BmpError("broken BMP file (24-bit BITFIELDS, which OpenCV does not read)");
  const Pixels px = pixels(d, n, hd);
  *h = hd.h;
  *w = hd.w;
  const size_t np = size_t(hd.h) * hd.w;
  bgr->resize(np * 3);
  uint8_t* o = bgr->data();
  const bool masked = hd.bpp == 32 && hd.comp == kBitfields && hd.size >= 56 && hd.masks[0] &&
                      hd.masks[1] && hd.masks[2];
  for (size_t i = 0; i < np; ++i, o += 3) {
    if (hd.bpp <= 8) {
      const uint8_t* c = hd.pal[px.b[i]];
      if (hd.core) {
        o[0] = o[1] = o[2] = gray_of(c[0], c[1], c[2]);
      } else {
        std::memcpy(o, c, 3);
      }
    } else if (hd.bpp == 16) {  // OpenCV widens by shifts
      int v = px.v16[i];
      o[0] = uint8_t((v & 31) << 3);
      if (is_565(hd)) {
        o[1] = uint8_t(((v >> 5) & 63) << 2);
        o[2] = uint8_t(((v >> 11) & 31) << 3);
      } else {
        o[1] = uint8_t(((v >> 5) & 31) << 3);
        o[2] = uint8_t(((v >> 10) & 31) << 3);
      }
    } else if (hd.bpp == 24) {
      const uint8_t* s = &px.b[3 * i];
      if (hd.core) {
        o[0] = o[1] = o[2] = gray_of(s[0], s[1], s[2]);
      } else {
        std::memcpy(o, s, 3);
      }
    } else if (masked) {  // OpenCV 4.6 casts each field to a byte
      const uint32_t v = le32(&px.b[4 * i]);
      for (int k = 0; k < 3; ++k) {
        uint32_t f, top;
        field(v, hd.masks[2 - k], &f, &top);
        o[k] = uint8_t(f & 0xFF);
      }
    } else {
      std::memcpy(o, &px.b[4 * i], 3);
    }
  }
}

}  // namespace sodt_bmp

extern "C" {

int bmp_file_shape(const char* path, int* h, int* w, int* c, int* kind, char* err, int err_len) {
  try {
    std::vector<uint8_t> data = sodt_bmp::read_all(path);
    const sodt_bmp::Header hd = sodt_bmp::parse(data.data(), data.size());
    sodt_bmp::shape_of(hd, c, kind);
    *h = hd.h;
    *w = hd.w;
    return 1;
  } catch (const std::exception& e) {
    sodt_bmp::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

int bmp_file_decode(const char* path, uint8_t* out, int h, int w, int c, int kind, char* err,
                    int err_len) {
  try {
    std::vector<uint8_t> data = sodt_bmp::read_all(path);
    int hh, ww, cc, kk;
    std::vector<uint8_t> px;
    sodt_bmp::decode(data.data(), data.size(), &hh, &ww, &cc, &kk, &px);
    if (hh != h || ww != w || cc != c || kk != kind)
      throw sodt_bmp::BmpError("the file changed between the shape query and the decode");
    std::memcpy(out, px.data(), px.size());
    return 1;
  } catch (const std::exception& e) {
    sodt_bmp::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

}  // extern "C"
