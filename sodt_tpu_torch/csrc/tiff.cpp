// TIFF decoder of the port: `data/tiff.py`'s decoder in C++17, standard
// library only. The numpy module is its plain version and the tests hold
// the two bit-equal; its doc has the table of kinds.
//
// Byte order II and MM, classic TIFF and BigTIFF, the first IFD; strips and
// tiles; planar configuration 1 and 2; compression none, LZW (libtiff's
// LZWDecode: MSB-first codes of 9-12 bits, the width one code early),
// deflate (through the tile loader's inflate, `sodt_inflate::inflate`) and
// PackBits; predictor 1 and 2; photometric MinIsWhite, MinIsBlack, RGB and
// palette, 1, 2, 4, 8 and 16 bits, one extra sample at most. A strip past
// the end of the file throws. A strip whose compressed data stops short or
// breaks (a bad LZW code, a bad deflate stream) is filled as libtiff's RGBA
// reader leaves it, the bytes that came before the fault and zeros, the
// predictor not undone, wherever OpenCV reads the kind through that reader
// (8 bits and fewer); elsewhere it throws, as PIL and OpenCV's 16-bit read
// fail. A 16-bit palette throws: no reader takes one, nor more than 2^30
// pixels (OpenCV) or, on PIL's branch of `decode`, more than 2 x 89478485
// (PIL's open). A kind out of the
// port's scope (JPEG, CCITT and other compressions, float, signed or 32-bit
// samples, FillOrder 2, photometrics other than 0-3, ...) throws a cause
// that starts "not implemented:".
//
// Two layouts of the same decode:
//   decode      what the JAX package's `_read_image` returns (cv2 5.0 for
//               8-bit gray and RGB, PIL for palettes, 1-, 2-, 4- and 16-bit
//               samples): (h, w, c) samples of kind 0 (bool, stored 0 / 1),
//               1 (uint8) or 2 (uint16);
//   decode_bgr  what the JAX native loader's cv::imread(IMREAD_UNCHANGED)
//               (OpenCV 4.6, libtiff) and its conversions leave before the
//               resize: (h, w) B G R bytes. Gray widened (MinIsWhite
//               inverted below 16 bits; 1, 2, 4 bits scaled to 0-255);
//               8-bit RGB with unassociated alpha premultiplied, (c a + 127)
//               / 255, as libtiff's RGBA reader leaves it, alpha dropped;
//               16-bit samples saturated to 255; palette colours from the
//               colour map (its samples >> 8, or as they are where every one
//               is below 256, as libtiff's checkcmap decides), a 1-bit
//               palette image as gray, (1868 B + 9617 G + 4899 R + 8192) >>
//               14; turned by the Orientation tag (2-8). Where OpenCV reads
//               nothing (2- and 4-bit gray, 4.6 and 2- or 4-bit palettes) or
//               misreads (16-bit planar configuration 2), the samples are
//               read as the format says. A broken deflate strip keeps
//               zlib's bytes (cv2 5.0's): OpenCV 4.6's libtiff inflates
//               with libdeflate, which leaves a few bytes of its own just
//               before the fault.
//
// In the library: sodt_tiff::decode_bgr for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   tiff_file_shape(path, &h, &w, &c, &kind, err, err_len)    -> 1 ok, 0 failed
//   tiff_file_decode(path, out, h, w, c, kind, err, err_len)  -> 1 ok, 0 failed

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

// csrc/tile_loader.cpp: a strip's deflate data in[0, n) -> its first `need`
// bytes in `out`, as libtiff reads them with zlib; "" or the cause of the
// fault, `out` then holding the bytes that came before it, zeros after
namespace sodt_inflate {
std::string inflate_prefix(const uint8_t* in, size_t n, size_t need, std::vector<uint8_t>* out);
}  // namespace sodt_inflate

namespace sodt_tiff {

struct TiffError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

namespace {

constexpr uint64_t kMaxPixels = uint64_t(1) << 30;     // OpenCV's limit
constexpr uint64_t kPilMaxPixels = 2 * 89478485ull;    // PIL's decompression bomb

TiffError out_of_scope(const std::string& what) {
  return TiffError("not implemented: a TIFF image with " + what +
                   "; the port reads uncompressed, LZW, deflate and PackBits gray, RGB and "
                   "palette images of 1-16 bits");
}

struct Reader {
  const uint8_t* d;
  size_t n;
  bool be;
  uint64_t u(size_t at, int bytes) const {
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i)
      v |= uint64_t(d[at + (be ? bytes - 1 - i : i)]) << (8 * i);
    return v;
  }
};

// tag type -> bytes a value takes; 0: not an integer type the decoder reads
int type_size(int typ) {
  switch (typ) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}
bool is_int_type(int typ) { return typ != 2 && typ != 5 && typ != 7 && typ != 10 && typ != 11 && typ != 12; }

using Tags = std::map<int, std::vector<int64_t>>;

// the first IFD as libtiff reads it: any short read throws
Tags walk_ifd(const Reader& r, bool* big) {
  const uint8_t* d = r.d;
  *big = d[2] == (r.be ? 0 : 43) && d[3] == (r.be ? 43 : 0);
  if (*big && (r.n < 16 || r.u(4, 2) != 8 || r.u(6, 2) != 0))
    throw TiffError("broken BigTIFF header");
  const size_t head = *big ? 16 : 8;
  if (r.n < head) throw TiffError("truncated TIFF file (header)");
  const int ob = *big ? 8 : 4, cb = *big ? 8 : 2, ent = *big ? 20 : 12;
  uint64_t pos = r.u(*big ? 8 : 4, ob);
  if (!pos) throw TiffError("broken TIFF file (no IFD)");
  auto broken = [](const std::string& why) { return TiffError("broken TIFF file (" + why + ")"); };
  if (pos > r.n || r.n - pos < uint64_t(cb)) throw broken("IFD past the end of the file");
  uint64_t count = r.u(pos, cb);
  pos += cb;
  Tags tags;
  for (uint64_t e = 0; e < count; ++e, pos += ent) {
    if (pos > r.n || r.n - pos < uint64_t(ent)) throw broken("IFD cut short");
    int tag = int(r.u(pos, 2)), typ = int(r.u(pos + 2, 2));
    uint64_t cnt = r.u(pos + 4, ob);
    const uint64_t field = pos + (*big ? 12 : 8);
    const int sz = type_size(typ);
    if (!sz) continue;
    if (cnt > (uint64_t(1) << 32) / sz) throw broken("tag " + std::to_string(tag) + " too long");
    uint64_t size = cnt * sz, at = field;
    if (size > uint64_t(ob)) {
      at = r.u(field, ob);
      if (at > r.n || r.n - at < size)
        throw broken("tag " + std::to_string(tag) + "'s data past the end of the file");
    }
    if (!size || !is_int_type(typ)) continue;
    std::vector<int64_t> vals(cnt);
    const bool sgn = typ == 6 || typ == 8 || typ == 9 || typ == 17;
    for (uint64_t i = 0; i < cnt; ++i) {
      uint64_t v = r.u(at + i * sz, sz);
      if (sgn && sz < 8 && (v >> (8 * sz - 1)) & 1) v |= ~uint64_t(0) << (8 * sz);
      vals[i] = int64_t(v);
    }
    tags[tag] = std::move(vals);
  }
  return tags;
}

int64_t one(const Tags& t, int tag, int64_t dflt) {
  auto it = t.find(tag);
  return it == t.end() || it->second.empty() ? dflt : it->second[0];
}

struct Info {
  int w = 0, h = 0, comp = 1, photo = 1, spp = 1, bits = 1, pred = 1, planes = 1, orient = 1;
  std::vector<int64_t> extra, offsets, counts, cmap;  // cmap: R..., G..., B...
  bool tiled = false, have_counts = false, be = false, big = false;
  int tw = 0, th = 0, across = 0, down = 0;
};

Info info_of(const uint8_t* d, size_t n) {
  if (n < 4 || !(std::memcmp(d, "II*\0", 4) == 0 || std::memcmp(d, "MM\0*", 4) == 0 ||
                 std::memcmp(d, "II+\0", 4) == 0 || std::memcmp(d, "MM\0+", 4) == 0))
    throw TiffError("not a TIFF file (signature)");
  Reader r{d, n, d[0] == 'M'};
  bool big;
  const Tags t = walk_ifd(r, &big);
  Info in;
  in.be = r.be;
  in.big = big;
  const int64_t w = one(t, 256, 0), h = one(t, 257, 0);
  if (w <= 0 || h <= 0) throw TiffError("broken TIFF file (no image size)");
  if (w > (1 << 16) || h > (1 << 16))
    throw TiffError("unsupported image size " + std::to_string(w) + " x " + std::to_string(h));
  if (uint64_t(w) * uint64_t(h) > kMaxPixels)
    throw TiffError("image too large (" + std::to_string(w) + " x " + std::to_string(h) +
                    " pixels; OpenCV reads at most 2^30)");
  in.w = int(w), in.h = int(h);
  in.comp = int(one(t, 259, 1));
  const int64_t photo = one(t, 262, -1);
  in.spp = int(one(t, 277, 1));
  std::vector<int64_t> bps = t.count(258) ? t.at(258) : std::vector<int64_t>{1};
  std::vector<int64_t> sf = t.count(339) ? t.at(339) : std::vector<int64_t>{1};
  // libtiff knows the Predictor tag only with the codecs that take it
  in.pred = in.comp == 5 || in.comp == 8 || in.comp == 32946 ? int(one(t, 317, 1)) : 1;
  const int64_t fill = one(t, 266, 1), planar = one(t, 284, 1);
  if (t.count(338)) in.extra = t.at(338);
  static const std::map<int, std::string> comp_names = {
      {2, "CCITT RLE (2)"}, {3, "CCITT Group 3 (3)"}, {4, "CCITT Group 4 (4)"},
      {6, "old-style JPEG (6)"}, {7, "JPEG (7)"}, {34712, "JPEG 2000 (34712)"},
      {34925, "LZMA (34925)"}, {50000, "Zstandard (50000)"}, {50001, "WebP (50001)"}};
  static const std::map<int, std::string> photo_names = {
      {4, "transparency mask (4)"}, {5, "CMYK (5)"}, {6, "YCbCr (6)"}, {8, "CIELab (8)"},
      {9, "ICCLab (9)"}, {10, "ITULab (10)"}, {32844, "LogL (32844)"},
      {32845, "LogLuv (32845)"}, {32803, "CFA (32803)"}, {34892, "LinearRaw (34892)"}};
  if (in.comp != 1 && in.comp != 5 && in.comp != 8 && in.comp != 32946 && in.comp != 32773) {
    auto it = comp_names.find(in.comp);
    throw out_of_scope(it != comp_names.end() ? it->second
                                              : "compression " + std::to_string(in.comp));
  }
  if (photo < 0) throw TiffError("broken TIFF file (no photometric interpretation)");
  if (photo > 3) {
    auto it = photo_names.find(int(photo));
    throw out_of_scope("photometric " +
                       (it != photo_names.end() ? it->second : std::to_string(photo)));
  }
  in.photo = int(photo);
  for (int64_t b : bps)
    if (b != bps[0]) {
      std::string all;
      for (int64_t v : bps) all += (all.empty() ? "" : ", ") + std::to_string(v);
      throw out_of_scope("mixed bits per sample (" + all + ")");
    }
  in.bits = int(bps[0]);
  int64_t sf_max = 1;
  for (int64_t s : sf) sf_max = std::max(sf_max, s);
  if (sf_max != 1)
    throw out_of_scope(std::string(sf_max == 2 ? "signed" : sf_max == 3 ? "floating-point" : "other") +
                       " samples (SampleFormat " + std::to_string(sf_max) + ")");
  if (in.bits != 1 && in.bits != 2 && in.bits != 4 && in.bits != 8 && in.bits != 16)
    throw out_of_scope(std::to_string(in.bits) + "-bit samples");
  if (in.pred != 1 && in.pred != 2) throw out_of_scope("predictor " + std::to_string(in.pred));
  if (fill != 1) throw out_of_scope("FillOrder " + std::to_string(fill));
  const int colours = in.photo == 2 ? 3 : 1;
  if (in.spp - colours != 0 && in.spp - colours != 1)
    throw out_of_scope(std::to_string(in.spp) + " samples per pixel (photometric " +
                       std::to_string(in.photo) + ")");
  const bool extra = in.spp > colours;
  if (extra && in.photo == 3) throw out_of_scope("a palette and an extra sample");
  if (extra && in.bits == 16 && in.photo < 2) throw out_of_scope("16-bit gray and an extra sample");
  if (extra && in.bits < 8)
    throw out_of_scope(std::to_string(in.bits) + "-bit samples and an extra sample");
  if (in.photo == 2 && in.bits < 8) throw out_of_scope(std::to_string(in.bits) + "-bit RGB");
  if (in.photo == 3 && in.bits > 8)
    throw TiffError("unreadable TIFF (a " + std::to_string(in.bits) +
                    "-bit palette, which neither libtiff nor PIL reads)");
  if (in.pred == 2 && in.bits < 8)
    throw TiffError("broken TIFF file (predictor 2 with " + std::to_string(in.bits) +
                    "-bit samples)");
  if (in.photo == 3) {
    auto it = t.find(320);
    if (it == t.end() || it->second.size() < size_t(3) << in.bits)
      throw TiffError("broken TIFF file (no colour map)");
    in.cmap.assign(it->second.begin(), it->second.begin() + (size_t(3) << in.bits));
  }
  in.tiled = t.count(322) || t.count(324);
  const std::vector<int64_t>* offs;
  const std::vector<int64_t>* cnts;
  if (in.tiled) {
    in.tw = int(one(t, 322, 0));
    in.th = int(one(t, 323, 0));
    offs = t.count(324) ? &t.at(324) : nullptr;
    cnts = t.count(325) ? &t.at(325) : nullptr;
    if (in.tw <= 0 || in.th <= 0 || !offs) throw TiffError("broken TIFF file (tiles)");
  } else {
    in.tw = in.w;
    int64_t rps = one(t, 278, in.h);
    in.th = int(rps <= 0 || rps > in.h ? in.h : rps);
    offs = t.count(273) ? &t.at(273) : nullptr;
    cnts = t.count(279) ? &t.at(279) : nullptr;
    if (!offs) throw TiffError("broken TIFF file (no strips)");
  }
  in.planes = planar == 2 && in.spp > 1 ? in.spp : 1;
  in.across = (in.w + in.tw - 1) / in.tw;
  in.down = (in.h + in.th - 1) / in.th;
  const size_t chunks = size_t(in.across) * in.down * in.planes;
  if (offs->size() < chunks || (cnts && cnts->size() < offs->size()))
    throw TiffError("broken TIFF file (" + std::to_string(offs->size()) + " of " +
                    std::to_string(chunks) + " strips or tiles)");
  if (!cnts && in.comp != 1) throw TiffError("broken TIFF file (no byte counts)");
  // no codec makes more than `ratio` bytes of a byte of its data: a file
  // that claims more pixels than that is refused before they are allocated
  const uint64_t ratio = in.comp == 1 ? 1 : in.comp == 5 ? 4096 : in.comp == 32773 ? 128 : 1032;
  const uint64_t need = uint64_t(in.tiled ? in.down * in.th : in.h) * in.across * in.planes *
                        ((uint64_t(in.tw) * (in.spp / in.planes) * in.bits + 7) / 8);
  if (need > ratio * n)
    throw TiffError("broken TIFF file (" + std::to_string(in.w) + " x " + std::to_string(in.h) +
                    " pixels, more than its " + std::to_string(n) + " bytes can hold)");
  in.offsets = *offs;
  if (cnts) in.counts = *cnts;
  in.have_counts = cnts != nullptr;
  in.orient = int(one(t, 274, 1));
  return in;
}

// ---------------------------------------------------------------- codecs

// A strip or tile's codec: fills out[0, need) and returns "", or stops at
// the first fault and returns its cause, `out` holding the bytes that came
// before it, zeros after (libtiff's decoders leave a strip so).
std::string lzw(const uint8_t* src, size_t n, size_t need, std::vector<uint8_t>* out) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    throw TiffError("not implemented: a TIFF image with old-style LZW codes (LSB-first)");
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) prefix[i] = 0, suffix[i] = first[i] = uint8_t(i), length[i] = 1;
  out->assign(need, 0);
  size_t got = 0;
  int next = 258, nbits = 9, prev = -1;
  uint32_t buf = 0;
  int nb = 0;
  size_t pos = 0;
  std::vector<uint8_t> str(4096);
  while (got < need) {
    while (nb < nbits && pos < n) {
      buf = (buf << 8) | src[pos++];
      nb += 8;
    }
    if (nb < nbits) break;  // the data ends: taken as EOI
    nb -= nbits;
    int code = int(buf >> nb);
    buf &= (1u << nb) - 1;
    if (code == 256) {
      next = 258, nbits = 9, prev = -1;
      continue;
    }
    if (code == 257) break;
    int len;
    if (prev < 0) {
      if (code > 255) return "broken LZW data (code " + std::to_string(code) + " after a clear code)";
      str[0] = uint8_t(code);
      len = 1;
    } else {
      if (code > next)
        return "broken LZW data (code " + std::to_string(code) + " not yet in the table)";
      const int base = code < next ? code : prev;
      len = length[base];
      for (int c = base, i = len - 1; i >= 0; --i, c = prefix[c]) str[i] = suffix[c];
      if (code == next) str[len++] = first[prev];
      if (next < 4096) {
        prefix[next] = uint16_t(prev);
        suffix[next] = str[0];
        first[next] = first[prev];
        length[next] = uint16_t(length[prev] + 1);
        ++next;
      }
    }
    const size_t take = std::min(size_t(len), need - got);
    std::memcpy(out->data() + got, str.data(), take);
    got += take;
    prev = code;
    if (next + 1 >= (1 << nbits) && nbits < 12) ++nbits;
  }
  if (got < need)
    return "truncated TIFF file (LZW data ends after " + std::to_string(got) + " of " +
           std::to_string(need) + " bytes)";
  return "";
}

// libtiff's PackBitsDecode: a literal run the data cuts short is dropped
std::string packbits(const uint8_t* src, size_t n, size_t need, std::vector<uint8_t>* out) {
  out->assign(need, 0);
  size_t got = 0, i = 0;
  while (got < need && i < n) {
    int c = src[i++];
    if (c < 128) {
      const size_t take = std::min<size_t>(c + 1, need - got);
      if (n - i < take) break;
      std::memcpy(out->data() + got, src + i, take);
      got += take;
      i += c + 1;
    } else if (c > 128 && i < n) {
      const size_t take = std::min<size_t>(257 - c, need - got);
      std::memset(out->data() + got, src[i], take);
      got += take;
      ++i;
    }
  }
  if (got < need)
    return "truncated TIFF file (PackBits data ends after " + std::to_string(got) + " of " +
           std::to_string(need) + " bytes)";
  return "";
}

// strip or tile i, decompressed to `need` bytes in `out`: "" or the cause
// of its codec's fault (above); a strip past the end of the file throws
std::string chunk(const uint8_t* d, size_t n, const Info& in, size_t i, size_t need,
                  std::vector<uint8_t>* out) {
  const uint64_t off = uint64_t(in.offsets[i]);
  const uint64_t cnt = in.have_counts ? uint64_t(in.counts[i]) : need;
  auto past_end = [&] {
    return TiffError("truncated TIFF file (strip or tile " + std::to_string(i) +
                     " past the end of the file)");
  };
  if (in.comp == 1) {
    // libtiff takes a single strip's byte count for bogus and reads the
    // strip's rows from its offset; any other strip must fit
    const bool one_strip = !in.tiled && in.offsets.size() == 1;
    if (off > n || (n - off < cnt && !one_strip) || n - off < need) throw past_end();
    out->assign(d + off, d + off + need);
    return "";
  }
  if (off > n || n - off < cnt) throw past_end();
  const uint8_t* src = d + off;
  if (in.comp == 5) return lzw(src, size_t(cnt), need, out);
  if (in.comp == 32773) return packbits(src, size_t(cnt), need, out);
  const std::string cause = sodt_inflate::inflate_prefix(src, size_t(cnt), need, out);
  return cause.empty() ? cause : "broken deflate data (" + cause + ")";
}

// every strip or tile placed: (h, w, spp) sample values. A codec's fault
// throws, or with `fill` leaves the strip as libtiff's RGBA reader does:
// the bytes that came before it, zeros after, the predictor not undone.
std::vector<uint16_t> samples(const uint8_t* d, size_t n, const Info& in, bool fill) {
  const int k = in.spp / in.planes;
  const size_t stride = (size_t(in.tw) * k * in.bits + 7) / 8;
  std::vector<uint16_t> out(size_t(in.h) * in.w * in.spp, 0);
  std::vector<uint16_t> row(size_t(in.tw) * k);
  size_t i = 0;
  for (int p = 0; p < in.planes; ++p)
    for (int ty = 0; ty < in.down; ++ty)
      for (int tx = 0; tx < in.across; ++tx, ++i) {
        const int y0 = ty * in.th, x0 = tx * in.tw;
        const int rows = in.tiled ? in.th : std::min(in.th, in.h - y0);
        std::vector<uint8_t> raw;
        const std::string fault = chunk(d, n, in, i, size_t(rows) * stride, &raw);
        if (!fault.empty() && !fill) throw TiffError(fault);
        for (int r = 0; r < rows; ++r) {
          const uint8_t* s = raw.data() + size_t(r) * stride;
          const size_t m = row.size();
          for (size_t j = 0; j < m; ++j) {
            if (in.bits == 16) {
              row[j] = uint16_t(in.be ? s[2 * j] << 8 | s[2 * j + 1] : s[2 * j] | s[2 * j + 1] << 8);
            } else if (in.bits == 8) {
              row[j] = s[j];
            } else {
              size_t bit = j * in.bits;
              row[j] = uint16_t((s[bit >> 3] >> (8 - in.bits - int(bit & 7))) & ((1 << in.bits) - 1));
            }
          }
          if (in.pred == 2 && fault.empty()) {
            const uint16_t mask = in.bits == 16 ? 0xFFFF : 0xFF;
            for (size_t j = k; j < m; ++j) row[j] = uint16_t((row[j] + row[j - k]) & mask);
          }
          const int y = y0 + r;
          if (y >= in.h) break;
          for (int x = 0; x < in.tw && x0 + x < in.w; ++x)
            for (int c = 0; c < k; ++c)
              out[(size_t(y) * in.w + x0 + x) * in.spp + p * k + c] = row[size_t(x) * k + c];
        }
      }
  return out;
}

// the source (y, x) of output pixel (i, j) under the Orientation tag
void turn(int o, int h, int w, int i, int j, int* y, int* x) {
  switch (o) {
    case 2: *y = i, *x = w - 1 - j; break;
    case 3: *y = h - 1 - i, *x = w - 1 - j; break;
    case 4: *y = h - 1 - i, *x = j; break;
    case 5: *y = j, *x = i; break;
    case 6: *y = h - 1 - j, *x = i; break;
    case 7: *y = h - 1 - j, *x = w - 1 - i; break;
    case 8: *y = j, *x = w - 1 - i; break;
    default: *y = i, *x = j;
  }
}
bool swaps(int o) { return o >= 5 && o <= 8; }

uint8_t gray8(const Info& in, int v) {  // 1-8 bit gray -> 8-bit level
  const int top = (1 << in.bits) - 1;
  return uint8_t((in.photo == 1 ? v : top - v) * (255 / top));
}

bool cv2_branch(const Info& in) { return in.bits == 8 && in.photo != 3; }

// `_read_image`'s (h, w, c, kind); throws where PIL opens no such file
void layout(const Info& in, int* h, int* w, int* c, int* kind) {
  bool turned = swaps(in.orient);
  if (cv2_branch(in)) {
    *c = in.photo < 2 ? 1 : in.spp;
    *kind = 1;
  } else {
    const bool gray16 = in.photo < 2 && in.bits == 16;
    bool pil = !(gray16 && in.be && in.photo == 0);
    if (in.photo == 2 && in.spp == 4)
      pil = in.extra.empty() || (in.extra.size() == 1 && in.extra[0] >= 0 && in.extra[0] <= 2);
    if (in.spp == (in.photo == 2 ? 3 : 1) && !in.extra.empty()) pil = false;
    if (in.big && in.be) throw TiffError("PIL opens no big-endian BigTIFF");
    if (uint64_t(in.w) * uint64_t(in.h) > kPilMaxPixels)
      throw TiffError("decompression bomb (" + std::to_string(in.w) + " x " +
                      std::to_string(in.h) + " pixels; PIL opens at most " +
                      std::to_string(kPilMaxPixels) + ")");
    if (!pil)
      throw TiffError("PIL reads no such TIFF (photometric " + std::to_string(in.photo) + ", " +
                      std::to_string(in.spp) + " x " + std::to_string(in.bits) + " bits)");
    if (turned)
      throw out_of_scope("orientation " + std::to_string(in.orient) +
                         " read through PIL, which reads its samples with the sides swapped");
    *c = in.photo == 2 ? 3 : 1;
    *kind = gray16 ? 2 : in.photo < 2 && in.bits == 1 ? 0 : 1;
  }
  *h = turned ? in.w : in.h;
  *w = turned ? in.h : in.w;
}

uint8_t unpremultiply(int c, int a) {  // PIL's RGBa unpackers
  if (a == 255) return uint8_t(c);
  if (a == 0) return 0;
  return uint8_t(std::min(c * 255 / a, 255));
}

std::vector<uint8_t> read_all(const char* path) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path, "rb"), std::fclose);
  if (!f) throw TiffError(std::string("cannot open the file (") + std::strerror(errno) + ")");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f.get())) > 0) data.insert(data.end(), buf, buf + got);
  if (std::ferror(f.get())) throw TiffError("cannot read the file");
  return data;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", msg.c_str());
}

}  // namespace

// `_read_image`'s layout (module doc of data/tiff.py); out holds h * w * c
// samples of 1 byte (kinds 0, 1) or 2 (kind 2, native order)
void decode(const uint8_t* d, size_t n, int* h, int* w, int* c, int* kind,
            std::vector<uint8_t>* out) {
  const Info in = info_of(d, n);
  layout(in, h, w, c, kind);
  const bool cv2 = cv2_branch(in);
  const std::vector<uint16_t> s = samples(d, n, in, cv2);  // PIL raises on a fault
  const size_t np = size_t(*h) * *w;
  out->assign(np * *c * (*kind == 2 ? 2 : 1), 0);
  uint8_t* o8 = out->data();
  uint16_t* o16 = reinterpret_cast<uint16_t*>(out->data());
  for (int i = 0; i < *h; ++i)
    for (int j = 0; j < *w; ++j) {
      int y, x;
      turn(in.orient, in.h, in.w, i, j, &y, &x);
      const uint16_t* p = &s[(size_t(y) * in.w + x) * in.spp];
      const size_t q = (size_t(i) * *w + j) * *c;
      if (cv2) {
        if (in.photo < 2) {
          o8[q] = gray8(in, p[0]);
        } else if (in.spp == 3) {
          for (int k = 0; k < 3; ++k) o8[q + k] = uint8_t(p[k]);
        } else {  // A R G B, unassociated alpha premultiplied
          const bool unassoc = in.extra.size() == 1 && in.extra[0] == 2;
          o8[q] = uint8_t(p[3]);
          for (int k = 0; k < 3; ++k)
            o8[q + 1 + k] = uint8_t(unassoc ? (p[k] * p[3] + 127) / 255 : p[k]);
        }
      } else if (*kind == 2 || in.photo == 3) {
        if (*kind == 2) o16[q] = p[0]; else o8[q] = uint8_t(p[0]);
      } else if (in.photo < 2) {
        const uint8_t v = gray8(in, p[0]);
        o8[q] = *kind == 0 ? v != 0 : v;
      } else {  // 16-bit RGB: high bytes, associated alpha divided out
        const bool assoc = in.extra.size() == 1 && in.extra[0] == 1 && in.spp == 4;
        for (int k = 0; k < 3; ++k)
          o8[q + k] = assoc ? unpremultiply(p[k] >> 8, p[3] >> 8) : uint8_t(p[k] >> 8);
      }
    }
}

// the JAX native loader's pixels, B G R (header comment)
void decode_bgr(const uint8_t* d, size_t n, int* h, int* w, std::vector<uint8_t>* bgr) {
  const Info in = info_of(d, n);
  // OpenCV reads a 16-bit image with TIFFReadEncodedStrip, and fails where
  // it fails; the others through the RGBA reader, which fills
  const std::vector<uint16_t> s = samples(d, n, in, in.bits <= 8);
  *h = swaps(in.orient) ? in.w : in.h;
  *w = swaps(in.orient) ? in.h : in.w;
  bgr->resize(size_t(*h) * *w * 3);
  uint8_t pal[256][3] = {};
  if (in.photo == 3) {
    const size_t entries = size_t(1) << in.bits;
    bool eight = true;  // libtiff's checkcmap: a map of 8-bit samples
    for (int64_t v : in.cmap) eight = eight && v < 256;
    for (size_t e = 0; e < entries; ++e)
      for (int k = 0; k < 3; ++k) {
        int64_t v = in.cmap[(2 - k) * entries + e];
        pal[e][k] = uint8_t(eight ? v : v >> 8);
      }
    if (in.bits == 1)  // OpenCV reads a 1-bit image as gray
      for (size_t e = 0; e < entries; ++e)
        pal[e][0] = pal[e][1] = pal[e][2] =
            uint8_t((pal[e][0] * 1868 + pal[e][1] * 9617 + pal[e][2] * 4899 + 8192) >> 14);
  }
  const bool unassoc = in.photo == 2 && in.bits == 8 && in.spp == 4 && in.extra.size() == 1 &&
                       in.extra[0] == 2;
  uint8_t* o = bgr->data();
  for (int i = 0; i < *h; ++i)
    for (int j = 0; j < *w; ++j, o += 3) {
      int y, x;
      turn(in.orient, in.h, in.w, i, j, &y, &x);
      const uint16_t* p = &s[(size_t(y) * in.w + x) * in.spp];
      if (in.photo == 3) {
        std::memcpy(o, pal[p[0]], 3);
      } else if (in.photo < 2) {
        o[0] = o[1] = o[2] = in.bits == 16 ? uint8_t(std::min<int>(p[0], 255)) : gray8(in, p[0]);
      } else {
        for (int k = 0; k < 3; ++k) {
          int v = p[2 - k];
          if (in.bits == 16) v = std::min(v, 255);
          else if (unassoc) v = (v * p[3] + 127) / 255;
          o[k] = uint8_t(v);
        }
      }
    }
}

}  // namespace sodt_tiff

extern "C" {

int tiff_file_shape(const char* path, int* h, int* w, int* c, int* kind, char* err, int err_len) {
  try {
    std::vector<uint8_t> data = sodt_tiff::read_all(path);
    sodt_tiff::layout(sodt_tiff::info_of(data.data(), data.size()), h, w, c, kind);
    return 1;
  } catch (const std::exception& e) {
    sodt_tiff::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

int tiff_file_decode(const char* path, uint8_t* out, int h, int w, int c, int kind, char* err,
                     int err_len) {
  try {
    std::vector<uint8_t> data = sodt_tiff::read_all(path);
    int hh, ww, cc, kk;
    std::vector<uint8_t> px;
    sodt_tiff::decode(data.data(), data.size(), &hh, &ww, &cc, &kk, &px);
    if (hh != h || ww != w || cc != c || kk != kind)
      throw sodt_tiff::TiffError("the file changed between the shape query and the decode");
    std::memcpy(out, px.data(), px.size());
    return 1;
  } catch (const std::exception& e) {
    sodt_tiff::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

}  // extern "C"
