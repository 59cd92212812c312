// TIFF decoder of the port: `data/tiff.py`'s decoder in C++17, standard
// library only. The numpy module is its plain version and the tests hold
// the two bit-equal; its doc has the table of kinds.
//
// Byte order II and MM, classic TIFF and BigTIFF, the first IFD; strips and
// tiles; planar configuration 1 and 2; compression none, LZW (libtiff's
// LZWDecode: MSB-first codes of 9-12 bits, the width one code early),
// deflate (through the tile loader's inflate, `sodt_inflate::inflate`),
// PackBits and JPEG (each strip or tile after JPEGTables, through the JPEG
// decoder's `sodt_jpeg::decode_segment`, csrc/jpeg.h), and DNG 1.4's lossy
// JPEG (34892), which libtiff has no decoder for (each strip a fault at its
// first byte, filled as below); predictor 1, 2 and 3
// (floating point); FillOrder 1 and 2; photometric MinIsWhite, MinIsBlack,
// RGB, palette, CMYK and YCbCr (data units of 1 x 1, 2 x 1 and 2 x 2,
// libtiff's YCbCr -> RGB); unsigned samples of 1, 2, 4, 8, 16 and 32 bits,
// signed of 8, 16 and 32, float of 32 and 64; one extra sample at most. A
// strip past the end of the file throws. A strip whose compressed data stops
// short or breaks (a bad LZW code, a bad deflate stream) is filled as
// libtiff's RGBA reader leaves it, the bytes that came before the fault and
// zeros, the predictor not undone, wherever OpenCV reads the kind through
// that reader (unsigned samples of 8 bits and fewer, not JPEG); elsewhere it
// throws, as PIL and OpenCV's other reads fail. A 16-bit palette throws: no
// reader takes one, nor more than 2^30 pixels (OpenCV) or, on PIL's branch
// of `decode`, more than 2 x 89478485 (PIL's open); nor does a raw DNG IFD0
// (photometric CFA, LinearRaw), which cv2 and PIL read no image from (a DNG
// is read as its IFD0 reads as a TIFF). A kind out of the port's
// scope (CCITT and other compressions, old-style JPEG and LZW, CIELab, ...)
// throws a cause that starts "not implemented:".
//
// Two layouts of the same decode:
//   decode      what the JAX package's `_read_image` returns (cv2 5.0 for
//               8-bit gray, RGB(A), CMYK, YCbCr, JPEG, signed, float and
//               32-bit samples; PIL for palettes, 1-, 2-, 4- and 16-bit
//               samples and CMYK with an extra sample): (h, w, c) samples
//               of kind 0 (bool, stored 0 / 1), 1 (uint8), 2 (uint16), 3
//               (int8), 4 (int16), 5 (int32), 6 (uint32), 7 (float32) or 8
//               (float64), native byte order;
//   decode_bgr  what the JAX native loader's cv::imread(IMREAD_UNCHANGED)
//               (OpenCV 4.6, libtiff) and its conversions leave before the
//               resize: (h, w) B G R bytes. Gray widened (MinIsWhite
//               inverted below 16 bits; 1, 2, 4 bits scaled to 0-255);
//               8-bit RGB with unassociated alpha premultiplied, (c a + 127)
//               / 255, as libtiff's RGBA reader leaves it, alpha dropped;
//               16-bit, signed and float samples saturated to 0-255 as
//               convertTo(CV_8U) does (float rounded half to even; NaN and
//               values outside int32 to 0); CMYK and YCbCr as the RGBA
//               reader converts them; palette colours from the colour map
//               (its samples >> 8, or as they are where every one is below
//               256, as libtiff's checkcmap decides), a 1-bit palette image
//               as gray, (1868 B + 9617 G + 4899 R + 8192) >> 14; turned by
//               the Orientation tag (2-8). Where OpenCV reads nothing (2- and
//               4-bit gray, 4.6 and 2- or 4-bit palettes) or misreads (16-bit
//               planar configuration 2), the samples are read as the format
//               says. Where OpenCV 4.6 aborts its process (cvtColor of 1- or
//               4-channel signed or float64 samples) or reads nothing
//               (32-bit integer, float64 colour, CMYK with an extra sample),
//               it throws, naming the kind. A broken deflate strip keeps
//               zlib's bytes (cv2 5.0's): OpenCV 4.6's libtiff inflates with
//               libdeflate, which leaves a few bytes of its own just before
//               the fault.
//
// In the library: sodt_tiff::decode_bgr for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   tiff_file_shape(path, &h, &w, &c, &kind, err, err_len)    -> 1 ok, 0 failed
//   tiff_file_decode(path, out, h, w, c, kind, err, err_len)  -> 1 ok, 0 failed

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "jpeg.h"

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
                   "; the port reads uncompressed, LZW, deflate, PackBits and JPEG gray, RGB, "
                   "palette, CMYK and YCbCr images of unsigned, signed and float samples");
}

TiffError broken(const std::string& why) { return TiffError("broken TIFF file (" + why + ")"); }

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

// tag type -> bytes a value takes; 0: a type the decoder skips
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

struct Ifd {
  Tags tags;
  std::map<int, std::vector<float>> rationals;  // as libtiff reads them
  std::vector<uint8_t> tables;                  // JPEGTables (347)
};

// the first IFD as libtiff reads it: any short read throws
Ifd walk_ifd(const Reader& r, bool* big) {
  const uint8_t* d = r.d;
  *big = d[2] == (r.be ? 0 : 43) && d[3] == (r.be ? 43 : 0);
  if (*big && (r.n < 8 || r.u(4, 2) != 8 || r.u(6, 2) != 0))
    throw TiffError("broken BigTIFF header");
  const size_t head = *big ? 16 : 8;
  if (r.n < head) throw TiffError("truncated TIFF file (header)");
  const int ob = *big ? 8 : 4, cb = *big ? 8 : 2, ent = *big ? 20 : 12;
  uint64_t pos = r.u(*big ? 8 : 4, ob);
  if (!pos) throw TiffError("broken TIFF file (no IFD)");
  if (pos > r.n || r.n - pos < uint64_t(cb)) throw broken("IFD past the end of the file");
  uint64_t count = r.u(pos, cb);
  pos += cb;
  Ifd ifd;
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
    if (tag == 347 && (typ == 1 || typ == 7)) ifd.tables.assign(d + at, d + at + size);
    if (!size) continue;
    if (typ == 5) {
      std::vector<float> v(cnt);
      for (uint64_t i = 0; i < cnt; ++i) {
        const uint64_t a = r.u(at + 8 * i, 4), b = r.u(at + 8 * i + 4, 4);
        v[i] = b ? float(double(a) / double(b)) : 0.0f;
      }
      ifd.rationals[tag] = std::move(v);
    }
    if (!is_int_type(typ)) continue;
    std::vector<int64_t> vals(cnt);
    const bool sgn = typ == 6 || typ == 8 || typ == 9 || typ == 17;
    for (uint64_t i = 0; i < cnt; ++i) {
      uint64_t v = r.u(at + i * sz, sz);
      if (sgn && sz < 8 && (v >> (8 * sz - 1)) & 1) v |= ~uint64_t(0) << (8 * sz);
      vals[i] = int64_t(v);
    }
    ifd.tags[tag] = std::move(vals);
  }
  return ifd;
}

int64_t one(const Tags& t, int tag, int64_t dflt) {
  auto it = t.find(tag);
  return it == t.end() || it->second.empty() ? dflt : it->second[0];
}

// the decode's sample kinds (header comment)
enum Kind { kBool = 0, kU8, kU16, kI8, kI16, kI32, kU32, kF32, kF64 };

struct Info {
  int w = 0, h = 0, comp = 1, photo = 1, spp = 1, bits = 1, sf = 1, pred = 1, fill = 1;
  int planes = 1, orient = 1;
  std::vector<int64_t> extra, offsets, counts, cmap;  // cmap: R..., G..., B...
  bool tiled = false, have_counts = false, be = false, big = false;
  int tw = 0, th = 0, across = 0, down = 0;
  int hs = 0, vs = 0;             // YCbCr data units (0: none, or JPEG)
  int sub_h = 2, sub_v = 2;       // YCbCrSubsampling
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float ref_bw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
  std::vector<uint8_t> tables;
  bool numeric() const { return sf != 1 || bits >= 32; }
  int es() const { return bits <= 8 ? 1 : bits / 8; }  // bytes a sample takes
  Kind kind() const {
    if (sf == 2) return bits == 8 ? kI8 : bits == 16 ? kI16 : kI32;
    if (sf == 3) return bits == 32 ? kF32 : kF64;
    return bits == 32 ? kU32 : bits == 16 ? kU16 : kU8;
  }
};

std::string join(const std::vector<int64_t>& v) {
  std::string all;
  for (int64_t x : v) all += (all.empty() ? "" : ", ") + std::to_string(x);
  return "(" + all + ")";
}

Info info_of(const uint8_t* d, size_t n) {
  if (n < 4 || !(std::memcmp(d, "II*\0", 4) == 0 || std::memcmp(d, "MM\0*", 4) == 0 ||
                 std::memcmp(d, "II+\0", 4) == 0 || std::memcmp(d, "MM\0+", 4) == 0))
    throw TiffError("not a TIFF file (signature)");
  Reader r{d, n, d[0] == 'M'};
  bool big;
  const Ifd ifd = walk_ifd(r, &big);
  const Tags& t = ifd.tags;
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
  std::vector<int64_t> sfs = t.count(339) ? t.at(339) : std::vector<int64_t>{1};
  // libtiff knows the Predictor tag only with the codecs that take it
  in.pred = in.comp == 5 || in.comp == 8 || in.comp == 32946 ? int(one(t, 317, 1)) : 1;
  in.fill = int(one(t, 266, 1));
  const int64_t planar = one(t, 284, 1);
  in.orient = int(one(t, 274, 1));
  if (t.count(338)) in.extra = t.at(338);
  static const std::map<int, std::string> comp_names = {
      {2, "CCITT RLE (2)"}, {3, "CCITT Group 3 (3)"}, {4, "CCITT Group 4 (4)"},
      {6, "old-style JPEG (6)"}, {34712, "JPEG 2000 (34712)"}, {34925, "LZMA (34925)"},
      {50000, "Zstandard (50000)"}, {50001, "WebP (50001)"}};
  static const std::map<int, std::string> photo_names = {
      {4, "transparency mask (4)"}, {5, "CMYK (5)"}, {6, "YCbCr (6)"}, {8, "CIELab (8)"},
      {9, "ICCLab (9)"}, {10, "ITULab (10)"}, {32844, "LogL (32844)"},
      {32845, "LogLuv (32845)"}, {32803, "CFA (32803)"}, {34892, "LinearRaw (34892)"}};
  const int comp = in.comp;
  if (comp != 1 && comp != 5 && comp != 7 && comp != 8 && comp != 32946 && comp != 32773 &&
      comp != 34892) {
    auto it = comp_names.find(comp);
    throw out_of_scope(it != comp_names.end() ? it->second : "compression " + std::to_string(comp));
  }
  if (photo < 0) throw TiffError("broken TIFF file (no photometric interpretation)");
  if (photo == 32803 || photo == 34892)
    throw TiffError("a raw DNG image (photometric " + photo_names.at(int(photo)) +
                    "): cv2 and PIL read none from it");
  if (photo == 4 || photo > 6) {
    auto it = photo_names.find(int(photo));
    throw out_of_scope("photometric " +
                       (it != photo_names.end() ? it->second : std::to_string(photo)));
  }
  in.photo = int(photo);
  for (int64_t b : bps)
    if (b != bps[0]) throw out_of_scope("mixed bits per sample " + join(bps));
  in.bits = int(bps[0]);
  for (int64_t s : sfs)
    if (s != sfs[0]) throw out_of_scope("mixed sample formats " + join(sfs));
  in.sf = int(sfs[0]);
  const int bits = in.bits, sf = in.sf, spp = in.spp;
  if (sf < 1 || sf > 3) throw out_of_scope("SampleFormat " + std::to_string(sf));
  if (sf == 3 && bits == 16)
    throw TiffError("unreadable TIFF (16-bit floating-point samples, which neither cv2 nor PIL "
                    "reads)");
  const bool known = (sf == 1 && (bits == 1 || bits == 2 || bits == 4 || bits == 8 ||
                                  bits == 16 || bits == 32)) ||
                     (sf == 2 && (bits == 8 || bits == 16 || bits == 32)) ||
                     (sf == 3 && (bits == 32 || bits == 64));
  if (!known)
    throw out_of_scope(std::to_string(bits) + "-bit samples (SampleFormat " + std::to_string(sf) +
                       ")");
  if (in.pred < 1 || in.pred > 3) throw out_of_scope("predictor " + std::to_string(in.pred));
  if (in.pred == 3 && sf != 3)
    throw broken("the floating-point predictor with SampleFormat " + std::to_string(sf));
  if (in.fill != 1 && in.fill != 2) throw broken("FillOrder " + std::to_string(in.fill));
  const bool numeric = in.numeric();
  const int colours = in.photo == 2 || in.photo == 6 ? 3 : in.photo == 5 ? 4 : 1;
  if (spp - colours != 0 && spp - colours != 1)
    throw out_of_scope(std::to_string(spp) + " samples per pixel (photometric " +
                       std::to_string(in.photo) + ")");
  const bool more = spp > colours;
  if (more && in.photo == 3) throw out_of_scope("a palette and an extra sample");
  if (more && bits == 16 && in.photo < 2) throw out_of_scope("16-bit gray and an extra sample");
  if (more && bits < 8)
    throw out_of_scope(std::to_string(bits) + "-bit samples and an extra sample");
  if (in.photo == 2 && bits < 8) throw out_of_scope(std::to_string(bits) + "-bit RGB");
  if (in.photo == 3 && bits > 8)
    throw TiffError("unreadable TIFF (a " + std::to_string(bits) +
                    "-bit palette, which neither libtiff nor PIL reads)");
  if (in.pred == 2 && bits < 8)
    throw broken("predictor 2 with " + std::to_string(bits) + "-bit samples");
  if (numeric && in.photo != 1 && in.photo != 2)
    throw out_of_scope(std::to_string(bits) + "-bit samples of SampleFormat " +
                       std::to_string(sf) + " under photometric " + std::to_string(in.photo));
  if (numeric && more && in.photo == 1)
    throw out_of_scope(std::to_string(bits) + "-bit gray (SampleFormat " + std::to_string(sf) +
                       ") and an extra sample");
  if ((in.photo == 5 || in.photo == 6) && (bits != 8 || sf != 1))
    throw out_of_scope(std::to_string(bits) + "-bit samples under photometric " +
                       photo_names.at(in.photo));
  if (in.photo == 5 && one(t, 332, 1) != 1)
    throw out_of_scope("InkSet " + std::to_string(one(t, 332, 1)) + " (CMYK is InkSet 1)");
  if (t.count(530) && t.at(530).size() >= 2) {
    in.sub_h = int(t.at(530)[0]);
    in.sub_v = int(t.at(530)[1]);
  }
  const bool sub_known = in.sub_v == 1 ? in.sub_h == 1 || in.sub_h == 2
                                       : in.sub_v == 2 && in.sub_h == 2;
  if (in.photo == 6) {
    if (more) throw out_of_scope("YCbCr and an extra sample");
    if (!sub_known)
      throw out_of_scope("YCbCr subsampling " + std::to_string(in.sub_h) + " x " +
                         std::to_string(in.sub_v));
    if (in.pred != 1 && (in.sub_h != 1 || in.sub_v != 1))
      throw out_of_scope("predictor " + std::to_string(in.pred) + " with subsampled YCbCr");
  }
  if (comp == 7) {
    if ((in.photo != 1 && in.photo != 2 && in.photo != 6) || bits != 8 || sf != 1 || more)
      throw out_of_scope("JPEG compression under photometric " + std::to_string(in.photo) + " (" +
                         std::to_string(spp) + " x " + std::to_string(bits) + " bits)");
    in.pred = in.fill = 1;  // libtiff's JPEG codec reverses no bits
  }
  const bool new_kind = numeric || in.photo == 5 || in.photo == 6 || comp == 7;
  if (new_kind && in.orient != 1)
    throw out_of_scope("orientation " + std::to_string(in.orient) + " with photometric " +
                       std::to_string(in.photo) + " and " + std::to_string(bits) +
                       "-bit samples of SampleFormat " + std::to_string(sf));
  if (planar == 2 && spp > 1 && new_kind)
    throw out_of_scope("planar configuration 2 under photometric " + std::to_string(in.photo) +
                       " with " + std::to_string(bits) + "-bit samples");
  if (in.photo == 3) {
    auto it = t.find(320);
    if (it == t.end() || it->second.size() < size_t(3) << bits)
      throw TiffError("broken TIFF file (no colour map)");
    in.cmap.assign(it->second.begin(), it->second.begin() + (size_t(3) << bits));
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
  if (in.tiled && in.fill == 2 && comp == 1)
    // libtiff's reading of them fails on small tiles (an RGBA tile of
    // fewer than 1024 pixels) and not on large ones
    throw out_of_scope("uncompressed tiles under FillOrder 2");
  in.planes = planar == 2 && spp > 1 ? spp : 1;
  in.across = (in.w + in.tw - 1) / in.tw;
  in.down = (in.h + in.th - 1) / in.th;
  const size_t chunks = size_t(in.across) * in.down * in.planes;
  if (offs->size() < chunks || (cnts && cnts->size() < offs->size()))
    throw TiffError("broken TIFF file (" + std::to_string(offs->size()) + " of " +
                    std::to_string(chunks) + " strips or tiles)");
  if (!cnts && comp != 1) throw TiffError("broken TIFF file (no byte counts)");
  if (in.photo == 6 && comp != 7) in.hs = in.sub_h, in.vs = in.sub_v;
  if (in.photo == 6) {
    auto l = ifd.rationals.find(529), rb = ifd.rationals.find(532);
    if ((l != ifd.rationals.end() && l->second.size() < 3) ||
        (rb != ifd.rationals.end() && rb->second.size() < 6))
      throw TiffError("broken TIFF file (YCbCr coefficients)");
    if (l != ifd.rationals.end()) std::copy(l->second.begin(), l->second.begin() + 3, in.luma);
    if (rb != ifd.rationals.end()) std::copy(rb->second.begin(), rb->second.begin() + 6, in.ref_bw);
  }
  in.tables = ifd.tables;
  // no codec makes more than `ratio` bytes of a byte of its data: a file
  // that claims more pixels than that is refused before they are allocated
  const uint64_t ratio = comp == 1 ? 1 : comp == 5 ? 4096 : comp == 7 || comp == 34892 ? 1536
                         : comp == 32773 ? 128 : 1032;
  const uint64_t rows = uint64_t(in.tiled ? in.down * in.th : in.h);
  uint64_t need;
  if (comp == 7)
    need = rows * in.across * in.tw * spp;
  else if (in.hs)
    need = (rows + in.vs - 1) / in.vs * in.across * ((uint64_t(in.tw) + in.hs - 1) / in.hs) *
           (in.hs * in.vs + 2);
  else
    need = rows * in.across * in.planes *
           ((uint64_t(in.tw) * (spp / in.planes) * bits + 7) / 8);
  if (need > ratio * n)
    throw TiffError("broken TIFF file (" + std::to_string(in.w) + " x " + std::to_string(in.h) +
                    " pixels, more than its " + std::to_string(n) + " bytes can hold)");
  in.offsets = *offs;
  if (cnts) in.counts = *cnts;
  in.have_counts = cnts != nullptr;
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
// of its codec's fault (above); a strip past the end of the file throws.
// FillOrder 2 reverses the bits of each byte of the data first, as libtiff
// does before it decodes.
std::string chunk(const uint8_t* d, size_t n, const Info& in, size_t i, size_t need,
                  std::vector<uint8_t>* out) {
  const uint64_t off = uint64_t(in.offsets[i]);
  const uint64_t cnt = in.have_counts ? uint64_t(in.counts[i]) : need;
  auto past_end = [&] {
    return TiffError("truncated TIFF file (strip or tile " + std::to_string(i) +
                     " past the end of the file)");
  };
  std::vector<uint8_t> rev;
  auto bits_of = [&](const uint8_t* p, size_t m) -> const uint8_t* {
    if (in.fill != 2) return p;
    rev.resize(m);
    for (size_t j = 0; j < m; ++j) {
      uint8_t b = p[j], o = 0;
      for (int k = 0; k < 8; ++k) o = uint8_t(o << 1 | ((b >> k) & 1));
      rev[j] = o;
    }
    return rev.data();
  };
  if (in.comp == 1) {
    // libtiff takes a single strip's byte count for bogus and reads the
    // strip's rows from its offset; any other strip must fit
    const bool one_strip = !in.tiled && in.offsets.size() == 1;
    if (off > n || (n - off < cnt && !one_strip) || n - off < need) throw past_end();
    const uint8_t* src = bits_of(d + off, need);
    out->assign(src, src + need);
    return "";
  }
  if (off > n || n - off < cnt) throw past_end();
  if (in.comp == 34892) {  // DNG 1.4's lossy JPEG: libtiff has no decoder
    out->assign(need, 0);
    return "compression 34892 (DNG's lossy JPEG): libtiff has no decoder for it";
  }
  const uint8_t* src = bits_of(d + off, size_t(cnt));
  if (in.comp == 5) return lzw(src, size_t(cnt), need, out);
  if (in.comp == 32773) return packbits(src, size_t(cnt), need, out);
  const std::string cause = sodt_inflate::inflate_prefix(src, size_t(cnt), need, out);
  return cause.empty() ? cause : "broken deflate data (" + cause + ")";
}

// a sample of `es` bytes in the file's order -> native order at `dst`
inline void put_sample(const uint8_t* src, int es, bool be, uint8_t* dst) {
  uint64_t v = 0;
  for (int b = 0; b < es; ++b) v |= uint64_t(src[be ? es - 1 - b : b]) << (8 * b);
  std::memcpy(dst, &v, size_t(es));  // little-endian hosts (x86, Arm)
}

// A decompressed chunk of `rows` x `cols` pixels of k samples -> (rows,
// cols, k) samples of `in.es()` bytes, native order; the predictor undone
// with `predict` (2: each sample plus the one k to its left, wrapping, on
// the unsigned word; 3: each byte of the row plus the one k to its left,
// then the row's bytes read as planes, most significant byte first).
void unpack(const uint8_t* raw, int rows, int cols, int k, const Info& in, bool predict,
            std::vector<uint8_t>* out) {
  const int es = in.es();
  const size_t m = size_t(cols) * k;  // samples a row
  const size_t stride = (m * in.bits + 7) / 8;
  out->assign(size_t(rows) * m * es, 0);
  std::vector<uint8_t> row(stride);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* s = raw + size_t(r) * stride;
    uint8_t* o = out->data() + size_t(r) * m * es;
    if (in.pred == 3 && predict) {
      std::memcpy(row.data(), s, stride);
      for (size_t j = k; j < stride; ++j) row[j] = uint8_t(row[j] + row[j - k]);
      for (size_t j = 0; j < m; ++j)
        for (int b = 0; b < es; ++b) o[j * es + es - 1 - b] = row[b * m + j];
      continue;
    }
    for (size_t j = 0; j < m; ++j) {
      if (in.bits >= 8) {
        put_sample(s + j * es, es, in.be, o + j * es);
      } else {
        size_t bit = j * in.bits;
        o[j] = uint8_t((s[bit >> 3] >> (8 - in.bits - int(bit & 7))) & ((1 << in.bits) - 1));
      }
    }
    if (in.pred == 2 && predict) {
      for (size_t j = k; j < m; ++j) {
        uint64_t a = 0, b = 0;
        std::memcpy(&a, o + j * es, size_t(es));
        std::memcpy(&b, o + (j - k) * es, size_t(es));
        a += b;
        std::memcpy(o + j * es, &a, size_t(es));
      }
    }
  }
}

// a chunk of YCbCr data units -> (rows, cols, 3) Y, Cb, Cr bytes, each
// unit's Cb and Cr on all of its hs x vs pixels
void units(const uint8_t* raw, int rows, int cols, const Info& in, std::vector<uint8_t>* out) {
  const int hs = in.hs, vs = in.vs, us = hs * vs + 2, uc = (cols + hs - 1) / hs;
  out->assign(size_t(rows) * cols * 3, 0);
  for (int y = 0; y < rows; ++y)
    for (int x = 0; x < cols; ++x) {
      const uint8_t* u = raw + (size_t(y / vs) * uc + x / hs) * us;
      uint8_t* o = out->data() + (size_t(y) * cols + x) * 3;
      o[0] = u[(y % vs) * hs + x % hs];
      o[1] = u[us - 2];
      o[2] = u[us - 1];
    }
}

// strip or tile i of a JPEG-compressed TIFF (`tiff.py`'s `_jpeg`): its
// stream after the JPEGTables, YCbCr converted where the photometric is
// YCbCr, as stored where it is RGB; the frame the chunk's width and from
// its rows to its nominal rows high (refused before it is decoded), its
// first component sampled as YCbCrSubsampling says (1 x 1 unless YCbCr),
// the others 1 x 1
void jpeg_chunk(const uint8_t* d, size_t n, const Info& in, size_t i, int rows, int cols,
                std::vector<uint8_t>* out) {
  const uint64_t off = uint64_t(in.offsets[i]), cnt = uint64_t(in.counts[i]);
  if (off > n || n - off < cnt)
    throw TiffError("truncated TIFF file (strip or tile " + std::to_string(i) +
                    " past the end of the file)");
  int h, w, c;
  std::vector<std::pair<int, int>> samp;
  sodt_jpeg::decode_segment(in.tables.data(), in.tables.size(), d + off, size_t(cnt),
                            in.photo == 6, cols, rows, in.th, &h, &w, &c, out, &samp);
  if (int(samp.size()) != in.spp)
    throw broken("a JPEG strip or tile of " + std::to_string(samp.size()) + " components for " +
                 std::to_string(in.spp) + " samples");
  std::vector<std::pair<int, int>> want(size_t(in.spp), {1, 1});
  if (in.photo == 6) want[0] = {in.sub_h, in.sub_v};
  if (samp != want) {
    auto list = [](const std::vector<std::pair<int, int>>& v) {
      std::string s;
      for (auto& p : v)
        s += (s.empty() ? "(" : ", (") + std::to_string(p.first) + ", " +
             std::to_string(p.second) + ")";
      return "[" + s + "]";
    };
    throw broken("JPEG sampling factors " + list(samp) + ", where libtiff takes " + list(want));
  }
  out->resize(size_t(rows) * cols * c);
}

// every strip or tile placed: (h, w, spp) samples of in.es() bytes, native
// order (YCbCr data units as Y, Cb, Cr; JPEG chunks decoded). A codec's fault
// throws, or with `fill` leaves the strip as libtiff's RGBA reader does: the
// bytes that came before it, zeros after, the predictor not undone.
std::vector<uint8_t> samples(const uint8_t* d, size_t n, const Info& in, bool fill) {
  const int k = in.spp / in.planes, es = in.es();
  std::vector<uint8_t> out(size_t(in.h) * in.w * in.spp * es, 0);
  std::vector<uint8_t> raw, a;
  size_t i = 0;
  for (int p = 0; p < in.planes; ++p)
    for (int ty = 0; ty < in.down; ++ty)
      for (int tx = 0; tx < in.across; ++tx, ++i) {
        const int y0 = ty * in.th, x0 = tx * in.tw;
        const int rows = in.tiled ? in.th : std::min(in.th, in.h - y0);
        if (in.comp == 7) {
          jpeg_chunk(d, n, in, i, rows, in.tw, &a);
        } else {
          const size_t need =
              in.hs ? size_t((rows + in.vs - 1) / in.vs) * ((in.tw + in.hs - 1) / in.hs) *
                          (in.hs * in.vs + 2)
                    : size_t(rows) * ((size_t(in.tw) * k * in.bits + 7) / 8);
          const std::string fault = chunk(d, n, in, i, need, &raw);
          if (!fault.empty() && !fill) throw TiffError(fault);
          if (in.hs)
            units(raw.data(), rows, in.tw, in, &a);
          else
            unpack(raw.data(), rows, in.tw, k, in, fault.empty(), &a);
        }
        for (int r = 0; r < rows && y0 + r < in.h; ++r)
          for (int x = 0; x < in.tw && x0 + x < in.w; ++x)
            std::memcpy(&out[((size_t(y0 + r) * in.w + x0 + x) * in.spp + p * k) * es],
                        &a[(size_t(r) * in.tw + x) * k * es], size_t(k) * es);
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

// OpenCV reads these through libtiff's RGBA reader, which fills a broken
// strip; the others through TIFFReadEncodedStrip, which fails
bool rgba_reader(const Info& in) { return in.sf == 1 && in.bits <= 8 && in.comp != 7; }

// the kinds `decode` reads as cv2 5.0 does (`tiff.py`'s `_cv2_branch`)
bool cv2_branch(const Info& in) {
  return (in.bits == 8 && in.photo != 3 && !(in.photo == 5 && in.spp == 5)) || in.numeric();
}

// libtiff's TIFFYCbCrToRGB tables (`tiff.py`'s `_ycbcr_rgb`)
struct Ycc {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
};

int32_t code2v(int c, float rb, float rw, int cr) {
  float den = rw - rb;
  if (den == 0) den = 1;
  float v = float(c - int32_t(rb)) * float(cr) / den;
  v = v < -4096.0f ? -4096.0f : v > 4096.0f ? 4096.0f : v;
  return int32_t(v);
}

Ycc ycc_tables(const Info& in) {
  auto fix = [](float x) { return int32_t(double(x) * 65536.0 + 0.5); };
  auto clamp2 = [](float v) { return v < 0.0f ? 0.0f : v > 2.0f ? 2.0f : v; };
  const float lr = in.luma[0], lg = in.luma[1], lb = in.luma[2];
  const float f1 = 2.0f - 2.0f * lr, f3 = 2.0f - 2.0f * lb;
  const float f2 = lr * f1 / lg, f4 = lb * f3 / lg;
  const int32_t d1 = fix(clamp2(f1)), d2 = -fix(clamp2(f2)), d3 = fix(clamp2(f3)),
                d4 = -fix(clamp2(f4));
  const float* rb = in.ref_bw;
  Ycc t;
  for (int i = 0; i < 256; ++i) {
    const int x = i - 128;
    const int32_t cr = code2v(x, rb[4] - 128.0f, rb[5] - 128.0f, 127);
    const int32_t cb = code2v(x, rb[2] - 128.0f, rb[3] - 128.0f, 127);
    t.cr_r[i] = (d1 * cr + 32768) >> 16;
    t.cb_b[i] = (d3 * cb + 32768) >> 16;
    t.cr_g[i] = d2 * cr;
    t.cb_g[i] = d4 * cb + 32768;
    t.y[i] = code2v(x + 128, rb[0], rb[1], 255);
  }
  return t;
}

inline uint8_t clamp8(int64_t v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// Y Cb Cr -> R G B
inline void ycc_rgb(const Ycc& t, const uint8_t* p, uint8_t* rgb) {
  const int32_t y = t.y[p[0]];
  rgb[0] = clamp8(y + t.cr_r[p[2]]);
  rgb[1] = clamp8(y + ((t.cb_g[p[1]] + t.cr_g[p[2]]) >> 16));
  rgb[2] = clamp8(y + t.cb_b[p[1]]);
}

// 8-bit C M Y K -> R G B, as libtiff's RGBA reader
inline void cmyk_rgb(const uint8_t* p, uint8_t* rgb) {
  const int k = 255 - p[3];
  for (int c = 0; c < 3; ++c) rgb[c] = uint8_t(k * (255 - p[c]) / 255);
}

// one sample of `in`'s kind at p -> convertTo(CV_8U): saturated, float
// rounded half to even, NaN and values outside int32 to 0 (cvRound's)
uint8_t to_u8(const Info& in, const uint8_t* p) {
  switch (in.kind()) {
    case kI8: return clamp8(int8_t(p[0]));
    case kI16: { int16_t v; std::memcpy(&v, p, 2); return clamp8(v); }
    case kI32: { int32_t v; std::memcpy(&v, p, 4); return clamp8(v); }
    case kU16: { uint16_t v; std::memcpy(&v, p, 2); return clamp8(v); }
    case kU32: { uint32_t v; std::memcpy(&v, p, 4); return clamp8(v); }
    case kF32: case kF64: {
      double v;
      if (in.kind() == kF32) { float f; std::memcpy(&f, p, 4); v = f; }
      else std::memcpy(&v, p, 8);
      if (std::isnan(v)) return 0;
      const double r = std::nearbyint(v);
      if (r >= 2147483648.0 || r < -2147483648.0) return 0;
      return clamp8(int64_t(r));
    }
    default: return p[0];
  }
}

// `_read_image`'s (h, w, c, kind); throws where PIL opens no such file
void layout(const Info& in, int* h, int* w, int* c, int* kind) {
  bool turned = swaps(in.orient);
  if (cv2_branch(in)) {
    *c = in.photo == 5 ? 4 : in.photo == 6 ? 3 : in.photo < 2 ? 1 : in.spp;
    *kind = in.numeric() ? int(in.kind()) : kU8;
  } else {
    const bool gray16 = in.photo < 2 && in.bits == 16;
    // PIL's OPEN_INFO keys for the kinds of this branch (`tiff.py`'s
    // PIL_KEYS): FillOrder 2 only for 1-8 bit gray and palettes and for
    // little-endian MinIsBlack 16-bit gray
    bool pil = in.fill == 1 || (in.bits <= 8 && in.photo != 2 && in.photo != 5) ||
               (gray16 && !in.be && in.photo == 1);
    if (gray16 && in.be && in.photo == 0) pil = false;
    if (in.photo == 2 && in.spp == 4)
      pil = pil && (in.extra.empty() ||
                    (in.extra.size() == 1 && in.extra[0] >= 0 && in.extra[0] <= 2));
    if (in.photo == 5) pil = pil && in.extra.size() == 1 && in.extra[0] == 0;
    if (in.spp == (in.photo == 2 ? 3 : 1) && !in.extra.empty()) pil = false;
    if (in.big && in.be) throw TiffError("PIL opens no big-endian BigTIFF");
    if (uint64_t(in.w) * uint64_t(in.h) > kPilMaxPixels)
      throw TiffError("decompression bomb (" + std::to_string(in.w) + " x " +
                      std::to_string(in.h) + " pixels; PIL opens at most " +
                      std::to_string(kPilMaxPixels) + ")");
    if (!pil)
      throw TiffError("PIL reads no such TIFF (photometric " + std::to_string(in.photo) + ", " +
                      std::to_string(in.spp) + " x " + std::to_string(in.bits) +
                      " bits, SampleFormat " + std::to_string(in.sf) + ", FillOrder " +
                      std::to_string(in.fill) + ")");
    if (turned)
      throw out_of_scope("orientation " + std::to_string(in.orient) +
                         " read through PIL, which reads its samples with the sides swapped");
    *c = in.photo == 2 || in.photo == 5 ? 3 : 1;
    *kind = gray16 ? kU16 : in.photo < 2 && in.bits == 1 ? kBool : kU8;
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

// a sample of 16 bits or fewer at p (the value, for the 8- and 16-bit paths)
inline int small(const uint8_t* p, int es) {
  if (es == 1) return p[0];
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

}  // namespace

// `_read_image`'s layout (module doc of data/tiff.py); out holds h * w * c
// samples of the kind's size, native order
void decode(const uint8_t* d, size_t n, int* h, int* w, int* c, int* kind,
            std::vector<uint8_t>* out) {
  const Info in = info_of(d, n);
  layout(in, h, w, c, kind);
  const bool cv2 = cv2_branch(in);
  // PIL raises on a codec's fault, and so does OpenCV's encoded-strip read
  const std::vector<uint8_t> s = samples(d, n, in, cv2 && rgba_reader(in));
  const int es = in.es();
  const size_t ok = *kind == kU16 || *kind == kI16 ? 2 : *kind >= kI32 && *kind <= kF32 ? 4
                    : *kind == kF64 ? 8 : 1;
  out->assign(size_t(*h) * *w * *c * ok, 0);
  uint8_t* o8 = out->data();
  const Ycc ycc = in.hs ? ycc_tables(in) : Ycc{};
  for (int i = 0; i < *h; ++i)
    for (int j = 0; j < *w; ++j) {
      int y, x;
      turn(in.orient, in.h, in.w, i, j, &y, &x);
      const uint8_t* p = &s[(size_t(y) * in.w + x) * in.spp * es];
      const size_t q = (size_t(i) * *w + j) * *c;
      uint8_t* o = o8 + q * ok;
      if (cv2 && in.numeric()) {       // samples as stored; A R G B
        if (in.spp == 4) {
          std::memcpy(o, p + 3 * es, size_t(es));
          std::memcpy(o + es, p, size_t(3) * es);
        } else {
          std::memcpy(o, p, size_t(*c) * es);
        }
      } else if (cv2 && in.photo == 5) {
        o[0] = 255;
        cmyk_rgb(p, o + 1);
      } else if (cv2 && in.photo == 6) {
        if (in.hs) ycc_rgb(ycc, p, o); else std::memcpy(o, p, 3);
      } else if (cv2) {
        if (in.photo < 2) {
          o[0] = gray8(in, p[0]);
        } else if (in.spp == 3) {
          std::memcpy(o, p, 3);
        } else {  // A R G B, unassociated alpha premultiplied
          const bool unassoc = in.extra.size() == 1 && in.extra[0] == 2;
          o[0] = p[3];
          for (int k = 0; k < 3; ++k) o[1 + k] = uint8_t(unassoc ? (p[k] * p[3] + 127) / 255 : p[k]);
        }
      } else if (in.photo == 5) {      // PIL's CMYK: the ink as stored
        std::memcpy(o, p, 3);
      } else if (*kind == kU16 || in.photo == 3) {
        if (*kind == kU16) std::memcpy(o, p, 2); else o[0] = p[0];
      } else if (in.photo < 2) {
        const uint8_t v = gray8(in, p[0]);
        o[0] = *kind == kBool ? v != 0 : v;
      } else {  // 16-bit RGB: high bytes, associated alpha divided out
        const bool assoc = in.extra.size() == 1 && in.extra[0] == 1 && in.spp == 4;
        for (int k = 0; k < 3; ++k) {
          const int v = small(p + k * es, es) >> 8;
          o[k] = assoc ? unpremultiply(v, small(p + 3 * es, es) >> 8) : uint8_t(v);
        }
      }
    }
}

// the JAX native loader's pixels, B G R (header comment)
void decode_bgr(const uint8_t* d, size_t n, int* h, int* w, std::vector<uint8_t>* bgr) {
  const Info in = info_of(d, n);
  const int cn = in.photo == 5 || (in.photo == 2 && in.spp == 4) ? 4 : in.photo == 2 ||
                 in.photo == 6 ? 3 : 1;
  if (in.numeric() || (in.photo == 5 && in.spp == 5)) {
    const Kind k = in.kind();
    const char* what = k == kI8 ? "signed 8-bit" : k == kI16 ? "signed 16-bit"
                       : k == kI32 ? "signed 32-bit" : k == kU32 ? "unsigned 32-bit"
                       : k == kF64 ? "64-bit float" : "32-bit float";
    if (((k == kI32 || k == kF64) && cn == 1) || ((k == kI8 || k == kI16) && cn != 3))
      throw TiffError(std::string("a ") + std::to_string(cn) + "-channel " + what +
                      " TIFF, on which OpenCV 4.6 aborts its process (cvtColor takes 8U, 16U "
                      "and 32F); the port fails the job instead");
    if (k == kI32 || k == kU32 || k == kF64 || in.photo == 5)
      throw TiffError(std::string("OpenCV 4.6 reads no such TIFF (") +
                      (in.photo == 5 ? "CMYK and an extra sample" : std::to_string(cn) +
                       "-channel " + what) + ")");
  }
  // OpenCV reads a 16-bit or wider image with TIFFReadEncodedStrip, and
  // fails where it fails; the others through the RGBA reader, which fills
  const std::vector<uint8_t> s = samples(d, n, in, rgba_reader(in));
  const int es = in.es();
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
  const bool unassoc = in.photo == 2 && in.bits == 8 && in.sf == 1 && in.spp == 4 &&
                       in.extra.size() == 1 && in.extra[0] == 2;
  const Ycc ycc = in.hs ? ycc_tables(in) : Ycc{};
  uint8_t* o = bgr->data();
  for (int i = 0; i < *h; ++i)
    for (int j = 0; j < *w; ++j, o += 3) {
      int y, x;
      turn(in.orient, in.h, in.w, i, j, &y, &x);
      const uint8_t* p = &s[(size_t(y) * in.w + x) * in.spp * es];
      uint8_t rgb[3];
      if (in.numeric()) {
        for (int k = 0; k < 3; ++k) o[k] = to_u8(in, p + (cn == 1 ? 0 : 2 - k) * es);
      } else if (in.photo == 3) {
        std::memcpy(o, pal[p[0]], 3);
      } else if (in.photo < 2) {
        o[0] = o[1] = o[2] = in.bits == 16 ? uint8_t(std::min(small(p, es), 255)) : gray8(in, p[0]);
      } else if (in.photo == 5 || (in.photo == 6 && in.hs)) {
        if (in.photo == 5) cmyk_rgb(p, rgb); else ycc_rgb(ycc, p, rgb);
        o[0] = rgb[2], o[1] = rgb[1], o[2] = rgb[0];
      } else {
        for (int k = 0; k < 3; ++k) {
          int v = in.bits == 16 ? small(p + (2 - k) * es, es) : p[2 - k];
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
