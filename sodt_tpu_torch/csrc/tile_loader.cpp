// Tile loader of the port: PNG / JPEG / BMP / TIFF decode, resize and
// prefetch on host threads.
//
// The port's counterpart of the JAX system's native loader, in C++17 with
// the standard library alone: no OpenCV and no zlib. A worker thread takes
// decode jobs in the order they were submitted and splits each job's tiles
// over a small pool, so Python can submit the next step's (rgb, ir) pairs
// and go on driving the device while they decode; `loader_wait` blocks
// without the interpreter lock (ctypes releases it). Decoded tiles stay in a
// RAM cache up to a byte budget.
//
// Each tile is made as the JAX native loader makes it through OpenCV:
//   1. the file is read as cv::imread(IMREAD_UNCHANGED) reads it, the
//      decoder chosen by its signature (as OpenCV chooses it), not by its
//      name: a PNG here (gray, palette colours, RGB, each with or without
//      alpha), a JPEG by `jpeg.cpp` (gray or RGB), a BMP by `bmp.cpp` and
//      a TIFF by `tiff.cpp` (their docs say what each kind gives); held as
//      BGR;
//   2. gray is widened to three channels, alpha is dropped;
//   3. 16-bit samples saturate to 8 bits (convertTo(CV_8U) without a scale);
//   4. the longest side is resized to img_size with cv::resize's arithmetic:
//      INTER_AREA when shrinking, INTER_LINEAR when enlarging, nothing when
//      the side already is img_size;
//   5. the result, RGB, is padded at the bottom and right to
//      img_size x img_size with 114.
// The resize follows `sodt_tpu_torch/data/resize.py` step for step. Build
// without -ffast-math and with -ffp-contract=off: the area resize sums
// float32 products in cv2's order, and a fused multiply-add changes them.
//
// C ABI (ctypes), the JAX loader's:
//   handle = loader_create(rgb_paths, ir_paths, n_files, img_size,
//                          cache_bytes)
//   loader_submit(handle, job_id, indices, n_idx)   // starts a job
//   loader_wait(handle, job_id, rgb_out, ir_out)    // 1 done, 0 failed
//   loader_last_error(handle, buf, buf_len)         // why a job failed
//   loader_destroy(handle)
// Output of a job: n_idx tiles of (img_size, img_size, 3) uint8, RGB then
// IR, C-contiguous. Any file that cannot be read fails the whole job, and
// the error names the file and the cause: a gray stand-in would train the
// sample's labels against a blank tile.

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// csrc/jpeg.cpp: a JPEG file in memory -> (h, w), c = 1 gray or 3 RGB, and
// its (h, w, c) pixels, as OpenCV 4.6 reads them where `opencv46`; throws
// std::runtime_error with the cause
namespace sodt_jpeg {
void decode(const uint8_t* data, size_t n, int* h, int* w, int* c, std::vector<uint8_t>* px,
            bool opencv46);
}  // namespace sodt_jpeg

// csrc/bmp.cpp, csrc/tiff.cpp and csrc/webp.cpp: a BMP, TIFF or WebP file in
// memory -> (h, w) and its (h, w) B G R pixels as OpenCV 4.6 reads them (gray
// widened, alpha dropped, 16-bit, signed and float samples saturated as its
// convertTo(CV_8U) does); throw std::runtime_error with the cause, which for
// the TIFF kinds on which 4.6 aborts its process names the kind
namespace sodt_bmp {
void decode_bgr(const uint8_t* data, size_t n, int* h, int* w, std::vector<uint8_t>* bgr);
}  // namespace sodt_bmp
namespace sodt_tiff {
void decode_bgr(const uint8_t* data, size_t n, int* h, int* w, std::vector<uint8_t>* bgr);
}  // namespace sodt_tiff
namespace sodt_webp {
void decode_bgr(const uint8_t* data, size_t n, int* h, int* w, std::vector<uint8_t>* bgr);
}  // namespace sodt_webp

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------ checksums

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  // slicing by 8 over the reflected polynomial 0xEDB88320
  static const auto table = [] {
    std::vector<uint32_t> t(8 * 256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s * 256 + i] = (t[(s - 1) * 256 + i] >> 8) ^ t[t[(s - 1) * 256 + i] & 0xFF];
    return t;
  }();
  const uint32_t* t = table.data();
  crc = ~crc;
  while (n >= 8) {
    uint32_t a = crc ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 |
                        uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
    uint32_t b = uint32_t(p[4]) | uint32_t(p[5]) << 8 | uint32_t(p[6]) << 16 |
                 uint32_t(p[7]) << 24;
    crc = t[7 * 256 + (a & 0xFF)] ^ t[6 * 256 + ((a >> 8) & 0xFF)] ^
          t[5 * 256 + ((a >> 16) & 0xFF)] ^ t[4 * 256 + (a >> 24)] ^
          t[3 * 256 + (b & 0xFF)] ^ t[2 * 256 + ((b >> 8) & 0xFF)] ^
          t[1 * 256 + ((b >> 16) & 0xFF)] ^ t[b >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

}  // namespace

// ------------------------------------------------------ inflate (RFC 1950/1951)
// One inflate for the host library: the PNG reader below and csrc/tiff.cpp
// (deflate strips and tiles, through `sodt_inflate::inflate_prefix`) share
// it.

namespace sodt_inflate {

struct InflateError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = std::min<size_t>(n, 5552);  // no uint32 overflow before % 65521
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return b << 16 | a;
}


constexpr int kFastBits = 10;

// A canonical Huffman code. Codes of up to kFastBits bits decode through
// `fast`, indexed by the next kFastBits input bits (the stream holds codes
// most significant bit first, so the table is filled at bit-reversed
// indices); longer codes are found by comparing the next 16 bits, reversed,
// with each length's upper limit.
struct Huffman {
  uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0: a longer code
  int first_code[17];
  int first_sym[17];
  int max_code[18];   // (first code + count) << (16 - length); [16]: sentinel
  uint16_t sym[320];  // symbols ordered by (length, value)

  // lens[i]: the code length of symbol i (0: unused). Over-subscribed codes
  // fail; incomplete ones fail unless `lone_ok` and the code holds at most
  // one 1-bit code, as zlib allows for literal/length and distance codes.
  void build(const uint8_t* lens, int n, bool lone_ok) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) count[lens[i]]++;
    count[0] = 0;
    int left = 1, max_len = 0;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) throw InflateError("bad zlib stream (over-subscribed code)");
      if (count[len]) max_len = len;
    }
    if (left > 0 && !(lone_ok && max_len <= 1))
      throw InflateError("bad zlib stream (incomplete code)");
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
      first_code[len] = code;
      first_sym[len] = k;
      code += count[len];
      max_code[len] = code << (16 - len);
      code <<= 1;
      k += count[len];
    }
    max_code[16] = 0x10000;
    std::memset(fast, 0, sizeof fast);
    int next[16], slot[16];
    for (int len = 1; len <= 15; ++len) {
      next[len] = first_code[len];
      slot[len] = first_sym[len];
    }
    for (int i = 0; i < n; ++i) {
      int len = lens[i];
      if (!len) continue;
      sym[slot[len]++] = uint16_t(i);
      int c = next[len]++;
      if (len > kFastBits) continue;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((c >> b) & 1) << (len - 1 - b);
      for (int j = rev; j < (1 << kFastBits); j += 1 << len)
        fast[j] = uint16_t(len << 9 | i);
    }
  }
};

constexpr int kLenBase[29] = {3,  4,  5,  6,   7,   8,   9,   10,  11, 13,
                              15, 17, 19, 23,  27,  31,  35,  43,  51, 59,
                              67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                               17,   25,   33,   49,   65,   97,    129,   193,
                               257,  385,  513,  769,  1025, 1537,  2049,  3073,
                               4097, 6145, 8193, 12289, 16385, 24577};
constexpr int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

class Inflater {
 public:
  Inflater(const uint8_t* in, size_t n) : pos_(in), end_(in + n) {}

  // The zlib stream -> at most `cap` bytes (the count in `size`), its
  // Adler-32 checked.
  std::unique_ptr<uint8_t[]> Run(size_t cap, size_t& size) {
    std::unique_ptr<uint8_t[]> out(new uint8_t[cap]);
    Stream(out.get(), cap);
    size = n_;
    return out;
  }

  // zlib's inflate() into out[0, need), as libtiff's ZIPDecode calls it on a
  // strip: it stops at the first byte past `need` (mid-match or not) and
  // leaves the rest of the stream, its Adler-32 too, unread, but reads the
  // symbols and block headers up to that byte; the input running out after
  // `need` bytes is no fault. Returns "" where all `need` bytes came, else
  // the cause; `got` counts the bytes that came before it.
  std::string Prefix(uint8_t* out, size_t need, size_t& got) {
    prefix_ = true;
    std::string cause;
    try {
      Stream(out, need);
      if (n_ < need)
        cause = "the stream ends after " + std::to_string(n_) + " of " + std::to_string(need) +
                " bytes";
    } catch (const Full&) {
    } catch (const Truncated& e) {
      if (n_ < need) cause = e.what();
    } catch (const InflateError& e) {
      cause = e.what();
    }
    got = n_;
    return cause;
  }

 private:
  struct Full {};  // Prefix: `need` bytes came and the next one has no room
  struct Truncated : InflateError {
    Truncated() : InflateError("truncated zlib stream") {}
  };

  void Stream(uint8_t* out, size_t cap) {
    uint32_t cmf = Bits(8), flg = Bits(8);
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31)
      throw InflateError("bad zlib stream (header)");
    if (flg & 32) throw InflateError("bad zlib stream (preset dictionary)");
    for (bool last = false; !last;) {
      last = Bits(1);
      uint32_t type = Bits(2);
      if (type == 0) {
        Drop(nbits_ & 7);
        uint32_t len = Bits(16), nlen = Bits(16);
        if ((len ^ 0xFFFF) != nlen) throw InflateError("bad zlib stream (stored length)");
        if (n_ + len > cap && !prefix_) throw InflateError("too much image data");
        // the bytes the bit buffer holds, then the rest straight from the
        // input; Prefix copies what has room, as zlib does
        for (; len && n_ < cap && nbits_ >= 8; --len) out[n_++] = uint8_t(Bits(8));
        if (len && n_ < cap) {
          const size_t take = std::min({size_t(len), cap - n_, size_t(end_ - pos_)});
          std::memcpy(out + n_, pos_, take);
          pos_ += take;
          n_ += take;
          len -= uint32_t(take);
          bits_ = 0;  // the buffer is empty; drop what was loaded ahead
        }
        if (len && n_ == cap) throw Full();
        if (len) throw Truncated();
      } else if (type == 3) {
        throw InflateError("bad zlib stream (block type 3)");
      } else {
        const Huffman* lit;
        const Huffman* dist;
        if (type == 1) {
          lit = &Fixed().first;
          dist = &Fixed().second;
        } else {
          Dynamic();
          lit = &lit_;
          dist = &dist_;
        }
        Codes(*lit, *dist, out, cap);
      }
    }
    Drop(nbits_ & 7);
    uint32_t want = Bits(8) << 24;
    want |= Bits(8) << 16;
    want |= Bits(8) << 8;
    want |= Bits(8);
    if (adler32(out, n_) != want) throw InflateError("bad zlib stream (Adler-32)");
  }

  // Tops the bit buffer up to at least 56 bits while input remains. With 8
  // bytes ahead it loads them at once and counts the whole bytes that fit:
  // the bits above the count are those same next bytes, which a later load
  // puts at the same place again.
  void Refill() {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (end_ - pos_ >= 8) {
      uint64_t word;
      std::memcpy(&word, pos_, 8);
      bits_ |= word << nbits_;
      int take = (63 - nbits_) >> 3;
      pos_ += take;
      nbits_ += take * 8;
      return;
    }
#endif
    while (nbits_ <= 56 && pos_ < end_) {
      bits_ |= uint64_t(*pos_++) << nbits_;
      nbits_ += 8;
    }
  }
  void Drop(int n) {
    bits_ >>= n;
    nbits_ -= n;
  }
  uint32_t Bits(int n) {
    if (nbits_ < n) Refill();
    if (nbits_ < n) throw Truncated();
    uint32_t v = uint32_t(bits_ & ((uint64_t(1) << n) - 1));
    Drop(n);
    return v;
  }
  int Decode(const Huffman& h) {
    if (nbits_ < 16) Refill();
    int e = h.fast[bits_ & ((1 << kFastBits) - 1)];
    int len, s;
    if (e) {
      len = e >> 9;
      s = e & 511;
    } else {
      uint32_t v = uint32_t(bits_ & 0xFFFF), k = 0;
      for (int b = 0; b < 16; ++b) k |= ((v >> b) & 1) << (15 - b);
      for (len = kFastBits + 1; int(k) >= h.max_code[len]; ++len) {
      }
      if (len > nbits_) throw Truncated();
      if (len >= 16) throw InflateError("bad zlib stream (invalid code)");
      int i = int(k >> (16 - len)) - h.first_code[len] + h.first_sym[len];
      if (i < 0 || i >= 320) throw InflateError("bad zlib stream (invalid code)");
      s = h.sym[i];
    }
    if (len > nbits_) throw Truncated();
    Drop(len);
    return s;
  }

  static const std::pair<Huffman, Huffman>& Fixed() {
    static const auto fixed = [] {
      std::pair<Huffman, Huffman> f;
      uint8_t lens[288];
      std::fill(lens, lens + 144, 8);
      std::fill(lens + 144, lens + 256, 9);
      std::fill(lens + 256, lens + 280, 7);
      std::fill(lens + 280, lens + 288, 8);
      f.first.build(lens, 288, false);
      uint8_t d[32];
      std::fill(d, d + 32, 5);
      f.second.build(d, 32, false);
      return f;
    }();
    return fixed;
  }

  void Dynamic() {
    static const int order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};
    int nlit = int(Bits(5)) + 257, ndist = int(Bits(5)) + 1, ncode = int(Bits(4)) + 4;
    if (nlit > 286 || ndist > 30)
      throw InflateError("bad zlib stream (too many length or distance symbols)");
    uint8_t clens[19] = {0};
    for (int i = 0; i < ncode; ++i) clens[order[i]] = uint8_t(Bits(3));
    Huffman cl;
    cl.build(clens, 19, false);
    uint8_t lens[286 + 30] = {0};
    for (int i = 0; i < nlit + ndist;) {
      int s = Decode(cl);
      if (s < 16) {
        lens[i++] = uint8_t(s);
        continue;
      }
      int rep, val = 0;
      if (s == 16) {
        if (i == 0) throw InflateError("bad zlib stream (repeat with no length)");
        val = lens[i - 1];
        rep = 3 + int(Bits(2));
      } else if (s == 17) {
        rep = 3 + int(Bits(3));
      } else {
        rep = 11 + int(Bits(7));
      }
      if (i + rep > nlit + ndist) throw InflateError("bad zlib stream (too many lengths)");
      while (rep--) lens[i++] = uint8_t(val);
    }
    if (!lens[256]) throw InflateError("bad zlib stream (no end-of-block code)");
    lit_.build(lens, nlit, true);
    dist_.build(lens + nlit, ndist, true);
  }

  // The codes of one block into out[n_, cap); n_ counts what came, also
  // where it throws.
  void Codes(const Huffman& lit, const Huffman& dist, uint8_t* out, size_t cap) {
    size_t n = n_;
    try {
      for (;;) {
        int s = Decode(lit);
        if (s < 256) {
          if (n >= cap) {
            if (prefix_) throw Full();
            throw InflateError("too much image data");
          }
          out[n++] = uint8_t(s);
          continue;
        }
        if (s == 256) break;
        s -= 257;
        if (s >= 29) throw InflateError("bad zlib stream (invalid length symbol)");
        size_t len = size_t(kLenBase[s]) + Bits(kLenExtra[s]);
        int d = Decode(dist);
        if (d >= 30) throw InflateError("bad zlib stream (invalid distance symbol)");
        size_t back = size_t(kDistBase[d]) + Bits(kDistExtra[d]);
        if (n >= cap && prefix_) throw Full();  // zlib stops before it checks the distance
        if (back > n) throw InflateError("bad zlib stream (distance too far back)");
        bool cut = false;
        if (n + len > cap) {
          if (!prefix_) throw InflateError("too much image data");
          len = cap - n;
          cut = true;
        }
        const uint8_t* src = out + n - back;
        uint8_t* dst = out + n;
        if (back >= len) {
          std::memcpy(dst, src, len);
        } else {
          for (size_t i = 0; i < len; ++i) dst[i] = src[i];
        }
        n += len;
        if (cut) throw Full();
      }
    } catch (...) {
      n_ = n;
      throw;
    }
    n_ = n;
  }

  const uint8_t* pos_;
  const uint8_t* end_;
  uint64_t bits_ = 0;
  int nbits_ = 0;
  size_t n_ = 0;  // the bytes written
  bool prefix_ = false;
  Huffman lit_, dist_;
};

// A TIFF strip or tile's deflate data in[0, n) -> its first `need` bytes in
// `out`, as libtiff's ZIPDecode reads them with zlib (Inflater::Prefix).
// Returns "" where all came, else the cause; `out` then holds the bytes that
// came before it, zeros after.
std::string inflate_prefix(const uint8_t* in, size_t n, size_t need, std::vector<uint8_t>* out) {
  out->assign(need, 0);
  size_t got = 0;
  return Inflater(in, n).Prefix(out->data(), need, got);
}

}  // namespace sodt_inflate

namespace {

using sodt_inflate::Inflater;

// ------------------------------------------------------------------ PNG

// An 8-bit three-channel image in OpenCV's BGR order, rows packed.
struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> px;
};

// Adam7: each pass's row start, column start, row step, column step
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4}, {0, 2, 4, 4},
                              {2, 0, 4, 2}, {0, 1, 2, 2}, {1, 0, 2, 1}};

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int spp() const { return ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 1; }
  size_t stride(uint32_t width) const {
    return (size_t(width) * depth * spp() + 7) / 8;
  }
};

std::vector<uint8_t> read_file(const std::string& path) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path.c_str(), "rb"), std::fclose);
  if (!f) throw Error(std::string("cannot open the file (") + std::strerror(errno) + ")");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f.get())) > 0)
    data.insert(data.end(), buf, buf + got);
  if (std::ferror(f.get())) throw Error("cannot read the file");
  return data;
}

uint8_t paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  int bc = pb <= pc ? b : c;
  return uint8_t(pa <= pb && pa <= pc ? a : bc);
}

// Undo the row filters of `rows` rows of `stride` bytes, each led by its
// filter type byte, in place; `bpp` is the bytes of a whole pixel (>= 1).
void unfilter(uint8_t* buf, size_t rows, size_t stride, int bpp) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * (stride + 1);
    int ft = row[0];
    uint8_t* x = row + 1;
    switch (ft) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) x[i] = uint8_t(x[i] + x[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) x[i] = uint8_t(x[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? x[i - bpp] : 0;
          x[i] = uint8_t(x[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          bool left = i >= size_t(bpp);
          x[i] = uint8_t(x[i] + paeth(left ? x[i - bpp] : 0, prev[i],
                                      left ? prev[i - bpp] : 0));
        }
        break;
      default:
        throw Error("broken PNG file (filter type " + std::to_string(ft) + ")");
    }
    prev = x;
  }
}

// One unfiltered row of `n` pixels -> BGR pixels at out, out + step, ...,
// as cv::imread(IMREAD_UNCHANGED) and the loader's conversions leave them.
void row_to_bgr(const uint8_t* row, uint32_t n, const PngHeader& hd,
                const uint8_t* pal, uint8_t* out, size_t step) {
  const int spp = hd.spp(), depth = hd.depth;
  if (depth == 8 && (hd.ctype == 0 || hd.ctype == 2)) {  // the common cases
    for (uint32_t x = 0; x < n; ++x, out += step, row += spp) {
      out[0] = row[spp - 1];
      out[1] = row[spp / 2];
      out[2] = row[0];
    }
    return;
  }
  auto sample = [&](uint32_t x, int c) -> uint8_t {
    if (depth == 8) return row[size_t(x) * spp + c];
    const uint8_t* p = row + 2 * (size_t(x) * spp + c);
    return p[0] ? 255 : p[1];  // 16 bits saturated to 8
  };
  for (uint32_t x = 0; x < n; ++x, out += step) {
    if (hd.ctype == 2 || hd.ctype == 6) {
      out[0] = sample(x, 2);
      out[1] = sample(x, 1);
      out[2] = sample(x, 0);
      continue;
    }
    uint8_t v;
    if (depth >= 8) {
      v = sample(x, 0);
    } else {
      size_t bit = size_t(x) * depth;
      int i = (row[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1 << depth) - 1);
      if (hd.ctype == 3) {
        std::memcpy(out, pal + 3 * i, 3);
        continue;
      }
      v = uint8_t(i * (255 / ((1 << depth) - 1)));  // gray widened to 8 bits
    }
    if (hd.ctype == 3) {
      std::memcpy(out, pal + 3 * v, 3);
    } else {
      out[0] = out[1] = out[2] = v;
    }
  }
}

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

Image decode_png(const std::vector<uint8_t>& data) {
  PngHeader hd;
  bool have_header = false, have_end = false;
  // the palette in BGR order, black past its end
  std::vector<uint8_t> pal(256 * 3, 0);
  int n_pal = 0;
  std::vector<uint8_t> idat;
  for (size_t pos = 8; pos < data.size() && !have_end;) {
    if (data.size() - pos < 12) throw Error("truncated PNG file (chunk header)");
    uint32_t len = be32(&data[pos]);
    std::string kind(reinterpret_cast<const char*>(&data[pos + 4]), 4);
    if (len > data.size() - pos - 12)
      throw Error("truncated PNG file (chunk " + kind + ")");
    const uint8_t* body = &data[pos + 8];
    if (crc32(&data[pos + 4], len + 4) != be32(body + len))
      throw Error("broken PNG file (bad CRC in chunk " + kind + ")");
    if (!have_header && kind != "IHDR") throw Error("broken PNG file (IHDR is not first)");
    if (kind == "IHDR") {
      if (len != 13 || have_header) throw Error("broken PNG file (IHDR)");
      hd.w = be32(body);
      hd.h = be32(body + 4);
      hd.depth = body[8];
      hd.ctype = body[9];
      hd.interlace = body[12];
      static const std::map<int, std::vector<int>> depths = {
          {0, {1, 2, 4, 8, 16}}, {2, {8, 16}}, {3, {1, 2, 4, 8}}, {4, {8, 16}}, {6, {8, 16}}};
      auto it = depths.find(hd.ctype);
      bool ok = it != depths.end() &&
                std::count(it->second.begin(), it->second.end(), hd.depth) &&
                body[10] == 0 && body[11] == 0 && hd.interlace <= 1;
      if (!ok)
        throw Error("broken PNG file (bit depth " + std::to_string(hd.depth) +
                    ", colour type " + std::to_string(hd.ctype) + ", interlace " +
                    std::to_string(hd.interlace) + ")");
      if (hd.w == 0 || hd.h == 0 || hd.w > (1u << 16) || hd.h > (1u << 16))
        throw Error("unsupported image size " + std::to_string(hd.w) + " x " +
                    std::to_string(hd.h));
      have_header = true;
    } else if (kind == "PLTE") {
      if (len % 3 || len > 768) throw Error("broken PNG file (PLTE)");
      n_pal = int(len / 3);
      for (int i = 0; i < n_pal; ++i)
        for (int c = 0; c < 3; ++c) pal[3 * i + c] = body[3 * i + 2 - c];
    } else if (kind == "IDAT") {
      idat.insert(idat.end(), body, body + len);
    } else if (kind == "IEND") {
      have_end = true;
    }
    pos += size_t(len) + 12;
  }
  if (!have_header) throw Error("broken PNG file (no IHDR)");
  if (idat.empty()) throw Error("broken PNG file (no IDAT)");
  if (!have_end) throw Error("truncated PNG file (no IEND)");
  if (hd.ctype == 3 && !n_pal) throw Error("broken PNG file (no PLTE)");

  // each pass's (rows, pixels a row); one pass where not interlaced
  std::vector<std::array<uint32_t, 6>> passes;  // ph, pw, y0, x0, dy, dx
  if (!hd.interlace) {
    passes.push_back({hd.h, hd.w, 0, 0, 1, 1});
  } else {
    for (const auto& a : kAdam7) {
      uint32_t ph = hd.h > uint32_t(a[0]) ? (hd.h - a[0] + a[2] - 1) / a[2] : 0;
      uint32_t pw = hd.w > uint32_t(a[1]) ? (hd.w - a[1] + a[3] - 1) / a[3] : 0;
      if (ph && pw)
        passes.push_back({ph, pw, uint32_t(a[0]), uint32_t(a[1]), uint32_t(a[2]),
                          uint32_t(a[3])});
    }
  }
  size_t need = 0;
  for (const auto& p : passes) need += size_t(p[0]) * (hd.stride(p[1]) + 1);
  size_t got = 0;
  std::unique_ptr<uint8_t[]> raw = Inflater(idat.data(), idat.size()).Run(need + (1 << 20), got);
  if (got < need) throw Error("truncated PNG file (image data)");

  Image img;
  img.h = int(hd.h);
  img.w = int(hd.w);
  img.px.resize(size_t(img.h) * img.w * 3);
  const int bpp = std::max(hd.depth * hd.spp() / 8, 1);
  size_t off = 0;
  for (const auto& p : passes) {
    const uint32_t ph = p[0], pw = p[1];
    const size_t stride = hd.stride(pw);
    uint8_t* buf = raw.get() + off;
    unfilter(buf, ph, stride, bpp);
    for (uint32_t r = 0; r < ph; ++r) {
      size_t y = p[2] + size_t(r) * p[4];
      uint8_t* out = img.px.data() + (y * img.w + p[3]) * 3;
      row_to_bgr(buf + r * (stride + 1) + 1, pw, hd, pal.data(), out, 3 * p[5]);
    }
    off += size_t(ph) * (stride + 1);
  }
  return img;
}

Image decode_image(const std::string& path) {
  std::vector<uint8_t> data = read_file(path);
  if (data.size() >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    int h, w, c;
    std::vector<uint8_t> px;
    sodt_jpeg::decode(data.data(), data.size(), &h, &w, &c, &px, true);
    Image img;
    img.h = h;
    img.w = w;
    img.px.resize(size_t(h) * w * 3);
    const size_t n = size_t(h) * w;
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* s = &px[i * c];
      uint8_t* d = &img.px[i * 3];
      d[0] = s[c == 3 ? 2 : 0];
      d[1] = s[c == 3 ? 1 : 0];
      d[2] = s[0];
    }
    return img;
  }
  if (data.size() >= 8 && !std::memcmp(data.data(), kPngSig, 8)) return decode_png(data);
  const bool bmp = data.size() >= 2 && data[0] == 'B' && data[1] == 'M';
  const bool tiff = data.size() >= 4 && (!std::memcmp(data.data(), "II*\0", 4) ||
                                         !std::memcmp(data.data(), "MM\0*", 4) ||
                                         !std::memcmp(data.data(), "II+\0", 4) ||
                                         !std::memcmp(data.data(), "MM\0+", 4));
  const bool webp = data.size() >= 12 && !std::memcmp(data.data(), "RIFF", 4) &&
                    !std::memcmp(data.data() + 8, "WEBP", 4);
  if (bmp || tiff || webp) {
    Image img;
    (bmp ? sodt_bmp::decode_bgr : tiff ? sodt_tiff::decode_bgr : sodt_webp::decode_bgr)(
        data.data(), data.size(), &img.h, &img.w, &img.px);
    return img;
  }
  throw Error("not a PNG, JPEG, BMP, TIFF or WebP file (signature): the port reads those five "
              "formats");
}

// ---------------------------------------------------------------- resize
// cv::resize on 8-bit three-channel images, as `data/resize.py` computes it.

constexpr int kCoefBits = 11;       // INTER_RESIZE_COEF_BITS
constexpr int kCoefScale = 1 << kCoefBits;
constexpr int kC = 3;

double step_of(int n_in, int n_out) { return 1.0 / (double(n_out) / double(n_in)); }

uint8_t round_u8(float v) {
  long r = std::lrint(v);  // half to even, as cvRound
  return uint8_t(std::min<long>(std::max<long>(r, 0), 255));
}

// integer factors kx, ky: each output the mean of its kx x ky cell
Image area_integer(const Image& src, int ow, int oh, int kx, int ky) {
  Image dst;
  dst.w = ow;
  dst.h = oh;
  dst.px.resize(size_t(ow) * oh * kC);
  const bool vec2 = kx == 2 && ky == 2;  // cv2's vector path: (s + 2) >> 2
  const float scale = 1.0f / float(kx * ky);
  const size_t sw = size_t(src.w) * kC;
  std::vector<int32_t> col(sw);  // the cell rows summed, per source byte
  for (int y = 0; y < oh; ++y) {
    std::fill(col.begin(), col.end(), 0);
    for (int i = 0; i < ky; ++i) {
      const uint8_t* row = &src.px[(size_t(y) * ky + i) * sw];
      for (size_t j = 0; j < sw; ++j) col[j] += row[j];
    }
    uint8_t* d = &dst.px[size_t(y) * ow * kC];
    for (int x = 0; x < ow; ++x) {
      const int32_t* cell = &col[size_t(x) * kx * kC];
      for (int c = 0; c < kC; ++c) {
        int32_t s = 0;
        for (int j = 0; j < kx; ++j) s += cell[j * kC + c];
        d[x * kC + c] = vec2 ? uint8_t((s + 2) >> 2) : round_u8(float(s) * scale);
      }
    }
  }
  return dst;
}

struct Tap {
  int d, s;
  float a;
};

// cv2's computeResizeAreaTab: (dst index, src index, float32 weight) of
// every tap, in cv2's order
std::vector<Tap> area_tab(int n_in, int n_out, double scale) {
  std::vector<Tap> tab;
  for (int d = 0; d < n_out; ++d) {
    double f1 = d * scale, f2 = f1 + scale;
    double cell = std::min(scale, n_in - f1);
    int s1 = int(std::ceil(f1)), s2 = int(std::floor(f2));
    s2 = std::min(s2, n_in - 1);
    s1 = std::min(s1, s2);
    if (s1 - f1 > 1e-3) tab.push_back({d, s1 - 1, float((s1 - f1) / cell)});
    for (int s = s1; s < s2; ++s) tab.push_back({d, s, float(1.0 / cell)});
    if (f2 - s2 > 1e-3)
      tab.push_back({d, s2, float(std::min(std::min(f2 - s2, 1.0), cell) / cell)});
  }
  return tab;
}

// cv2's ResizeArea_Invoker: float32 sums along x, then along y
Image area_general(const Image& src, int ow, int oh) {
  const std::vector<Tap> xt = area_tab(src.w, ow, step_of(src.w, ow));
  const std::vector<Tap> yt = area_tab(src.h, oh, step_of(src.h, oh));
  Image dst;
  dst.w = ow;
  dst.h = oh;
  dst.px.resize(size_t(ow) * oh * kC);
  const size_t width = size_t(ow) * kC;
  std::vector<float> buf(width), acc(width);
  int prev = yt[0].d;
  auto flush = [&](int dy) {
    uint8_t* d = &dst.px[size_t(dy) * width];
    for (size_t i = 0; i < width; ++i) d[i] = round_u8(acc[i]);
  };
  bool first = true;
  for (const Tap& ty : yt) {
    std::fill(buf.begin(), buf.end(), 0.0f);
    const uint8_t* row = &src.px[size_t(ty.s) * src.w * kC];
    for (const Tap& tx : xt) {
      for (int c = 0; c < kC; ++c) {
        float prod = float(row[size_t(tx.s) * kC + c]) * tx.a;
        buf[size_t(tx.d) * kC + c] = buf[size_t(tx.d) * kC + c] + prod;
      }
    }
    if (ty.d != prev) {
      flush(prev);
      prev = ty.d;
      first = true;
    }
    for (size_t i = 0; i < width; ++i) {
      float term = ty.a * buf[i];
      acc[i] = first ? term : acc[i] + term;
    }
    first = false;
  }
  flush(prev);
  return dst;
}

// cv2's two source indices and 11-bit weights of each output position.
// Along x (`clamp`) a tap left of the first or right of the last source
// pixel takes weight 0 at the edge pixel; along y cv2 keeps the weights and
// clamps only the rows it reads.
void linear_coeffs(int n_in, int n_out, bool clamp, std::vector<int>& i0,
                   std::vector<int>& i1, std::vector<int>& a0, std::vector<int>& a1) {
  const double scale = step_of(n_in, n_out);
  i0.resize(n_out);
  i1.resize(n_out);
  a0.resize(n_out);
  a1.resize(n_out);
  for (int d = 0; d < n_out; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int s = int(std::floor(f));
    f = f - float(s);
    if (clamp) {
      if (s < 0) {
        f = 0;
        s = 0;
      }
      if (s >= n_in - 1) {
        f = 0;
        s = n_in - 1;
      }
    }
    a1[d] = int(std::lrint(f * float(kCoefScale)));
    a0[d] = int(std::lrint((1.0f - f) * float(kCoefScale)));
    i0[d] = std::min(std::max(s, 0), n_in - 1);
    i1[d] = std::min(std::max(s + 1, 0), n_in - 1);
  }
}

// cv2's INTER_LINEAR for uint8: a horizontal pass in int32, then a
// vertical pass as cv2's vector steps round ((S >> 4) * b >> 16, summed,
// + 2 >> 2), at every byte of the row: OpenCV rounds the bytes past the
// last whole 16 as its vector body does
Image linear(const Image& src, int ow, int oh) {
  std::vector<int> x0, x1, a0, a1, y0, y1, b0, b1;
  linear_coeffs(src.w, ow, true, x0, x1, a0, a1);
  linear_coeffs(src.h, oh, false, y0, y1, b0, b1);
  const size_t width = size_t(ow) * kC;
  std::vector<int32_t> hor(size_t(src.h) * width);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* row = &src.px[size_t(y) * src.w * kC];
    int32_t* h = &hor[size_t(y) * width];
    for (int x = 0; x < ow; ++x)
      for (int c = 0; c < kC; ++c)
        h[x * kC + c] = int32_t(row[size_t(x0[x]) * kC + c]) * a0[x] +
                        int32_t(row[size_t(x1[x]) * kC + c]) * a1[x];
  }
  Image dst;
  dst.w = ow;
  dst.h = oh;
  dst.px.resize(size_t(oh) * width);
  for (int y = 0; y < oh; ++y) {
    const int32_t* s0 = &hor[size_t(y0[y]) * width];
    const int32_t* s1 = &hor[size_t(y1[y]) * width];
    const int32_t w0 = b0[y], w1 = b1[y];
    uint8_t* d = &dst.px[size_t(y) * width];
    for (size_t i = 0; i < width; ++i) {
      int32_t v = (((s0[i] >> 4) * w0) >> 16) + (((s1[i] >> 4) * w1) >> 16);
      v = (v + 2) >> 2;
      d[i] = uint8_t(std::min(std::max(v, 0), 255));
    }
  }
  return dst;
}

// the longest side to `size` (sides int(side * r)): INTER_AREA shrinking,
// INTER_LINEAR enlarging, the image itself at r == 1; then RGB on a
// size x size canvas of 114
void make_tile(const Image& img, int size, uint8_t* out) {
  const double r = double(size) / std::max(img.h, img.w);
  const Image* src = &img;
  Image resized;
  if (r != 1.0) {
    int ow = int(img.w * r), oh = int(img.h * r);
    if (ow < 1 || oh < 1) throw Error("image too small to resize");
    if (r > 1) {
      resized = linear(img, ow, oh);
    } else {
      double sx = step_of(img.w, ow), sy = step_of(img.h, oh);
      double kx = std::nearbyint(sx), ky = std::nearbyint(sy);
      const double eps = 2.220446049250313e-16;  // DBL_EPSILON
      if (std::abs(sx - kx) < eps && std::abs(sy - ky) < eps)
        resized = area_integer(img, ow, oh, int(kx), int(ky));
      else
        resized = area_general(img, ow, oh);
    }
    src = &resized;
  }
  std::memset(out, 114, size_t(size) * size * kC);
  for (int y = 0; y < src->h; ++y) {
    const uint8_t* s = &src->px[size_t(y) * src->w * kC];
    uint8_t* d = out + size_t(y) * size * kC;
    for (int x = 0; x < src->w; ++x) {
      d[x * kC + 0] = s[x * kC + 2];
      d[x * kC + 1] = s[x * kC + 1];
      d[x * kC + 2] = s[x * kC + 0];
    }
  }
}

// ---------------------------------------------------------------- loader

struct Job {
  uint64_t id;
  std::vector<int> indices;
  std::vector<uint8_t> rgb, ir;  // filled by the worker
  bool done = false;
  std::string error;  // non-empty: the job failed, Wait returns false
};

// the threads a job's tiles are split over: half the host's hardware
// threads, 1 to 8 (the caller's thread drives the device meanwhile)
int pool_size() {
  int hw = int(std::thread::hardware_concurrency());
  return std::min(std::max(hw / 2, 1), 8);
}

class Loader {
 public:
  Loader(std::vector<std::string> rgb_paths, std::vector<std::string> ir_paths,
         int img_size, size_t cache_bytes)
      : rgb_paths_(std::move(rgb_paths)),
        ir_paths_(std::move(ir_paths)),
        img_size_(img_size),
        cache_budget_(cache_bytes),
        threads_(pool_size()) {
    worker_ = std::thread([this] { Run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    worker_.join();
  }

  void Submit(uint64_t id, const int* idx, int n) {
    auto job = std::make_shared<Job>();
    job->id = id;
    job->indices.assign(idx, idx + n);
    {
      std::lock_guard<std::mutex> lk(mu_);
      pending_.push_back(job);
      jobs_[id] = job;
    }
    cv_.notify_all();
  }

  bool Wait(uint64_t id, uint8_t* rgb_out, uint8_t* ir_out) {
    std::shared_ptr<Job> job;
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto it = jobs_.find(id);
      if (it == jobs_.end()) {
        last_error_ = "no job " + std::to_string(id);
        return false;
      }
      job = it->second;
      done_cv_.wait(lk, [&] { return job->done || stop_; });
      jobs_.erase(id);
      if (!job->done) return false;
      if (!job->error.empty()) {
        last_error_ = job->error;
        return false;
      }
    }
    std::memcpy(rgb_out, job->rgb.data(), job->rgb.size());
    std::memcpy(ir_out, job->ir.data(), job->ir.size());
    return true;
  }

  std::string LastError() {
    std::lock_guard<std::mutex> lk(mu_);
    return last_error_;
  }

 private:
  size_t TileBytes() const { return size_t(img_size_) * img_size_ * kC; }

  // tile `index` of one modality into `out`: from the cache, else decoded
  // and kept while the budget allows (JAX's rule: a tile is cached when it
  // still fits, and nothing is ever evicted)
  void Tile(int index, bool ir, uint8_t* out) {
    auto& cache = ir ? ir_cache_ : rgb_cache_;
    {
      std::lock_guard<std::mutex> lk(cache_mu_);
      auto it = cache.find(index);
      if (it != cache.end()) {
        std::memcpy(out, it->second.data(), TileBytes());
        return;
      }
    }
    const std::string& path = ir ? ir_paths_[index] : rgb_paths_[index];
    try {
      make_tile(decode_image(path), img_size_, out);
    } catch (const std::exception& e) {
      throw Error("failed to decode " + path + ": " + e.what());
    }
    std::lock_guard<std::mutex> lk(cache_mu_);
    if (cache_used_ + TileBytes() <= cache_budget_ && !cache.count(index)) {
      cache_used_ += TileBytes();
      cache.emplace(index, std::vector<uint8_t>(out, out + TileBytes()));
    }
  }

  // task 2i is sample i's rgb tile, 2i + 1 its ir tile; the job keeps the
  // error of the first task in that order that failed, as a loop over the
  // tasks in order would
  void RunJob(Job& job) {
    const size_t tile = TileBytes();
    const int n_tasks = int(2 * job.indices.size());
    job.rgb.resize(tile * job.indices.size());
    job.ir.resize(tile * job.indices.size());
    std::atomic<int> next{0}, first_bad{INT_MAX};
    std::vector<std::string> errors(n_tasks);
    auto work = [&] {
      for (int t; (t = next.fetch_add(1)) < n_tasks;) {
        if (first_bad.load() < t) continue;
        size_t i = size_t(t / 2);
        int idx = job.indices[i];
        try {
          if (idx < 0 || size_t(idx) >= rgb_paths_.size())
            throw Error("index " + std::to_string(idx) + " out of range");
          bool ir = t % 2;
          Tile(idx, ir, (ir ? job.ir : job.rgb).data() + i * tile);
        } catch (const std::exception& e) {
          errors[t] = e.what();
          int cur = first_bad.load();
          while (t < cur && !first_bad.compare_exchange_weak(cur, t)) {
          }
        }
      }
    };
    std::vector<std::thread> helpers;
    for (int k = 1; k < std::min(threads_, n_tasks); ++k) helpers.emplace_back(work);
    work();
    for (auto& th : helpers) th.join();
    if (first_bad.load() != INT_MAX) job.error = errors[first_bad.load()];
  }

  void Run() {
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !pending_.empty(); });
        if (stop_) return;
        job = pending_.front();
        pending_.pop_front();
      }
      RunJob(*job);
      {
        std::lock_guard<std::mutex> lk(mu_);
        job->done = true;
      }
      done_cv_.notify_all();
    }
  }

  std::vector<std::string> rgb_paths_, ir_paths_;
  int img_size_;
  size_t cache_budget_;
  int threads_;
  std::mutex cache_mu_;
  size_t cache_used_ = 0;
  std::unordered_map<int, std::vector<uint8_t>> rgb_cache_, ir_cache_;

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<std::shared_ptr<Job>> pending_;
  std::map<uint64_t, std::shared_ptr<Job>> jobs_;
  std::thread worker_;
  bool stop_ = false;
  std::string last_error_;
};

}  // namespace

extern "C" {

void* loader_create(const char** rgb_paths, const char** ir_paths, int n_files,
                    int img_size, size_t cache_bytes) {
  std::vector<std::string> rgb(rgb_paths, rgb_paths + n_files);
  std::vector<std::string> ir(ir_paths, ir_paths + n_files);
  return new Loader(std::move(rgb), std::move(ir), img_size, cache_bytes);
}

void loader_submit(void* handle, uint64_t job_id, const int* indices, int n_idx) {
  static_cast<Loader*>(handle)->Submit(job_id, indices, n_idx);
}

int loader_wait(void* handle, uint64_t job_id, uint8_t* rgb_out, uint8_t* ir_out) {
  return static_cast<Loader*>(handle)->Wait(job_id, rgb_out, ir_out) ? 1 : 0;
}

// Copies the most recent failure (the file and the cause) into buf; returns
// the bytes written, the NUL not counted.
int loader_last_error(void* handle, char* buf, int buf_len) {
  std::string err = static_cast<Loader*>(handle)->LastError();
  if (buf_len <= 0) return 0;
  int n = std::min<int>(int(err.size()), buf_len - 1);
  std::memcpy(buf, err.data(), n);
  buf[n] = '\0';
  return n;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
