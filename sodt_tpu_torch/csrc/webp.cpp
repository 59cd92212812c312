// WebP decoder of the port: `data/webp.py`'s decoder in C++17, standard
// library only. The numpy module is its plain version and the tests hold
// the two bit-equal; its doc has the table of kinds and libwebp's rules
// that both follow.
//
// The container as libwebp's WebPDecode walks it (RIFF size against the
// file, VP8X of 10 bytes with its canvas equal to the frame, ALPH / ICCP /
// EXIF / XMP / unknown chunks before the frame, sizes padded to even), with
// OpenCV's 32-byte minimum (the channels come from the first 32 bytes) and
// 64 MiB maximum; VP8L (RFC 9649) with its four transforms, prefix codes,
// colour cache and LZ77; VP8 keyframes (RFC 6386) to YUV 4:2:0, with
// libwebp's end-of-partition rule; the ALPH plane, raw or VP8L-compressed,
// with its four filters; libwebp's fancy upsampler and 14-bit YUV -> RGB.
// An animated file throws "not implemented: an animated WebP". A WebP side
// is at most 16383 px; more than 2^30 pixels throws before any is
// allocated, as OpenCV refuses them.
//
// Two layouts of the same decode:
//   decode      cv2.imread(IMREAD_UNCHANGED) (cv2 5.0): (h, w)
//               B G R, or B G R A where the first 32 bytes say alpha;
//   decode_bgr  what the JAX native loader's cv::imread (OpenCV 4.6) and
//               its BGRA2BGR leave: (h, w) B G R, alpha dropped.
//
// In the library: sodt_webp::decode_bgr for the tile loader, and a C ABI for
// Python (ctypes), a size query and then a fill:
//   webp_file_shape(path, &h, &w, &c, &kind, err, err_len)    -> 1 ok, 0 failed
//   webp_file_decode(path, out, h, w, c, kind, err, err_len)  -> 1 ok, 0 failed
// (kind is 1: uint8). A failure writes its cause, the file named, into err;
// an animated file starts its cause with "not implemented:".

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace sodt_webp {

struct WebPError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

namespace {

constexpr uint64_t kMaxPixels = uint64_t(1) << 30;  // OpenCV's limit
constexpr size_t kCvHeader = 32;                    // OpenCV's WEBP_HEADER_SIZE
constexpr size_t kCvMaxFile = size_t(64) << 20;     // OpenCV's file size limit
constexpr uint32_t kMaxChunk = ~0u - 10u;           // libwebp's MAX_CHUNK_PAYLOAD
constexpr uint32_t kAnimationFlag = 0x02, kAlphaFlag = 0x10;

// libwebp's constant tables (the port's own copies)
const uint8_t kCoeffsProba0[1056] = {
    128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,
    128,128,128,128,128,128,128,128,128,128,128,253,136,254,255,228,219,128,128,128,128,128,
    189,129,242,255,227,213,255,219,128,128,128,106,126,227,252,214,209,255,255,128,128,128,
    1,98,248,255,236,226,255,255,128,128,128,181,133,238,254,221,234,255,154,128,128,128,
    78,134,202,247,198,180,255,219,128,128,128,1,185,249,255,243,255,128,128,128,128,128,
    184,150,247,255,236,224,128,128,128,128,128,77,110,216,255,236,230,128,128,128,128,128,
    1,101,251,255,241,255,128,128,128,128,128,170,139,241,252,236,209,255,255,128,128,128,
    37,116,196,243,228,255,255,255,128,128,128,1,204,254,255,245,255,128,128,128,128,128,
    207,160,250,255,238,128,128,128,128,128,128,102,103,231,255,211,171,128,128,128,128,128,
    1,152,252,255,240,255,128,128,128,128,128,177,135,243,255,234,225,128,128,128,128,128,
    80,129,211,255,194,224,128,128,128,128,128,1,1,255,128,128,128,128,128,128,128,128,
    246,1,255,128,128,128,128,128,128,128,128,255,128,128,128,128,128,128,128,128,128,128,
    198,35,237,223,193,187,162,160,145,155,62,131,45,198,221,172,176,220,157,252,221,1,
    68,47,146,208,149,167,221,162,255,223,128,1,149,241,255,221,224,255,255,128,128,128,
    184,141,234,253,222,220,255,199,128,128,128,81,99,181,242,176,190,249,202,255,255,128,
    1,129,232,253,214,197,242,196,255,255,128,99,121,210,250,201,198,255,202,128,128,128,
    23,91,163,242,170,187,247,210,255,255,128,1,200,246,255,234,255,128,128,128,128,128,
    109,178,241,255,231,245,255,255,128,128,128,44,130,201,253,205,192,255,255,128,128,128,
    1,132,239,251,219,209,255,165,128,128,128,94,136,225,251,218,190,255,255,128,128,128,
    22,100,174,245,186,161,255,199,128,128,128,1,182,249,255,232,235,128,128,128,128,128,
    124,143,241,255,227,234,128,128,128,128,128,35,77,181,251,193,211,255,205,128,128,128,
    1,157,247,255,236,231,255,255,128,128,128,121,141,235,255,225,227,255,255,128,128,128,
    45,99,188,251,195,217,255,224,128,128,128,1,1,251,255,213,255,128,128,128,128,128,
    203,1,248,255,255,128,128,128,128,128,128,137,1,177,255,224,255,128,128,128,128,128,
    253,9,248,251,207,208,255,192,128,128,128,175,13,224,243,193,185,249,198,255,255,128,
    73,17,171,221,161,179,236,167,255,234,128,1,95,247,253,212,183,255,255,128,128,128,
    239,90,244,250,211,209,255,255,128,128,128,155,77,195,248,188,195,255,255,128,128,128,
    1,24,239,251,218,219,255,205,128,128,128,201,51,219,255,196,186,128,128,128,128,128,
    69,46,190,239,201,218,255,228,128,128,128,1,191,251,255,255,128,128,128,128,128,128,
    223,165,249,255,213,255,128,128,128,128,128,141,124,248,255,255,128,128,128,128,128,128,
    1,16,248,255,255,128,128,128,128,128,128,190,36,230,255,236,255,128,128,128,128,128,
    149,1,255,128,128,128,128,128,128,128,128,1,226,255,128,128,128,128,128,128,128,128,
    247,192,255,128,128,128,128,128,128,128,128,240,128,255,128,128,128,128,128,128,128,128,
    1,134,252,255,255,128,128,128,128,128,128,213,62,250,255,255,128,128,128,128,128,128,
    55,93,255,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,
    128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,
    202,24,213,235,186,191,220,160,240,175,255,126,38,182,232,169,184,228,174,255,187,128,
    61,46,138,219,151,178,240,170,255,216,128,1,112,230,250,199,191,247,159,255,255,128,
    166,109,228,252,211,215,255,174,128,128,128,39,77,162,232,172,180,245,178,255,255,128,
    1,52,220,246,198,199,249,220,255,255,128,124,74,191,243,183,193,250,221,255,255,128,
    24,71,130,219,154,170,243,182,255,255,128,1,182,225,249,219,240,255,224,128,128,128,
    149,150,226,252,216,205,255,171,128,128,128,28,108,170,242,183,194,254,223,255,255,128,
    1,81,230,252,204,203,255,192,128,128,128,123,102,209,247,188,196,255,233,128,128,128,
    20,95,153,243,164,173,255,203,128,128,128,1,222,248,255,216,213,128,128,128,128,128,
    168,175,246,252,235,205,255,255,128,128,128,47,116,215,255,211,212,255,255,128,128,128,
    1,121,236,253,212,214,255,255,128,128,128,141,84,213,252,201,202,255,219,128,128,128,
    42,80,160,240,162,185,255,205,128,128,128,1,1,255,128,128,128,128,128,128,128,128,
    244,1,255,128,128,128,128,128,128,128,128,238,1,255,128,128,128,128,128,128,128,128,
};
const uint8_t kCoeffsUpdateProba[1056] = {
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,176,246,255,255,255,255,255,255,255,255,255,
    223,241,252,255,255,255,255,255,255,255,255,249,253,253,255,255,255,255,255,255,255,255,
    255,244,252,255,255,255,255,255,255,255,255,234,254,254,255,255,255,255,255,255,255,255,
    253,255,255,255,255,255,255,255,255,255,255,255,246,254,255,255,255,255,255,255,255,255,
    239,253,254,255,255,255,255,255,255,255,255,254,255,254,255,255,255,255,255,255,255,255,
    255,248,254,255,255,255,255,255,255,255,255,251,255,254,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,253,254,255,255,255,255,255,255,255,255,
    251,254,254,255,255,255,255,255,255,255,255,254,255,254,255,255,255,255,255,255,255,255,
    255,254,253,255,254,255,255,255,255,255,255,250,255,254,255,254,255,255,255,255,255,255,
    254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    217,255,255,255,255,255,255,255,255,255,255,225,252,241,253,255,255,254,255,255,255,255,
    234,250,241,250,253,255,253,254,255,255,255,255,254,255,255,255,255,255,255,255,255,255,
    223,254,254,255,255,255,255,255,255,255,255,238,253,254,254,255,255,255,255,255,255,255,
    255,248,254,255,255,255,255,255,255,255,255,249,254,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,253,255,255,255,255,255,255,255,255,255,
    247,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,253,254,255,255,255,255,255,255,255,255,252,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,254,254,255,255,255,255,255,255,255,255,
    253,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,254,253,255,255,255,255,255,255,255,255,250,255,255,255,255,255,255,255,255,255,255,
    254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    186,251,250,255,255,255,255,255,255,255,255,234,251,244,254,255,255,255,255,255,255,255,
    251,251,243,253,254,255,254,255,255,255,255,255,253,254,255,255,255,255,255,255,255,255,
    236,253,254,255,255,255,255,255,255,255,255,251,253,253,254,254,255,255,255,255,255,255,
    255,254,254,255,255,255,255,255,255,255,255,254,254,254,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,
    254,254,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    248,255,255,255,255,255,255,255,255,255,255,250,254,252,254,255,255,255,255,255,255,255,
    248,254,249,253,255,255,255,255,255,255,255,255,253,253,255,255,255,255,255,255,255,255,
    246,253,253,255,255,255,255,255,255,255,255,252,254,251,254,254,255,255,255,255,255,255,
    255,254,252,255,255,255,255,255,255,255,255,248,254,253,255,255,255,255,255,255,255,255,
    253,255,254,254,255,255,255,255,255,255,255,255,251,254,255,255,255,255,255,255,255,255,
    245,251,254,255,255,255,255,255,255,255,255,253,253,254,255,255,255,255,255,255,255,255,
    255,251,253,255,255,255,255,255,255,255,255,252,253,254,255,255,255,255,255,255,255,255,
    255,254,255,255,255,255,255,255,255,255,255,255,252,255,255,255,255,255,255,255,255,255,
    249,255,254,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,
    255,255,253,255,255,255,255,255,255,255,255,250,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
};
const uint8_t kBmodesProba[900] = {
    231,120,48,89,115,113,120,152,112,152,179,64,126,170,118,46,70,95,175,69,143,80,
    85,82,72,155,103,56,58,10,171,218,189,17,13,152,114,26,17,163,44,195,21,10,
    173,121,24,80,195,26,62,44,64,85,144,71,10,38,171,213,144,34,26,170,46,55,
    19,136,160,33,206,71,63,20,8,114,114,208,12,9,226,81,40,11,96,182,84,29,
    16,36,134,183,89,137,98,101,106,165,148,72,187,100,130,157,111,32,75,80,66,102,
    167,99,74,62,40,234,128,41,53,9,178,241,141,26,8,107,74,43,26,146,73,166,
    49,23,157,65,38,105,160,51,52,31,115,128,104,79,12,27,217,255,87,17,7,87,
    68,71,44,114,51,15,186,23,47,41,14,110,182,183,21,17,194,66,45,25,102,197,
    189,23,18,22,88,88,147,150,42,46,45,196,205,43,97,183,117,85,38,35,179,61,
    39,53,200,87,26,21,43,232,171,56,34,51,104,114,102,29,93,77,39,28,85,171,
    58,165,90,98,64,34,22,116,206,23,34,43,166,73,107,54,32,26,51,1,81,43,
    31,68,25,106,22,64,171,36,225,114,34,19,21,102,132,188,16,76,124,62,18,78,
    95,85,57,50,48,51,193,101,35,159,215,111,89,46,111,60,148,31,172,219,228,21,
    18,111,112,113,77,85,179,255,38,120,114,40,42,1,196,245,209,10,25,109,88,43,
    29,140,166,213,37,43,154,61,63,30,155,67,45,68,1,209,100,80,8,43,154,1,
    51,26,71,142,78,78,16,255,128,34,197,171,41,40,5,102,211,183,4,1,221,51,
    50,17,168,209,192,23,25,82,138,31,36,171,27,166,38,44,229,67,87,58,169,82,
    115,26,59,179,63,59,90,180,59,166,93,73,154,40,40,21,116,143,209,34,39,175,
    47,15,16,183,34,223,49,45,183,46,17,33,183,6,98,15,32,183,57,46,22,24,
    128,1,54,17,37,65,32,73,115,28,128,23,128,205,40,3,9,115,51,192,18,6,
    223,87,37,9,115,59,77,64,21,47,104,55,44,218,9,54,53,130,226,64,90,70,
    205,40,41,23,26,57,54,57,112,184,5,41,38,166,213,30,34,26,133,152,116,10,
    32,134,39,19,53,221,26,114,32,73,255,31,9,65,234,2,15,1,118,73,75,32,
    12,51,192,255,160,43,51,88,31,35,67,102,85,55,186,85,56,21,23,111,59,205,
    45,37,192,55,38,70,124,73,102,1,34,98,125,98,42,88,104,85,117,175,82,95,
    84,53,89,128,100,113,101,45,75,79,123,47,51,128,81,171,1,57,17,5,71,102,
    57,53,41,49,38,33,13,121,57,73,26,1,85,41,10,67,138,77,110,90,47,114,
    115,21,2,10,102,255,166,23,6,101,29,16,10,85,128,101,196,26,57,18,10,102,
    102,213,34,20,43,117,20,15,36,163,128,68,1,26,102,61,71,37,34,53,31,243,
    192,69,60,71,38,73,119,28,222,37,68,45,128,34,1,47,11,245,171,62,17,19,
    70,146,85,55,62,70,37,43,37,154,100,163,85,160,1,63,9,92,136,28,64,32,
    201,85,75,15,9,9,64,255,184,119,16,86,6,28,5,64,255,25,248,1,56,8,
    17,132,137,255,55,116,128,58,15,20,82,135,57,26,121,40,164,50,31,137,154,133,
    25,35,218,51,103,44,131,131,123,31,6,158,86,40,64,135,148,224,45,183,128,22,
    26,17,131,240,154,14,1,209,45,16,21,91,64,222,7,1,197,56,21,39,155,60,
    138,23,102,213,83,12,13,54,192,255,68,47,28,85,26,85,85,128,128,32,146,171,
    18,11,7,63,144,171,4,4,246,35,27,10,146,174,171,12,26,128,190,80,35,99,
    180,80,126,54,45,85,126,47,87,176,51,41,20,32,101,75,128,139,118,146,116,128,
    85,56,41,15,176,236,85,37,9,62,71,30,17,119,118,255,17,18,138,101,38,60,
    138,55,70,43,26,142,146,36,19,30,171,255,97,27,20,138,45,61,62,219,1,81,
    188,64,32,41,20,117,151,142,20,21,163,112,19,12,61,195,128,48,4,24,
};
const int8_t kYmodesIntra4[18] = {
    0,1,-1,2,-2,3,4,6,-3,5,-4,-5,-6,7,-7,8,-8,-9,
};
const uint16_t kAcTable[128] = {
    4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,
    26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,44,45,46,47,
    48,49,50,51,52,53,54,55,56,57,58,60,62,64,66,68,70,72,74,76,78,80,
    82,84,86,88,90,92,94,96,98,100,102,104,106,108,110,112,114,116,119,122,125,128,
    131,134,137,140,143,146,149,152,155,158,161,164,167,170,173,177,181,185,189,193,197,201,
    205,209,213,217,221,225,229,234,239,245,249,254,259,264,269,274,279,284,
};
const uint8_t kDcTable[128] = {
    4,5,6,7,8,9,10,10,11,12,13,14,15,16,17,17,18,19,20,20,21,21,
    22,22,23,23,24,25,25,26,27,28,29,30,31,32,33,34,35,36,37,37,38,39,
    40,41,42,43,44,45,46,46,47,48,49,50,51,52,53,54,55,56,57,58,59,60,
    61,62,63,64,65,66,67,68,69,70,71,72,73,74,75,76,76,77,78,79,80,81,
    82,83,84,85,86,87,88,89,91,93,95,96,98,100,101,102,104,106,108,110,112,114,
    116,118,122,124,126,128,130,132,134,136,138,140,143,145,148,151,154,157,
};
const uint8_t kZigzag[16] = {
    0,1,4,8,5,2,3,6,9,12,13,10,7,11,14,15,
};
const uint8_t kBands[17] = {
    0,1,2,3,6,4,5,6,6,6,6,6,6,6,6,7,0,
};
const uint8_t kCodeLengthCodeOrder[19] = {
    17,18,0,1,2,3,4,5,16,6,7,8,9,10,11,12,13,14,15,
};
const uint8_t kCodeToPlane[120] = {
    24,7,23,25,40,6,39,41,22,26,38,42,56,5,55,57,21,27,54,58,37,43,
    72,4,71,73,20,28,53,59,70,74,36,44,88,69,75,52,60,3,87,89,19,29,
    86,90,35,45,68,76,85,91,51,61,104,2,103,105,18,30,102,106,34,46,84,92,
    67,77,101,107,50,62,120,1,119,121,83,93,17,31,100,108,66,78,118,122,33,47,
    117,123,49,63,99,109,82,94,0,116,124,65,79,16,32,98,110,48,115,125,81,95,
    64,114,126,97,111,80,113,127,96,112,
};

uint32_t le24(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
}
uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }

// ------------------------------------------------------------- container

// libwebp's VP8GetInfo: a keyframe's 10-byte header
bool vp8_info(const uint8_t* d, size_t avail, uint64_t chunk, int* w, int* h) {
  if (avail < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  const uint32_t bits = le24(d);
  *w = int((d[7] << 8 | d[6]) & 0x3FFF);
  *h = int((d[9] << 8 | d[8]) & 0x3FFF);
  return !(bits & 1) && ((bits >> 1) & 7) <= 3 && ((bits >> 4) & 1) && (bits >> 5) < chunk &&
         *w && *h;
}

// libwebp's VP8LGetInfo: the 5-byte header
bool vp8l_info(const uint8_t* d, size_t avail, int* w, int* h, int* alpha) {
  if (avail < 5 || d[0] != 0x2F || (d[4] >> 5)) return false;
  const uint32_t v = le32(d + 1);
  *w = int(v & 0x3FFF) + 1;
  *h = int((v >> 14) & 0x3FFF) + 1;
  *alpha = int((v >> 28) & 1);
  return true;
}

enum Status { kOk = 0, kShort = 1, kBad = 2 };

struct Headers {
  int w = 0, h = 0, channels = 3;
  bool alpha = false, animated = false, lossless = false;
  size_t pos = 0;                       // the bitstream's first byte
  bool has_alph = false;
  size_t alph_off = 0, alph_size = 0;   // the last ALPH chunk's payload
};

// libwebp's ParseHeadersInternal over d[0, n): `full` as WebPDecode reads
// the whole file (have_all_data), else as WebPGetFeatures reads a prefix
Status parse_headers(const uint8_t* d, size_t n, bool full, Headers* out) {
  if (n < 12) return kShort;
  size_t pos = 0;
  uint32_t riff = 0;
  if (!std::memcmp(d, "RIFF", 4)) {
    if (std::memcmp(d + 8, "WEBP", 4)) return kBad;
    riff = le32(d + 4);
    if (riff < 12 || riff > kMaxChunk) return kBad;
    if (full && riff > n - 8) return kShort;
    pos = 12;
  }
  if (n - pos < 8) return kShort;
  bool vp8x = false;
  uint32_t flags = 0;
  uint64_t w = 0, h = 0;
  if (!std::memcmp(d + pos, "VP8X", 4)) {
    if (le32(d + pos + 4) != 10) return kBad;
    if (n - pos < 18) return kShort;
    flags = le32(d + pos + 8);
    w = 1 + uint64_t(le24(d + pos + 12));
    h = 1 + uint64_t(le24(d + pos + 15));
    if (w * h >= (uint64_t(1) << 32)) return kBad;
    pos += 18;
    vp8x = true;
  }
  if (!riff && vp8x) return kBad;
  Headers hd;
  hd.w = int(w);
  hd.h = int(h);
  hd.alpha = flags & kAlphaFlag;
  hd.animated = flags & kAnimationFlag;
  hd.pos = pos;
  if (vp8x && hd.animated && !full) {
    *out = hd;
    return kOk;
  }
  Status st = kOk;
  do {
    if (n - pos < 4) {
      st = kShort;
      break;
    }
    if (vp8x || (!riff && !std::memcmp(d + pos, "ALPH", 4))) {
      uint64_t total = 22;  // "WEBP" + the VP8X chunk
      for (;;) {
        if (n - pos < 8) {
          st = kShort;
          break;
        }
        const uint32_t size = le32(d + pos + 4);
        if (size > kMaxChunk) {
          st = kBad;
          break;
        }
        const uint64_t disk = (8 + uint64_t(size) + 1) & ~uint64_t(1);
        total += disk;
        if (riff && total > riff) {
          st = kBad;
          break;
        }
        if (!std::memcmp(d + pos, "VP8 ", 4) || !std::memcmp(d + pos, "VP8L", 4)) break;
        if (n - pos < disk) {
          st = kShort;
          break;
        }
        if (!std::memcmp(d + pos, "ALPH", 4)) {
          hd.has_alph = true;
          hd.alph_off = pos + 8;
          hd.alph_size = size;
        }
        pos += disk;
      }
      if (st != kOk) break;
    }
    if (n - pos < 8) {
      st = kShort;
      break;
    }
    uint64_t chunk;
    int fw, fh, fa = 0;
    const bool vp8 = !std::memcmp(d + pos, "VP8 ", 4), vp8l = !std::memcmp(d + pos, "VP8L", 4);
    if (vp8 || vp8l) {
      const uint32_t size = le32(d + pos + 4);
      if (riff >= 12 && size > riff - 12) {
        st = kBad;
        break;
      }
      if (full && size > n - pos - 8) {
        st = kShort;
        break;
      }
      chunk = size;
      hd.lossless = vp8l;
      pos += 8;
    } else {  // a raw bitstream
      hd.lossless = vp8l_info(d + pos, n - pos, &fw, &fh, &fa);
      chunk = n - pos;
    }
    if (chunk > kMaxChunk) return kBad;
    hd.pos = pos;
    if (!hd.lossless) {
      if (n - pos < 10) {
        st = kShort;
        break;
      }
      if (!vp8_info(d + pos, n - pos, chunk, &fw, &fh)) return kBad;
    } else {
      if (n - pos < 5) {
        st = kShort;
        break;
      }
      if (!vp8l_info(d + pos, n - pos, &fw, &fh, &fa)) return kBad;
      hd.alpha = fa;
    }
    if (vp8x && (uint64_t(fw) != w || uint64_t(fh) != h)) return kBad;
    hd.w = fw;
    hd.h = fh;
  } while (false);
  if (st != kOk && !(st == kShort && vp8x && !full)) return st;
  hd.alpha = hd.alpha || hd.has_alph;
  *out = hd;
  return kOk;
}

// what cv2 takes from a file before it decodes (data/webp.py `_cv2_headers`)
Headers cv2_headers(const uint8_t* d, size_t n) {
  if (n < kCvHeader)
    throw WebPError("a WebP file of " + std::to_string(n) + " bytes, below the 32 OpenCV reads");
  if (n > kCvMaxFile) throw WebPError("a WebP file above OpenCV's 64 MiB limit");
  Headers head, hd;
  Status st = parse_headers(d, kCvHeader, false, &head);
  if (st != kOk)
    throw WebPError(st == kShort ? "broken WebP header (short)" : "broken WebP header (bad)");
  if (head.animated)
    throw WebPError("not implemented: an animated WebP (the port reads still images)");
  st = parse_headers(d, n, true, &hd);
  if (st != kOk)
    throw WebPError(st == kShort ? "broken WebP file (short)" : "broken WebP file (bad)");
  if (uint64_t(hd.w) * uint64_t(hd.h) > kMaxPixels)
    throw WebPError(std::to_string(hd.w) + " x " + std::to_string(hd.h) +
                    " px, above OpenCV's 2^30");
  hd.channels = head.alpha ? 4 : 3;
  return hd;
}

struct Bad : std::runtime_error {  // a bitstream libwebp does not decode
  using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------------ VP8L

// libwebp's VP8L bit reader, state for state (data/webp.py `_LBits`)
struct LBits {
  const uint8_t* b;
  size_t n, pos;
  uint64_t val = 0;
  int bit = 0;
  bool eos = false;
  LBits(const uint8_t* d, size_t len) : b(d), n(len) {
    const size_t k = std::min<size_t>(8, n);
    for (size_t i = 0; i < k; ++i) val |= uint64_t(b[i]) << (8 * i);
    pos = k;
  }
  void shift() {
    while (bit >= 8 && pos < n) {
      val = (val >> 8) | uint64_t(b[pos++]) << 56;
      bit -= 8;
    }
    if (eos || (pos == n && bit > 64)) {
      eos = true;
      bit = 0;
    }
  }
  bool at_end() const { return eos || (pos == n && bit > 64); }
  uint32_t read(int k) {
    if (eos) {
      bit = 0;
      return 0;
    }
    const uint32_t v = uint32_t(val >> (bit & 63)) & ((1u << k) - 1);
    bit += k;
    shift();
    return v;
  }
  void fill() {
    if (bit >= 32) shift();
  }
  uint32_t peek() const { return uint32_t(val >> (bit & 63)); }
};

// A prefix code: 256 root entries (len << 16 | symbol), or 0x80000000 |
// bits << 24 | offset of a second-level table of 2^bits entries
using Code = std::vector<uint32_t>;
constexpr uint32_t kSub = 0x80000000u;

inline int read_symbol(LBits& br, const uint32_t* t) {
  const uint32_t w = br.peek();
  uint32_t e = t[w & 255];
  if (e & kSub) {
    e = t[(e & 0xFFFFFF) + ((w >> 8) & ((1u << ((e >> 24) & 0x7F)) - 1))];
    br.bit += 8;
  }
  br.bit += int(e >> 16);
  return int(e & 0xFFFF);
}

uint32_t reverse_bits(uint32_t c, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((c >> i) & 1) << (n - 1 - i);
  return r;
}

// libwebp's BuildHuffmanTable: false where it refuses the lengths
bool build_code(const std::vector<int>& lengths, Code* out) {
  int count[16] = {0};
  for (int l : lengths) ++count[l];
  const int coded = int(lengths.size()) - count[0];
  if (coded == 0) return false;
  if (coded == 1) {
    int sym = 0;
    while (!lengths[sym]) ++sym;
    out->assign(256, uint32_t(sym));
    return true;
  }
  int left = 1;
  for (int l = 1; l < 16; ++l) {
    left = 2 * left - count[l];
    if (left < 0) return false;
  }
  if (left) return false;
  uint32_t next[16] = {0}, code = 0;
  for (int l = 2; l < 16; ++l) {
    code = (code + uint32_t(count[l - 1])) << 1;
    next[l] = code;
  }
  // second-level tables: per 8-bit prefix, the longest code under it
  int sub_bits[256] = {0};
  std::vector<uint32_t> codes(lengths.size());
  for (size_t s = 0; s < lengths.size(); ++s) {
    const int l = lengths[s];
    if (!l) continue;
    codes[s] = reverse_bits(next[l]++, l);
    if (l > 8) sub_bits[codes[s] & 255] = std::max(sub_bits[codes[s] & 255], l - 8);
  }
  out->assign(256, 0);
  for (int p = 0; p < 256; ++p) {
    if (!sub_bits[p]) continue;
    (*out)[p] = kSub | uint32_t(sub_bits[p]) << 24 | uint32_t(out->size());
    out->resize(out->size() + (size_t(1) << sub_bits[p]), 0);
  }
  for (size_t s = 0; s < lengths.size(); ++s) {
    const int l = lengths[s];
    if (!l) continue;
    const uint32_t rev = codes[s];
    if (l <= 8) {
      for (uint32_t k = rev; k < 256; k += 1u << l) (*out)[k] = uint32_t(l) << 16 | uint32_t(s);
    } else {
      const uint32_t e = (*out)[rev & 255];
      const int sb = int((e >> 24) & 0x7F);
      const size_t base = e & 0xFFFFFF;
      for (uint32_t k = rev >> 8; k < (1u << sb); k += 1u << (l - 8))
        (*out)[base + k] = uint32_t(l - 8) << 16 | uint32_t(s);
    }
  }
  return true;
}

bool read_lengths(LBits& br, const std::vector<int>& cl, int size, std::vector<int>* lengths) {
  Code tab;
  if (!build_code(cl, &tab)) return false;
  int max_symbol = size;
  if (br.read(1)) {
    const int nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(nbits));
    if (max_symbol > size) return false;
  }
  lengths->assign(size_t(size), 0);
  int prev = 8, s = 0;
  while (s < size) {
    if (max_symbol-- == 0) break;
    br.fill();
    const int code = read_symbol(br, tab.data());
    if (code < 16) {
      (*lengths)[size_t(s++)] = code;
      if (code) prev = code;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int rep = int(br.read(kExtra[code - 16])) + kOffset[code - 16];
      if (s + rep > size) return false;
      std::fill_n(lengths->begin() + s, rep, code == 16 ? prev : 0);
      s += rep;
    }
  }
  return true;
}

bool read_code(LBits& br, int size, Code* out) {
  std::vector<int> lengths;
  if (br.read(1)) {  // simple code
    lengths.assign(size_t(size), 0);
    const bool two = br.read(1);
    uint32_t s = br.read(br.read(1) ? 8 : 1);
    if (int(s) < size) lengths[s] = 1;
    if (two) {
      s = br.read(8);
      if (int(s) < size) lengths[s] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num = int(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthCodeOrder[i]] = int(br.read(3));
    if (!read_lengths(br, cl, size, &lengths)) return false;
  }
  if (br.eos) return false;
  return build_code(lengths, out);
}

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

constexpr int kPred = 0, kCross = 1, kGreen = 2, kIndex = 3;

struct Transform {
  int kind, xs, bits;
  std::vector<uint32_t> data;
};

struct Codes {  // the prefix-code groups of an image (VP8LMetadata)
  int cache_bits = 0, meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;    // per tile: group slot
  std::vector<Code> groups;      // 5 codes a used group
};

std::vector<uint32_t> stream(LBits& br, int xs, int ys);

void read_codes(LBits& br, int xs, int ys, bool level0, Codes* c) {
  int ngroups = 1;
  std::vector<int32_t> slot(1, 0);
  if (level0 && br.read(1)) {
    c->meta_bits = int(br.read(3)) + 2;
    c->meta_w = sub_size(xs, c->meta_bits);
    c->meta = stream(br, c->meta_w, sub_size(ys, c->meta_bits));
    int top = 0;
    for (uint32_t& v : c->meta) {
      v = (v >> 8) & 0xFFFF;
      top = std::max(top, int(v));
    }
    ngroups = top + 1;
    slot.assign(size_t(ngroups), -1);
    int used = 0;
    for (uint32_t v : c->meta)
      if (slot[v] < 0) slot[v] = used++;
    for (uint32_t& v : c->meta) v = uint32_t(slot[v]);
    c->groups.resize(size_t(used) * 5);
  } else {
    c->groups.resize(5);
  }
  if (br.eos) throw Bad("VP8L: end of data in the meta codes");
  Code scratch;
  for (int g = 0; g < ngroups; ++g) {
    for (int j = 0; j < 5; ++j) {
      static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
      const int size = kAlphabet[j] + (j == 0 && c->cache_bits ? 1 << c->cache_bits : 0);
      const int32_t at = slot[size_t(g)];
      Code* dst = at >= 0 ? &c->groups[size_t(at) * 5 + size_t(j)] : &scratch;
      if (!read_code(br, size, dst)) throw Bad("VP8L: bad prefix code");
    }
  }
}

inline int copy_value(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + int(br.read(extra)) + 1;
}

inline int64_t plane_distance(int xs, int code) {
  if (code > 120) return code - 120;
  const int dc = kCodeToPlane[code - 1];
  const int64_t dist = int64_t(dc >> 4) * xs + 8 - (dc & 15);
  return dist >= 1 ? dist : 1;
}

inline uint32_t cache_key(uint32_t px, int shift) { return (px * 0x1E35A7BDu) >> shift; }

// DecodeImageData (or DecodeAlphaData with alpha8)
std::vector<uint32_t> pixels(LBits& br, int xs, int ys, const Codes& c, bool alpha8) {
  const size_t n = size_t(xs) * size_t(ys);
  std::vector<uint32_t> out(n, 0);
  std::vector<uint32_t> cache(c.cache_bits ? size_t(1) << c.cache_bits : 0, 0);
  const int shift = 32 - c.cache_bits;
  const bool has_cache = c.cache_bits > 0;
  size_t pos = 0;
  int x = 0, y = 0;
  while (pos < n) {
    if (alpha8 && br.eos) break;
    const size_t g =
        c.meta.empty()
            ? 0
            : c.meta[size_t(y >> c.meta_bits) * size_t(c.meta_w) + size_t(x >> c.meta_bits)];
    const Code* gr = &c.groups[g * 5];
    br.fill();
    const int code = read_symbol(br, gr[0].data());
    if (!alpha8 && br.at_end()) break;
    if (code < 256) {
      uint32_t px;
      if (alpha8) {
        px = uint32_t(code) << 8;
      } else {
        const uint32_t r = uint32_t(read_symbol(br, gr[1].data()));
        br.fill();
        const uint32_t b = uint32_t(read_symbol(br, gr[2].data()));
        const uint32_t a = uint32_t(read_symbol(br, gr[3].data()));
        if (br.at_end()) break;
        px = a << 24 | r << 16 | uint32_t(code) << 8 | b;
      }
      out[pos++] = px;
      if (has_cache) cache[cache_key(px, shift)] = px;
      if (++x >= xs) {
        x = 0;
        ++y;
      }
    } else if (code < 280) {
      const int length = copy_value(code - 256, br);
      const int dsym = read_symbol(br, gr[4].data());
      br.fill();
      const int64_t dist = plane_distance(xs, copy_value(dsym, br));
      if (!alpha8 && br.at_end()) break;
      if (int64_t(pos) < dist || n - pos < size_t(length))
        throw Bad("VP8L: backward reference out of the image");
      for (size_t k = pos; k < pos + size_t(length); ++k) {
        const uint32_t px = out[k - size_t(dist)];
        out[k] = px;
        if (has_cache) cache[cache_key(px, shift)] = px;
      }
      pos += size_t(length);
      x += length;
      while (x >= xs) {
        x -= xs;
        ++y;
      }
    } else if (has_cache && code < 280 + (1 << c.cache_bits)) {
      const uint32_t px = cache[size_t(code - 280)];
      out[pos++] = px;
      cache[cache_key(px, shift)] = px;
      if (++x >= xs) {
        x = 0;
        ++y;
      }
    } else {
      throw Bad("VP8L: bad symbol");
    }
    if (alpha8) br.eos = br.at_end();
  }
  if (alpha8) {
    br.eos = br.at_end();
    if (br.eos && pos < n) throw Bad("VP8L: premature end of the alpha data");
  } else if (br.at_end()) {
    throw Bad("VP8L: premature end of data");
  }
  return out;
}

void header(LBits& br, int* xs, int ys, std::vector<Transform>* ts, Codes* c, bool level0) {
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.kind = int(br.read(2));
      if (seen & (1u << t.kind)) throw Bad("VP8L: a transform twice");
      seen |= 1u << t.kind;
      t.xs = *xs;
      t.bits = 0;
      if (t.kind == kPred || t.kind == kCross) {
        t.bits = int(br.read(3)) + 2;
        t.data = stream(br, sub_size(*xs, t.bits), sub_size(ys, t.bits));
      } else if (t.kind == kIndex) {
        const int ncol = int(br.read(8)) + 1;
        t.bits = ncol > 16 ? 0 : ncol > 4 ? 1 : ncol > 2 ? 2 : 3;
        const std::vector<uint32_t> pal = stream(br, ncol, 1);
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        t.data[0] = pal[0];
        for (int i = 1; i < ncol; ++i) {  // deltas, byte by byte
          const uint32_t p = pal[size_t(i)], q = t.data[size_t(i - 1)];
          t.data[size_t(i)] = (((p & 0xFF00FF00u) + (q & 0xFF00FF00u)) & 0xFF00FF00u) |
                              (((p & 0x00FF00FFu) + (q & 0x00FF00FFu)) & 0x00FF00FFu);
        }
        *xs = sub_size(*xs, t.bits);
      }
      ts->push_back(std::move(t));
    }
  }
  if (br.read(1)) {
    c->cache_bits = int(br.read(4));
    if (c->cache_bits < 1 || c->cache_bits > 11) throw Bad("VP8L: bad colour cache size");
  }
  read_codes(br, *xs, ys, level0, c);
}

// DecodeImageStream of a sub-image: its ARGB pixels
std::vector<uint32_t> stream(LBits& br, int xs, int ys) {
  Codes c;
  header(br, &xs, ys, nullptr, &c, false);
  std::vector<uint32_t> data = pixels(br, xs, ys, c, false);
  if (br.eos) throw Bad("VP8L: premature end of data");
  return data;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select_px(uint32_t t, uint32_t l, uint32_t tl) {
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = int((t >> sh) & 255), b = int((l >> sh) & 255), c = int((tl >> sh) & 255);
    s += std::abs(b - c) - std::abs(a - c);
  }
  return s <= 0 ? t : l;
}

uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8)
    out |= uint32_t(clip255(int((a >> sh) & 255) + int((b >> sh) & 255) - int((c >> sh) & 255)))
           << sh;
  return out;
}

uint32_t clamp_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int x = int((a >> sh) & 255), y = int((b >> sh) & 255);
    out |= uint32_t(clip255(x + (x - y) / 2)) << sh;
  }
  return out;
}

uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr, uint32_t tl) {
  switch (mode) {
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(l, tr), t);
    case 6: return avg2(l, tl);
    case 7: return avg2(l, t);
    case 8: return avg2(tl, t);
    case 9: return avg2(t, tr);
    case 10: return avg2(avg2(l, tl), avg2(t, tr));
    case 11: return select_px(t, l, tl);
    case 12: return clamp_full(l, t, tl);
    case 13: return clamp_half(avg2(l, t), tl);
    default: return 0xFF000000u;  // modes 0, 14 and 15: black
  }
}

// one transform undone on an (h, xs_in) image, giving (h, t.xs)
void inverse(const Transform& t, int h, std::vector<uint32_t>* img) {
  const int xs = t.xs;
  std::vector<uint32_t>& o = *img;
  if (t.kind == kGreen) {
    for (uint32_t& v : o) {
      const uint32_t g = (v >> 8) & 255;
      v = (v & 0xFF00FF00u) | (((v & 0x00FF00FFu) + (g << 16 | g)) & 0x00FF00FFu);
    }
  } else if (t.kind == kCross) {
    const int tw = sub_size(xs, t.bits);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < xs; ++x) {
        uint32_t& v = o[size_t(y) * size_t(xs) + size_t(x)];
        const uint32_t m = t.data[size_t(y >> t.bits) * size_t(tw) + size_t(x >> t.bits)];
        const int green = int8_t(v >> 8);
        int red = int((v >> 16) & 255);
        red = (red + ((int(int8_t(m)) * green) >> 5)) & 255;
        int blue = int(v & 255) + ((int(int8_t(m >> 8)) * green) >> 5);
        blue = (blue + ((int(int8_t(m >> 16)) * int(int8_t(red))) >> 5)) & 255;
        v = (v & 0xFF00FF00u) | uint32_t(red) << 16 | uint32_t(blue);
      }
    }
  } else if (t.kind == kIndex) {
    const int packed_w = sub_size(xs, t.bits);
    std::vector<uint32_t> out(size_t(h) * size_t(xs));
    const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < xs; ++x) {
        const uint32_t packed = (o[size_t(y) * size_t(packed_w) + size_t(x >> t.bits)] >> 8) & 255;
        const uint32_t idx = (packed >> ((x & (per - 1)) * bpp)) & uint32_t(mask);
        out[size_t(y) * size_t(xs) + size_t(x)] = t.data[idx];
      }
    }
    o.swap(out);
  } else {  // predictor, row after row
    const int tw = sub_size(xs, t.bits);
    o[0] = add_px(o[0], 0xFF000000u);
    for (int x = 1; x < xs; ++x) o[size_t(x)] = add_px(o[size_t(x)], o[size_t(x - 1)]);
    for (int y = 1; y < h; ++y) {
      size_t i = size_t(y) * size_t(xs);
      o[i] = add_px(o[i], o[i - size_t(xs)]);
      const uint32_t* modes = &t.data[size_t(y >> t.bits) * size_t(tw)];
      for (int x = 1; x < xs; ++x) {
        ++i;
        const int m = int((modes[x >> t.bits] >> 8) & 15);
        o[i] = add_px(o[i], predict(m, o[i - 1], o[i - size_t(xs)], o[i - size_t(xs) + 1],
                                    o[i - size_t(xs) - 1]));
      }
    }
  }
}

bool single(const Code& c) { return !(c[0] & kSub) && (c[0] >> 16) == 0; }

// a VP8L image from its transforms on -> (h, w) ARGB; `alpha`: an ALPH
// stream (data/webp.py `_vp8l_image`)
std::vector<uint32_t> vp8l_image(LBits& br, int w, int h, bool alpha) {
  std::vector<Transform> ts;
  Codes c;
  int xs = w;
  header(br, &xs, h, &ts, &c, true);
  bool alpha8 = alpha && ts.size() == 1 && ts[0].kind == kIndex && !c.cache_bits;
  for (size_t g = 0; alpha8 && g < c.groups.size(); g += 5)
    alpha8 = single(c.groups[g + 1]) && single(c.groups[g + 2]) && single(c.groups[g + 3]);
  std::vector<uint32_t> img = pixels(br, xs, h, c, alpha8);
  for (size_t k = ts.size(); k-- > 0;) inverse(ts[k], h, &img);
  return img;
}

std::vector<uint32_t> vp8l(const uint8_t* d, size_t n, int* w, int* h) {
  LBits br(d, n);
  if (br.read(8) != 0x2F) throw Bad("VP8L: bad signature");
  *w = int(br.read(14)) + 1;
  *h = int(br.read(14)) + 1;
  br.read(1);
  if (br.read(3) || br.eos) throw Bad("VP8L: bad header");
  return vp8l_image(br, *w, *h, false);
}

// ------------------------------------------------------------------- VP8

// libwebp's boolean decoder: eof set by the first read that needs a byte
// past the partition's end (data/webp.py `_Bool`)
struct Bool {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  Bool() = default;
  Bool(const uint8_t* d, size_t n) : p(d), end(d + n) { load(); }
  // whole bytes, only when the window runs dry (bits < 0): libwebp's eof
  // comes at the same read whatever the bytes a load takes
  void load() {
    if (end - p >= 8) {
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = v << 8 | p[i];
      value = value << 56 | v;
      p += 7;
      bits += 56;
    } else if (p < end) {
      value = value << 8 | *p++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    int b;
    if (uint32_t(value >> bits) > split) {
      r -= split;
      value -= uint64_t(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = __builtin_clz(r) - 24;  // r in [1, 255]
    range = (r << shift) - 1;
    bits -= shift;
    return b;
  }
  int value_of(int n) {
    int v = 0;
    while (n--) v |= bit(0x80) << n;
    return v;
  }
  int signed_of(int n) {
    const int v = value_of(n);
    return bit(0x80) ? -v : v;
  }
};

constexpr int kDC = 0, kTM = 1, kVE = 2, kHE = 3, kRD = 4, kVR = 5, kLD = 6, kVL = 7, kHD = 8;

struct Frame {
  int w = 0, h = 0;
  int use_segment = 0, update_map = 0, absolute = 1;
  int quant[4] = {0}, fstrength[4] = {0}, seg_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_delta[4] = {0}, mode_delta[4] = {0};
  std::vector<Bool> parts;
  int dq[4][3][2];                      // segment, (y1, y2, uv), (dc, ac)
  uint8_t bands[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  Bool br;
};

// VP8GetHeaders (data/webp.py `_parse_header`)
void parse_header(const uint8_t* d, size_t n, Frame* f) {
  if (n < 4) throw Bad("VP8: truncated header");
  const uint32_t bits = le24(d);
  if (((bits >> 1) & 7) > 3) throw Bad("VP8: incorrect keyframe parameters");
  if (!((bits >> 4) & 1)) throw Bad("VP8: frame not displayable");
  const size_t plen = bits >> 5;
  const bool key = !(bits & 1);
  const uint8_t* p = d + 3;
  n -= 3;
  if (key) {
    if (n < 7) throw Bad("VP8: cannot parse picture header");
    if (p[0] != 0x9d || p[1] != 0x01 || p[2] != 0x2a) throw Bad("VP8: bad code word");
    f->w = (p[4] << 8 | p[3]) & 0x3FFF;
    f->h = (p[6] << 8 | p[5]) & 0x3FFF;
    p += 7;
    n -= 7;
  }
  if (plen > n) throw Bad("VP8: bad partition length");
  f->br = Bool(p, plen);
  Bool& br = f->br;
  p += plen;
  n -= plen;
  if (key) {
    br.bit(0x80);
    br.bit(0x80);  // colour space and clamping: ignored
  }
  f->use_segment = br.bit(0x80);
  if (f->use_segment) {
    f->update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      f->absolute = br.bit(0x80);
      for (int& q : f->quant) q = br.bit(0x80) ? br.signed_of(7) : 0;
      for (int& s : f->fstrength) s = br.bit(0x80) ? br.signed_of(6) : 0;
    }
    if (f->update_map)
      for (int& s : f->seg_probs) s = br.bit(0x80) ? br.value_of(8) : 255;
  }
  if (br.eof) throw Bad("VP8: cannot parse segment header");
  f->simple = br.bit(0x80);
  f->level = br.value_of(6);
  f->sharpness = br.value_of(3);
  f->use_lf_delta = br.bit(0x80);
  if (f->use_lf_delta && br.bit(0x80)) {
    for (int& r : f->ref_delta)
      if (br.bit(0x80)) r = br.signed_of(6);
    for (int& m : f->mode_delta)
      if (br.bit(0x80)) m = br.signed_of(6);
  }
  f->filter_type = f->level == 0 ? 0 : f->simple ? 1 : 2;
  if (br.eof) throw Bad("VP8: cannot parse filter header");
  // the partitions; the last runs to the end of the data
  const size_t last = (size_t(1) << br.value_of(2)) - 1;
  if (n < 3 * last) throw Bad("VP8: cannot parse partitions");
  const uint8_t* part = p + 3 * last;
  size_t left = n - 3 * last;
  for (size_t k = 0; k < last; ++k) {
    size_t ps = le24(p + 3 * k);
    ps = std::min(ps, left);
    f->parts.emplace_back(part, ps);
    part += ps;
    left -= ps;
  }
  f->parts.emplace_back(part, left);
  if (!left) throw Bad("VP8: cannot parse partitions");
  // VP8ParseQuant
  const int base = br.value_of(7);
  int dlt[5];
  for (int& v : dlt) v = br.bit(0x80) ? br.signed_of(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q;
    if (f->use_segment) {
      q = f->quant[s] + (f->absolute ? 0 : base);
    } else if (s > 0) {
      std::memcpy(f->dq[s], f->dq[0], sizeof f->dq[0]);
      continue;
    } else {
      q = base;
    }
    f->dq[s][0][0] = kDcTable[clip(q + dlt[0], 127)];
    f->dq[s][0][1] = kAcTable[clip(q, 127)];
    f->dq[s][1][0] = kDcTable[clip(q + dlt[1], 127)] * 2;
    f->dq[s][1][1] = std::max((kAcTable[clip(q + dlt[2], 127)] * 101581) >> 16, 8);
    f->dq[s][2][0] = kDcTable[clip(q + dlt[3], 117)];
    f->dq[s][2][1] = kAcTable[clip(q + dlt[4], 127)];
  }
  if (!key) throw Bad("VP8: not a key frame");
  br.bit(0x80);  // update_proba: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int q = 0; q < 11; ++q) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + q;
          f->bands[t][b][c][q] =
              uint8_t(br.bit(kCoeffsUpdateProba[i]) ? br.value_of(8) : kCoeffsProba0[i]);
        }
  f->use_skip = br.bit(0x80);
  f->skip_p = f->use_skip ? br.value_of(8) : 0;
}

struct MB {
  int segment = 0, skip = 0, i4 = 0, uvmode = 0, inner = 0;
  uint8_t modes[16];
};

void parse_modes(Frame* f, int mb_w, std::vector<uint8_t>* intra_t, std::vector<MB>* row) {
  Bool& br = f->br;
  uint8_t intra_l[4] = {kDC, kDC, kDC, kDC};
  for (int mx = 0; mx < mb_w; ++mx) {
    MB& m = (*row)[size_t(mx)];
    m = MB();
    if (f->update_map) {
      const int* p = f->seg_probs;
      m.segment = !br.bit(p[0]) ? br.bit(p[1]) : br.bit(p[2]) + 2;
    }
    m.skip = f->use_skip ? br.bit(f->skip_p) : 0;
    m.i4 = !br.bit(145);
    uint8_t* top = &(*intra_t)[size_t(4 * mx)];
    if (!m.i4) {
      const int ym = br.bit(156) ? (br.bit(128) ? kTM : kHE) : (br.bit(163) ? kVE : kDC);
      m.modes[0] = uint8_t(ym);
      std::memset(top, ym, 4);
      std::memset(intra_l, ym, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int ym = intra_l[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = &kBmodesProba[(top[x] * 10 + ym) * 9];
          int i = kYmodesIntra4[br.bit(prob[0])];
          while (i > 0) i = kYmodesIntra4[2 * i + br.bit(prob[i])];
          ym = -i;
          top[x] = uint8_t(ym);
        }
        std::memcpy(m.modes + 4 * y, top, 4);
        intra_l[y] = uint8_t(ym);
      }
    }
    m.uvmode = !br.bit(142) ? kDC : !br.bit(114) ? kVE : br.bit(183) ? kTM : kHE;
  }
}

int large_value(Bool& br, const uint8_t* p) {
  static const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
                       kCat5[] = {180, 157, 141, 134, 130, 0},
                       kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
  static const uint8_t* const kCat[4] = {kCat3, kCat4, kCat5, kCat6};
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int b1 = br.bit(p[8]);
  const int cat = 2 * b1 + br.bit(p[9 + b1]);
  int v = 0;
  for (const uint8_t* t = kCat[cat]; *t; ++t) v += v + br.bit(*t);
  return v + 3 + (8 << cat);
}

// GetCoeffs: one block's tokens into out[16] (raster, dequantized, int16)
int coeffs(Bool& br, const uint8_t (*band)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = band[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*pc)[11] = band[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = pc[1];
    } else {
      v = large_value(br, p);
      p = pc[2];
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = int16_t(uint16_t(uint32_t(v * dq[n > 0])));
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out) {  // out[16 * k]: block k's DC
  int t[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    t[i] = a0 + a1;
    t[8 + i] = a0 - a1;
    t[4 + i] = a3 + a2;
    t[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = t[4 * i] + 3;
    const int a0 = dc + t[4 * i + 3], a1 = t[4 * i + 1] + t[4 * i + 2];
    const int a2 = t[4 * i + 1] - t[4 * i + 2], a3 = dc - t[4 * i + 3];
    out[16 * (4 * i + 0)] = int16_t(uint16_t(uint32_t((a0 + a1) >> 3)));
    out[16 * (4 * i + 1)] = int16_t(uint16_t(uint32_t((a3 + a2) >> 3)));
    out[16 * (4 * i + 2)] = int16_t(uint16_t(uint32_t((a0 - a1) >> 3)));
    out[16 * (4 * i + 3)] = int16_t(uint16_t(uint32_t((a3 - a2) >> 3)));
  }
}

inline uint32_t nz_code(int nz, bool dc_nz) { return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz; }

// ParseResiduals: tnz / lnz the {nz, nz_dc} contexts above and to the left
void residuals(const Frame& f, const MB& m, int* tnz, int* lnz, Bool& br, int16_t* out,
               uint32_t* nzy_out, uint32_t* nzuv_out) {
  std::memset(out, 0, 384 * sizeof(int16_t));
  const int* y1 = f.dq[m.segment][0];
  const int* y2 = f.dq[m.segment][1];
  const int* uv = f.dq[m.segment][2];
  int first;
  const uint8_t(*ac)[3][11];
  if (!m.i4) {
    int16_t dc[16] = {0};
    const int nz = coeffs(br, f.bands[1], tnz[1] + lnz[1], y2, 0, dc);
    tnz[1] = lnz[1] = nz > 0;
    if (nz > 1) {
      wht(dc, out);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16; ++i) out[16 * i] = int16_t(dc0);
    }
    first = 1;
    ac = f.bands[0];
  } else {
    first = 0;
    ac = f.bands[3];
  }
  uint32_t t = uint32_t(tnz[0]) & 0x0F, l = uint32_t(lnz[0]) & 0x0F, nzy = 0;
  for (int y = 0; y < 4; ++y) {
    uint32_t lb = l & 1, codes = 0;
    for (int x = 0; x < 4; ++x) {
      int16_t* blk = out + 16 * (4 * y + x);
      const int nz = coeffs(br, ac, int(lb + (t & 1)), y1, first, blk);
      lb = nz > first;
      t = (t >> 1) | (lb << 7);
      codes = codes << 2 | nz_code(nz, blk[0] != 0);
    }
    t >>= 4;
    l = (l >> 1) | (lb << 7);
    nzy = nzy << 8 | codes;
  }
  uint32_t out_t = t, out_l = l >> 4, nzuv = 0;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t codes = 0;
    t = uint32_t(tnz[0]) >> (4 + ch);
    l = uint32_t(lnz[0]) >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      uint32_t lb = l & 1;
      for (int x = 0; x < 2; ++x) {
        int16_t* blk = out + 16 * (16 + 2 * ch + 2 * y + x);
        const int nz = coeffs(br, f.bands[2], int(lb + (t & 1)), uv, 0, blk);
        lb = nz > 0;
        t = (t >> 1) | (lb << 3);
        codes = codes << 2 | nz_code(nz, blk[0] != 0);
      }
      t >>= 2;
      l = (l >> 1) | (lb << 5);
    }
    nzuv |= codes << (4 * ch);
    out_t |= (t << 4) << ch;
    out_l |= (l & 0xF0) << ch;
  }
  tnz[0] = int(out_t & 0xFF);
  lnz[0] = int(out_l & 0xFF);
  *nzy_out = nzy;
  *nzuv_out = nzuv;
}

// The IDCT of in[16] added to dst (stride bytes a row), as libwebp on x86
// computes it: TransformOne in 32-bit ints (its C TransformDC / AC3), or with
// `wrap` its SSE2 Transform, whose sums wrap at 16 bits (the two differ only
// for coefficients no encoder writes)
inline int w16(int a) { return int16_t(uint16_t(uint32_t(a))); }
inline int mulhi(int a, int k) { return (a * k) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst, int stride, bool wrap) {
  int tmp[16];
  auto pass = [wrap](int r0, int r1, int r2, int r3, int dc, int* o) {
    if (!wrap) {
      const int a = r0 + dc + r2, b = r0 + dc - r2;
      const int c = mulhi(r1, 35468) - (mulhi(r3, 20091) + r3);
      const int d = (mulhi(r1, 20091) + r1) + mulhi(r3, 35468);
      o[0] = a + d;
      o[1] = b + c;
      o[2] = b - c;
      o[3] = a - d;
      return;
    }
    const int z = w16(r0 + dc), a = w16(z + r2), b = w16(z - r2);
    const int c = w16(w16(r1 - r3) + w16(mulhi(r1, -30068) - mulhi(r3, 20091)));
    const int d = w16(w16(r1 + r3) + w16(mulhi(r1, 20091) + mulhi(r3, -30068)));
    o[0] = w16(a + d);
    o[1] = w16(b + c);
    o[2] = w16(b - c);
    o[3] = w16(a - d);
  };
  for (int i = 0; i < 4; ++i) pass(in[i], in[4 + i], in[8 + i], in[12 + i], 0, tmp + 4 * i);
  for (int i = 0; i < 4; ++i, dst += stride) {  // output row i
    int v[4];
    pass(tmp[i], tmp[4 + i], tmp[8 + i], tmp[12 + i], 4, v);
    for (int x = 0; x < 4; ++x) dst[x] = uint8_t(clip255(dst[x] + (v[x] >> 3)));
  }
}

// A macroblock plane's work array: row 0 the samples above (127 on the
// first row; the top-left 129 on the first column below it), column 0 those
// to the left (129 on the first column); with extra, 4 top-right samples
// (the last above sample repeated on the last column)
struct Work {
  int stride, size;
  uint8_t buf[17 * 21];
  uint8_t* at(int r, int c) { return buf + r * stride + c; }  // r, c from -1
};

void edges(const std::vector<uint8_t>& plane, int pw, int y0, int x0, int size, int mx, int my,
           int mb_w, int extra, Work* w) {
  w->size = size;
  w->stride = size + 1 + extra;
  uint8_t* top = w->buf;
  if (my == 0) {
    std::memset(top, 127, size_t(w->stride));
  } else {
    const uint8_t* above = &plane[size_t(y0 - 1) * size_t(pw)];
    top[0] = mx == 0 ? 129 : above[x0 - 1];
    std::memcpy(top + 1, above + x0, size_t(size));
    if (extra) {
      if (mx == mb_w - 1)
        std::memset(top + size + 1, above[x0 + size - 1], 4);
      else
        std::memcpy(top + size + 1, above + x0 + size, 4);
    }
  }
  for (int r = 0; r < size; ++r)
    w->buf[(r + 1) * w->stride] =
        mx == 0 ? 129 : plane[size_t(y0 + r) * size_t(pw) + size_t(x0 - 1)];
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

// VP8PredLuma4 at dst (the stride s; dst[-s] the row above, dst[-1] the left)
void pred4(uint8_t* dst, int s, int mode) {
  const uint8_t* top = dst - s;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
            G = top[6], H = top[7];
  const int I = dst[-1], J = dst[s - 1], K = dst[2 * s - 1], L = dst[3 * s - 1];
  auto put = [&](int x, int y, int v) { dst[y * s + x] = uint8_t(v); };
  switch (mode) {
    case kDC: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y) std::memset(dst + y * s, v, 4);
      break;
    }
    case kTM: {
      const int lf[4] = {I, J, K, L}, tp[4] = {A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, clip255(tp[x] + lf[y] - X));
      break;
    }
    case kVE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, v[x]);
      break;
    }
    case kHE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * s, v[y], 4);
      break;
    }
    case kRD:
      put(0, 3, avg3(J, K, L));
      put(1, 3, avg3(I, J, K)); put(0, 2, avg3(I, J, K));
      put(2, 3, avg3(X, I, J)); put(1, 2, avg3(X, I, J)); put(0, 1, avg3(X, I, J));
      put(3, 3, avg3(A, X, I)); put(2, 2, avg3(A, X, I)); put(1, 1, avg3(A, X, I));
      put(0, 0, avg3(A, X, I));
      put(3, 2, avg3(B, A, X)); put(2, 1, avg3(B, A, X)); put(1, 0, avg3(B, A, X));
      put(3, 1, avg3(C, B, A)); put(2, 0, avg3(C, B, A));
      put(3, 0, avg3(D, C, B));
      break;
    case kLD:
      put(0, 0, avg3(A, B, C));
      put(1, 0, avg3(B, C, D)); put(0, 1, avg3(B, C, D));
      put(2, 0, avg3(C, D, E)); put(1, 1, avg3(C, D, E)); put(0, 2, avg3(C, D, E));
      put(3, 0, avg3(D, E, F)); put(2, 1, avg3(D, E, F)); put(1, 2, avg3(D, E, F));
      put(0, 3, avg3(D, E, F));
      put(3, 1, avg3(E, F, G)); put(2, 2, avg3(E, F, G)); put(1, 3, avg3(E, F, G));
      put(3, 2, avg3(F, G, H)); put(2, 3, avg3(F, G, H));
      put(3, 3, avg3(G, H, H));
      break;
    case kVR:
      put(0, 0, avg2i(X, A)); put(1, 2, avg2i(X, A));
      put(1, 0, avg2i(A, B)); put(2, 2, avg2i(A, B));
      put(2, 0, avg2i(B, C)); put(3, 2, avg2i(B, C));
      put(3, 0, avg2i(C, D));
      put(0, 3, avg3(K, J, I));
      put(0, 2, avg3(J, I, X));
      put(0, 1, avg3(I, X, A)); put(1, 3, avg3(I, X, A));
      put(1, 1, avg3(X, A, B)); put(2, 3, avg3(X, A, B));
      put(2, 1, avg3(A, B, C)); put(3, 3, avg3(A, B, C));
      put(3, 1, avg3(B, C, D));
      break;
    case kVL:
      put(0, 0, avg2i(A, B));
      put(1, 0, avg2i(B, C)); put(0, 2, avg2i(B, C));
      put(2, 0, avg2i(C, D)); put(1, 2, avg2i(C, D));
      put(3, 0, avg2i(D, E)); put(2, 2, avg2i(D, E));
      put(0, 1, avg3(A, B, C));
      put(1, 1, avg3(B, C, D)); put(0, 3, avg3(B, C, D));
      put(2, 1, avg3(C, D, E)); put(1, 3, avg3(C, D, E));
      put(3, 1, avg3(D, E, F)); put(2, 3, avg3(D, E, F));
      put(3, 2, avg3(E, F, G));
      put(3, 3, avg3(F, G, H));
      break;
    case kHD:
      put(0, 0, avg2i(I, X)); put(2, 1, avg2i(I, X));
      put(0, 1, avg2i(J, I)); put(2, 2, avg2i(J, I));
      put(0, 2, avg2i(K, J)); put(2, 3, avg2i(K, J));
      put(0, 3, avg2i(L, K));
      put(3, 0, avg3(A, B, C));
      put(2, 0, avg3(X, A, B));
      put(1, 0, avg3(I, X, A)); put(3, 1, avg3(I, X, A));
      put(1, 1, avg3(J, I, X)); put(3, 2, avg3(J, I, X));
      put(1, 2, avg3(K, J, I)); put(3, 3, avg3(K, J, I));
      put(1, 3, avg3(L, K, J));
      break;
    default:  // kHU
      put(0, 0, avg2i(I, J));
      put(2, 0, avg2i(J, K)); put(0, 1, avg2i(J, K));
      put(2, 1, avg2i(K, L)); put(0, 2, avg2i(K, L));
      put(1, 0, avg3(I, J, K));
      put(3, 0, avg3(J, K, L)); put(1, 1, avg3(J, K, L));
      put(3, 1, avg3(K, L, L)); put(1, 2, avg3(K, L, L));
      put(3, 2, L); put(2, 2, L); put(0, 3, L); put(1, 3, L); put(2, 3, L); put(3, 3, L);
      break;
  }
}

// a 16x16 luma or 8x8 chroma prediction in the work array (libwebp's
// CheckMode for DC at the frame's edges)
void pred_block(Work* w, int mode, int mx, int my) {
  const int size = w->size, s = w->stride, sh = size == 16 ? 4 : 3;
  uint8_t* dst = w->at(1, 1);
  const uint8_t* top = dst - s;
  if (mode == kDC) {
    int st = 0, sl = 0, v;
    for (int i = 0; i < size; ++i) {
      st += top[i];
      sl += dst[i * s - 1];
    }
    if (mx && my)
      v = (st + sl + size) >> (sh + 1);
    else if (mx)
      v = (sl + size / 2) >> sh;
    else if (my)
      v = (st + size / 2) >> sh;
    else
      v = 128;
    for (int y = 0; y < size; ++y) std::memset(dst + y * s, v, size_t(size));
  } else if (mode == kTM) {
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x)
        dst[y * s + x] = uint8_t(clip255(top[x] + dst[y * s - 1] - top[-1]));
  } else if (mode == kVE) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * s, top, size_t(size));
  } else {
    for (int y = 0; y < size; ++y) std::memset(dst + y * s, dst[y * s - 1], size_t(size));
  }
}

struct Planes {
  int w = 0, h = 0, yw = 0, uw = 0;  // yw / uw: the padded strides
  std::vector<uint8_t> y, u, v;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

// libwebp's edge filters; p: the first pixel past the edge (q0), hs: the
// step across the edge, vs: the step along it, n positions
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int hs) {
  const int p1 = p[-2 * hs], p0 = p[-hs], q0 = p[0], q1 = p[hs];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-hs] = uint8_t(clip255(p0 + a2));
  p[0] = uint8_t(clip255(q0 - a1));
}

inline void filter4(uint8_t* p, int hs) {
  const int p1 = p[-2 * hs], p0 = p[-hs], q0 = p[0], q1 = p[hs];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * hs] = uint8_t(clip255(p1 + a3));
  p[-hs] = uint8_t(clip255(p0 + a2));
  p[0] = uint8_t(clip255(q0 - a1));
  p[hs] = uint8_t(clip255(q1 - a3));
}

inline void filter6(uint8_t* p, int hs) {
  const int p2 = p[-3 * hs], p1 = p[-2 * hs], p0 = p[-hs], q0 = p[0], q1 = p[hs], q2 = p[2 * hs];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * hs] = uint8_t(clip255(p2 + a3));
  p[-2 * hs] = uint8_t(clip255(p1 + a2));
  p[-hs] = uint8_t(clip255(p0 + a1));
  p[0] = uint8_t(clip255(q0 - a1));
  p[hs] = uint8_t(clip255(q1 - a2));
  p[2 * hs] = uint8_t(clip255(q2 - a3));
}

inline bool needs(const uint8_t* p, int hs, int t2) {
  return 4 * std::abs(p[-hs] - p[0]) + std::abs(p[-2 * hs] - p[hs]) <= t2;
}

inline bool needs2(const uint8_t* p, int hs, int t2, int it) {
  const int p3 = p[-4 * hs], p2 = p[-3 * hs], p1 = p[-2 * hs], p0 = p[-hs];
  const int q0 = p[0], q1 = p[hs], q2 = p[2 * hs], q3 = p[3 * hs];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

inline bool hev(const uint8_t* p, int hs, int t) {
  return std::abs(p[-2 * hs] - p[-hs]) > t || std::abs(p[hs] - p[0]) > t;
}

void simple_edge(uint8_t* p, int hs, int vs, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vs)
    if (needs(p, hs, t2)) filter2(p, hs);
}

void normal_edge(uint8_t* p, int hs, int vs, int n, int thresh, int it, int hev_t, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += vs) {
    if (!needs2(p, hs, t2, it)) continue;
    if (hev(p, hs, hev_t))
      filter2(p, hs);
    else if (mb)
      filter6(p, hs);
    else
      filter4(p, hs);
  }
}

// DoFilter over the frame in macroblock order
void loop_filter(const Frame& f, const std::vector<FInfo>& fi, int mb_w, int mb_h, Planes* pl) {
  const int ys = pl->yw, cs = pl->uw;
  for (int my = 0; my < mb_h; ++my) {
    for (int mx = 0; mx < mb_w; ++mx) {
      const FInfo& q = fi[size_t(my) * size_t(mb_w) + size_t(mx)];
      if (!q.limit) continue;
      uint8_t* y = &pl->y[size_t(16 * my) * size_t(ys) + size_t(16 * mx)];
      if (f.filter_type == 1) {
        if (mx > 0) simple_edge(y, 1, ys, q.limit + 4);
        if (q.inner)
          for (int e = 4; e < 16; e += 4) simple_edge(y + e, 1, ys, q.limit);
        if (my > 0) simple_edge(y, ys, 1, q.limit + 4);
        if (q.inner)
          for (int e = 4; e < 16; e += 4) simple_edge(y + e * ys, ys, 1, q.limit);
        continue;
      }
      const size_t co = size_t(8 * my) * size_t(cs) + size_t(8 * mx);
      uint8_t* c[2] = {&pl->u[co], &pl->v[co]};
      const int lim = q.limit, il = q.ilevel, hv = q.hev;
      if (mx > 0) {
        normal_edge(y, 1, ys, 16, lim + 4, il, hv, true);
        for (uint8_t* p : c) normal_edge(p, 1, cs, 8, lim + 4, il, hv, true);
      }
      if (q.inner) {
        for (int e = 4; e < 16; e += 4) normal_edge(y + e, 1, ys, 16, lim, il, hv, false);
        for (uint8_t* p : c) normal_edge(p + 4, 1, cs, 8, lim, il, hv, false);
      }
      if (my > 0) {
        normal_edge(y, ys, 1, 16, lim + 4, il, hv, true);
        for (uint8_t* p : c) normal_edge(p, cs, 1, 8, lim + 4, il, hv, true);
      }
      if (q.inner) {
        for (int e = 4; e < 16; e += 4) normal_edge(y + e * ys, ys, 1, 16, lim, il, hv, false);
        for (uint8_t* p : c) normal_edge(p + 4 * cs, cs, 1, 8, lim, il, hv, false);
      }
    }
  }
}

// PrecomputeFilterStrengths: [segment][i4]
void filter_strengths(const Frame& f, FInfo out[4][2]) {
  for (int s = 0; s < 4; ++s) {
    const int base = f.use_segment ? f.fstrength[s] + (f.absolute ? 0 : f.level) : f.level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int level = base;
      if (f.use_lf_delta) level += f.ref_delta[0] + (i4 ? f.mode_delta[0] : 0);
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      FInfo& q = out[s][i4];
      q = FInfo();
      if (level > 0) {
        int il = level;
        if (f.sharpness > 0) {
          il >>= f.sharpness > 4 ? 2 : 1;
          il = std::min(il, 9 - f.sharpness);
        }
        il = std::max(il, 1);
        q.limit = 2 * level + il;
        q.ilevel = il;
        q.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
    }
  }
}

constexpr int kScanY[16] = {0, 0, 0, 0, 4, 4, 4, 4, 8, 8, 8, 8, 12, 12, 12, 12};

// a VP8 keyframe from its frame tag to the end of the data -> the planes
Planes vp8(const uint8_t* d, size_t n) {
  Frame f;
  parse_header(d, n, &f);
  const int w = f.w, h = f.h, mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  if (!w || !h) throw Bad("VP8: zero size");
  Planes pl;
  pl.w = w;
  pl.h = h;
  pl.yw = 16 * mb_w;
  pl.uw = 8 * mb_w;
  pl.y.assign(size_t(16 * mb_h) * size_t(pl.yw), 0);
  pl.u.assign(size_t(8 * mb_h) * size_t(pl.uw), 0);
  pl.v.assign(size_t(8 * mb_h) * size_t(pl.uw), 0);
  FInfo fs[4][2];
  filter_strengths(f, fs);
  std::vector<FInfo> fi(size_t(mb_w) * size_t(mb_h));
  std::vector<uint8_t> intra_t(size_t(4 * mb_w), kDC);
  std::vector<int> top_nz(size_t(2 * mb_w), 0);
  std::vector<MB> row(static_cast<size_t>(mb_w));
  int16_t coef[384];
  Work wk;
  for (int my = 0; my < mb_h; ++my) {
    parse_modes(&f, mb_w, &intra_t, &row);
    if (f.br.eof) throw Bad("VP8: premature end-of-partition0 encountered");
    Bool& tb = f.parts[size_t(my) & (f.parts.size() - 1)];
    int left[2] = {0, 0};
    for (int mx = 0; mx < mb_w; ++mx) {
      MB& m = row[size_t(mx)];
      int* tnz = &top_nz[size_t(2 * mx)];
      uint32_t nzy = 0, nzuv = 0;
      int skip = f.use_skip ? m.skip : 0;
      if (!skip) {
        residuals(f, m, tnz, left, tb, coef, &nzy, &nzuv);
        skip = !(nzy | nzuv);
      } else {
        tnz[0] = left[0] = 0;
        if (!m.i4) tnz[1] = left[1] = 0;
      }
      if (tb.eof) throw Bad("VP8: premature end-of-file encountered");
      if (f.filter_type) {
        FInfo& q = fi[size_t(my) * size_t(mb_w) + size_t(mx)];
        q = fs[m.segment][m.i4];
        q.inner = m.i4 || !skip;
      }
      // reconstruct from the unfiltered neighbours
      const int y0 = 16 * my, x0 = 16 * mx;
      edges(pl.y, pl.yw, y0, x0, 16, mx, my, mb_w, m.i4 ? 4 : 0, &wk);
      if (m.i4) {
        for (int r = 4; r <= 12; r += 4) std::memcpy(wk.at(r, 17), wk.at(0, 17), 4);
        for (int k = 0; k < 16; ++k) {
          uint8_t* dst = wk.at(1 + kScanY[k], 1 + 4 * (k & 3));
          pred4(dst, wk.stride, m.modes[k]);
          const uint32_t code = (nzy >> (30 - 2 * k)) & 3;
          if (code) idct_add(coef + 16 * k, dst, wk.stride, code == 3);
        }
      } else {
        pred_block(&wk, m.modes[0], mx, my);
        for (int k = 0; k < 16; ++k) {
          const uint32_t code = (nzy >> (30 - 2 * k)) & 3;
          if (code)
            idct_add(coef + 16 * k, wk.at(1 + kScanY[k], 1 + 4 * (k & 3)), wk.stride, code == 3);
        }
      }
      for (int r = 0; r < 16; ++r)
        std::memcpy(&pl.y[size_t(y0 + r) * size_t(pl.yw) + size_t(x0)], wk.at(1 + r, 1), 16);
      for (int ci = 0; ci < 2; ++ci) {
        std::vector<uint8_t>& P = ci ? pl.v : pl.u;
        edges(P, pl.uw, y0 / 2, x0 / 2, 8, mx, my, mb_w, 0, &wk);
        pred_block(&wk, m.uvmode, mx, my);
        const uint32_t bits = (nzuv >> (8 * ci)) & 0xFF;
        for (int k = 0; k < 4; ++k)
          if (bits)
            idct_add(coef + 16 * (16 + 4 * ci + k), wk.at(1 + 4 * (k >> 1), 1 + 4 * (k & 1)),
                     wk.stride, bits & 0xAA);
        for (int r = 0; r < 8; ++r)
          std::memcpy(&P[size_t(y0 / 2 + r) * size_t(pl.uw) + size_t(x0 / 2)], wk.at(1 + r, 1), 8);
      }
    }
  }
  if (f.filter_type) loop_filter(f, fi, mb_w, mb_h, &pl);
  return pl;
}

// ------------------------------------------------------- alpha and output

// libwebp's alpha unfilters (data/webp.py `_unfilter`)
void unfilter(std::vector<uint8_t>* a, int w, int h, int filt) {
  if (!filt) return;
  uint8_t* o = a->data();
  for (int x = 1; x < w; ++x) o[x] = uint8_t(o[x] + o[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint8_t* cur = o + size_t(y) * size_t(w);
    const uint8_t* prev = cur - w;
    if (filt == 1) {
      cur[0] = uint8_t(cur[0] + prev[0]);
      for (int x = 1; x < w; ++x) cur[x] = uint8_t(cur[x] + cur[x - 1]);
    } else if (filt == 2) {
      for (int x = 0; x < w; ++x) cur[x] = uint8_t(cur[x] + prev[x]);
    } else {
      int left = prev[0], tl = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x];
        left = (cur[x] + clip255(left + top - tl)) & 255;
        tl = top;
        cur[x] = uint8_t(left);
      }
    }
  }
}

// the ALPH chunk's payload -> the (h, w) alpha plane
std::vector<uint8_t> alpha_plane(const uint8_t* d, size_t size, int w, int h) {
  if (size <= 1) throw Bad("ALPH: empty");
  const int hdr = d[0], method = hdr & 3, filt = (hdr >> 2) & 3, pre = (hdr >> 4) & 3;
  if (method > 1 || pre > 1 || (hdr >> 6)) throw Bad("ALPH: bad header");
  const size_t np = size_t(w) * size_t(h);
  std::vector<uint8_t> a(np);
  if (method == 0) {
    if (size - 1 < np) throw Bad("ALPH: short raw plane");
    std::memcpy(a.data(), d + 1, np);
  } else {
    LBits br(d + 1, size - 1);
    const std::vector<uint32_t> img = vp8l_image(br, w, h, true);
    for (size_t i = 0; i < np; ++i) a[i] = uint8_t(img[i] >> 8);
  }
  unfilter(&a, w, h, filt);
  return a;
}

inline int mulhi8(int v, int k) { return (v * k) >> 8; }
inline uint8_t clip8(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }

// libwebp's fancy upsampler for one output row: near / far chroma rows
void upsample_row(const uint8_t* nr, const uint8_t* fr, int w, int uw, int* out) {
  out[0] = (3 * nr[0] + fr[0] + 2) >> 2;
  for (int k = 1; k <= (w - 1) >> 1; ++k) {
    const int nl = nr[k - 1], nn = nr[k], fl = fr[k - 1], ff = fr[k];
    const int avg = nl + nn + fl + ff + 8;
    out[2 * k - 1] = (((avg + 2 * (nn + fl)) >> 3) + nl) >> 1;
    out[2 * k] = (((avg + 2 * (nl + ff)) >> 3) + nn) >> 1;
  }
  if (!(w & 1)) out[w - 1] = (3 * nr[uw - 1] + fr[uw - 1] + 2) >> 2;
}

// VP8YUVToB / G / R after the upsampler -> B G R (A) samples, c a pixel
void yuv_to_bgr(const Planes& pl, const uint8_t* alpha, int c, uint8_t* out) {
  const int w = pl.w, h = pl.h, uh = (h + 1) >> 1, uw = (w + 1) >> 1;
  std::vector<int> u(static_cast<size_t>(w)), v(static_cast<size_t>(w));
  for (int y = 0; y < h; ++y) {
    const int near = y >> 1;
    const int far = (y & 1) ? std::min(near + 1, uh - 1) : std::max(near - 1, 0);
    upsample_row(&pl.u[size_t(near) * size_t(pl.uw)], &pl.u[size_t(far) * size_t(pl.uw)], w, uw,
                 u.data());
    upsample_row(&pl.v[size_t(near) * size_t(pl.uw)], &pl.v[size_t(far) * size_t(pl.uw)], w, uw,
                 v.data());
    const uint8_t* yr = &pl.y[size_t(y) * size_t(pl.yw)];
    uint8_t* o = out + size_t(y) * size_t(w) * size_t(c);
    for (int x = 0; x < w; ++x, o += c) {
      const int yy = mulhi8(yr[x], 19077);
      o[0] = clip8(yy + mulhi8(u[size_t(x)], 33050) - 17685);
      o[1] = clip8(yy - mulhi8(u[size_t(x)], 6419) - mulhi8(v[size_t(x)], 13320) + 8708);
      o[2] = clip8(yy + mulhi8(v[size_t(x)], 26149) - 14234);
      if (c == 4) o[3] = alpha ? alpha[size_t(y) * size_t(w) + size_t(x)] : 255;
    }
  }
}

std::vector<uint8_t> read_all(const char* path) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path, "rb"), std::fclose);
  if (!f) throw WebPError(std::string("cannot open the file (") + std::strerror(errno) + ")");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f.get())) > 0)
    data.insert(data.end(), buf, buf + got);
  if (std::ferror(f.get())) throw WebPError("cannot read the file");
  return data;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", msg.c_str());
}

}  // namespace

// cv2's imread(IMREAD_UNCHANGED): (h, w, c) B G R (A), c = 3 or 4
void decode(const uint8_t* d, size_t n, int* h, int* w, int* c, std::vector<uint8_t>* out) {
  const Headers hd = cv2_headers(d, n);
  *h = hd.h;
  *w = hd.w;
  *c = hd.channels;
  const size_t np = size_t(hd.w) * size_t(hd.h);
  try {
    if (hd.lossless) {
      int fw, fh;
      const std::vector<uint32_t> argb = vp8l(d + hd.pos, n - hd.pos, &fw, &fh);
      out->resize(np * size_t(hd.channels));
      uint8_t* o = out->data();
      for (size_t i = 0; i < np; ++i, o += hd.channels) {
        const uint32_t v = argb[i];
        o[0] = uint8_t(v);
        o[1] = uint8_t(v >> 8);
        o[2] = uint8_t(v >> 16);
        if (hd.channels == 4) o[3] = uint8_t(v >> 24);
      }
    } else {
      const Planes pl = vp8(d + hd.pos, n - hd.pos);
      std::vector<uint8_t> alpha;
      if (hd.has_alph) alpha = alpha_plane(d + hd.alph_off, hd.alph_size, pl.w, pl.h);
      out->resize(np * size_t(hd.channels));
      yuv_to_bgr(pl, alpha.empty() ? nullptr : alpha.data(), hd.channels, out->data());
    }
  } catch (const Bad& e) {
    throw WebPError(e.what());
  }
}

// the JAX native loader's OpenCV 4.6 read and BGRA2BGR: (h, w) B G R
void decode_bgr(const uint8_t* d, size_t n, int* h, int* w, std::vector<uint8_t>* bgr) {
  int c;
  decode(d, n, h, w, &c, bgr);
  if (c == 4) {
    const size_t np = size_t(*h) * size_t(*w);
    uint8_t* o = bgr->data();
    for (size_t i = 0; i < np; ++i) std::memmove(o + 3 * i, o + 4 * i, 3);
    bgr->resize(np * 3);
  }
}

}  // namespace sodt_webp

extern "C" {

int webp_file_shape(const char* path, int* h, int* w, int* c, int* kind, char* err, int err_len) {
  try {
    std::vector<uint8_t> data = sodt_webp::read_all(path);
    const sodt_webp::Headers hd = sodt_webp::cv2_headers(data.data(), data.size());
    *h = hd.h;
    *w = hd.w;
    *c = hd.channels;
    *kind = 1;
    return 1;
  } catch (const std::exception& e) {
    sodt_webp::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

int webp_file_decode(const char* path, uint8_t* out, int h, int w, int c, int kind, char* err,
                     int err_len) {
  try {
    std::vector<uint8_t> data = sodt_webp::read_all(path);
    int hh, ww, cc;
    std::vector<uint8_t> px;
    sodt_webp::decode(data.data(), data.size(), &hh, &ww, &cc, &px);
    if (hh != h || ww != w || cc != c || kind != 1)
      throw sodt_webp::WebPError("the file changed between the shape query and the decode");
    std::memcpy(out, px.data(), px.size());
    return 1;
  } catch (const std::exception& e) {
    sodt_webp::set_error(err, err_len, std::string(path) + ": " + e.what());
    return 0;
  }
}

}  // extern "C"
