"""WebP decode in numpy: the plain version of the port's WebP decoder
(`csrc/webp.cpp`), and the reader of the box crops' tool.

The card's machine has neither cv2 nor PIL nor libwebp, so the port carries
its own WebP code, as it does for PNG, JPEG, BMP and TIFF. The JAX package
reads an image through `cv2.imread(IMREAD_UNCHANGED)` and then `[..., ::-1]`
(`sodt_tpu/data/vedai.py` `_read_image`), which for a WebP file is libwebp's
`WebPDecodeBGRInto` / `WebPDecodeBGRAInto`:

  file                              read_webp
  VP8  (lossy), no alpha            (H, W, 3) RGB
  VP8X + ALPH + VP8 (alpha flag)    (H, W, 4) A R G B (`[..., ::-1]` of BGRA)
  VP8L (lossless), alpha bit clear  (H, W, 3) RGB
  VP8L, alpha bit set               (H, W, 4) A R G B
  VP8X + VP8L                       (H, W, 4) where the VP8X alpha flag is
                                      set, else (H, W, 3): OpenCV takes the
                                      channels from the file's first 32 bytes

  read_webp_rgb(path)  (H, W, 3) RGB as PIL's `convert("RGB")` gives it
                       (the same decode, alpha dropped; on a damaged file
                       cv2's reading of it, ROADMAP Queue 3).
  webp_size(path)      (width, height) as PIL's `Image.size`.
  verify_webp(path)    raises where PIL's `Image.open` (libwebp's
                       WebPGetFeatures and its demuxer over the whole file,
                       PIL's decompression bomb) plus the JAX scan's 10 px
                       assert fail; PIL's `verify` reads no pixels.

The decode is libwebp's:
  container  the RIFF walk of `WebPDecode` (RIFF size against the file,
             VP8X of 10 bytes with its canvas equal to the frame, ALPH /
             ICCP / EXIF / XMP / unknown chunks before the frame, sizes
             padded to even), the 32-byte minimum and 64 MiB maximum of
             OpenCV's reader;
  VP8L       RFC 9649: the four transforms, canonical prefix codes (simple
             and normal code-length codes), the meta prefix image, the
             colour cache, LZ77 with the 120-entry distance map; a stream
             that reads past its end fails, as libwebp's does;
  VP8        RFC 6386 keyframes: the boolean decoder, segments, the simple
             and normal loop filters, 1-8 token partitions, the
             coefficient probabilities and their updates, the 16x16, 4x4
             and chroma intra modes, the WHT and IDCT (in 16-bit sums
             where x86 libwebp takes its SSE2 transform, so that
             coefficients no encoder writes decode as cv2's); a partition
             that runs out before the last macroblock using it fails
             ("premature end-of-file"), as in libwebp;
  ALPH       raw or VP8L-compressed (the green of a headerless VP8L
             image), with the none, horizontal, vertical and gradient
             filters undone;
  YUV        libwebp's "fancy" upsampler (9-3-3-1) and its 14-bit
             fixed-point VP8YUVToR / G / B, without dithering.
An animated file (the VP8X animation flag) raises NotImplementedError
naming "animated WebP": cv2 5.0 reads its first frame, OpenCV 4.6 fails.
A WebP side is at most 16383 px, so no file reaches OpenCV's 2^30 pixel
limit; one above PIL's 2 x 89478485 raises in `webp_size` / `verify_webp`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .png import MIN_SIDE, pil_bomb

MAX_PIXELS = 1 << 30             # OpenCV's CV_IO_MAX_IMAGE_PIXELS
CV_HEADER = 32       # OpenCV's WEBP_HEADER_SIZE: files below it fail
CV_MAX_FILE = 64 << 20           # OpenCV's default WebP file size limit
MAX_CHUNK = (1 << 32) - 1 - 10   # libwebp's MAX_CHUNK_PAYLOAD
ANIMATION_FLAG, ALPHA_FLAG = 0x02, 0x10
VALID_FLAGS = 0x3E               # alpha, animation, EXIF, ICCP, XMP


# libwebp's constant tables (the port's own copies)
_COEFFS_PROBA0 = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189,
    129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214,
    209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128,
    128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255,
    128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251,
    255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255,
    255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128,
    128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177,
    135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194,
    224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162,
    160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68,
    47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221,
    224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128,
    128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232,
    253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255,
    202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1,
    200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231,
    245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128,
    128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136,
    225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161,
    255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128,
    128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181,
    251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255, 236, 231, 255,
    255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213,
    255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128,
    128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248,
    251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249,
    198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1,
    95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211,
    209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128,
    128, 128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219,
    255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255,
    228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255,
    255, 128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128,
    128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149,
    1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252,
    255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128,
    128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126,
    38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151,
    178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255,
    255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77,
    162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199,
    249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255,
    128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249,
    219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171,
    128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81,
    230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196,
    255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128,
    128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246,
    252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255,
    255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240,
    162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128,
)
_COEFFS_UPDATE_PROBA = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223,
    241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255,
    255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254,
    255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255,
    255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248,
    254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255,
)
_BMODES_PROBA = (
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46,
    70, 95, 175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189,
    17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26,
    62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19,
    136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11,
    96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72,
    187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234,
    128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166, 49,
    23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27, 217, 255,
    87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183,
    21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42,
    46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53, 200, 87,
    26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85,
    171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54,
    32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19,
    21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193,
    101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18,
    111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209,
    10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67,
    45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255,
    128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168,
    209, 192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58,
    169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40,
    21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46,
    17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65,
    32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6, 223, 87,
    37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64,
    90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30,
    34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205, 45, 37,
    192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85, 117,
    175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128,
    81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73,
    26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255,
    166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102, 102,
    213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34,
    53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1,
    47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154,
    100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9,
    64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8, 17, 132,
    137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31,
    137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40,
    64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45,
    16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83,
    12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20,
    32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85,
    37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55,
    70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62,
    219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12,
    61, 195, 128, 48, 4, 24,
)
_YMODES_INTRA4 = (
    0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9,
)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100,
    102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137,
    140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249,
    254, 259, 264, 269, 274, 279, 284,
)
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71,
    72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154,
    157,
)
_ZIGZAG = (
    0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15,
)
_BANDS = (
    0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0,
)
_CODE_LENGTH_CODE_ORDER = (
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
)
_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103,
    105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1,
    119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49,
    63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
)


def _le24(d, i):
    return d[i] | d[i + 1] << 8 | d[i + 2] << 16


def _le32(d, i):
    return d[i] | d[i + 1] << 8 | d[i + 2] << 16 | d[i + 3] << 24


def _vp8_info(d, pos, avail, chunk):
    """libwebp's VP8GetInfo: a keyframe's 10-byte header -> (w, h), or
    None where libwebp refuses it."""
    if avail < 10 or d[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        return None
    bits = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16
    w = (d[pos + 7] << 8 | d[pos + 6]) & 0x3FFF
    h = (d[pos + 9] << 8 | d[pos + 8]) & 0x3FFF
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk or w == 0 or h == 0):
        return None
    return w, h


def _vp8l_info(d, pos, avail):
    """libwebp's VP8LGetInfo: the 5-byte header -> (w, h, alpha), or None."""
    if avail < 5 or d[pos] != 0x2F or d[pos + 4] >> 5:
        return None
    v = _le32(d, pos + 1)
    return (v & 0x3FFF) + 1, (v >> 14 & 0x3FFF) + 1, v >> 28 & 1


class _Status(Exception):
    """A libwebp status other than OK: "short" (NOT_ENOUGH_DATA) or
    "bad" (BITSTREAM_ERROR)."""


def _headers(d, n, full):
    """libwebp's ParseHeadersInternal over the first n bytes of d: with
    `full`, as WebPDecode reads the whole file (have_all_data); else as
    WebPGetFeatures reads a prefix. Returns a dict (w, h, alpha, animated,
    lossless, pos: the bitstream's first byte, alph: (offset, size) of the
    last ALPH chunk or None); raises _Status."""
    if n < 12:
        raise _Status("short")
    pos, riff = 0, 0
    if d[:4] == b"RIFF":
        if d[8:12] != b"WEBP":
            raise _Status("bad")
        riff = _le32(d, 4)
        if riff < 12 or riff > MAX_CHUNK:
            raise _Status("bad")
        if full and riff > n - 8:
            raise _Status("short")
        pos = 12
    if n - pos < 8:
        raise _Status("short")
    vp8x, flags, w, h = False, 0, 0, 0
    if d[pos:pos + 4] == b"VP8X":
        if _le32(d, pos + 4) != 10:
            raise _Status("bad")
        if n - pos < 18:
            raise _Status("short")
        flags = _le32(d, pos + 8)
        w, h = 1 + _le24(d, pos + 12), 1 + _le24(d, pos + 15)
        if w * h >= 1 << 32:
            raise _Status("bad")
        pos += 18
        vp8x = True
    if not riff and vp8x:
        raise _Status("bad")
    out = dict(w=w, h=h, alpha=bool(flags & ALPHA_FLAG),
               animated=bool(flags & ANIMATION_FLAG), lossless=False,
               pos=pos, alph=None)
    if vp8x and out["animated"] and not full:
        return out
    try:
        if n - pos < 4:
            raise _Status("short")
        if vp8x or (not riff and d[pos:pos + 4] == b"ALPH"):
            total = 22                  # "WEBP" + the VP8X chunk
            while True:
                if n - pos < 8:
                    raise _Status("short")
                size = _le32(d, pos + 4)
                if size > MAX_CHUNK:
                    raise _Status("bad")
                disk = (8 + size + 1) & ~1
                total += disk
                if riff and total > riff:
                    raise _Status("bad")
                if d[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if n - pos < disk:
                    raise _Status("short")
                if d[pos:pos + 4] == b"ALPH":
                    out["alph"] = (pos + 8, size)
                pos += disk
        if n - pos < 8:
            raise _Status("short")
        tag = d[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le32(d, pos + 4)
            if riff >= 12 and size > riff - 12:
                raise _Status("bad")
            if full and size > n - pos - 8:
                raise _Status("short")
            chunk, lossless = size, tag == b"VP8L"
            pos += 8
        else:                           # a raw bitstream
            lossless = _vp8l_info(d, pos, n - pos) is not None
            chunk = n - pos
        if chunk > MAX_CHUNK:
            raise _Status("bad")
        out.update(lossless=lossless, pos=pos)
        if not lossless:
            if n - pos < 10:
                raise _Status("short")
            info = _vp8_info(d, pos, n - pos, chunk)
            if info is None:
                raise _Status("bad")
            fw, fh = info
        else:
            if n - pos < 5:
                raise _Status("short")
            info = _vp8l_info(d, pos, n - pos)
            if info is None:
                raise _Status("bad")
            fw, fh, out["alpha"] = info
        if vp8x and (w, h) != (fw, fh):
            raise _Status("bad")
        out.update(w=fw, h=fh)
    except _Status as e:
        if not (str(e) == "short" and vp8x and not full):
            raise
    out["alpha"] = bool(out["alpha"] or out["alph"] is not None)
    return out


def _cv2_headers(d: bytes, name: str) -> dict:
    """What cv2 takes from a WebP file before it decodes: OpenCV's reader
    (a 32-byte header read by WebPGetFeatures, which sets the channels: 4
    where it finds alpha) and then WebPDecode's walk over the whole file;
    raises ValueError where cv2 returns no image, NotImplementedError for an
    animated file."""
    n = len(d)
    if n < CV_HEADER:
        raise ValueError(f"{name}: a WebP file of {n} bytes, below the "
                         f"{CV_HEADER} OpenCV reads")
    if n > CV_MAX_FILE:
        raise ValueError(f"{name}: a WebP file above OpenCV's 64 MiB limit")
    try:
        head = _headers(d, CV_HEADER, full=False)
    except _Status as e:
        raise ValueError(f"{name}: broken WebP header ({e})") from None
    if head["animated"]:
        raise NotImplementedError(f"{name}: an animated WebP (the port reads "
                                  "still images)")
    try:
        hd = _headers(d, n, full=True)
    except _Status as e:
        raise ValueError(f"{name}: broken WebP file ({e})") from None
    if hd["w"] * hd["h"] > MAX_PIXELS:
        raise ValueError(f"{name}: {hd['w']} x {hd['h']} px, above OpenCV's "
                         "2^30")
    hd["channels"] = 4 if head["alpha"] else 3
    return hd


# ------------------------------------------------------------- demuxer
# PIL opens a WebP file with libwebp's WebPAnimDecoderNew, whose demuxer
# validates the container of the whole file (no partial data).

def _store_frame(d, pos, end, num, min_size, fr):
    """libwebp demux's StoreFrame: ALPH and VP8 / VP8L chunks from pos into
    the frame dict; returns the position after them; raises _Status."""
    if end - pos < 8 or end - pos < min_size:
        raise _Status("short")
    alphas = images = 0
    while True:
        start = pos
        tag, size = d[pos:pos + 4], _le32(d, pos + 4)
        pos += 8
        if size > MAX_CHUNK:
            raise _Status("bad")
        padded = size + (size & 1)
        if padded > end - pos:
            raise _Status("bad")
        chunk = 8 + padded
        if tag == b"ALPH" and not alphas:
            alphas = 1
            fr.update(alph=(start, chunk), has_alpha=True, num=num)
            pos += padded
        elif tag in (b"VP8 ", b"VP8L") and not images:
            if tag == b"VP8L" and alphas:
                raise _Status("bad")
            if tag == b"VP8L":
                info = _vp8l_info(d, start + 8, chunk - 8)
            else:
                info = _vp8_info(d, start + 8, chunk - 8, size)
                info = info and (*info, 0)
            if info is None:
                raise _Status("bad")
            images = 1
            fr.update(img=(start, chunk), w=info[0], h=info[1], num=num,
                      has_alpha=fr["has_alpha"] or bool(info[2]),
                      complete=True)
            pos += padded
        else:
            return start
        if pos == end:
            return pos
        if end - pos < 8:
            raise _Status("short")


def _new_frame():
    return dict(num=0, alph=None, img=None, w=0, h=0, x=0, y=0,
                has_alpha=False, complete=False)


def _demux(d: bytes, name: str) -> tuple[int, int]:
    """libwebp's WebPDemux over a whole file, as PIL's open runs it:
    (canvas width, canvas height), or ValueError."""
    def bad(why):
        return ValueError(f"{name}: broken WebP file ({why}; PIL does not "
                          "open it)")
    n = len(d)
    if n < 20 or d[:4] != b"RIFF" or d[8:12] != b"WEBP":
        raise bad("RIFF header")
    riff = _le32(d, 4)
    if riff < 8 or riff > MAX_CHUNK:
        raise bad("RIFF size")
    end = riff + 8
    if n < end:
        raise bad("shorter than its RIFF size")
    pos, frames = 12, []
    flags, cw, ch, anims = 0, 0, 0, 0
    first = d[pos:pos + 4]
    try:
        if first in (b"VP8 ", b"VP8L"):
            if end - pos < 8:
                raise _Status("bad")
            fr = _new_frame()
            _store_frame(d, pos, end, 1, 0, fr)
            if fr["w"] > 0 and fr["h"] > 0:
                cw, ch = fr["w"], fr["h"]
            frames.append(fr)
        elif first == b"VP8X":
            if end - pos < 8:
                raise _Status("short")
            size = _le32(d, pos + 4)
            if size > MAX_CHUNK or size < 10:
                raise _Status("bad")
            size += size & 1
            pos += 8
            if size > end - pos:
                raise _Status("bad")
            flags = d[pos]
            cw, ch = 1 + _le24(d, pos + 4), 1 + _le24(d, pos + 7)
            if cw * ch >= 1 << 32:
                raise _Status("bad")
            pos += size
            if 8 > end - pos:
                raise _Status("bad")
            animated = bool(flags & ANIMATION_FLAG)
            while True:
                start = pos
                tag, size = d[pos:pos + 4], _le32(d, pos + 4)
                pos += 8
                if size > MAX_CHUNK:
                    raise _Status("bad")
                padded = size + (size & 1)
                if padded > end - pos:
                    raise _Status("bad")
                if tag == b"VP8X":
                    raise _Status("bad")
                if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                    if anims or animated or frames:
                        raise _Status("bad")
                    fr = _new_frame()
                    pos = _store_frame(d, start, end, 1, 0, fr)
                    if not flags & ALPHA_FLAG and fr["alph"]:
                        fr.update(alph=None, has_alpha=False)
                    frames.append(fr)
                elif tag == b"ANIM":
                    if padded < 6:
                        raise _Status("bad")
                    anims = 1
                    pos += padded
                elif tag == b"ANMF":
                    if not anims:
                        raise _Status("bad")
                    if padded < 16:
                        raise _Status("bad")
                    fr = _new_frame()
                    fr.update(x=2 * _le24(d, pos), y=2 * _le24(d, pos + 3))
                    fw, fh = 1 + _le24(d, pos + 6), 1 + _le24(d, pos + 9)
                    if fw * fh >= 1 << 32:
                        raise _Status("bad")
                    fr.update(w=fw, h=fh)
                    at = pos + 16
                    nxt = _store_frame(d, at, end, len(frames) + 1,
                                       padded - 16, fr)
                    if nxt - at > padded - 16:
                        raise _Status("bad")
                    if animated and fr["num"] > 0:
                        if frames and not frames[-1]["complete"]:
                            raise _Status("bad")
                        frames.append(fr)
                    pos = nxt
                else:                       # ICCP, EXIF, XMP, unknown
                    pos += padded
                if pos == end:
                    break
                if end - pos < 8:
                    raise _Status("short")
        else:
            raise _Status("bad")
    except _Status as e:
        raise bad(f"chunk walk: {e}") from None
    # IsValidSimpleFormat / IsValidExtendedFormat
    if cw <= 0 or ch <= 0 or not frames:
        raise bad("no frame")
    if first == b"VP8X":
        if flags & ~VALID_FLAGS:
            raise bad("VP8X flags")
        animated = bool(flags & ANIMATION_FLAG)
        for fr in frames:
            if not animated and fr["num"] > 1:
                raise bad("frames")
            if not fr["complete"]:
                raise bad("incomplete frame")
            if fr["alph"] and fr["alph"][0] > fr["img"][0]:
                raise bad("ALPH after the frame")
            if fr["w"] <= 0 or fr["h"] <= 0:
                raise bad("frame size")
            if not animated and (fr["x"] or fr["y"] or fr["w"] != cw
                                 or fr["h"] != ch):
                raise bad("frame and canvas differ")
            if animated and (fr["w"] + fr["x"] > cw
                             or fr["h"] + fr["y"] > ch):
                raise bad("frame outside the canvas")
    elif frames[0]["w"] <= 0 or frames[0]["h"] <= 0:
        raise bad("frame size")
    return cw, ch


# ---------------------------------------------------------------- VP8L
# RFC 9649, read as libwebp's vp8l_dec.c reads it.

_ALPHABET = (256 + 24, 256, 256, 256, 40)   # green (+ cache), R, B, A, dist
_PRED, _CROSS, _GREEN, _INDEX = 0, 1, 2, 3


class _LBits:
    """libwebp's VP8L bit reader, state for state: a 64-bit window of the
    stream, LSB first, refilled a byte at a time. A read that leaves the
    window past the stream's end sets end-of-stream (after which reads give
    0 and the window restarts at its first bit), so that a damaged stream
    fails, or decodes, where libwebp's does."""
    __slots__ = ("b", "n", "val", "pos", "bit", "eos")

    def __init__(self, d, start, end):
        self.b, self.n = bytes(d[start:end]), end - start
        k = min(8, self.n)
        self.val = int.from_bytes(self.b[:k], "little")
        self.pos, self.bit, self.eos = k, 0, False

    def _shift(self):
        b, val, pos, bit = self.b, self.val, self.pos, self.bit
        while bit >= 8 and pos < self.n:
            val = (val >> 8) | b[pos] << 56
            pos += 1
            bit -= 8
        self.val, self.pos, self.bit = val, pos, bit
        if self.eos or (pos == self.n and bit > 64):
            self.eos, self.bit = True, 0

    def at_end(self):
        return self.eos or (self.pos == self.n and self.bit > 64)

    def read(self, k):
        if self.eos:
            self.bit = 0
            return 0
        v = (self.val >> (self.bit & 63)) & ((1 << k) - 1)
        self.bit += k
        self._shift()
        return v

    def fill(self):
        if self.bit >= 32:
            self._shift()

    def sym(self, tab):
        w = self.val >> (self.bit & 63)
        e = tab[0][w & 255]
        if e < 0:
            bits, sub = tab[1][~e]
            e = sub[(w >> 8) & ((1 << bits) - 1)]
            self.bit += 8
        self.bit += e >> 16
        return e & 0xFFFF


def _huffman(lengths):
    """libwebp's BuildHuffmanTable: a canonical prefix code from its code
    lengths -> (root, subtables) with an 8-bit root, or None where libwebp
    refuses the lengths (none coded, over-subscribed, incomplete); a code
    of one symbol reads no bits."""
    count = [0] * 16
    for ln in lengths:
        count[ln] += 1
    coded = len(lengths) - count[0]
    if coded == 0:
        return None
    if coded == 1:
        sym = next(i for i, ln in enumerate(lengths) if ln)
        return [sym] * 256, []
    left = 1
    for ln in range(1, 16):
        left = 2 * left - count[ln]
        if left < 0:
            return None
    if left:
        return None
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1 if ln > 1 else 0
        nxt[ln] = code
    root, subs, long = [0] * 256, [], {}
    for s, ln in enumerate(lengths):
        if not ln:
            continue
        c = nxt[ln]
        nxt[ln] += 1
        rev = int(format(c, f"0{ln}b")[::-1], 2)
        if ln <= 8:
            for k in range(rev, 256, 1 << ln):
                root[k] = ln << 16 | s
        else:
            long.setdefault(rev & 255, []).append((ln - 8, rev >> 8, s))
    for low, ents in long.items():
        bits = max(e[0] for e in ents)
        sub = [0] * (1 << bits)
        for ln, rest, s in ents:
            for k in range(rest, 1 << bits, 1 << ln):
                sub[k] = ln << 16 | s
        root[low] = ~len(subs)
        subs.append((bits, sub))
    return root, subs


def _read_lengths(br, cl, size):
    """ReadHuffmanCodeLengths: the code lengths of one alphabet, read with
    the code-length code; None where libwebp refuses them."""
    tab = _huffman(cl)
    if tab is None:
        return None
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > size:
            return None
    else:
        max_symbol = size
    lengths, prev, s = [0] * size, 8, 0
    while s < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        br.fill()
        code = br.sym(tab)
        if code < 16:
            lengths[s] = code
            s += 1
            if code:
                prev = code
        else:
            rep = br.read((2, 3, 7)[code - 16]) + (3, 3, 11)[code - 16]
            if s + rep > size:
                return None
            lengths[s:s + rep] = [prev if code == 16 else 0] * rep
            s += rep
    return lengths


def _read_code(br, size):
    """ReadHuffmanCode: one prefix code of `size` symbols; None where
    libwebp refuses it."""
    if br.read(1):                          # simple code
        lengths = [0] * size
        two = br.read(1)
        s = br.read(8 if br.read(1) else 1)
        if s < size:
            lengths[s] = 1
        if two:
            s = br.read(8)
            if s < size:
                lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_CODE_ORDER[i]] = br.read(3)
        lengths = _read_lengths(br, cl, size)
    if lengths is None or br.eos:
        return None
    return _huffman(lengths)


def _sub(size, bits):
    return (size + (1 << bits) - 1) >> bits


class _Bad(Exception):
    """A VP8L or VP8 bitstream libwebp does not decode."""


def _read_codes(br, xs, ys, cache_bits, level0):
    """ReadHuffmanCodes: (meta bits, meta image or None, {group: 5 codes})
    for the groups the meta image uses (the others read and checked)."""
    bits, meta = 0, None
    if level0 and br.read(1):
        bits = br.read(3) + 2
        img = _stream(br, _sub(xs, bits), _sub(ys, bits), False)
        meta = [(v >> 8) & 0xFFFF for v in img]
        ngroups = max(meta) + 1
    else:
        ngroups = 1
    if br.eos:
        raise _Bad("VP8L: end of data in the meta codes")
    used = set(meta) if meta is not None else {0}
    groups = {}
    for g in range(ngroups):
        codes = []
        for j in range(5):
            size = _ALPHABET[j] + ((1 << cache_bits) if j == 0 and cache_bits
                                   else 0)
            tab = _read_code(br, size)
            if tab is None:
                raise _Bad("VP8L: bad prefix code")
            codes.append(tab)
        if g in used:
            groups[g] = codes
    return bits, meta, groups


def _copy_value(sym, br):
    """GetCopyDistance / GetCopyLength: a prefix-coded LZ77 value."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _distance(xs, code):
    """PlaneCodeToDistance: the 120 short codes through the distance map."""
    if code > 120:
        return code - 120
    dc = _CODE_TO_PLANE[code - 1]
    dist = (dc >> 4) * xs + 8 - (dc & 15)
    return dist if dist >= 1 else 1


def _pixels(br, xs, ys, cache_bits, meta_bits, meta, groups, alpha8=False):
    """DecodeImageData (or DecodeAlphaData with `alpha8`): the entropy-coded
    ARGB pixels of an xs x ys image, as a list of ints."""
    n = xs * ys
    out = [0] * n
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    mw = _sub(xs, meta_bits) if meta is not None else 0
    pos = x = y = 0
    g0 = groups[0] if meta is None else None
    while pos < n:
        if alpha8 and br.eos:
            break
        g = g0 or groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
        br.fill()
        code = br.sym(g[0])
        if not alpha8 and br.at_end():
            break
        if code < 256:
            if alpha8:
                px = code << 8
            else:
                r = br.sym(g[1])
                br.fill()
                b = br.sym(g[2])
                a = br.sym(g[3])
                if br.at_end():
                    break
                px = a << 24 | r << 16 | code << 8 | b
            out[pos] = px
            if cache:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            pos += 1
            x += 1
            if x >= xs:
                x, y = 0, y + 1
        elif code < 280:
            length = _copy_value(code - 256, br)
            dsym = br.sym(g[4])
            br.fill()
            dist = _distance(xs, _copy_value(dsym, br))
            if not alpha8 and br.at_end():
                break
            if pos < dist or n - pos < length:
                raise _Bad("VP8L: backward reference out of the image")
            for k in range(pos, pos + length):
                px = out[k - dist]
                out[k] = px
                if cache:
                    cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            pos += length
            x += length
            while x >= xs:
                x, y = x - xs, y + 1
        elif cache is not None and code < 280 + len(cache):
            px = cache[code - 280]
            out[pos] = px
            cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            pos += 1
            x += 1
            if x >= xs:
                x, y = 0, y + 1
        else:
            raise _Bad("VP8L: bad symbol")
        if alpha8:
            br.eos = br.at_end()
    if alpha8:
        br.eos = br.at_end()
        if br.eos and pos < n:
            raise _Bad("VP8L: premature end of the alpha data")
    elif br.at_end():
        raise _Bad("VP8L: premature end of data")
    return out


def _stream(br, xs, ys, level0):
    """DecodeImageStream: a sub-image (level0 False) decoded to ARGB ints,
    or the main image's header (level0 True): (transforms, width after
    them, cache bits, meta bits, meta, groups)."""
    transforms, seen = [], set()
    if level0:
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise _Bad("VP8L: a transform twice")
            seen.add(kind)
            if kind in (_PRED, _CROSS):
                bits = br.read(3) + 2
                data = _stream(br, _sub(xs, bits), _sub(ys, bits), False)
                transforms.append((kind, xs, bits, data))
            elif kind == _INDEX:
                ncol = br.read(8) + 1
                bits = 0 if ncol > 16 else 1 if ncol > 4 else 2 if ncol > 2 \
                    else 3
                pal = _stream(br, ncol, 1, False)
                full = [0] * (1 << (8 >> bits))
                full[0] = pal[0]
                for i in range(1, ncol):          # deltas, byte by byte
                    p, q = pal[i], full[i - 1]
                    full[i] = (((p & 0xFF00FF00) + (q & 0xFF00FF00))
                               & 0xFF00FF00) | (((p & 0x00FF00FF)
                                                 + (q & 0x00FF00FF))
                                                & 0x00FF00FF)
                transforms.append((kind, xs, bits, full))
                xs = _sub(xs, bits)
            else:
                transforms.append((kind, xs, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _Bad("VP8L: bad colour cache size")
    meta_bits, meta, groups = _read_codes(br, xs, ys, cache_bits, level0)
    if level0:
        return transforms, xs, cache_bits, meta_bits, meta, groups
    data = _pixels(br, xs, ys, cache_bits, meta_bits, meta, groups)
    if br.eos:
        raise _Bad("VP8L: premature end of data")
    return data


def _add_px(a, b):
    """VP8LAddPixels on uint32 arrays or ints: bytewise sums."""
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _bytes4(v):
    return v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255


def _select(t, lf, tl):
    """libwebp's Select(T, L, TL): T where sum |L - TL| <= sum |T - TL|."""
    s = 0
    for a, b, c in zip(_bytes4(t), _bytes4(lf), _bytes4(tl)):
        s += abs(b - c) - abs(a - c)
    return t if s <= 0 else lf


def _clamp_full(a, b, c):
    out = 0
    for sh in (24, 16, 8, 0):
        v = ((a >> sh) & 255) + ((b >> sh) & 255) - ((c >> sh) & 255)
        out |= (0 if v < 0 else 255 if v > 255 else v) << sh
    return out


def _clamp_half(a, b):
    out = 0
    for sh in (24, 16, 8, 0):
        x, y = (a >> sh) & 255, (b >> sh) & 255
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))     # C's division
        out |= (0 if v < 0 else 255 if v > 255 else v) << sh
    return out


def _predict(mode, lf, t, tr, tl):
    if mode == 1:
        return lf
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(lf, tr), t)
    if mode == 6:
        return _avg2(lf, tl)
    if mode == 7:
        return _avg2(lf, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(lf, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, lf, tl)
    if mode == 12:
        return _clamp_full(lf, t, tl)
    if mode == 13:
        return _clamp_half(_avg2(lf, t), tl)
    return 0xFF000000                     # modes 0, 14 and 15: black


def _unpredict(img, xs, bits, data):
    """The predictor transform undone, row after row (the top-right of the
    last column is the row's own first pixel, as in libwebp)."""
    h = img.shape[0]
    o = img.reshape(-1).tolist()
    tw = _sub(xs, bits)
    modes = [(v >> 8) & 15 for v in data]
    o[0] = _add_px(o[0], 0xFF000000)
    for x in range(1, xs):
        o[x] = _add_px(o[x], o[x - 1])
    for y in range(1, h):
        i = y * xs
        o[i] = _add_px(o[i], o[i - xs])
        row = modes[(y >> bits) * tw:(y >> bits) * tw + tw]
        for x in range(1, xs):
            i += 1
            m = row[x >> bits]
            p = _predict(m, o[i - 1], o[i - xs], o[i - xs + 1],
                         o[i - xs - 1]) if m else 0xFF000000
            o[i] = _add_px(o[i], p)
    return np.array(o, np.uint32).reshape(h, xs)


def _tile_map(data, xs, h, bits):
    tw = _sub(xs, bits)
    d = np.asarray(data, np.uint32).reshape(-1, tw)
    return d[(np.arange(h) >> bits)[:, None], (np.arange(xs) >> bits)[None]]


def _inverse(t, img):
    """One transform undone on an (h, width) uint32 ARGB image."""
    kind, xs, bits, data = t
    h = img.shape[0]
    if kind == _GREEN:
        g = (img >> 8) & 0xFF
        return (img & 0xFF00FF00) | (((img & 0x00FF00FF) + (g << 16 | g))
                                     & 0x00FF00FF)
    if kind == _CROSS:
        m = _tile_map(data, xs, h, bits).astype(np.int64)
        i8 = lambda v: ((v & 255) ^ 128) - 128                # noqa: E731
        px = img.astype(np.int64)
        green = i8(px >> 8)
        red = (px >> 16) & 255
        red = (red + ((i8(m) * green) >> 5)) & 255
        blue = px & 255
        blue = blue + ((i8(m >> 8) * green) >> 5)
        blue = (blue + ((i8(m >> 16) * i8(red)) >> 5)) & 255
        return ((px & 0xFF00FF00) | red << 16 | blue).astype(np.uint32)
    if kind == _INDEX:
        pal = np.asarray(data, np.uint32)
        if bits == 0:
            return pal[(img >> 8) & 0xFF]
        per = 1 << bits
        bpp = 8 >> bits
        x = np.arange(xs)
        packed = (img[:, x >> bits] >> 8) & 0xFF
        idx = (packed >> ((x & (per - 1)) * bpp)) & ((1 << bpp) - 1)
        return pal[idx]
    return _unpredict(img, xs, bits, data)


def _single(tab):
    """Whether a prefix code has one symbol (reads no bits)."""
    return tab[0][0] >= 0 and tab[0][0] >> 16 == 0


def _vp8l_image(br, w, h, alpha=False) -> np.ndarray:
    """A VP8L image stream from its transforms on (the bit reader past the
    header) -> (h, w) uint32 ARGB. `alpha`: an ALPH stream, which libwebp
    decodes green-only (8 bits) where its only transform is colour indexing
    and R, B and A carry one symbol each; such a stream may end on its last
    pixel's final bit."""
    transforms, xs, cache_bits, meta_bits, meta, groups = _stream(br, w, h,
                                                                  True)
    alpha8 = (alpha and len(transforms) == 1 and transforms[0][0] == _INDEX
              and not cache_bits
              and all(_single(g[k]) for g in groups.values()
                      for k in (1, 2, 3)))
    data = _pixels(br, xs, h, cache_bits, meta_bits, meta, groups, alpha8)
    img = np.array(data, np.uint32).reshape(h, xs)
    for t in reversed(transforms):
        img = _inverse(t, img)
    return img


def _vp8l(d, start, end) -> np.ndarray:
    """A VP8L bitstream (its 5-byte header on) -> (h, w) uint32 ARGB."""
    br = _LBits(d, start, end)
    if br.read(8) != 0x2F:
        raise _Bad("VP8L: bad signature")
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)
    if br.read(3) or br.eos:
        raise _Bad("VP8L: bad header")
    return _vp8l_image(br, w, h)


# ----------------------------------------------------------------- VP8
# RFC 6386 keyframes, read as libwebp's vp8_dec.c / tree_dec.c /
# quant_dec.c / frame_dec.c read them.

class _Bool:
    """libwebp's boolean decoder (RFC 6386, section 7): `eof` is set by the
    first read that needs a byte past the partition's end."""
    __slots__ = ("b", "pos", "end", "value", "range", "bits", "eof")

    def __init__(self, d, start, size):
        self.b, self.pos, self.end = d, start, start + size
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos < self.end:
            self.value = self.value << 8 | self.b[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob):
        bits = self.bits
        if bits < 0:
            self._load()
            bits = self.bits
        split = (self.range * prob) >> 8
        if (self.value >> bits) > split:
            r = self.range - split
            self.value -= (split + 1) << bits
            shift = _NORM[r]
            self.range = (r << shift) - 1
            self.bits = bits - shift
            return 1
        r = split + 1
        shift = _NORM[r]
        self.range = (r << shift) - 1
        self.bits = bits - shift
        return 0

    def value_of(self, n):
        v = 0
        while n:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed(self, n):
        v = self.value_of(n)
        return -v if self.bit(0x80) else v


_NORM = bytes([0] + [8 - r.bit_length() for r in range(1, 256)])
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's intra modes: B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED (also
# the 16x16 and chroma DC, TM, V, H), B_RD_PRED, B_VR_PRED, B_LD_PRED,
# B_VL_PRED, B_HD_PRED, B_HU_PRED
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)


def _large(br, p):
    """GetLargeValue: a coefficient's magnitude above 1."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    b1 = br.bit(p[8])
    cat = 2 * b1 + br.bit(p[9 + b1])
    v = 0
    for q in _CAT[cat]:
        v = v + v + br.bit(q)
    return v + 3 + (8 << cat)


def _coeffs(br, prob, ctx, dq, n, out, base):
    """GetCoeffs: one block's tokens into out[base:base + 16] (raster
    order, dequantized, int16); returns the position after the last. The
    boolean decoder's reads of the token tree's first three nodes and of
    the sign are written out here (`_Bool.bit`'s arithmetic), being most
    of a lossy file's reads."""
    value, rng, bits = br.value, br.range, br.bits
    norm = _NORM
    p = prob[n][ctx]
    while n < 16:
        # bit(p[0]): more tokens?
        if bits < 0:
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = (rng * p[0]) >> 8
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
        else:
            rng = split + 1
            sh = norm[rng]
            br.value, br.range, br.bits = value, (rng << sh) - 1, bits - sh
            return n
        sh = norm[rng]
        rng = (rng << sh) - 1
        bits -= sh
        while True:                      # bit(p[1]): a non-zero token?
            if bits < 0:
                br.value, br.bits = value, bits
                br._load()
                value, bits = br.value, br.bits
            split = (rng * p[1]) >> 8
            if (value >> bits) > split:
                rng -= split
                value -= (split + 1) << bits
                sh = norm[rng]
                rng = (rng << sh) - 1
                bits -= sh
                break
            rng = split + 1
            sh = norm[rng]
            rng = (rng << sh) - 1
            bits -= sh
            n += 1
            p = prob[n][0]
            if n == 16:
                br.value, br.range, br.bits = value, rng, bits
                return 16
        pc = prob[n + 1]
        if bits < 0:                     # bit(p[2]): one, or larger?
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = (rng * p[2]) >> 8
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
            sh = norm[rng]
            br.value, br.range, br.bits = value, (rng << sh) - 1, bits - sh
            v, p = _large(br, p), pc[2]
            value, rng, bits = br.value, br.range, br.bits
        else:
            rng = split + 1
            sh = norm[rng]
            rng = (rng << sh) - 1
            bits -= sh
            v, p = 1, pc[1]
        if bits < 0:                     # the sign: bit(0x80)
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = (rng * 0x80) >> 8
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
            v = -v
        else:
            rng = split + 1
        sh = norm[rng]
        rng = (rng << sh) - 1
        bits -= sh
        out[base + _ZIGZAG[n]] = ((v * dq[n > 0] + 32768) & 0xFFFF) - 32768
        n += 1
    br.value, br.range, br.bits = value, rng, bits
    return 16


def _wht(dc):
    """TransformWHT: the Y2 block -> the 16 luma DCs (int16)."""
    t = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        t[i], t[8 + i] = a0 + a1, a0 - a1
        t[4 + i], t[12 + i] = a3 + a2, a3 - a2
    out = []
    for i in range(4):
        dc0 = t[4 * i] + 3
        a0, a1 = dc0 + t[4 * i + 3], t[4 * i + 1] + t[4 * i + 2]
        a2, a3 = t[4 * i + 1] - t[4 * i + 2], dc0 - t[4 * i + 3]
        out += [(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
                (a3 - a2) >> 3]
    # out[4 i + j] is the DC of block 4 i + j
    return [((v + 32768) & 0xFFFF) - 32768 for v in out]


def _nz_code(nz, dc_nz):
    return 3 if nz > 3 else 2 if nz > 1 else dc_nz


def _idct(coeffs: np.ndarray, sse2: np.ndarray) -> np.ndarray:
    """The IDCT of (n, 16) int16 blocks -> (n, 4, 4) residuals (the values
    added to the prediction before clipping), as libwebp on x86 computes
    them: TransformOne in 32-bit ints (its C TransformDC / TransformAC3),
    or, where `sse2`, its SSE2 Transform, whose sums wrap at 16 bits (the
    two differ only for coefficients no encoder writes)."""
    c = coeffs.astype(np.int32).reshape(-1, 4, 4)      # [block, row, col]
    out = np.empty_like(c)
    w16 = lambda a: ((a + 32768) & 0xFFFF) - 32768      # noqa: E731
    hi = lambda a, k: (a * k) >> 16                     # noqa: E731
    for wrap, sel in ((False, ~sse2), (True, sse2)):
        if not sel.any():
            continue
        w = w16 if wrap else (lambda a: a)               # noqa: E731
        x = c[sel]
        rows = [x[:, 0], x[:, 1], x[:, 2], x[:, 3]]      # per column

        def one_pass(r0, r1, r2, r3, dc_add):
            a = w(w(r0 + dc_add) + r2) if dc_add else w(r0 + r2)
            b = w(w(r0 + dc_add) - r2) if dc_add else w(r0 - r2)
            if wrap:
                cc = w(w(r1 - r3) + w(hi(r1, -30068) - hi(r3, 20091)))
                dd = w(w(r1 + r3) + w(hi(r1, 20091) + hi(r3, -30068)))
            else:
                cc = (hi(r1, 35468)) - (hi(r3, 20091) + r3)
                dd = (hi(r1, 20091) + r1) + hi(r3, 35468)
            return w(a + dd), w(b + cc), w(b - cc), w(a - dd)
        tmp = np.stack(one_pass(*rows, 0), axis=1)         # [blk, k, col]
        t = [tmp[..., 0], tmp[..., 1], tmp[..., 2], tmp[..., 3]]
        res = one_pass(*t, 4)                               # [blk, out row]
        out[sel] = np.stack(res, axis=2) >> 3
    return out


class _Frame:
    pass


def _parse_header(d, start, end):
    """VP8GetHeaders: the frame header and partition 0's global part."""
    f = _Frame()
    n = end - start
    if n < 4:
        raise _Bad("VP8: truncated header")
    bits = d[start] | d[start + 1] << 8 | d[start + 2] << 16
    if (bits >> 1) & 7 > 3:
        raise _Bad("VP8: incorrect keyframe parameters")
    if not (bits >> 4) & 1:
        raise _Bad("VP8: frame not displayable")
    plen = bits >> 5
    key = not bits & 1
    pos, n = start + 3, n - 3
    if key:
        if n < 7:
            raise _Bad("VP8: cannot parse picture header")
        if d[pos:pos + 3] != b"\x9d\x01\x2a":
            raise _Bad("VP8: bad code word")
        f.w = (d[pos + 4] << 8 | d[pos + 3]) & 0x3FFF
        f.h = (d[pos + 6] << 8 | d[pos + 5]) & 0x3FFF
        pos, n = pos + 7, n - 7
    if plen > n:
        raise _Bad("VP8: bad partition length")
    br = _Bool(d, pos, plen)
    pos, n = pos + plen, n - plen
    if key:
        br.bit(0x80)
        br.bit(0x80)                 # colour space and clamping: ignored
    # ParseSegmentHeader
    f.use_segment = br.bit(0x80)
    f.update_map, f.absolute = 0, 1
    f.quant, f.fstrength, f.seg_probs = [0] * 4, [0] * 4, [255] * 3
    if f.use_segment:
        f.update_map = br.bit(0x80)
        if br.bit(0x80):
            f.absolute = br.bit(0x80)
            f.quant = [br.signed(7) if br.bit(0x80) else 0 for _ in range(4)]
            f.fstrength = [br.signed(6) if br.bit(0x80) else 0
                           for _ in range(4)]
        if f.update_map:
            f.seg_probs = [br.value_of(8) if br.bit(0x80) else 255
                           for _ in range(3)]
    if br.eof:
        raise _Bad("VP8: cannot parse segment header")
    # ParseFilterHeader
    f.simple = br.bit(0x80)
    f.level = br.value_of(6)
    f.sharpness = br.value_of(3)
    f.use_lf_delta = br.bit(0x80)
    f.ref_delta, f.mode_delta = [0] * 4, [0] * 4
    if f.use_lf_delta and br.bit(0x80):
        for i in range(4):
            if br.bit(0x80):
                f.ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(0x80):
                f.mode_delta[i] = br.signed(6)
    f.filter_type = 0 if f.level == 0 else 1 if f.simple else 2
    if br.eof:
        raise _Bad("VP8: cannot parse filter header")
    # ParsePartitions: the last partition runs to the end of the data
    last = (1 << br.value_of(2)) - 1
    if n < 3 * last:
        raise _Bad("VP8: cannot parse partitions")
    part, left = pos + 3 * last, n - 3 * last
    f.parts = []
    for p in range(last):
        ps = _le24(d, pos + 3 * p)
        ps = min(ps, left)
        f.parts.append(_Bool(d, part, ps))
        part, left = part + ps, left - ps
    f.parts.append(_Bool(d, part, left))
    if part >= end:
        raise _Bad("VP8: cannot parse partitions")
    # VP8ParseQuant
    base = br.value_of(7)
    dlt = [br.signed(4) if br.bit(0x80) else 0 for _ in range(5)]
    clip = lambda v, m: 0 if v < 0 else m if v > m else v      # noqa: E731
    f.dqm = []
    for s in range(4):
        if f.use_segment:
            q = f.quant[s] + (0 if f.absolute else base)
        elif s > 0:
            f.dqm.append(f.dqm[0])
            continue
        else:
            q = base
        y2ac = (_AC_TABLE[clip(q + dlt[2], 127)] * 101581) >> 16
        f.dqm.append((
            (_DC_TABLE[clip(q + dlt[0], 127)], _AC_TABLE[clip(q, 127)]),
            (_DC_TABLE[clip(q + dlt[1], 127)] * 2, max(y2ac, 8)),
            (_DC_TABLE[clip(q + dlt[3], 117)], _AC_TABLE[clip(q + dlt[4],
                                                               127)])))
    if not key:
        raise _Bad("VP8: not a key frame")
    br.bit(0x80)                     # update_proba: ignored
    # VP8ParseProba
    bands = []
    for t in range(4):
        tb = []
        for b in range(8):
            tc = []
            for c in range(3):
                i = ((t * 8 + b) * 3 + c) * 11
                tc.append([br.value_of(8)
                           if br.bit(_COEFFS_UPDATE_PROBA[i + p])
                           else _COEFFS_PROBA0[i + p] for p in range(11)])
            tb.append(tc)
        bands.append([tb[_BANDS[k]] for k in range(17)])
    f.bands = bands
    f.use_skip = br.bit(0x80)
    f.skip_p = br.value_of(8) if f.use_skip else 0
    f.br = br
    return f


def _parse_modes(f, mb_w, intra_t):
    """ParseIntraMode for one macroblock row from partition 0."""
    br, row = f.br, []
    intra_l = [_DC] * 4
    for mx in range(mb_w):
        m = _Frame()
        if f.update_map:
            p = f.seg_probs
            m.segment = (br.bit(p[1]) if not br.bit(p[0])
                         else br.bit(p[2]) + 2)
        else:
            m.segment = 0
        m.skip = br.bit(f.skip_p) if f.use_skip else 0
        m.i4 = not br.bit(145)
        top = intra_t[4 * mx:4 * mx + 4]
        if not m.i4:
            ym = ((_TM if br.bit(128) else _HE) if br.bit(156)
                  else (_VE if br.bit(163) else _DC))
            m.modes = [ym]
            top = [ym] * 4
            intra_l = [ym] * 4
        else:
            modes = []
            for y in range(4):
                ym = intra_l[y]
                for x in range(4):
                    base = (top[x] * 10 + ym) * 9
                    i = _YMODES_INTRA4[br.bit(_BMODES_PROBA[base])]
                    while i > 0:
                        i = _YMODES_INTRA4[2 * i
                                           + br.bit(_BMODES_PROBA[base + i])]
                    ym = -i
                    top[x] = ym
                modes += top
                intra_l[y] = ym
            m.modes = modes
        intra_t[4 * mx:4 * mx + 4] = top
        m.uvmode = (_DC if not br.bit(142) else _VE if not br.bit(114)
                    else _TM if br.bit(183) else _HE)
        row.append(m)
    return row


def _residuals(f, m, tnz, lnz, br):
    """ParseResiduals: a macroblock's coefficients -> (384 int16 list,
    non_zero_y, non_zero_uv); tnz / lnz are the [nz, nz_dc] contexts of the
    macroblock above and to the left, updated in place."""
    out = [0] * 384
    y1, y2, uv = f.dqm[m.segment]
    bands = f.bands
    if not m.i4:
        dc = [0] * 16
        nz = _coeffs(br, bands[1], tnz[1] + lnz[1], y2, 0, dc, 0)
        tnz[1] = lnz[1] = int(nz > 0)
        if nz > 1:
            dcs = _wht(dc)
        else:
            dcs = [(dc[0] + 3) >> 3] * 16
        for i in range(16):
            out[16 * i] = dcs[i]
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    t, lf = tnz[0] & 0x0F, lnz[0] & 0x0F
    nzy = 0
    for y in range(4):
        lbit = lf & 1
        codes = 0
        for x in range(4):
            blk = 4 * y + x
            nz = _coeffs(br, ac, lbit + (t & 1), y1, first, out, 16 * blk)
            lbit = int(nz > first)
            t = (t >> 1) | (lbit << 7)
            codes = codes << 2 | _nz_code(nz, out[16 * blk] != 0)
        t >>= 4
        lf = (lf >> 1) | (lbit << 7)
        nzy = nzy << 8 | codes
    out_t, out_l = t, lf >> 4
    nzuv = 0
    for ch in (0, 2):
        codes = 0
        t, lf = tnz[0] >> (4 + ch), lnz[0] >> (4 + ch)
        for y in range(2):
            lbit = lf & 1
            for x in range(2):
                blk = 16 + 2 * ch + 2 * y + x
                nz = _coeffs(br, bands[2], lbit + (t & 1), uv, 0, out,
                             16 * blk)
                lbit = int(nz > 0)
                t = (t >> 1) | (lbit << 3)
                codes = codes << 2 | _nz_code(nz, out[16 * blk] != 0)
            t >>= 2
            lf = (lf >> 1) | (lbit << 5)
        nzuv |= codes << (4 * ch)
        out_t |= (t << 4) << ch
        out_l |= (lf & 0xF0) << ch
    tnz[0], lnz[0] = out_t, out_l
    return out, nzy, nzuv


def _filter_strengths(f):
    """PrecomputeFilterStrengths: [segment][i4] -> (limit, ilevel, hev)."""
    out = []
    for s in range(4):
        if f.use_segment:
            base = f.fstrength[s] + (0 if f.absolute else f.level)
        else:
            base = f.level
        per = []
        for i4 in (0, 1):
            level = base
            if f.use_lf_delta:
                level += f.ref_delta[0] + (f.mode_delta[0] if i4 else 0)
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                il = level
                if f.sharpness > 0:
                    il >>= 2 if f.sharpness > 4 else 1
                    il = min(il, 9 - f.sharpness)
                il = max(il, 1)
                per.append((2 * level + il, il,
                            2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                per.append((0, 0, 0))
        out.append(per)
    return out


def _pred4(ws, by, bx, mode):
    """One 4x4 luma prediction (libwebp's VP8PredLuma4) from the work rows
    `ws` (row 0 is the row above the macroblock, column 0 the column to its
    left, columns 17-20 of rows 0, 4, 8, 12 the top-right samples)."""
    r0, c0 = by, bx                      # ws[r0] is the row above the block
    top = ws[r0][c0:c0 + 9]              # X, A .. H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (ws[r0 + 1][c0], ws[r0 + 2][c0], ws[r0 + 3][c0],
                  ws[r0 + 4][c0])
    a3 = lambda a, b, c: (a + 2 * b + c + 2) >> 2          # noqa: E731
    a2 = lambda a, b: (a + b + 1) >> 1                     # noqa: E731
    if mode == _DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == _TM:
        cl = lambda v: 0 if v < 0 else 255 if v > 255 else v   # noqa: E731
        return [[cl(t + lf - X) for t in (A, B, C, D)] for lf in (I, J, K, L)]
    if mode == _VE:
        row = [a3(X, A, B), a3(A, B, C), a3(B, C, D), a3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == _HE:
        return [[a3(X, I, J)] * 4, [a3(I, J, K)] * 4, [a3(J, K, L)] * 4,
                [a3(K, L, L)] * 4]
    o = [[0] * 4 for _ in range(4)]

    def put(v, *xy):
        for x, y in xy:
            o[y][x] = v
    if mode == _RD:
        put(a3(J, K, L), (0, 3))
        put(a3(I, J, K), (1, 3), (0, 2))
        put(a3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(a3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(a3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(a3(C, B, A), (3, 1), (2, 0))
        put(a3(D, C, B), (3, 0))
    elif mode == _LD:
        put(a3(A, B, C), (0, 0))
        put(a3(B, C, D), (1, 0), (0, 1))
        put(a3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(a3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(a3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(a3(F, G, H), (3, 2), (2, 3))
        put(a3(G, H, H), (3, 3))
    elif mode == _VR:
        put(a2(X, A), (0, 0), (1, 2))
        put(a2(A, B), (1, 0), (2, 2))
        put(a2(B, C), (2, 0), (3, 2))
        put(a2(C, D), (3, 0))
        put(a3(K, J, I), (0, 3))
        put(a3(J, I, X), (0, 2))
        put(a3(I, X, A), (0, 1), (1, 3))
        put(a3(X, A, B), (1, 1), (2, 3))
        put(a3(A, B, C), (2, 1), (3, 3))
        put(a3(B, C, D), (3, 1))
    elif mode == _VL:
        put(a2(A, B), (0, 0))
        put(a2(B, C), (1, 0), (0, 2))
        put(a2(C, D), (2, 0), (1, 2))
        put(a2(D, E), (3, 0), (2, 2))
        put(a3(A, B, C), (0, 1))
        put(a3(B, C, D), (1, 1), (0, 3))
        put(a3(C, D, E), (2, 1), (1, 3))
        put(a3(D, E, F), (3, 1), (2, 3))
        put(a3(E, F, G), (3, 2))
        put(a3(F, G, H), (3, 3))
    elif mode == _HU:
        put(a2(I, J), (0, 0))
        put(a2(J, K), (2, 0), (0, 1))
        put(a2(K, L), (2, 1), (0, 2))
        put(a3(I, J, K), (1, 0))
        put(a3(J, K, L), (3, 0), (1, 1))
        put(a3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    else:                                 # _HD
        put(a2(I, X), (0, 0), (2, 1))
        put(a2(J, I), (0, 1), (2, 2))
        put(a2(K, J), (0, 2), (2, 3))
        put(a2(L, K), (0, 3))
        put(a3(A, B, C), (3, 0))
        put(a3(X, A, B), (2, 0))
        put(a3(I, X, A), (1, 0), (3, 1))
        put(a3(J, I, X), (1, 1), (3, 2))
        put(a3(K, J, I), (1, 2), (3, 3))
        put(a3(L, K, J), (1, 3))
    return o


def _pred_block(w, mode, size, mb_x, mb_y):
    """A 16x16 luma or 8x8 chroma prediction from the work array `w`
    (row 0 above, column 0 left), the DC variants at the frame's edges
    (libwebp's CheckMode)."""
    top = w[0, 1:size + 1].astype(np.int32)
    left = w[1:size + 1, 0].astype(np.int32)
    sh = 4 if size == 16 else 3
    if mode == _DC:
        if mb_x and mb_y:
            v = (int(top.sum()) + int(left.sum()) + size) >> (sh + 1)
        elif mb_x:                        # the first row: no top
            v = (int(left.sum()) + size // 2) >> sh
        elif mb_y:                        # the first column: no left
            v = (int(top.sum()) + size // 2) >> sh
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == _TM:
        return np.clip(top[None] + left[:, None] - int(w[0, 0]), 0, 255)
    if mode == _VE:
        return np.repeat(top[None], size, 0)
    return np.repeat(left[:, None], size, 1)


def _edges(plane, y0, x0, size, mb_x, mb_y, mb_w, extra=0):
    """The work array of one macroblock's plane: row 0 the samples above
    (127 on the first row; the top-left 129 on the first column below it),
    column 0 those to the left (129 on the first column); with `extra`, the
    4 top-right samples (the last above sample repeated on the last
    column)."""
    w = np.zeros((size + 1, size + 1 + extra), np.int32)
    if mb_y == 0:
        w[0] = 127
    else:
        w[0, 0] = 129 if mb_x == 0 else plane[y0 - 1, x0 - 1]
        w[0, 1:size + 1] = plane[y0 - 1, x0:x0 + size]
        if extra:
            w[0, size + 1:] = (plane[y0 - 1, x0 + size - 1]
                               if mb_x == mb_w - 1
                               else plane[y0 - 1, x0 + size:x0 + size + 4])
    w[1:, 0] = 129 if mb_x == 0 else plane[y0:y0 + size, x0 - 1]
    return w


_KSCAN = [(4 * (n >> 2), 4 * (n & 3)) for n in range(16)]


def _reconstruct(f, mbs, res, mb_w, mb_h):
    """ReconstructRow over the frame: unfiltered Y, U, V planes."""
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    k = 0
    for my in range(mb_h):
        for mx in range(mb_w):
            m, r = mbs[k], res[k]
            k += 1
            y0, x0 = 16 * my, 16 * mx
            ry = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(
                16, 16)
            if m.i4:
                w = _edges(Y, y0, x0, 16, mx, my, mb_w, extra=4)
                for rr in (4, 8, 12):
                    w[rr, 17:21] = w[0, 17:21]
                ws = w.tolist()
                for n in range(16):
                    by, bx = _KSCAN[n]
                    p = _pred4(ws, by, bx, m.modes[n])
                    for i in range(4):
                        row = ws[by + 1 + i]
                        for j in range(4):
                            v = p[i][j] + int(ry[by + i, bx + j])
                            row[bx + 1 + j] = 0 if v < 0 else 255 if v > 255 \
                                else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.array(ws)[1:17, 1:17]
            else:
                w = _edges(Y, y0, x0, 16, mx, my, mb_w)
                p = _pred_block(w, m.modes[0], 16, mx, my)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(p + ry, 0, 255)
            for ci, P in ((0, U), (1, V)):
                rc = r[16 + 4 * ci:20 + 4 * ci].reshape(2, 2, 4, 4).transpose(
                    0, 2, 1, 3).reshape(8, 8)
                w = _edges(P, y0 // 2, x0 // 2, 8, mx, my, mb_w)
                p = _pred_block(w, m.uvmode, 8, mx, my)
                P[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.clip(
                    p + rc, 0, 255)
    return Y, U, V


def _filter(c, kind, thresh, ithresh=0, hev_t=0):
    """libwebp's edge filters on an (n, 8) int32 array: columns p3 p2 p1 p0
    q0 q1 q2 q3 across the edge, one row a position, the thresholds one a
    position (or one for all); returns the filtered array. kind: "simple",
    "mb" (6 taps where not high edge variance) or "inner" (4 taps)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = c.T
    m = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    if not m.any():
        return c
    lo, hi_ = np.maximum, np.minimum
    if kind == "simple":
        two, rest = m, None
    else:
        it = ithresh
        m &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it)
              & (np.abs(p1 - p0) <= it) & (np.abs(q3 - q2) <= it)
              & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
        if not m.any():
            return c
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        two, rest = m & hev, m & ~hev
    out = c.copy()
    if two.any():                                          # DoFilter2
        a = 3 * (q0 - p0) + lo(hi_(p1 - q1, 127), -128)
        a1 = lo(hi_((a + 4) >> 3, 15), -16)
        a2 = lo(hi_((a + 3) >> 3, 15), -16)
        out[two, 3] = lo(hi_(p0 + a2, 255), 0)[two]
        out[two, 4] = lo(hi_(q0 - a1, 255), 0)[two]
    if rest is not None and rest.any():
        if kind == "inner":                                # DoFilter4
            a = 3 * (q0 - p0)
            a1 = lo(hi_((a + 4) >> 3, 15), -16)
            a2 = lo(hi_((a + 3) >> 3, 15), -16)
            a3 = (a1 + 1) >> 1
            upd = ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3))
        else:                                              # DoFilter6
            a = lo(hi_(3 * (q0 - p0) + lo(hi_(p1 - q1, 127), -128), 127),
                   -128)
            a1, a2 = (27 * a + 63) >> 7, (18 * a + 63) >> 7
            a3 = (9 * a + 63) >> 7
            upd = ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1),
                   (5, q1 - a2), (6, q2 - a3))
        for col, v in upd:
            out[rest, col] = lo(hi_(v, 255), 0)[rest]
    return out


def _edge_index(ys, xs, size, e, across_cols):
    """The (rows, cols) index arrays of one edge of each macroblock at
    (ys, xs) (macroblock units) of a plane of `size`-pixel macroblocks:
    the vertical edge at column offset e (filtered across columns) or the
    horizontal one at row offset e, as (n, size, 8) with the 8 pixels
    across the edge last."""
    k = np.arange(size)
    t = np.arange(-4, 4)
    if across_cols:
        r = (ys * size)[:, None, None] + k[None, :, None]
        c = (xs * size + e)[:, None, None] + t[None, None, :]
        return np.broadcast_arrays(r, c)
    r = (ys * size + e)[:, None, None] + t[None, None, :]
    c = (xs * size)[:, None, None] + k[None, :, None]
    return np.broadcast_arrays(r, c)


def _loop_filter(f, mbs, Y, U, V, mb_w, mb_h):
    """DoFilter over the frame: each macroblock's left edge, inner vertical
    edges, top edge and inner horizontal edges, in that order. A
    macroblock needs only its left neighbour and the one above its right
    neighbour done, so the macroblocks of one wave x + 2 y are filtered
    together (luma and chroma edges of one step in one call), which gives
    libwebp's raster order's pixels."""
    fs = _filter_strengths(f)
    info = np.array([fs[m.segment][int(m.i4)] + (int(m.i4 or m.inner),)
                     for m in mbs], np.int32).reshape(mb_h, mb_w, 4)
    my, mx = np.mgrid[:mb_h, :mb_w]
    wave = mx + 2 * my
    simple = f.filter_type == 1
    planes = ((Y, 16),) if simple else ((Y, 16), (U, 8), (V, 8))
    for t in range(int(wave.max()) + 1):
        on = (wave == t) & (info[..., 0] > 0)
        if not on.any():
            continue
        for across, edge_of in ((True, mx), (False, my)):
            for sel, offsets, kind in ((on & (edge_of > 0), (0,), "mb"),
                                       (on & (info[..., 3] > 0), (4, 8, 12),
                                        "inner")):
                if not sel.any():
                    continue
                ys, xs = my[sel], mx[sel]
                lim, il, hv = (info[..., i][sel] for i in range(3))
                lim = lim + 4 if kind == "mb" else lim
                for e in offsets:
                    # chroma's one inner edge (4) goes with luma's middle one
                    parts = [(P, _edge_index(ys, xs, size, o, across), size)
                             for P, size in planes
                             for o in ((e,) if size == 16 else
                                       {0: (0,), 8: (4,)}.get(e, ()))]
                    segs = [P[r, c].reshape(-1, 8) for P, (r, c), _ in parts]
                    thr = [np.concatenate([np.repeat(a, size)
                                           for _, _, size in parts])
                           for a in ((lim,) if simple else (lim, il, hv))]
                    out = _filter(np.concatenate(segs).astype(np.int32),
                                  "simple" if simple else kind, *thr)
                    at = 0
                    for P, (r, c), _ in parts:
                        n = r.size // 8
                        P[r, c] = out[at:at + n].reshape(r.shape)
                        at += n


def _vp8(d, start, end):
    """A VP8 keyframe (from its frame tag to the end of the data, as
    libwebp reads it) -> (w, h, Y, U, V) cropped planes."""
    f = _parse_header(d, start, end)
    w, h = f.w, f.h
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    intra_t = [_DC] * (4 * mb_w)
    top_nz = [[0, 0] for _ in range(mb_w)]
    mbs, res, sse2 = [], [], []
    for my in range(mb_h):
        row = _parse_modes(f, mb_w, intra_t)
        if f.br.eof:
            raise _Bad("VP8: premature end-of-partition0 encountered")
        tb = f.parts[my & (len(f.parts) - 1)]
        left = [0, 0]
        for mx, m in enumerate(row):
            skip = m.skip if f.use_skip else 0
            if not skip:
                coef, nzy, nzuv = _residuals(f, m, top_nz[mx], left, tb)
                skip = not (nzy | nzuv)
                # DoTransform / DoUVTransform: the SSE2 transform for a
                # luma block of more than 3 coefficients, and for all four
                # blocks of a chroma plane with any AC coefficient
                sse2.append([(nzy >> (30 - 2 * b)) & 3 == 3
                             for b in range(16)]
                            + [bool(nzuv & 0xAA)] * 4
                            + [bool((nzuv >> 8) & 0xAA)] * 4)
            else:
                sse2.append([False] * 24)
                coef = [0] * 384
                top_nz[mx][0] = left[0] = 0
                if not m.i4:
                    top_nz[mx][1] = left[1] = 0
            m.inner = not skip
            if tb.eof:
                raise _Bad("VP8: premature end-of-file encountered")
            mbs.append(m)
            res.append(coef)
    r = _idct(np.asarray(res, np.int16).reshape(-1, 16),
              np.asarray(sse2, bool).reshape(-1)).reshape(len(res), 24, 4, 4)
    Y, U, V = _reconstruct(f, mbs, r, mb_w, mb_h)
    if f.filter_type:
        _loop_filter(f, mbs, Y, U, V, mb_w, mb_h)
    uw, uh = (w + 1) >> 1, (h + 1) >> 1
    return w, h, Y[:h, :w], U[:uh, :uw], V[:uh, :uw]


# ------------------------------------------------------- alpha and YUV

def _unfilter(a: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha unfilters: 1 horizontal, 2 vertical, 3 gradient
    (each row but the first predicted from the one above; the first row,
    and each row's first pixel in the horizontal filter, from the left)."""
    if filt == 0:
        return a
    h, w = a.shape
    o = a.astype(np.int64)
    o[0] = np.cumsum(o[0]) & 255
    if filt == 1:
        for y in range(1, h):
            o[y, 0] = (o[y, 0] + o[y - 1, 0]) & 255
            o[y] = np.cumsum(o[y]) & 255
    elif filt == 2:
        o = np.cumsum(o, axis=0) & 255
    else:
        rows = o.tolist()
        for y in range(1, h):
            prev, cur = rows[y - 1], rows[y]
            left = tl = prev[0]
            for i in range(w):
                top = prev[i]
                g = left + top - tl
                left = (cur[i] + (0 if g < 0 else 255 if g > 255 else g)) & 255
                tl = top
                cur[i] = left
        o = np.array(rows, np.int64)
    return o.astype(np.uint8)


def _alpha(d, off, size, w, h) -> np.ndarray:
    """The ALPH chunk's payload -> the (h, w) alpha plane."""
    if size <= 1:
        raise _Bad("ALPH: empty")
    hdr = d[off]
    method, filt, pre = hdr & 3, (hdr >> 2) & 3, (hdr >> 4) & 3
    if method > 1 or pre > 1 or hdr >> 6:
        raise _Bad("ALPH: bad header")
    if method == 0:
        if size - 1 < w * h:
            raise _Bad("ALPH: short raw plane")
        a = np.frombuffer(d, np.uint8, w * h, off + 1).reshape(h, w)
    else:
        img = _vp8l_image(_LBits(d, off + 1, off + size), w, h, alpha=True)
        a = ((img >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(a, filt)


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler: a ((h+1)/2, (w+1)/2) chroma plane -> (h,
    w), each sample (9 near + 3 + 3 + 1 far) / 16 with libwebp's rounding,
    the first and last rows and columns from the nearer samples alone."""
    c = c.astype(np.int32)
    uh, uw = c.shape
    y = np.arange(h)
    near = y >> 1
    far = np.where(y & 1, np.minimum(near + 1, uh - 1),
                   np.maximum(near - 1, 0))
    N, F = c[near], c[far]
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    k = np.arange(1, ((w - 1) >> 1) + 1)
    if k.size:
        nl, nr, fl, fr = N[:, k - 1], N[:, k], F[:, k - 1], F[:, k]
        avg = nl + nr + fl + fr + 8
        out[:, 2 * k - 1] = (((avg + 2 * (nr + fl)) >> 3) + nl) >> 1
        out[:, 2 * k] = (((avg + 2 * (nl + fr)) >> 3) + nr) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * N[:, uw - 1] + F[:, uw - 1] + 2) >> 2
    return out


def _yuv_to_bgr(Y, U, V) -> np.ndarray:
    """VP8YUVToB / G / R (14-bit fixed point) after the upsampler ->
    (h, w, 3) B G R."""
    h, w = Y.shape
    u, v = _upsample(U, h, w), _upsample(V, h, w)
    y = (Y.astype(np.int32) * 19077) >> 8
    hi = lambda a, k: (a * k) >> 8                              # noqa: E731

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))
    b = clip8(y + hi(u, 33050) - 17685)
    g = clip8(y - hi(u, 6419) - hi(v, 13320) + 8708)
    r = clip8(y + hi(v, 26149) - 14234)
    return np.stack([b, g, r], -1).astype(np.uint8)


def _decode(data: bytes, name: str) -> np.ndarray:
    """cv2's `imread(IMREAD_UNCHANGED)` of a WebP file: (h, w, 3) B G R or
    (h, w, 4) B G R A."""
    hd = _cv2_headers(data, name)
    w, h = hd["w"], hd["h"]
    try:
        if hd["lossless"]:
            argb = _vp8l(data, hd["pos"], len(data))
            bgra = np.ascontiguousarray(argb, "<u4").view(np.uint8).reshape(
                h, w, 4)
        else:
            fw, fh, Y, U, V = _vp8(data, hd["pos"], len(data))
            alpha = (_alpha(data, *hd["alph"], fw, fh)
                     if hd["alph"] is not None else None)
            bgr = _yuv_to_bgr(Y, U, V)
            if hd["channels"] == 3:
                return bgr
            bgra = np.concatenate([bgr, (alpha if alpha is not None else
                                         np.full((h, w), 255, np.uint8))
                                   [..., None]], -1)
    except _Bad as e:
        raise ValueError(f"{name}: {e}") from None
    return np.ascontiguousarray(bgra[..., :hd["channels"]])


def read_webp(path: str | Path) -> np.ndarray:
    """A WebP file -> what the JAX package's `_read_image` returns for it
    through cv2 (module doc): (H, W, 3) RGB or (H, W, 4) A R G B."""
    return np.ascontiguousarray(
        _decode(Path(path).read_bytes(), str(path))[..., ::-1])


def read_webp_rgb(path: str | Path) -> np.ndarray:
    """A WebP file as PIL's `convert("RGB")` gives it: (H, W, 3) RGB, alpha
    dropped; raises where PIL's open fails."""
    data = Path(path).read_bytes()
    _pil_open(data, str(path))
    return np.ascontiguousarray(_decode(data, str(path))[..., 2::-1])


def _pil_open(data: bytes, name: str) -> tuple[int, int]:
    """PIL's open: its signature test, WebPAnimDecoderNew's WebPGetFeatures
    over the whole file and its demuxer, and the decompression bomb."""
    if data[12:16] not in (b"VP8 ", b"VP8L", b"VP8X"):
        raise ValueError(f"{name}: not a WebP file PIL identifies")
    try:
        _headers(data, len(data), full=False)
    except _Status as e:
        raise ValueError(f"{name}: broken WebP file ({e}; PIL does not open "
                         "it)") from None
    w, h = _demux(data, name)
    pil_bomb(w, h, name)
    return w, h


def webp_size(path: str | Path) -> tuple[int, int]:
    """(width, height) as PIL's `Image.size` (the canvas)."""
    return _pil_open(Path(path).read_bytes(), str(path))


def verify_webp(path: str | Path) -> None:
    """Raise where the JAX scan marks the file corrupt: PIL's open (the
    demuxer's walk) fails, or a side is under 10 px."""
    w, h = webp_size(path)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ValueError(f"{path}: image size <10 pixels ({w} x {h})")
