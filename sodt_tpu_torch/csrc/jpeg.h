// The JPEG decoder's entry for a TIFF strip or tile (compression 7), defined
// in csrc/jpeg.cpp and called by csrc/tiff.cpp; `data/jpeg.py`'s
// `decode_segment` is its plain version.
#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace sodt_jpeg {

// The tables-only stream of JPEGTables (tables[0, tn), none where tn is 0)
// read first, then the chunk's own stream data[0, n), as libtiff feeds
// libjpeg: (h, w), c = 1 gray or 3, the pixels (h, w, c) into px and each
// component's sampling factors (h, v). Three components are YCbCr converted
// to RGB with `ycc`, else RGB as stored (libtiff sets the colour space by the
// TIFF's photometric). A frame not `cols` wide and `rows` to `top` high
// throws before it is decoded. Throws std::runtime_error with the cause.
void decode_segment(const uint8_t* tables, size_t tn, const uint8_t* data, size_t n,
                    bool ycc, int cols, int rows, int top, int* h, int* w, int* c,
                    std::vector<uint8_t>* px, std::vector<std::pair<int, int>>* sampling);

}  // namespace sodt_jpeg
