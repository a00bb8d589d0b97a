// Baseline JPEG decode for the flowgen native texture loader (jpeg.cpp).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

// Decodes a sequential (SOF0/1) or progressive (SOF2) 8-bit Huffman JPEG
// into interleaved RGB. Returns false on any unsupported feature (12-bit,
// arithmetic coding, lossless/hierarchical) or malformed stream; the caller
// falls back to PIL.
bool fg_decode_jpeg(const uint8_t* data, size_t len, int* out_w, int* out_h,
                    std::vector<uint8_t>* rgb);
