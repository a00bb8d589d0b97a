// flowgen native texture loader.
//
// Multi-threaded decode + resize of texture databases into the packed atlas
// buffer consumed by the JAX pipeline. This is the native-runtime counterpart
// of the reference's startup texture load (TextureCollection ctor,
// src/caffe/DataGenerator.cpp:117-149), which decoded every image serially
// via CImg; here a std::thread pool decodes and bilinearly resizes in
// parallel straight into the caller-provided atlas memory (zero-copy into
// numpy).
//
// Supported formats: sequential + progressive JPEG (jpeg.cpp), PNG (via
// system zlib), binary PPM/PGM, uncompressed 24/32-bit BMP. Anything else
// (TIFF, ...) fails PER FILE: the ok[] output marks which slots were decoded,
// and the Python caller PIL-decodes only the stragglers — one exotic file in
// a large database no longer forfeits the threaded decode of the rest.
//
// Build: make -C flowgen/texture_io/native

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#include "jpeg.h"

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved, c channels
  bool ok() const { return w > 0 && h > 0 && !data.empty(); }
};

// ---------------------------------------------------------------------------
// PPM / PGM
// ---------------------------------------------------------------------------

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

int skip_ws_comments(const std::vector<uint8_t>& b, int pos) {
  while (pos < (int)b.size()) {
    if (isspace(b[pos])) {
      pos++;
    } else if (b[pos] == '#') {
      while (pos < (int)b.size() && b[pos] != '\n') pos++;
    } else {
      break;
    }
  }
  return pos;
}

int parse_int(const std::vector<uint8_t>& b, int* pos) {
  *pos = skip_ws_comments(b, *pos);
  int v = 0;
  while (*pos < (int)b.size() && isdigit(b[*pos])) {
    v = v * 10 + (b[*pos] - '0');
    (*pos)++;
  }
  return v;
}

Image decode_pnm(const std::vector<uint8_t>& b) {
  Image img;
  if (b.size() < 2 || b[0] != 'P') return img;
  int channels = (b[1] == '6') ? 3 : (b[1] == '5') ? 1 : 0;
  if (!channels) return img;
  int pos = 2;
  int w = parse_int(b, &pos);
  int h = parse_int(b, &pos);
  int maxv = parse_int(b, &pos);
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) return img;
  pos++;  // single whitespace after maxval
  size_t need = (size_t)w * h * channels;
  if (b.size() < pos + need) return img;
  img.w = w;
  img.h = h;
  img.c = channels;
  img.data.assign(b.begin() + pos, b.begin() + pos + need);
  return img;
}

// ---------------------------------------------------------------------------
// BMP (uncompressed 24/32-bit)
// ---------------------------------------------------------------------------

uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
int32_t rd32s(const uint8_t* p) { return (int32_t)rd32(p); }
uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

Image decode_bmp(const std::vector<uint8_t>& b) {
  Image img;
  if (b.size() < 54 || b[0] != 'B' || b[1] != 'M') return img;
  uint32_t offset = rd32(&b[10]);
  int32_t w = rd32s(&b[18]);
  int32_t h = rd32s(&b[22]);
  uint16_t bpp = rd16(&b[28]);
  uint32_t comp = rd32(&b[30]);
  bool flip = h > 0;
  h = h > 0 ? h : -h;
  if (comp != 0 || (bpp != 24 && bpp != 32) || w <= 0 || h <= 0) return img;
  int bytes = bpp / 8;
  size_t stride = ((size_t)w * bytes + 3) & ~3u;
  if (b.size() < offset + stride * h) return img;
  img.w = w;
  img.h = h;
  img.c = 3;
  img.data.resize((size_t)w * h * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = &b[offset + stride * (flip ? (h - 1 - y) : y)];
    for (int x = 0; x < w; ++x) {
      // BMP stores BGR
      img.data[((size_t)y * w + x) * 3 + 0] = row[x * bytes + 2];
      img.data[((size_t)y * w + x) * 3 + 1] = row[x * bytes + 1];
      img.data[((size_t)y * w + x) * 3 + 2] = row[x * bytes + 0];
    }
  }
  return img;
}

// ---------------------------------------------------------------------------
// PNG (zlib inflate + defilter; 8-bit gray/RGB/RGBA/palette, no interlace)
// ---------------------------------------------------------------------------

Image decode_png(const std::vector<uint8_t>& b) {
  Image img;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (b.size() < 8 || memcmp(b.data(), sig, 8) != 0) return img;

  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  size_t pos = 8;
  while (pos + 8 <= b.size()) {
    uint32_t len = (b[pos] << 24) | (b[pos + 1] << 16) | (b[pos + 2] << 8) | b[pos + 3];
    const char* type = reinterpret_cast<const char*>(&b[pos + 4]);
    if (pos + 12 + len > b.size()) break;
    const uint8_t* payload = &b[pos + 8];
    if (!strncmp(type, "IHDR", 4) && len >= 13) {
      w = (payload[0] << 24) | (payload[1] << 16) | (payload[2] << 8) | payload[3];
      h = (payload[4] << 24) | (payload[5] << 16) | (payload[6] << 8) | payload[7];
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (!strncmp(type, "PLTE", 4)) {
      palette.assign(payload, payload + len);
    } else if (!strncmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!strncmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || bit_depth != 8 || interlace != 0) return img;
  int src_c;
  switch (color_type) {
    case 0: src_c = 1; break;  // gray
    case 2: src_c = 3; break;  // RGB
    case 3: src_c = 1; break;  // palette index
    case 4: src_c = 2; break;  // gray+alpha
    case 6: src_c = 4; break;  // RGBA
    default: return img;
  }
  if (color_type == 3 && palette.empty()) return img;

  size_t stride = (size_t)w * src_c;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return img;
  }

  // Defilter (PNG filters 0-4), per scanline.
  std::vector<uint8_t> pix((size_t)w * h * src_c);
  int bpp = src_c;
  for (int y = 0; y < h; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* in = &raw[(stride + 1) * y + 1];
    uint8_t* out = &pix[stride * y];
    const uint8_t* prev = y > 0 ? &pix[stride * (y - 1)] : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= (size_t)bpp ? out[i - bpp] : 0;
      int bb = prev ? prev[i] : 0;
      int c = (prev && i >= (size_t)bpp) ? prev[i - bpp] : 0;
      int x = in[i];
      switch (filter) {
        case 0: out[i] = x; break;
        case 1: out[i] = x + a; break;
        case 2: out[i] = x + bb; break;
        case 3: out[i] = x + ((a + bb) >> 1); break;
        case 4: {
          int p = a + bb - c;
          int pa = std::abs(p - a), pb = std::abs(p - bb), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? bb : c);
          out[i] = x + pred;
          break;
        }
        default: return img;
      }
    }
  }

  // Expand to RGB.
  img.w = w;
  img.h = h;
  img.c = 3;
  img.data.resize((size_t)w * h * 3);
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    const uint8_t* s = &pix[i * src_c];
    uint8_t r, g, bl;
    switch (color_type) {
      case 0:
      case 4: r = g = bl = s[0]; break;
      case 2:
      case 6: r = s[0]; g = s[1]; bl = s[2]; break;
      case 3: {
        size_t pi = (size_t)s[0] * 3;
        if (pi + 2 >= palette.size()) { r = g = bl = 0; }
        else { r = palette[pi]; g = palette[pi + 1]; bl = palette[pi + 2]; }
        break;
      }
      default: r = g = bl = 0;
    }
    img.data[i * 3 + 0] = r;
    img.data[i * 3 + 1] = g;
    img.data[i * 3 + 2] = bl;
  }
  return img;
}

// ---------------------------------------------------------------------------
// Decode dispatch + bilinear resize into the atlas slot
// ---------------------------------------------------------------------------

Image decode(const std::string& path) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes) || bytes.size() < 8) return Image{};
  if (bytes[0] == 'P' && (bytes[1] == '5' || bytes[1] == '6'))
    return decode_pnm(bytes);
  if (bytes[0] == 'B' && bytes[1] == 'M') return decode_bmp(bytes);
  if (bytes[0] == 137 && bytes[1] == 'P') return decode_png(bytes);
  if (bytes[0] == 0xFF && bytes[1] == 0xD8) {
    Image img;
    if (fg_decode_jpeg(bytes.data(), bytes.size(), &img.w, &img.h,
                       &img.data)) {
      img.c = 3;
      return img;
    }
    return Image{};
  }
  return Image{};
}

void resize_into(const Image& img, int oh, int ow, uint8_t* out) {
  // Bilinear, align_corners=false convention (matches PIL/CImg closely).
  const float sx = (float)img.w / ow;
  const float sy = (float)img.h / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 >= img.h ? img.h - 1 : y1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x1 = x0 + 1;
      x0 = x0 < 0 ? 0 : (x0 >= img.w ? img.w - 1 : x0);
      x1 = x1 < 0 ? 0 : (x1 >= img.w ? img.w - 1 : x1);
      for (int c = 0; c < 3; ++c) {
        int cc = img.c == 1 ? 0 : c;
        float v00 = img.data[((size_t)y0 * img.w + x0) * img.c + cc];
        float v01 = img.data[((size_t)y0 * img.w + x1) * img.c + cc];
        float v10 = img.data[((size_t)y1 * img.w + x0) * img.c + cc];
        float v11 = img.data[((size_t)y1 * img.w + x1) * img.c + cc];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        float v = top + (bot - top) * wy;
        out[((size_t)y * ow + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

}  // namespace

// ABI marker: lets the Python binding detect a stale pre-per-file-fallback
// build of the shared library and rebuild it.
extern "C" int fg_loader_abi_v2() { return 2; }

// Returns -1 on invalid arguments, else the number of files that could not
// be decoded natively. ``ok`` (optional, length n) receives a per-file 1/0
// decode flag so the caller can fall back per file instead of per batch.
extern "C" int fg_load_images(const char** paths, int n, int out_h, int out_w,
                              uint8_t* out, int n_threads, uint8_t* ok) {
  if (n <= 0 || out_h <= 0 || out_w <= 0 || !out) return -1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t slot = (size_t)out_h * out_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img = decode(paths[i]);
      if (!img.ok()) {
        failures.fetch_add(1);
        if (ok) ok[i] = 0;
        continue;
      }
      resize_into(img, out_h, out_w, out + slot * i);
      if (ok) ok[i] = 1;
    }
  };

  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}
