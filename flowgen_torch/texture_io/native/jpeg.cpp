// Minimal JPEG decoder for the flowgen native texture loader.
//
// The reference's texture databases are overwhelmingly JPEG, decoded at
// startup through CImg (TextureCollection ctor, DataGenerator.cpp:117-149).
// This is an original implementation of the 8-bit Huffman DCT processes of
// ITU T.81: the baseline/extended sequential process (annexes B/F, SOF0/1)
// and the progressive process (annex G, SOF2) — spectral selection and
// successive approximation, DC+AC first and refinement scans, EOB runs —
// with 1 or 3 components, arbitrary (<=2x2) sampling factors, restart
// markers, and multi-scan sequential frames. Arithmetic coding, 12-bit
// precision, and hierarchical frames return failure and the Python caller
// falls back to PIL for that file.
//
// All scans decode into per-component int16 coefficient planes (zigzag
// order); a single finalize pass dequantizes, runs the separable float
// IDCT, level-shifts into component planes, and converts via JFIF YCbCr
// with pixel-replication chroma upsampling.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg.h"

namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  bool valid = false;
  // Canonical code bookkeeping per length (F.2.2.3 DECODE procedure).
  int32_t mincode[17];
  int32_t maxcode[17];
  int32_t valptr[17];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dc_pred = 0;
  int bw = 0, bh = 0;    // coefficient plane dims in blocks (MCU-padded)
  int nbx = 0, nby = 0;  // real block counts (non-interleaved scan geometry)
  std::vector<int16_t> coef;  // bw*bh blocks x 64, zigzag order per block
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int nbits = 0;
  bool bad = false;

  BitReader(const uint8_t* data, const uint8_t* e) : p(data), end(e) {}

  // Returns false at a marker (0xFF non-stuffing) or end of data.
  bool fill() {
    while (nbits <= 24) {
      if (p >= end) return nbits > 0;
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 >= end) return nbits > 0;
        uint8_t m = p[1];
        if (m == 0x00) {
          p += 2;
        } else {
          // Marker: stop feeding (caller handles RSTn via restart_sync).
          return nbits > 0;
        }
      } else {
        p += 1;
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
    return true;
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n && !fill() && nbits < n) {
      // Past the end: pad with zeros (tolerates truncated final byte).
      acc <<= (n - nbits);
      nbits = n;
      bad = true;
    }
    if (nbits < n) {
      acc <<= (n - nbits);
      nbits = n;
      bad = true;
    }
    int v = (acc >> (nbits - n)) & ((1u << n) - 1);
    nbits -= n;
    return v;
  }

  // Drop pad bits and consume the expected RSTn; returns false if the next
  // marker is not a restart.
  bool restart_sync() {
    acc = 0;
    nbits = 0;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00)) ++p;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      return true;
    }
    return false;
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | br.bits(1);
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
      int idx = t.valptr[l] + code - t.mincode[l];
      if (idx < 0 || idx > 255) return -1;
      return t.vals[idx];
    }
  }
  return -1;
}

int extend(int v, int t) {
  if (t == 0) return 0;
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

void idct8x8(const float in[64], float out[64]) {
  static float c[8][8];
  static bool init = false;
  if (!init) {
    for (int u = 0; u < 8; ++u) {
      float cu = u == 0 ? 0.353553390593f : 0.5f;  // sqrt(1/8), sqrt(2/8)
      for (int x = 0; x < 8; ++x)
        c[u][x] = cu * std::cos((2 * x + 1) * u * 0.19634954084936207f);
    }
    init = true;
  }
  float tmp[64];
  for (int y = 0; y < 8; ++y) {  // rows: 1-D IDCT over u
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int u = 0; u < 8; ++u) s += c[u][x] * in[y * 8 + u];
      tmp[y * 8 + x] = s;
    }
  }
  for (int x = 0; x < 8; ++x) {  // cols: 1-D IDCT over v
    for (int y = 0; y < 8; ++y) {
      float s = 0;
      for (int v = 0; v < 8; ++v) s += c[v][y] * tmp[v * 8 + x];
      out[y * 8 + x] = s;
    }
  }
}

inline uint8_t clamp_u8(float v) {
  return v < 0.f ? 0 : (v > 255.f ? 255 : (uint8_t)(v + 0.5f));
}

struct ScanState {
  // Shared across the blocks of one scan.
  unsigned eobrun = 0;
};

// Sequential block: DC diff + AC run/size into zigzag coefficients (F.2.2).
bool decode_block_seq(BitReader& br, Component& c, const HuffTable& dc,
                      const HuffTable& ac, int16_t* coef) {
  int t = huff_decode(br, dc);
  if (t < 0 || t > 11) return false;
  c.dc_pred += extend(br.bits(t), t);
  coef[0] = (int16_t)c.dc_pred;
  for (int k = 1; k < 64;) {
    int rs = huff_decode(br, ac);
    if (rs < 0) return false;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) {
        k += 16;  // ZRL
        continue;
      }
      break;  // EOB
    }
    k += r;
    if (k > 63) return false;
    coef[k] = (int16_t)extend(br.bits(s), s);
    ++k;
  }
  return true;
}

// Progressive DC scans (G.1.2.1): first pass codes the diff at Al precision;
// refinement appends one bit.
bool decode_block_dc(BitReader& br, Component& c, const HuffTable& dc, int Ah,
                     int Al, int16_t* coef) {
  if (Ah == 0) {
    int t = huff_decode(br, dc);
    if (t < 0 || t > 11) return false;
    c.dc_pred += extend(br.bits(t), t);
    coef[0] = (int16_t)(c.dc_pred * (1 << Al));
  } else {
    if (br.bits(1)) coef[0] = (int16_t)(coef[0] | (1 << Al));
  }
  return true;
}

// Progressive AC first scan (G.1.2.2): spectral band [Ss, Se] at Al
// precision, with EOB run-lengths shared across blocks.
bool decode_block_ac_first(BitReader& br, const HuffTable& ac, int Ss, int Se,
                           int Al, ScanState& st, int16_t* coef) {
  if (st.eobrun > 0) {
    --st.eobrun;
    return true;
  }
  for (int k = Ss; k <= Se; ++k) {
    int rs = huff_decode(br, ac);
    if (rs < 0) return false;
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > Se) return false;
      coef[k] = (int16_t)(extend(br.bits(s), s) * (1 << Al));
    } else {
      if (r != 15) {
        st.eobrun = (1u << r) - 1;
        if (r) st.eobrun += br.bits(r);
        break;
      }
      k += 15;  // ZRL (+1 from the loop)
    }
  }
  return true;
}

// Progressive AC refinement scan (G.1.2.3): one correction bit per already-
// nonzero coefficient crossed, new +-1<<Al coefficients at run ends.
bool decode_block_ac_refine(BitReader& br, const HuffTable& ac, int Ss,
                            int Se, int Al, ScanState& st, int16_t* coef) {
  const int p1 = 1 << Al, m1 = -(1 << Al);
  int k = Ss;
  if (st.eobrun == 0) {
    while (k <= Se) {
      int rs = huff_decode(br, ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      int newval = 0;
      if (s) {
        if (s != 1) return false;  // refinement codes only +-1 magnitudes
        newval = br.bits(1) ? p1 : m1;
      } else if (r != 15) {
        st.eobrun = 1u << r;
        if (r) st.eobrun += br.bits(r);
        break;
      }
      // Advance over r zero-history coefficients, appending a correction
      // bit to every nonzero coefficient crossed on the way.
      while (k <= Se) {
        int16_t& cf = coef[k];
        if (cf != 0) {
          if (br.bits(1) && (cf & p1) == 0) cf += cf >= 0 ? p1 : m1;
        } else {
          if (r == 0) break;
          --r;
        }
        ++k;
      }
      if (newval) {
        if (k > Se) return false;
        coef[k] = (int16_t)newval;
      }
      ++k;
    }
  }
  if (st.eobrun > 0) {
    for (; k <= Se; ++k) {
      int16_t& cf = coef[k];
      if (cf != 0) {
        if (br.bits(1) && (cf & p1) == 0) cf += cf >= 0 ? p1 : m1;
      }
    }
    --st.eobrun;
  }
  return true;
}

}  // namespace

bool fg_decode_jpeg(const uint8_t* data, size_t len, int* out_w, int* out_h,
                    std::vector<uint8_t>* rgb) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;

  uint16_t qt[4][64] = {};
  bool qt_ok[4] = {};
  HuffTable hdc[4], hac[4];
  Component comp[3];
  int ncomp = 0, W = 0, H = 0, restart_interval = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, got_scan = false;
  size_t pos = 2;

  while (pos + 2 <= len) {
    if (data[pos] != 0xFF) return false;
    uint8_t marker = data[pos + 1];
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (marker == 0xD9) break;  // EOI
    if (pos + 4 > len) return false;
    size_t seg = ((size_t)data[pos + 2] << 8) | data[pos + 3];
    if (seg < 2 || pos + 2 + seg > len) return false;
    const uint8_t* pl = data + pos + 4;
    size_t pn = seg - 2;

    if (marker == 0xDB) {  // DQT
      size_t i = 0;
      while (i < pn) {
        int pq = pl[i] >> 4, tq = pl[i] & 15;
        i += 1;
        if (tq > 3 || i + (pq ? 128 : 64) > pn) return false;
        for (int k = 0; k < 64; ++k)
          qt[tq][k] = pq ? ((pl[i + 2 * k] << 8) | pl[i + 2 * k + 1])
                         : pl[i + k];
        qt_ok[tq] = true;
        i += pq ? 128 : 64;
      }
    } else if (marker == 0xC4) {  // DHT
      size_t i = 0;
      while (i + 17 <= pn) {
        int tc = pl[i] >> 4, th = pl[i] & 15;
        if (tc > 1 || th > 3) return false;
        HuffTable& t = tc ? hac[th] : hdc[th];
        int total = 0, code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) total += pl[i + l];
        if (total > 256 || i + 17 + total > pn) return false;
        for (int l = 1; l <= 16; ++l) {
          int n = pl[i + l];
          t.valptr[l] = k;
          t.mincode[l] = code;
          t.maxcode[l] = n ? code + n - 1 : -1;
          code = (code + n) << 1;
          k += n;
        }
        memcpy(t.vals, pl + i + 17, total);
        t.valid = true;
        i += 17 + total;
      }
    } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
      // SOF0/1 (sequential) / SOF2 (progressive), 8-bit Huffman.
      if (W != 0) return false;  // one frame only (no hierarchical)
      progressive = marker == 0xC2;
      if (pn < 6 || pl[0] != 8) return false;
      H = (pl[1] << 8) | pl[2];
      W = (pl[3] << 8) | pl[4];
      ncomp = pl[5];
      if (W <= 0 || H <= 0 || (ncomp != 1 && ncomp != 3) ||
          pn < 6 + 3 * (size_t)ncomp)
        return false;
      for (int ci = 0; ci < ncomp; ++ci) {
        comp[ci].id = pl[6 + 3 * ci];
        comp[ci].h = pl[7 + 3 * ci] >> 4;
        comp[ci].v = pl[7 + 3 * ci] & 15;
        comp[ci].tq = pl[8 + 3 * ci];
        if (comp[ci].h < 1 || comp[ci].h > 2 || comp[ci].v < 1 ||
            comp[ci].v > 2 || comp[ci].tq > 3)
          return false;
      }
      hmax = vmax = 1;
      for (int ci = 0; ci < ncomp; ++ci) {
        hmax = comp[ci].h > hmax ? comp[ci].h : hmax;
        vmax = comp[ci].v > vmax ? comp[ci].v : vmax;
      }
      mcux = (W + 8 * hmax - 1) / (8 * hmax);
      mcuy = (H + 8 * vmax - 1) / (8 * vmax);
      for (int ci = 0; ci < ncomp; ++ci) {
        Component& c = comp[ci];
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.nbx = ((W * c.h + hmax - 1) / hmax + 7) / 8;
        c.nby = ((H * c.v + vmax - 1) / vmax + 7) / 8;
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
    } else if ((marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 &&
                marker != 0xC8 && marker != 0xCC)) {
      return false;  // lossless / arithmetic / hierarchical
    } else if (marker == 0xDD) {  // DRI
      if (pn < 2) return false;
      restart_interval = (pl[0] << 8) | pl[1];
    } else if (marker == 0xDA) {  // SOS
      if (W == 0 || pn < 4) return false;
      int ns = pl[0];
      if (ns < 1 || ns > ncomp || pn < 1 + 2 * (size_t)ns + 3) return false;
      Component* sc[3] = {};
      for (int si = 0; si < ns; ++si) {
        int cid = pl[1 + 2 * si];
        int tabs = pl[2 + 2 * si];
        for (int ci = 0; ci < ncomp; ++ci) {
          if (comp[ci].id == cid) {
            comp[ci].td = tabs >> 4;
            comp[ci].ta = tabs & 15;
            sc[si] = &comp[ci];
          }
        }
        if (!sc[si]) return false;
      }
      int Ss = pl[1 + 2 * ns], Se = pl[2 + 2 * ns];
      int Ah = pl[3 + 2 * ns] >> 4, Al = pl[3 + 2 * ns] & 15;
      if (!progressive) {
        Ss = 0;
        Se = 63;
        Ah = Al = 0;
      } else {
        if (Ss > Se || Se > 63 || Al > 13 || (Ss == 0 && Se != 0) ||
            (Ss > 0 && ns != 1))
          return false;
      }
      const bool dc_scan = Ss == 0;
      const bool need_ac = !progressive || Ss > 0;
      for (int si = 0; si < ns; ++si) {
        if (dc_scan && Ah == 0 && !hdc[sc[si]->td].valid) return false;
        if (need_ac && !hac[sc[si]->ta].valid) return false;
        sc[si]->dc_pred = 0;  // predictors reset per scan (F.2.1.3.1)
      }

      BitReader br(data + pos + 2 + seg, data + len);
      ScanState st;
      bool ok = true;
      int unit_count = 0;

      // Data-unit iteration: MCU-interleaved when ns > 1, the component's
      // own (nbx, nby) block raster when ns == 1 (A.2.2/A.2.3).
      const int nux = ns > 1 ? mcux : sc[0]->nbx;
      const int nuy = ns > 1 ? mcuy : sc[0]->nby;
      for (int uy = 0; uy < nuy && ok; ++uy) {
        for (int ux = 0; ux < nux && ok; ++ux) {
          if (restart_interval && unit_count == restart_interval) {
            if (!br.restart_sync()) {
              ok = false;
              break;
            }
            for (int si = 0; si < ns; ++si) sc[si]->dc_pred = 0;
            st.eobrun = 0;
            unit_count = 0;
          }
          for (int si = 0; si < ns && ok; ++si) {
            Component& c = *sc[si];
            const int bh = ns > 1 ? c.v : 1, bwn = ns > 1 ? c.h : 1;
            for (int by = 0; by < bh && ok; ++by) {
              for (int bx = 0; bx < bwn && ok; ++bx) {
                const int gx = ns > 1 ? ux * c.h + bx : ux;
                const int gy = ns > 1 ? uy * c.v + by : uy;
                int16_t* coef = &c.coef[((size_t)gy * c.bw + gx) * 64];
                if (!progressive)
                  ok = decode_block_seq(br, c, hdc[c.td], hac[c.ta], coef);
                else if (dc_scan)
                  ok = decode_block_dc(br, c, hdc[c.td], Ah, Al, coef);
                else if (Ah == 0)
                  ok = decode_block_ac_first(br, hac[c.ta], Ss, Se, Al, st,
                                             coef);
                else
                  ok = decode_block_ac_refine(br, hac[c.ta], Ss, Se, Al, st,
                                              coef);
              }
            }
          }
          ++unit_count;
        }
      }
      if (!ok || br.bad) return false;
      got_scan = true;
      // Resume marker parsing at the next true marker (skip pad bytes,
      // stuffed zeros, and any trailing RSTn).
      pos = br.p - data;
      while (pos + 1 < len &&
             !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
               !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
        ++pos;
      continue;
    }
    // APPn / COM / others: skip.
    pos += 2 + seg;
  }
  if (!got_scan || W == 0) return false;
  for (int ci = 0; ci < ncomp; ++ci)
    if (!qt_ok[comp[ci].tq]) return false;

  // Finalize: dequantize + IDCT every block into 8-bit component planes.
  std::vector<std::vector<uint8_t>> planes(ncomp);
  float blk[64], px[64];
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp[ci];
    const uint16_t* q = qt[c.tq];
    planes[ci].assign((size_t)c.bw * c.bh * 64, 0);
    size_t stride = (size_t)c.bw * 8;
    for (int gy = 0; gy < c.bh; ++gy) {
      for (int gx = 0; gx < c.bw; ++gx) {
        const int16_t* coef = &c.coef[((size_t)gy * c.bw + gx) * 64];
        for (int k = 0; k < 64; ++k)
          blk[kZigzag[k]] = (float)coef[k] * q[k];
        idct8x8(blk, px);
        uint8_t* base = &planes[ci][(size_t)gy * 8 * stride + gx * 8];
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            base[y * stride + x] = clamp_u8(px[y * 8 + x] + 128.0f);
      }
    }
  }

  rgb->resize((size_t)W * H * 3);
  if (ncomp == 1) {
    size_t stride = (size_t)comp[0].bw * 8;
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        uint8_t g = planes[0][y * stride + x];
        uint8_t* o = &(*rgb)[((size_t)y * W + x) * 3];
        o[0] = o[1] = o[2] = g;
      }
  } else {
    size_t ys = (size_t)comp[0].bw * 8;
    size_t cbs = (size_t)comp[1].bw * 8;
    size_t crs = (size_t)comp[2].bw * 8;
    int cbx = hmax / comp[1].h, cby = vmax / comp[1].v;
    int crx = hmax / comp[2].h, cry = vmax / comp[2].v;
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        float Y = planes[0][y * ys + x];
        float Cb = planes[1][(y / cby) * cbs + (x / cbx)] - 128.0f;
        float Cr = planes[2][(y / cry) * crs + (x / crx)] - 128.0f;
        uint8_t* o = &(*rgb)[((size_t)y * W + x) * 3];
        o[0] = clamp_u8(Y + 1.402f * Cr);
        o[1] = clamp_u8(Y - 0.344136f * Cb - 0.714136f * Cr);
        o[2] = clamp_u8(Y + 1.772f * Cb);
      }
    }
  }
  *out_w = W;
  *out_h = H;
  return true;
}
