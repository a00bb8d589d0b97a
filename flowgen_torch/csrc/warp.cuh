// Mode-9 device functions of the scene kernel: the f32 two-pass resample of
// warp planes with the TPU kernel's banded taps, the separable displacement
// warps of a deforming object's expanded window, and the deforming
// background. The device twins of flowgen_torch/ops/resample.py
// (resample_rows_f32, displace_warp, displace_warp_rgb) and of the warp
// branch of flowgen_torch/ops/scene.py:scene_render_plain, which restate the
// JAX kernel (flowgen/ops/pallas_scene.py, has_warp; pallas_resample.py).
//
// Per pixel, not per staged window. The TPU kernel stages whole windows and
// reads every tap through _banded_tap_pair: per block of positions, a band of
// 128-lane source tiles starts at the tile of the block's smallest left tap,
// and a tap outside it reads 0.
//   * f32 resample (forward-field flow at the moved positions): its
//     positions are affine in the block's coordinates, and every rounded
//     operation is monotone, so a block's smallest tap is at one of its four
//     corners. Each pixel evaluates the corners of the blocks its taps belong
//     to and applies the band exactly.
//   * displacement warps of objects: the band covers the whole source at
//     every frame size (the expanded window is at most 3 tiles wide and
//     tall, the scans are 3), so the rule changes nothing.
//   * displacement warp of the background: pass 2 as above; pass 1 scans 4
//     of W/128 + 2 tiles, and its blocks' smallest taps depend on the
//     slot's gdisp over the whole block: the bank producer reduces them
//     once per bank epoch (ops/scene.py:bg_band_starts) and each pixel
//     applies its block's band.
// A displaced pixel reads its source at 2x2 taps of a u8-rounded
// intermediate; those sources (coverage, affine-resampled texture, plain
// background) are recomputed per tap rather than staged with a halo.
//
// Included by scene.cu after its layout constants, StagedEdges and
// unit_coverage.
#pragma once

#include "coverage.cuh"
#include "resample.cuh"

namespace flowgen {

constexpr int kWarpEY = 56, kWarpEX = 64, kBgEY = 96, kBgEX = 128;
constexpr float kInThr = (float)(1.0 - 0.5 / 255.0);

struct WarpFrame {
  int H, W, wh, ww;
  int whE, wwE;        // object expanded window
  int HB, WB, whB;     // background extended grid and its displaced band
};

__device__ __forceinline__ WarpFrame warp_frame(int H, int W) {
  WarpFrame g;
  g.H = H;
  g.W = W;
  g.wh = min(192, H);
  g.ww = min(256, W);
  g.whE = min(g.wh + 2 * kWarpEY, H);
  g.wwE = min(g.ww + 2 * kWarpEX, W);
  g.HB = H + 2 * kBgEY;
  g.WB = W + 2 * kBgEX;
  g.whB = min(g.wh + 2 * kBgEY, g.HB);
  return g;
}

__device__ __forceinline__ float det_lerp(float p0, float p1, float t) {
  return __fadd_rn(p0, __fmul_rn(__fsub_rn(p1, p0), t));
}

// Two-pass split of a raw output -> plane affine (the JAX kernel's
// _two_pass_split).
__device__ __forceinline__ void two_pass_split(const float* m, float co[6]) {
  const float B = m[1] / m[4];
  co[0] = m[0] - B * m[3];
  co[1] = B;
  co[2] = m[2] - B * m[5];
  co[3] = m[3];
  co[4] = m[4];
  co[5] = m[5];
}

// Banded-tap band start of a block whose smallest left tap is min_tap.
__device__ __forceinline__ int band_lo(int min_tap, int n_src, int nscan) {
  return max(min(min_tap >> 7, n_src - nscan), 0) * 128;
}

// One plane of a warp bank slot (rows H, width W) sampled through the
// two-pass affine co at pixel (x, y) of the (wh, ww) window at (y0, x0): the
// JAX kernel's sample_plane_affine -> resample_rows_f32 with min(P, H)
// staged rows, pass-1 chunks of 128 rows, pass-2 blocks of 128 x 128 and a
// transposed pass-1 scratch Pp lanes wide.
__device__ __noinline__ float resample_plane_pixel(
    const float* __restrict__ plane, int H, int W, const float co[6], int y0,
    int x0, int wh, int ww, int P, int Pp, int xscan, int yscan, int x,
    int y) {
  const int PF = min(P, H);
  const int w0 = pass1_row_start(co, x0, y0, wh, ww, PF, H);
  const float w0f = (float)w0;
  const float A = co[0], B = co[1], C = co[2], c = co[3], d = co[4],
              f = co[5];
  // ---- pass 2: v over rows of the staged block ----
  const int xch = ww >= 128 ? 128 : ww;
  const int xc0 = x0 + ((x - x0) / xch) * xch;
  const int yt0 = y0 + ((y - y0) / 128) * 128;
  float vmin = 3.4e38f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float xg = (float)(xc0 + ((i & 1) ? xch - 1 : 0));
    const float yg = (float)(yt0 + ((i & 2) ? 127 : 0));
    vmin = fminf(vmin, clipf(((c * xg + d * yg) + f) - w0f, 0.0f,
                             (float)(PF - 1)));
  }
  const int n2 = Pp / 128, s2 = min(yscan, n2);
  const int lo2 = band_lo((int)floorf(vmin), n2, s2), hi2 = lo2 + s2 * 128;
  const float xf = (float)x, yf = (float)y;
  const float v = clipf(((c * xf + d * yf) + f) - w0f, 0.0f, (float)(PF - 1));
  const float vf = floorf(v);
  const float fy = v - vf;
  const int v0 = (int)vf;
  const int vs[2] = {v0, min(v0 + 1, PF - 1)};
  // ---- pass 1 at the two rows pass 2 reads ----
  const int n1 = W / 128, s1 = min(xscan, n1);
  const int xt0 = x0 + ((x - x0) / 128) * 128;
  float q[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int vi = vs[k];
    if (vi < lo2 || vi >= hi2) {
      q[k] = 0.0f;
      continue;
    }
    const int r0 = (vi / 128) * 128;
    const int rc = min(128, PF - r0);
    float umin = 3.4e38f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xg = (float)(xt0 + ((i & 1) ? 127 : 0));
      const float wg = (float)(w0 + r0 + ((i & 2) ? rc - 1 : 0));
      umin = fminf(umin, clipf((A * xg + B * wg) + C, 0.0f, (float)(W - 1)));
    }
    const int lo1 = band_lo((int)floorf(umin), n1, s1), hi1 = lo1 + s1 * 128;
    const float wg = (float)(w0 + vi);
    const float u = clipf((A * xf + B * wg) + C, 0.0f, (float)(W - 1));
    const float uf = floorf(u);
    const float fx = u - uf;
    const int u0 = (int)uf;
    const int u1 = min(u0 + 1, W - 1);
    const float* row = plane + (size_t)(w0 + vi) * W;
    const float p0 = (u0 >= lo1 && u0 < hi1) ? __ldg(row + u0) : 0.0f;
    const float p1 = (u1 >= lo1 && u1 < hi1) ? __ldg(row + u1) : 0.0f;
    q[k] = p0 + (p1 - p0) * fx;
  }
  return q[0] + (q[1] - q[0]) * fy;
}

// Clipped lerp position of a displacement-warp tap: (u0, u1, weight, inside).
struct Tap {
  int i0, i1;
  float t;
  bool ok;
};

__device__ __forceinline__ Tap warp_tap(float u, int n) {
  Tap k;
  k.ok = u >= 0.0f && u <= (float)(n - 1);
  const float uc = clipf(u, 0.0f, (float)(n - 1));
  const float uf = floorf(uc);
  k.t = uc - uf;
  k.i0 = (int)uf;
  k.i1 = min(k.i0 + 1, n - 1);
  return k;
}

// The u8-rounded affine-resampled texture of a deforming object's expanded
// window at local (wi, ui): the last texture sub-tile covering it, folded at
// its own centre (scalar_fold_coeffs of the frame-1 motion).
__device__ __forceinline__ void expanded_texel(
    const WarpFrame& g, const int* __restrict__ slab, int SHs, int SWs, int P,
    int CWO, const float* motion, int ey0, int ex0, int wi, int ui,
    float out[3]) {
  const int ly = (g.whE != g.wh && wi >= g.whE - g.wh) ? g.whE - g.wh : 0;
  const int lx = (g.wwE != g.ww && ui >= g.wwE - g.ww) ? g.wwE - g.ww : 0;
  const int oy = ey0 + ly, ox = ex0 + lx;
  float co[6];
  fold_coeffs(motion, (float)ox + 0.5f * (float)g.ww,
              (float)oy + 0.5f * (float)g.wh, (float)g.W, (float)g.H,
              (float)256, co);
  const int w0 = pass1_row_start(co, ox, oy, g.wh, g.ww, P, SHs);
  const int c0 = col_window(co, ox, w0, g.ww, P, CWO, SWs);
  two_pass_pixel(slab, SWs, w0, c0, CWO, P, co, ex0 + ui, ey0 + wi, out);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = rintf(out[ch]);
}

// The taps of a deforming object's frame-1 pixel (x, y) whose unit's window
// is at (y0w, x0w): the expanded window's origin (ey0, ex0), the row lerp
// tv on it and, for each of tv's two rows, the column lerp tu[k], through
// the slot's gdisp / vdisp planes. Coverage and texture are evaluated at
// rows tv.i0, tv.i1 and columns tu[k].i0, tu[k].i1 of the expanded window.
struct WarpTaps {
  int ey0, ex0;
  Tap tv;
  Tap tu[2];
};

__device__ __forceinline__ WarpTaps warp_taps(const WarpFrame& g,
                                              const float* __restrict__ gdp,
                                              const float* __restrict__ vdp,
                                              int x, int y, int y0w, int x0w) {
  WarpTaps w;
  w.ey0 = min(max(y0w - kWarpEY, 0), g.H - g.whE) & ~7;
  w.ex0 = min(max(x0w - kWarpEX, 0), g.W - g.wwE);
  w.tv = warp_tap(((float)y + __ldg(vdp + (size_t)y * g.W + x)) -
                      (float)w.ey0, g.whE);
  const int rows[2] = {w.tv.i0, w.tv.i1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float gd = __ldg(gdp + (size_t)(w.ey0 + rows[k]) * g.W + x);
    w.tu[k] = warp_tap(((float)x + gd) - (float)w.ex0, g.wwE);
  }
  return w;
}

// Frame 1 of a deforming object at output pixel (x, y) of its unit's window
// (y0w, x0w): coverage and texture on the expanded window at the pixel's
// taps (warp_taps), coverage from the unit's edges as staged for them.
// Returns the blend mask, the warped binary mask (disp(binary) >= 1 -
// 0.5/255, for the inverse flow and the ids) and the texture.
__device__ __noinline__ void warp_unit_pixel(
    const WarpFrame& g, const int* om, const float* of,
    const StagedEdges& st, const float* __restrict__ gdp,
    const float* __restrict__ vdp, const int* __restrict__ slab, int SHs,
    int SWs, int P, int CWO, int use_aa, int x, int y, int y0w, int x0w,
    float* m_out, float* in_out, float tex[3]) {
  const WarpTaps tp = warp_taps(g, gdp, vdp, x, y, y0w, x0w);
  const int ey0 = tp.ey0, ex0 = tp.ex0;
  const Tap tv = tp.tv;
  float aa_r[2], in_r[2], rgb_r[2][3];
  const int rows[2] = {tv.i0, tv.i1};
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const int wi = rows[k];
    const Tap tu = tp.tu[k];
    float aa[2], in[2], rgb[2][3];
    const int cols[2] = {tu.i0, tu.i1};
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      unit_coverage(om, of, st, ex0 + cols[j], ey0 + wi, ey0, ex0, g.whE,
                    &aa[j], &in[j]);
      expanded_texel(g, slab, SHs, SWs, P, CWO, of + kOmfMotion, ey0, ex0, wi,
                     cols[j], rgb[j]);
    }
    aa_r[k] = tu.ok ? det_lerp(aa[0], aa[1], tu.t) : 0.0f;
    in_r[k] = tu.ok ? det_lerp(in[0], in[1], tu.t) : 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb_r[k][ch] = rintf(tu.ok ? det_lerp(rgb[0][ch], rgb[1][ch], tu.t) : 0.0f);
  }
  const float inw = tv.ok ? det_lerp(in_r[0], in_r[1], tv.t) : 0.0f;
  *in_out = inw >= kInThr ? 1.0f : 0.0f;
  *m_out = use_aa ? (tv.ok ? det_lerp(aa_r[0], aa_r[1], tv.t) : 0.0f)
                  : *in_out;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    tex[ch] = tv.ok ? det_lerp(rgb_r[0][ch], rgb_r[1][ch], tv.t) : 0.0f;
}

// The plain frame-1 background at extended-grid position (X', Y') =
// (frame x + BG_EX, frame y + BG_EY), u8-rounded: the last extended tile
// covering it, folded at its centre.
__device__ __forceinline__ void extended_bg_texel(
    const WarpFrame& g, const float* bgm, const int* __restrict__ bslab,
    int SHb, int SWb, int PBG, int CWB, int xe, int ye, float out[3]) {
  const int oy = ye >= g.HB - g.wh ? g.H + kBgEY - g.wh : (ye / g.wh) * g.wh - kBgEY;
  const int ox = xe >= g.WB - g.ww ? g.W + kBgEX - g.ww : (xe / g.ww) * g.ww - kBgEX;
  float co[6];
  fold_coeffs(bgm + kBgmT1, (float)ox + 0.5f * (float)g.ww,
              (float)oy + 0.5f * (float)g.wh, bgm[kBgmSrcW], bgm[kBgmSrcH],
              (float)256, co);
  const int w0 = pass1_row_start(co, ox, oy, g.wh, g.ww, PBG, SHb);
  const int c0 = col_window(co, ox, w0, g.ww, PBG, CWB, SWb);
  two_pass_pixel(bslab, SWb, w0, c0, CWB, PBG, co, xe - kBgEX, ye - kBgEY, out);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = rintf(out[ch]);
}

// Frame 1 of a deforming background at pixel (x, y) of background tile
// (y0s, x0s): the plain frame 1 on the extended grid, displaced through the
// slot's x2-upscaled gdisp / vdisp planes (bgaux rows = frame rows + BG_EY).
// `band` is the first source tile of the pixel's pass-1 block.
__device__ __noinline__ void warp_bg_pixel(
    const WarpFrame& g, const float* bgm, const int* __restrict__ bslab,
    int SHb, int SWb, int PBG, int CWB, const float* __restrict__ gdp,
    const float* __restrict__ vdp, int band, int x, int y, int y0s,
    float out[3]) {
  const int lo = band * 128, hi = lo + min(4, g.WB / 128) * 128;
  const int ey0 = y0s - kBgEY;
  const Tap tv = warp_tap(
      ((float)y + __ldg(vdp + (size_t)(y + kBgEY) * g.W + x)) - (float)ey0,
      g.whB);
  float rgb_r[2][3];
  const int rows[2] = {tv.i0, tv.i1};
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const int wi = rows[k];
    const float gd = __ldg(gdp + (size_t)(y0s + wi) * g.W + x);
    const Tap tu = warp_tap(((float)x + gd) - (float)(-kBgEX), g.WB);
    float rgb[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    if (tu.i0 >= lo && tu.i0 < hi)
      extended_bg_texel(g, bgm, bslab, SHb, SWb, PBG, CWB, tu.i0, y0s + wi,
                        rgb[0]);
    if (tu.i1 >= lo && tu.i1 < hi)
      extended_bg_texel(g, bgm, bslab, SHb, SWb, PBG, CWB, tu.i1, y0s + wi,
                        rgb[1]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb_r[k][ch] = rintf(tu.ok ? det_lerp(rgb[0][ch], rgb[1][ch], tu.t) : 0.0f);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = tv.ok ? det_lerp(rgb_r[0][ch], rgb_r[1][ch], tv.t) : 0.0f;
}

}  // namespace flowgen
