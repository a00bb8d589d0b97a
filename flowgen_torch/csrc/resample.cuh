// Two-pass affine resampling of packed-RGB slabs, per pixel: the device twin
// of flowgen_torch/ops/resample.py (and of the JAX package's
// resample_rows_in_kernel, ops/pallas_resample.py).
//
// The TPU kernel stages a row block slab[w0 : w0+P, c0 : c0+CW], runs pass 1
// (a horizontal lerp at u = A x + B w + C) over all its rows, transposes, and
// runs pass 2 (a vertical lerp at v = c x + d y + f - w0). Per pixel the two
// passes collapse: pass 2 reads only rows floor(v) and floor(v)+1 of pass 1,
// so a pixel costs four texel loads. The clips stay relative to the staged
// block (u to [0, CW-1] after rebasing by c0, v to [0, P-1] after
// subtracting w0), so the result equals the staged form wherever the TPU
// kernel's banded scans find their taps, which holds inside the mode's
// motion envelope.
#pragma once

#include "coverage.cuh"

namespace flowgen {

// Row-block start of a (wh, ww) window at output origin (x0, y0): source v
// over the window corners, floor - 1, snapped to 8, clamped so that
// [w0, w0+P) stays inside a height-SH slab.
__device__ __forceinline__ int pass1_row_start(const float co[6], int x0,
                                               int y0, int wh, int ww, int P,
                                               int SH) {
  const float c = co[3], d = co[4], f = co[5];
  const float xs[2] = {(float)x0, (float)x0 + (float)(ww - 1)};
  const float ys[2] = {(float)y0, (float)y0 + (float)(wh - 1)};
  const float k00 = (c * xs[0] + d * ys[0]) + f;
  const float k01 = (c * xs[0] + d * ys[1]) + f;
  const float k10 = (c * xs[1] + d * ys[0]) + f;
  const float k11 = (c * xs[1] + d * ys[1]) + f;
  const float vmin = fminf(fminf(k00, k01), fminf(k10, k11));
  const int w0 = (floor_i(vmin) - 1) & ~7;
  return min(max(w0, 0), (SH - P) & ~7);
}

// Column window of the staged row block: the 128-aligned start of the source
// columns pass 1 can touch, clamped into a width-SW slab; rebases co[2]
// (the C term) by -c0. CW >= SW disables windowing.
__device__ __forceinline__ int col_window(float co[6], int x0, int w0,
                                          int wwl, int Pl, int CW, int SW) {
  if (CW >= SW) return 0;
  const float A = co[0], B = co[1], C = co[2];
  const float xf = (float)x0, wf = (float)w0;
  const float xs[2] = {xf, xf + (float)(wwl - 1)};
  const float ws[2] = {wf, wf + (float)(Pl - 1)};
  const float u00 = (A * xs[0] + B * ws[0]) + C;
  const float u01 = (A * xs[0] + B * ws[1]) + C;
  const float u10 = (A * xs[1] + B * ws[0]) + C;
  const float u11 = (A * xs[1] + B * ws[1]) + C;
  const float umin = fminf(fminf(u00, u01), fminf(u10, u11));
  int c0 = (floor_i(umin) - 1) & ~127;
  c0 = min(max(c0, 0), SW - CW);
  co[2] = C - (float)c0;
  return c0;
}

// Reflect fold at the footprint centre (cx, cy) composed into a raw
// output -> source affine m, split into two-pass coefficients (A, B, C, c,
// d, f): the TPU kernel's scalar_fold_coeffs (s - 2n * floor(s / 2n)).
__device__ __forceinline__ void fold_coeffs(const float* m, float cx, float cy,
                                            float nx, float ny, float margin,
                                            float co[6]) {
  const float sxc = (m[0] * cx + m[1] * cy) + m[2];
  const float syc = (m[3] * cx + m[4] * cy) + m[5];
  float sig[2], beta[2];
  const float sc[2] = {sxc, syc};
  const float n[2] = {nx, ny};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float two_n = 2.0f * n[i];
    const float r = sc[i] - two_n * floorf(sc[i] / two_n);
    const bool mirror = r >= n[i];
    const float off = sc[i] - r;
    sig[i] = mirror ? -1.0f : 1.0f;
    beta[i] = (mirror ? (two_n - 1.0f) + off : -off) + margin;
  }
  const float a = m[0] * sig[0];
  const float bb = m[1] * sig[0];
  const float e = m[2] * sig[0] + beta[0];
  const float c = m[3] * sig[1];
  const float d = m[4] * sig[1];
  const float f = m[5] * sig[1] + beta[1];
  const float B = bb / d;
  co[0] = a - B * c;
  co[1] = B;
  co[2] = e - B * f;
  co[3] = c;
  co[4] = d;
  co[5] = f;
}

__device__ __forceinline__ void unpack3(int v, float out[3]) {
  out[0] = (float)((v >> 16) & 0xFF);
  out[1] = (float)((v >> 8) & 0xFF);
  out[2] = (float)(v & 0xFF);
}

__device__ __forceinline__ int pack3(float r, float g, float b) {
  return ((int)r << 16) | ((int)g << 8) | (int)b;
}

// Pass 1 at absolute slab row w: the horizontal lerp at u. BANDED (the
// standalone resampler) reads 0 for a tap outside [lo, hi), as the TPU
// kernel's banded scan does; the scene kernel's calls are unbanded.
template <bool BANDED = false>
__device__ __forceinline__ void pass1_row(const int* __restrict__ slab,
                                          int SW, int w, int c0, int CW,
                                          const float co[6], float xf,
                                          float out[3], int lo = 0,
                                          int hi = 0) {
  const float wg = (float)w;
  const float u = clipf((co[0] * xf + co[1] * wg) + co[2], 0.0f,
                        (float)(CW - 1));
  const float uf = floorf(u);
  const float fx = u - uf;
  const int u0 = (int)uf;
  const int u1 = min(u0 + 1, CW - 1);
  const int* row = slab + (size_t)w * SW + c0;
  float a0[3], a1[3];
  if constexpr (BANDED) {
    unpack3(u0 >= lo && u0 < hi ? __ldg(row + u0) : 0, a0);
    unpack3(u1 >= lo && u1 < hi ? __ldg(row + u1) : 0, a1);
  } else {
    unpack3(__ldg(row + u0), a0);
    unpack3(__ldg(row + u1), a1);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = a0[ch] + (a1[ch] - a0[ch]) * fx;
}

// The two-pass resample of output pixel (x, y) from the row block
// [w0, w0+P) x [c0, c0+CW) of a width-SW slab.
__device__ __forceinline__ void two_pass_pixel(const int* __restrict__ slab,
                                               int SW, int w0, int c0, int CW,
                                               int P, const float co[6],
                                               int x, int y, float out[3]) {
  const float xf = (float)x, yf = (float)y;
  float v = ((co[3] * xf + co[4] * yf) + co[5]) - (float)w0;
  v = clipf(v, 0.0f, (float)(P - 1));
  const float vf = floorf(v);
  const float fy = v - vf;
  const int v0 = (int)vf;
  const int v1 = min(v0 + 1, P - 1);
  float q0[3], q1[3];
  pass1_row(slab, SW, w0 + v0, c0, CW, co, xf, q0);
  pass1_row(slab, SW, w0 + v1, c0, CW, co, xf, q1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = q0[ch] + (q1[ch] - q0[ch]) * fy;
}

}  // namespace flowgen
