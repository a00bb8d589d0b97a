// Exact-area coverage per pixel: the device twin of flowgen_torch/ops/raster.py
// (and of the JAX package's ops/raster.py and ops/pallas_raster.py).
//
// Every expression keeps the JAX package's order of operations, and the file
// is compiled with -fmad=false, so no product is contracted into an FMA:
// XLA:CPU, which produces the reference values, does not contract either.
// Float constants are the float32 roundings of the JAX package's Python
// constants, written as hex literals.
#pragma once

#include <math.h>

namespace flowgen {

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Edge (a -> b) of an outline, split as the three kernels evaluate it: the
// pixel-independent constants once per edge (edge_record), then the signed
// cell-area term at each cell whose lower-left corner is (xlo, ylo)
// (edge_term): the 3-piece trapezoid of the JAX kernel's
// _area_accumulate_blocked, with p/q face-crossing breakpoints and the
// unclamped midpoint. edge_term(edge_record(a, b), xlo, ylo) is the JAX
// loop body bit for bit: the constants are the same expressions, computed
// once.
//
// Exact culls, shared by object_window, polygon_coverage and the scene
// kernel. Each skips only terms that are +-0 for the cells it skips, and a
// cell's area, a sum from +0 in edge order, is never -0, so leaving out a
// +-0 term changes no bit:
//  * rows: with ylo >= max(ay, by) + kEdgeMargin or ylo + 1 <= min(ay, by)
//    - kEdgeMargin both r0 and r1 lie beyond the same end of [0, 1] (or
//    inv_dy is 0), so ta == tb and every piece of the integral is 0
//    (pallas_raster.py:_area_accumulate_blocked culls the same rows);
//  * columns: with xlo >= max(ax, bx) + kEdgeMargin the cell lies right of
//    the edge: p == q at ta or tb and the remaining piece's weight, ga or
//    gb = clip(x(t) - xlo, 0, 1), is 0.
// The facts hold from 1 px (tests/test_torch_cull.py); the kernels cut from
// 2 px. An edge with an endpoint that is not finite is never cut.
constexpr float kEdgeMargin = 2.0f;

// rec[0] = (ax, ay, dx, dy), rec[1] = (inv_dx, inv_dy, 0.5 dx, xcut),
// rec[2] = (ycut_lo, ycut_hi, -, -).
__device__ __forceinline__ void edge_record(float ax, float ay, float bx,
                                            float by, float4 rec[3]) {
  const float dx = bx - ax;
  const float dy = by - ay;
  const float eps = 0x1.197998p-40f;  // float32(1e-12)
  const float inv_dy = fabsf(dy) > eps ? 1.0f / dy : 0.0f;
  const float inv_dx = fabsf(dx) > eps ? 1.0f / dx : 0.0f;
  float xcut = fmaxf(ax, bx) + kEdgeMargin;
  float ylc = fminf(ay, by) - kEdgeMargin;
  float yhc = fmaxf(ay, by) + kEdgeMargin;
  if (!(isfinite(ax) && isfinite(ay) && isfinite(bx) && isfinite(by))) {
    xcut = yhc = INFINITY;
    ylc = -INFINITY;
  }
  rec[0] = make_float4(ax, ay, dx, dy);
  rec[1] = make_float4(inv_dx, inv_dy, 0.5f * dx, xcut);
  rec[2] = make_float4(ylc, yhc, 0.0f, 0.0f);
}

// Whether the edge can add a non-zero term to a cell whose rows lie in
// [ylo, yhi] (ylo its lowest lower-left corner, yhi its highest upper one).
__device__ __forceinline__ bool edge_rows_live(const float4& cut, float ylo,
                                               float yhi) {
  return !(ylo >= cut.y || yhi <= cut.x);
}

// Whether the edge (its rec[1]) can add a non-zero term to a cell whose
// lower-left x is at least xlo.
__device__ __forceinline__ bool edge_cols_live(const float4& r1, float xlo) {
  return !(xlo >= r1.w);
}

// The edge's term at the cell whose lower-left corner is (xlo, ylo), from
// rec[0] and rec[1].
__device__ __forceinline__ float edge_term(const float4& r0v,
                                           const float4& r1v, float xlo,
                                           float ylo) {
  const float ax = r0v.x, ay = r0v.y, dx = r0v.z, dy = r0v.w;
  const float inv_dx = r1v.x, inv_dy = r1v.y, hdx = r1v.z;
  const float s0 = (xlo - ax) * inv_dx;
  const float s1 = ((xlo + 1.0f) - ax) * inv_dx;
  const float smin = fminf(s0, s1);
  const float smax = fmaxf(s0, s1);
  const float hmid = ax - xlo;
  const float r0 = (ylo - ay) * inv_dy;
  const float r1 = ((ylo + 1.0f) - ay) * inv_dy;
  const float ta = clipf(fminf(r0, r1), 0.0f, 1.0f);
  const float tb = clipf(fmaxf(r0, r1), 0.0f, 1.0f);
  const float xta = ax + ta * dx;
  const float xtb = ax + tb * dx;
  const float p = clipf(smin, ta, tb);
  const float q = clipf(smax, ta, tb);
  const float ga = clipf(xta - xlo, 0.0f, 1.0f);
  const float gb = clipf(xtb - xlo, 0.0f, 1.0f);
  const float mid = hmid + (p + q) * hdx;
  const float integral = (ga * (p - ta) + mid * (q - p)) + gb * (tb - q);
  return dy * integral;
}

// Ellipses: a cell ell_cull_m px beyond an ellipse's extent lies outside
// its sector chord's half-plane while the 100-gon's sagitta is under a
// pixel (ops/scene.py:ELL_CULL_M, ELL_R_MAX), in rows as the TPU kernel
// culls and, by the same argument, in columns, for ellipses no more than
// ell_aniso times longer than wide (a needle's chords reach further:
// tests/test_torch_cull.py). Both come from the launch (ops/window.py owns
// the policy). The extent is recovered from the stored inverse transform,
// so kEllSlack more is kept, and only well-conditioned ellipses under
// kEllRCull px are culled.
constexpr float kEllSlack = 1.0f;
constexpr float kEllRCull = 2000.0f;   // under ELL_R_MAX = 2026.6
constexpr float kEllCondCull = 64.0f;  // |L|_F |L^-1|_F of a culled ellipse
constexpr int kEll = 16;               // floats of an ellipse record

// An ellipse primitive's record from its fmeta row f (inverse 2x3, rx, ry):
// f, the Jacobian over the radii, and its cull box [xlo, xhi] x [ylo, yhi]
// in cell lower-left coordinates (infinite when it is not culled): cells
// ell_cull_m (+ kEllSlack) px beyond its extent, for axis ratios up to
// ell_aniso.
__device__ __forceinline__ void ellipse_record(const float* f, float* e,
                                               float ell_cull_m,
                                               float ell_aniso) {
  const float i00 = f[0], i01 = f[1], i02 = f[2];
  const float i10 = f[3], i11 = f[4], i12 = f[5];
  const float rx_e = f[6], ry_e = f[7];
  for (int k = 0; k < 8; ++k) e[k] = f[k];
  e[8] = i00 / rx_e;
  e[9] = i01 / rx_e;
  e[10] = i10 / ry_e;
  e[11] = i11 / ry_e;
  // The forward transform L = I^-1, centre -L i, half extents.
  const float det = i00 * i11 - i01 * i10;
  const float l00 = i11 / det, l01 = -i01 / det;
  const float l10 = -i10 / det, l11 = i00 / det;
  const float ecx = -(l00 * i02 + l01 * i12);
  const float ecy = -(l10 * i02 + l11 * i12);
  const float a = l00 * rx_e, b = l01 * ry_e, c = l10 * rx_e, d = l11 * ry_e;
  const float hx = sqrtf(a * a + b * b);
  const float hy = sqrtf(c * c + d * d);
  const float r = sqrtf(a * a + b * b + c * c + d * d);
  const float cond = sqrtf(i00 * i00 + i01 * i01 + i10 * i10 + i11 * i11) *
                     sqrtf(l00 * l00 + l01 * l01 + l10 * l10 + l11 * l11);
  // Axis ratio a of the screen ellipse: |J|_F^2 / |det J| = a + 1 / a.
  const float jf = e[8] * e[8] + e[9] * e[9] + e[10] * e[10] + e[11] * e[11];
  const float jdet = fabsf(e[8] * e[11] - e[9] * e[10]);
  const bool round_enough =
      jf <= (ell_aniso + 1.0f / ell_aniso) * jdet;
  const float m = ell_cull_m + kEllSlack;
  const bool cull = round_enough && r < kEllRCull && cond < kEllCondCull &&
                    isfinite(ecx) &&
                    isfinite(ecy) && isfinite(hx) && isfinite(hy);
  e[12] = cull ? (ecx - hx) - m : -INFINITY;   // cells with xlo + 1 <= e[12]
  e[13] = cull ? (ecx + hx) + m : INFINITY;    // cells with xlo >= e[13]
  e[14] = cull ? (ecy - hy) - m : -INFINITY;
  e[15] = cull ? (ecy + hy) + m : INFINITY;
}


// Whether ellipse record e can cover a cell whose rows lie in [ylo, yhi]
// (lowest lower-left, highest upper corner), and one whose columns lie in
// [xlo, xhi].
__device__ __forceinline__ bool ell_rows_live(const float* e, float ylo,
                                              float yhi) {
  return !(ylo >= e[15] || yhi <= e[14]);
}

__device__ __forceinline__ bool ell_cols_live(const float* e, float xlo,
                                              float xhi) {
  return !(xlo >= e[13] || xhi <= e[12]);
}

// int(floor(v)) as XLA converts it (saturating).
__device__ __forceinline__ int floor_i(float v) {
  return __float2int_rz(floorf(v));
}

// Unit direction of the centre of the 2*pi/100 sector holding (ux, uy):
// quadrant fold plus a binary search over sector rotations 16, 8, 4, 2, 1.
__device__ __forceinline__ void sector_center_dir(float ux, float uy,
                                                  float* nx_out,
                                                  float* ny_out) {
  float c = fabsf(ux);
  float s = fabsf(uy);
  float nx = 0x1.ffbf52p-1f;  // cos(delta / 2)
  float ny = 0x1.015122p-5f;  // sin(delta / 2)
  const float cas[5] = {0x1.1257e4p-1f, 0x1.c0ab44p-1f, 0x1.efea22p-1f,
                        0x1.fbf676p-1f, 0x1.fefd5cp-1f};
  const float sas[5] = {0x1.b04bc0p-1f, 0x1.ed50d6p-2f, 0x1.fd5120p-3f,
                        0x1.00aeb6p-3f, 0x1.0130a2p-4f};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float ca = cas[i];
    const float sa = sas[i];
    const bool pred = (s * ca - c * sa) >= 0.0f;
    const float c2 = c * ca + s * sa;
    const float s2 = s * ca - c * sa;
    const float nx2 = nx * ca - ny * sa;
    const float ny2 = ny * ca + nx * sa;
    if (pred) {
      c = c2;
      s = s2;
      nx = nx2;
      ny = ny2;
    }
  }
  *nx_out = ux >= 0.0f ? nx : -nx;
  *ny_out = uy >= 0.0f ? ny : -ny;
}

// Integral over [a, b] of clamp(m*t + c, 0, 1) dt (0 if b <= a).
__device__ __forceinline__ float clamped_line_integral(float m, float c,
                                                       float a, float b) {
  const float eps = 0x1.197998p-40f;  // float32(1e-12)
  const float inv_m = fabsf(m) > eps ? 1.0f / m : 0.0f;
  const float r0 = (0.0f - c) * inv_m;
  const float r1 = (1.0f - c) * inv_m;
  b = fmaxf(b, a);
  const float p = clipf(fminf(r0, r1), a, b);
  const float q = clipf(fmaxf(r0, r1), a, b);
  const float ga = clipf(m * a + c, 0.0f, 1.0f);
  const float gb = clipf(m * b + c, 0.0f, 1.0f);
  const float mid = c + (p + q) * (0.5f * m);
  return (ga * (p - a) + mid * (q - p)) + gb * (b - q);
}

__device__ __forceinline__ float break_eta(float ma, float ca, float mb,
                                           float cb) {
  const float dm = ma - mb;
  const bool parallel = fabsf(dm) <= 0x1.12e0bep-30f;  // float32(1e-9)
  const float side = ca <= cb ? 0x1.333334p-1f : -0x1.333334p-1f;  // 0.6
  return parallel ? side : (cb - ca) / dm;
}

// Exact area of the unit cell inside the intersection of three half-planes
// {p : n_i . (p - centre) <= -d_i}.
__device__ __forceinline__ float halfplanes3_cell_coverage(
    float d1, float nx1, float ny1, float d2, float nx2, float ny2, float d3,
    float nx3, float ny3) {
  const bool swap = fabsf(nx1) < fabsf(ny1);
  const float lead = swap ? ny1 : nx1;
  const float s = lead >= 0.0f ? 1.0f : -1.0f;
  float m[3], c[3];
  const float nxs[3] = {nx1, nx2, nx3};
  const float nys[3] = {ny1, ny2, ny3};
  const float ds[3] = {d1, d2, d3};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float A = swap ? nys[i] : nxs[i];
    const float B = swap ? nxs[i] : nys[i];
    const float invA = 1.0f / fmaxf(A * s, 0x1.0c6f7ap-20f);  // 1e-6
    m[i] = (-B * s) * invA;
    c[i] = (-ds[i]) * invA;
  }
  // 3-element sort network on slope, descending.
  auto cswap = [](float& ma, float& ca, float& mb, float& cb) {
    if (ma < mb) {
      float t = ma; ma = mb; mb = t;
      t = ca; ca = cb; cb = t;
    }
  };
  cswap(m[0], c[0], m[1], c[1]);
  cswap(m[1], c[1], m[2], c[2]);
  cswap(m[0], c[0], m[1], c[1]);
  const float t12 = break_eta(m[0], c[0], m[1], c[1]);
  const float t23 = break_eta(m[1], c[1], m[2], c[2]);
  const float t13 = break_eta(m[0], c[0], m[2], c[2]);
  const bool mid = t12 <= t23;
  const float ta = clipf(mid ? t12 : t13, -0.5f, 0.5f);
  const float tb = clipf(mid ? t23 : t13, ta, 0.5f);
  return (clamped_line_integral(m[0], c[0] + 0.5f, -0.5f, ta) +
          clamped_line_integral(m[1], c[1] + 0.5f, ta, tb)) +
         clamped_line_integral(m[2], c[2] + 0.5f, tb, 0.5f);
}

// Coverage of the inscribed 100-gon of the unit circle at normalised ellipse
// coordinates (ux, uy), screen Jacobian [[jxx, jxy], [jyx, jyy]]: the
// pixel's sector chord and both neighbours.
__device__ __forceinline__ float ellipse_chord_coverage(float ux, float uy,
                                                        float jxx, float jxy,
                                                        float jyx, float jyy) {
  float nxu, nyu;
  sector_center_dir(ux, uy, &nxu, &nyu);
  const float cosd = 0x1.fefd5cp-1f;
  const float sind = 0x1.0130a2p-4f;
  const float coshalf = 0x1.ffbf52p-1f;
  float d[3], a[3], b[3];
  const float nxs[3] = {nxu, nxu * cosd - nyu * sind, nxu * cosd + nyu * sind};
  const float nys[3] = {nyu, nyu * cosd + nxu * sind, nyu * cosd - nxu * sind};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float aa = nxs[i] * jxx + nys[i] * jyx;
    const float bb = nxs[i] * jxy + nys[i] * jyy;
    const float norm = fmaxf(sqrtf(aa * aa + bb * bb), 0x1.12e0bep-30f);
    const float l = (nxs[i] * ux + nys[i] * uy) - coshalf;
    d[i] = l / norm;
    a[i] = aa / norm;
    b[i] = bb / norm;
  }
  return halfplanes3_cell_coverage(d[0], a[0], b[0], d[1], a[1], b[1], d[2],
                                   a[2], b[2]);
}

}  // namespace flowgen
