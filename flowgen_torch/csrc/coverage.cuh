// Exact-area coverage per pixel: the device twin of flowgen_torch/ops/raster.py
// (and of the JAX package's ops/raster.py and ops/pallas_raster.py).
//
// Every expression keeps the JAX package's order of operations, and the file
// is compiled with -fmad=false, so no product is contracted into an FMA:
// XLA:CPU, which produces the reference values, does not contract either.
// Float constants are the float32 roundings of the JAX package's Python
// constants, written as hex literals.
#pragma once

namespace flowgen {

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Signed cell-area contribution of edge (a -> b) to the unit cell whose
// lower-left corner is (xlo, ylo): the 3-piece trapezoid of the JAX kernel's
// _area_accumulate_blocked, with p/q face-crossing breakpoints and the
// unclamped midpoint.
__device__ __forceinline__ float edge_contrib(float ax, float ay, float bx,
                                              float by, float xlo, float ylo) {
  const float dx = bx - ax;
  const float dy = by - ay;
  const float eps = 0x1.197998p-40f;  // float32(1e-12)
  const float inv_dy = fabsf(dy) > eps ? 1.0f / dy : 0.0f;
  const float inv_dx = fabsf(dx) > eps ? 1.0f / dx : 0.0f;
  const float s0 = (xlo - ax) * inv_dx;
  const float s1 = ((xlo + 1.0f) - ax) * inv_dx;
  const float smin = fminf(s0, s1);
  const float smax = fmaxf(s0, s1);
  const float hmid = ax - xlo;
  const float hdx = 0.5f * dx;
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
