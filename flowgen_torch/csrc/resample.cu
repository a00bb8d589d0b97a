// The standalone two-pass affine resampler on NVIDIA Hopper: a (wh, ww)
// window of a packed-RGB padded slab through an output -> slab affine.
//
// Replaces flowgen/ops/pallas_resample.py:affine_resample_pallas (its
// pallas_call stages the slab's whole rows [w0, w0+P) from
// pass1_row_start and runs resample_rows_in_kernel over them). Per pixel the
// two passes collapse into two_pass_pixel_banded: resample.cuh's pass 1 at
// rows floor(v) and floor(v) + 1, each tap read through the TPU kernel's
// band of its block (x_tiles_scan and y_tiles_scan tiles from the block's
// smallest tap, found at the block's corners once a CTA; a tap outside
// reads 0), so band widths too narrow for the affine give the JAX
// function's result too.
// The row start is pass1_row_start, the column window the whole slab width.
// Block (32, 8); grid over the window. Compiled with -fmad=false, as the
// scene kernel.
// Bound by bytes (the window written once, the slab texels of its footprint
// read once): 3.3 MB for a 384x512 window, a microsecond at the card's
// memory rate, so a call's time is mostly the launch's own cost and one
// round trip of reads and writes (PERF.md). The row start and the bands,
// uniform over a CTA, are computed once a CTA by its first threads, behind
// one barrier, not in every thread. Forms that resample 2 or 4 pixels a thread or write a row
// segment through shared memory as 16-byte stores read no faster, and an
// unpack of a texel's bytes through the float32 bit pattern 2^23 + byte
// saves under 0.0001 ms at any shape measured (PERF.md), so a thread keeps
// one pixel and resample.cuh's arithmetic. Staging a row band in shared
// memory would not help either: a rotated row of the window spans tens of
// slab rows, while a pixel's 4 reads hit lines that its neighbours in the
// warp read too (L1).

#include <cuda_runtime.h>

#include "resample.cuh"

namespace flowgen {

struct Coeffs {
  float v[6];  // A, B, C, c, d, f
};

// The start of the TPU kernel's band of a block of positions
// (_banded_tap_pair): the band is the min(scan, n_src) of the n_src 128-lane
// tiles from the tile of the block's smallest left tap.
__device__ __forceinline__ int band_lo(int min_tap, int n_src, int scan) {
  const int nscan = min(scan, n_src);
  return max(min(min_tap >> 7, n_src - nscan), 0) * 128;
}

// The smallest and largest left tap of a block of positions p(x, y) =
// clip(((a x + b y) + e) - s, 0, lim) over x in [xa, xb], y in [ya, yb]:
// every rounding step is monotone in x and in y, so both lie at corners.
__device__ __forceinline__ void corner_taps(float a, float b, float e,
                                            float s, float lim, float xa,
                                            float xb, float ya, float yb,
                                            int& lo, int& hi) {
  auto tap = [&](float x, float y) {
    return (int)floorf(clipf(((a * x + b * y) + e) - s, 0.0f, lim));
  };
  const int t00 = tap(xa, ya), t01 = tap(xa, yb);
  const int t10 = tap(xb, ya), t11 = tap(xb, yb);
  lo = min(min(t00, t01), min(t10, t11));
  hi = max(max(t00, t01), max(t10, t11));
}

// Pass 1 reads rows [w0, w0+P) in chunks of 128 (the TPU kernel's
// PASS1_CHUNK); a launch takes at most kMaxChunks of them (one thread of
// the CTA's 256 a chunk, one for pass 2).
constexpr int kMaxChunks = 255;

// Output pixel (x0 + j, y0 + i) of resample_rows_in_kernel over the row
// block [w0, w0+P) of the whole slab width SW, every tap read through the
// band of its block: pass 1 blocks of (128-row chunk, 128-lane tile of the
// window), xscan slab tiles each; pass 2 blocks of (128 columns, 128 rows
// of the window), yscan tiles of the pass-1 rows (padded to 128) each. A
// tap outside its band reads 0. Inside the bands this is two_pass_pixel.
// A CTA's pixels lie in one tile of each pass, so its first threads find
// the bands once: lo2 of pass 2, lo1[c] of pass 1's chunk c.
__device__ __forceinline__ void two_pass_pixel_banded(
    const int* __restrict__ slab, int SW, int w0, int P, const float co[6],
    int x, int y, int lo2, int nscan2, const int* lo1, int nscan1,
    float out[3]) {
  const float xf = (float)x, yf = (float)y;
  float v = ((co[3] * xf + co[4] * yf) + co[5]) - (float)w0;
  v = clipf(v, 0.0f, (float)(P - 1));
  const float vf = floorf(v);
  const float fy = v - vf;
  const int v0 = (int)vf;
  const int v1 = min(v0 + 1, P - 1);
  float q[2][3];
  const int rows[2] = {v0, v1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = rows[e];
    if (r < lo2 || r >= lo2 + nscan2 * 128) {
      q[e][0] = q[e][1] = q[e][2] = 0.0f;
      continue;
    }
    const int lo = lo1[r >> 7];
    pass1_row<true>(slab, SW, w0 + r, 0, SW, co, xf, q[e], lo,
                    lo + nscan1 * 128);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = q[0][ch] + (q[1][ch] - q[0][ch]) * fy;
}

__global__ void __launch_bounds__(256)
    affine_resample_kernel(const int* __restrict__ slab, Coeffs coeffs,
                           float* __restrict__ out, int SH, int SW, int x0,
                           int y0, int wh, int ww, int P, int xscan,
                           int yscan) {
  float co[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) co[k] = coeffs.v[k];
  // One barrier: each of the first n_chunks + 1 threads finds the row
  // start itself, then its band, and whether every tap of this CTA's
  // pixels that its band governs lies inside it; thread 0 also publishes
  // the row start. A CTA whose taps all lie inside (the common case) runs
  // the unbanded two_pass_pixel, which then reads the same texels.
  __shared__ int w0_s, lo2_s, lo1_s[kMaxChunks];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int n_chunks = (P + 127) / 128;
  const int nscan1 = min(xscan, SW / 128), nscan2 = min(yscan, n_chunks);
  const int ja = blockIdx.x * 32, ia = blockIdx.y * 8;
  const float bx = (float)(x0 + (ja & ~127));
  const float by = (float)(y0 + (ia & ~127));
  bool inside = true;
  if (tid <= n_chunks) {
    const int w0 = pass1_row_start(co, x0, y0, wh, ww, P, SH);
    if (tid == 0) w0_s = w0;
    // This CTA's pixels and the pass-1 rows [ra, rb] they read.
    const float xa = (float)(x0 + ja), xb = (float)(x0 + min(ja + 31, ww - 1));
    const float ya = (float)(y0 + ia), yb = (float)(y0 + min(ia + 7, wh - 1));
    int ra, rb;
    corner_taps(co[3], co[4], co[5], (float)w0, (float)(P - 1), xa, xb, ya,
                yb, ra, rb);
    rb = min(rb + 1, P - 1);
    if (tid < n_chunks) {
      const int r0 = tid * 128, r1 = min(r0 + 128, P) - 1;
      int tmin, tmax;
      corner_taps(co[0], co[1], co[2], 0.0f, (float)(SW - 1), bx,
                  bx + 127.0f, (float)(w0 + r0), (float)(w0 + r1), tmin, tmax);
      const int lo = band_lo(tmin, SW / 128, xscan);
      lo1_s[tid] = lo;
      const int qa = max(ra, r0), qb = min(rb, r1);
      if (qa <= qb) {
        corner_taps(co[0], co[1], co[2], 0.0f, (float)(SW - 1), xa, xb,
                    (float)(w0 + qa), (float)(w0 + qb), tmin, tmax);
        inside = tmin >= lo && min(tmax + 1, SW - 1) < lo + nscan1 * 128;
      }
    } else {
      int tmin, tmax;
      corner_taps(co[3], co[4], co[5], (float)w0, (float)(P - 1), bx,
                  bx + 127.0f, by, by + 127.0f, tmin, tmax);
      const int lo = band_lo(tmin, n_chunks, yscan);
      lo2_s = lo;
      inside = ra >= lo && rb < lo + nscan2 * 128;
    }
  }
  const bool all_inside = __syncthreads_and(inside);
  const int j = ja + threadIdx.x;
  const int i = ia + threadIdx.y;
  if (i >= wh || j >= ww) return;
  float v[3];
  if (all_inside)
    two_pass_pixel(slab, SW, w0_s, 0, SW, P, co, x0 + j, y0 + i, v);
  else
    two_pass_pixel_banded(slab, SW, w0_s, P, co, x0 + j, y0 + i, lo2_s,
                          nscan2, lo1_s, nscan1, v);
  float* o = out + ((size_t)i * ww + j) * 3;
  o[0] = v[0];
  o[1] = v[1];
  o[2] = v[2];
}

}  // namespace flowgen

// The six coefficients come by value, so a call copies nothing to the card.
// xscan and yscan are the band widths in 128-lane tiles of the JAX kernel's
// passes (x_tiles_scan, y_tiles_scan); SW and ww are multiples of 128.
extern "C" int flowgen_affine_resample(const int* slab, float A, float B,
                                       float C, float c, float d, float f,
                                       float* out, int SH, int SW, int x0,
                                       int y0, int wh, int ww, int P,
                                       int xscan, int yscan, void* stream) {
  if (wh <= 0 || ww <= 0 || P <= 0 || P > SH || SW % 128 || ww % 128 ||
      xscan <= 0 || yscan <= 0 || P > 128 * flowgen::kMaxChunks)
    return (int)cudaErrorInvalidValue;
  const flowgen::Coeffs co = {{A, B, C, c, d, f}};
  const dim3 block(32, 8);
  const dim3 grid((ww + 31) / 32, (wh + 7) / 8);
  flowgen::affine_resample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      slab, co, out, SH, SW, x0, y0, wh, ww, P, xscan, yscan);
  return (int)cudaGetLastError();
}
