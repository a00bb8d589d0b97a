// Warp-field composition kernels of the mode-9 bank producer, on NVIDIA
// Hopper: the coarse column-inverse solve and the row-tiled horizontal warp.
//
// Replaces flowgen/warpfields/pallas_fields.py:
//   * coarse_solve_kernel <- _coarse_solve_kernel (pallas_call in
//     coarse_gdisp_batch);
//   * hwarp_rows_kernel   <- _hwarp_kernel (pallas_call in _hwarp_rows).
//
// Both read their two bilinear taps per element through the TPU kernels'
// banded rule (ops/pallas_resample.py:_banded_tap_pair): per block of
// positions (all rows of a field x 128 lanes for the solve, row_tile x 128
// for the warp) a band of `scan` 128-lane source tiles starts at the tile of
// the block's smallest left tap, and a tap outside it reads 0. So one CTA
// owns one block: it reduces the block's smallest tap index, then computes.
// The bank's 17 doublings are chaotic, so the lerp keeps the JAX package's
// det_lerp exactly (p0 + round((p1 - p0) * t)), and the file is compiled
// with -fmad=false.
//
// What bounds them. hwarp_rows must move 4 + 4 + 4/C bytes an element of
// (M, C, R, Sp) planes (read the plane, write the result, and read the
// displacement row that the field's C channels share once: 10 bytes for the
// bank's C = 2) and does a few operations, so bytes bound it; this version
// reads the displacement once per channel and twice per pass (the block
// minimum, then the lerp), 16 bytes an element. The coarse solve is a small
// sequential fixed point (9 lookups along each coarse column): one CTA per
// (field, 128-lane tile), latency-bound, a small part of a doubling.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace flowgen {

constexpr int kLanes = 128;
constexpr int kRowsPerPass = 8;   // blockDim.y

__device__ __forceinline__ int block_min_int(int v, int* smem) {
  if (threadIdx.x == 0 && threadIdx.y == 0) *smem = INT_MAX;
  __syncthreads();
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMin(smem, v);
  __syncthreads();
  const int r = *smem;
  __syncthreads();
  return r;
}

// Left tap index of position u clipped to [0, wv - 1].
__device__ __forceinline__ int left_tap(float u, int wv) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(wv - 1));
  return (int)floorf(uc);
}

// det_lerp of the banded taps of row `row` at position u (clamped).
__device__ __forceinline__ float banded_lerp_clamped(const float* __restrict__ row,
                                                     float u, int wv, int lo,
                                                     int hi) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(wv - 1));
  const float uf = floorf(uc);
  const float fx = __fsub_rn(uc, uf);
  const int u0 = (int)uf;
  const int u1 = min(u0 + 1, wv - 1);
  const float p0 = (u0 >= lo && u0 < hi) ? __ldg(row + u0) : 0.0f;
  const float p1 = (u1 >= lo && u1 < hi) ? __ldg(row + u1) : 0.0f;
  return __fadd_rn(p0, __fmul_rn(__fsub_rn(p1, p0), fx));
}

__device__ __forceinline__ void band_of(int min_u0, int n_src, int scan,
                                        int* lo, int* hi) {
  const int nscan = min(scan, n_src);
  const int tile0 = max(min(min_u0 >> 7, n_src - nscan), 0);
  *lo = tile0 * kLanes;
  *hi = *lo + nscan * kLanes;
}

// gd[n, x, w] = dx[n, x, y*] with w = y* + dy[n, x, y*]: n_iter fixed-point
// lerps d <- dy(w - d) along each row, then dx(w - d). Block (128, 8); grid
// (Lp / 128, N). d lives in `out` between iterations (each element is read
// and rewritten by its own thread; barriers separate the iterations).
__global__ void __launch_bounds__(kLanes* kRowsPerPass)
    coarse_solve_kernel(const float* __restrict__ dy,
                        const float* __restrict__ dx, float* out, int R,
                        int Lp, int Lv, int n_iter, int scan) {
  __shared__ int smin;
  const int n = blockIdx.y;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const float wpos = (float)lane;
  const size_t base = (size_t)n * R * Lp;
  const int n_src = Lp / kLanes;
  for (int r = threadIdx.y; r < R; r += kRowsPerPass) out[base + (size_t)r * Lp + lane] = 0.0f;
  __syncthreads();
  for (int it = 0; it <= n_iter; ++it) {
    const float* src = it < n_iter ? dy : dx;
    int m = INT_MAX;
    for (int r = threadIdx.y; r < R; r += kRowsPerPass) {
      const float d = out[base + (size_t)r * Lp + lane];
      m = min(m, left_tap(__fsub_rn(wpos, d), Lv));
    }
    int lo, hi;
    band_of(block_min_int(m, &smin), n_src, scan, &lo, &hi);
    for (int r = threadIdx.y; r < R; r += kRowsPerPass) {
      const size_t at = base + (size_t)r * Lp + lane;
      const float d = out[at];
      out[at] = banded_lerp_clamped(src + base + (size_t)r * Lp,
                                    __fsub_rn(wpos, d), Lv, lo, hi);
    }
    __syncthreads();
  }
}

// out[g, x] = lerp of row g of `src` at x + disp[row(g), x], clamped to the
// row, over G stacked rows of width Sp. Row g = (m * C + c) * R + r of the
// (M, C, R, Sp) planes shares displacement row m * R + r. Block (128, 8);
// grid (Sp / 128, G / row_tile).
__global__ void __launch_bounds__(kLanes* kRowsPerPass)
    hwarp_rows_kernel(const float* __restrict__ src,
                      const float* __restrict__ disp, float* __restrict__ out,
                      int Sp, int CR, int R, int row_tile, int scan) {
  __shared__ int smin;
  const int x = blockIdx.x * kLanes + threadIdx.x;
  const int g0 = blockIdx.y * row_tile;
  const float xf = (float)x;
  int m = INT_MAX;
  for (int i = threadIdx.y; i < row_tile; i += kRowsPerPass) {
    const int g = g0 + i;
    const size_t drow = (size_t)(g / CR) * R + (g % R);
    m = min(m, left_tap(__fadd_rn(xf, __ldg(disp + drow * Sp + x)), Sp));
  }
  int lo, hi;
  band_of(block_min_int(m, &smin), Sp / kLanes, scan, &lo, &hi);
  for (int i = threadIdx.y; i < row_tile; i += kRowsPerPass) {
    const int g = g0 + i;
    const size_t drow = (size_t)(g / CR) * R + (g % R);
    const float u = __fadd_rn(xf, __ldg(disp + drow * Sp + x));
    out[(size_t)g * Sp + x] =
        banded_lerp_clamped(src + (size_t)g * Sp, u, Sp, lo, hi);
  }
}

}  // namespace flowgen

extern "C" int flowgen_coarse_solve(const float* dy, const float* dx,
                                    float* out, int N, int R, int Lp, int Lv,
                                    int n_iter, int scan, void* stream) {
  if (Lp % flowgen::kLanes || N <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(flowgen::kLanes, flowgen::kRowsPerPass);
  const dim3 grid(Lp / flowgen::kLanes, N);
  flowgen::coarse_solve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dy, dx, out, R, Lp, Lv, n_iter, scan);
  return (int)cudaGetLastError();
}

extern "C" int flowgen_hwarp_rows(const float* src, const float* disp,
                                  float* out, int G, int Sp, int CR, int R,
                                  int row_tile, int scan, void* stream) {
  if (Sp % flowgen::kLanes || G % row_tile || row_tile % flowgen::kRowsPerPass)
    return (int)cudaErrorInvalidValue;
  const dim3 block(flowgen::kLanes, flowgen::kRowsPerPass);
  const dim3 grid(Sp / flowgen::kLanes, G / row_tile);
  flowgen::hwarp_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, disp, out, Sp, CR, R, row_tile, scan);
  return (int)cudaGetLastError();
}
