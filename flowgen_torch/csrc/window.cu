// The windowed renderer's kernels on NVIDIA Hopper: one object's window pass
// and standalone exact-area polygon coverage.
//
// Replaces flowgen/ops/pallas_raster.py:
//   * object_window_kernel    <- _make_object_window_kernel (pallas_call in
//     object_window_pallas);
//   * polygon_coverage_kernel <- _kernel (pallas_call in
//     polygon_coverage_pallas).
//
// The TPU kernels run once per object window with the window in VMEM and the
// tables in SMEM. Here one launch takes a batch of windows, one per sample
// (the renderer batches windows of one painter rank, which lie in different
// samples, so painter's order holds per pixel): one CTA per (window, 8x32
// tile), the window's tables staged in shared memory, one pixel per thread.
// object_window reads and writes the frame and flow planes in place at the
// window's origin, and reads its texture straight from the quad-packed atlas:
// frame 0 copies the object's centre crop, frame 1 samples the crop at the
// motion-inverse positions with the reflect fold (the JAX renderer's XLA
// sample_bilinear_quad, here inside the kernel).
//
// Both are bound by operations on this card: a window pixel evaluates about
// 45 float operations for each edge of each polygon primitive (190 for an
// ellipse) against 52 bytes of planes (object_window) or 16 bytes of grids
// and outputs (polygon_coverage). So the edge table sits in shared memory,
// the edge loop reads no device memory, and each pixel's planes are read
// and written once. The loops are not culled by rows as the TPU kernel's
// blocked variant is; that and splitting a pixel's edges across threads are
// later work.
//
// Both sum a polygon's edges 0..n_edges-1 in order, as the dense
// _area_accumulate does; coverage.cuh:edge_contrib is that loop body for a
// cell whose lower-left corner is (xlo, ylo) = (centre - 0.5). The file is
// compiled with -fmad=false and keeps the JAX order of operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coverage.cuh"

namespace flowgen {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kMaxComps = 7;
constexpr int kMaxEdges = 120;
constexpr int kMeta = 3 + 3 * kMaxComps;   // n_prims, x0, y0, add[C], poly[C], ne[C]
constexpr int kFmeta = 6 + 8 * kMaxComps;  // motion, (inverse, rx, ry)[C]
constexpr int kWin = 4;                    // batch index, wh, ww, texture id

// jnp.remainder for floats: fmod, then the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

// texture.py:_reflect_fold_coord.
__device__ __forceinline__ float reflect_fold(float x, float n) {
  const float period = 2.0f * n;
  const float u = floor_mod(x + 0.5f, period);
  const float xr = u < n ? u - 0.5f : (period - u) - 0.5f;
  const bool in_range = x >= 0.0f && x <= n - 1.0f;
  return in_range ? x : clipf(xr, 0.0f, n - 1.0f);
}

// sample_bilinear_quad (reflect) of texture `tex` restricted to its (H, W)
// crop at (cy0, cx0) of a (SH, SW) quad-packed layer.
__device__ __forceinline__ void sample_quad(const uint8_t* __restrict__ atlas,
                                            int tex, int SH, int SW, int cy0,
                                            int cx0, int H, int W, float x,
                                            float y, float out[3]) {
  x = reflect_fold(x, (float)W);
  y = reflect_fold(y, (float)H);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int xi = min(max((int)x0f, 0), W - 1);
  const int yi = min(max((int)y0f, 0), H - 1);
  const uint8_t* row =
      atlas + (((size_t)tex * SH + cy0 + yi) * SW + cx0 + xi) * 12;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float p00 = (float)row[ch];
    const float p01 = (float)row[3 + ch];
    const float p10 = (float)row[6 + ch];
    const float p11 = (float)row[9 + ch];
    const float top = p00 + (p01 - p00) * fx;
    const float bot = p10 + (p11 - p10) * fx;
    out[ch] = top + (bot - top) * fy;
  }
}

// One object's window pass per window: coverage over its primitives with the
// composite screen algebra, round(f (1 - m) + t m), and the flow overwrite
// under the binary mask. Block (32, 8); grid (tiles of the largest window,
// windows).
__global__ void __launch_bounds__(kTileW* kTileH)
    object_window_kernel(const float* __restrict__ edges,
                         const int* __restrict__ meta,
                         const float* __restrict__ fmeta,
                         const int* __restrict__ win,
                         const uint8_t* __restrict__ atlas, float* frames,
                         float* flow, int B, int H, int W, int T, int SH,
                         int SW, int cy0, int cx0, int tiles_x,
                         int tex_sampled, int use_aa, int emit_flow) {
  __shared__ float s_edges[4 * kMaxComps * kMaxEdges];
  __shared__ int s_meta[kMeta];
  __shared__ float s_fmeta[kFmeta];
  const int w = blockIdx.y;
  const int b = win[w * kWin + 0];
  const int wh = win[w * kWin + 1];
  const int ww = win[w * kWin + 2];
  const int tex = win[w * kWin + 3];
  const int ty = blockIdx.x / tiles_x;
  const int tx = blockIdx.x % tiles_x;
  // Windows outside the planes or the atlas are skipped whole (the
  // renderer never passes one; this keeps every access in bounds).
  if (ty * kTileH >= wh || tx * kTileW >= ww || b < 0 || b >= B || tex < 0 ||
      tex >= T)
    return;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthreads = kTileW * kTileH;
  for (int i = tid; i < kMeta; i += nthreads) s_meta[i] = meta[w * kMeta + i];
  for (int i = tid; i < kFmeta; i += nthreads) s_fmeta[i] = fmeta[w * kFmeta + i];
  const int ce = kMaxComps * kMaxEdges;
  for (int i = tid; i < 4 * ce; i += nthreads) s_edges[i] = edges[(size_t)w * 4 * ce + i];
  __syncthreads();

  const int i = ty * kTileH + threadIdx.y;
  const int j = tx * kTileW + threadIdx.x;
  if (i >= wh || j >= ww) return;
  const int n_prims = min(s_meta[0], kMaxComps);
  const int x0 = s_meta[1];
  const int y0 = s_meta[2];
  if (y0 < 0 || x0 < 0 || y0 + wh > H || x0 + ww > W) return;
  const float px = (float)j + (float)x0;
  const float py = (float)i + (float)y0;
  const float cx = px + 0.5f;
  const float cy = py + 0.5f;
  const float xlo = cx - 0.5f;
  const float ylo = cy - 0.5f;

  float acc_aa = 0.0f;
  int acc_in = 0;
  for (int c = 0; c < n_prims; ++c) {
    float aa;
    int ins;
    if (s_meta[3 + kMaxComps + c] != 0) {
      const int ne = min(s_meta[3 + 2 * kMaxComps + c], kMaxEdges);
      const int base = c * kMaxEdges;
      float area = 0.0f;
      for (int e = 0; e < ne; ++e) {
        area = area + edge_contrib(s_edges[base + e], s_edges[ce + base + e],
                                   s_edges[2 * ce + base + e],
                                   s_edges[3 * ce + base + e], xlo, ylo);
      }
      area = fabsf(area);
      aa = fminf(area, 1.0f);
      ins = area >= 0.5f ? 1 : 0;
    } else {
      const float* f = s_fmeta + 6 + c * 8;
      const float rx_e = f[6];
      const float ry_e = f[7];
      const float ux = ((f[0] * cx + f[1] * cy) + f[2]) / rx_e;
      const float uy = ((f[3] * cx + f[4] * cy) + f[5]) / ry_e;
      aa = ellipse_chord_coverage(ux, uy, f[0] / rx_e, f[1] / rx_e,
                                  f[3] / ry_e, f[4] / ry_e);
      ins = aa >= 0.5f ? 1 : 0;
    }
    if (s_meta[3 + c] != 0) {
      acc_aa = 1.0f - (1.0f - acc_aa) * (1.0f - aa);
      acc_in = max(acc_in, ins);
    } else {
      acc_aa = acc_aa * (1.0f - aa);
      acc_in = acc_in * (1 - ins);
    }
  }

  const bool inside = acc_in != 0;
  const float m = use_aa ? acc_aa : (inside ? 1.0f : 0.0f);
  const int gy = y0 + i;
  const int gx = x0 + j;
  float t[3];
  if (tex_sampled) {
    const float* mm = s_fmeta;
    const float sx = (mm[0] * px + mm[1] * py) + mm[2];
    const float sy = (mm[3] * px + mm[4] * py) + mm[5];
    sample_quad(atlas, tex, SH, SW, cy0, cx0, H, W, sx, sy, t);
  } else {
    const uint8_t* row =
        atlas + (((size_t)tex * SH + cy0 + gy) * SW + cx0 + gx) * 12;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) t[ch] = (float)row[ch];
  }
  float* fp = frames + (((size_t)b * H + gy) * W + gx) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    fp[ch] = rintf(fp[ch] * (1.0f - m) + t[ch] * m);
  }
  if (emit_flow) {
    const float* mm = s_fmeta;
    const float ofx = ((mm[0] * px + mm[1] * py) + mm[2]) - px;
    const float ofy = ((mm[3] * px + mm[4] * py) + mm[5]) - py;
    const float mi = inside ? 1.0f : 0.0f;
    float* fl = flow + (((size_t)b * H + gy) * W + gx) * 2;
    fl[0] = ofx * mi + fl[0] * (1.0f - mi);
    fl[1] = ofy * mi + fl[1] * (1.0f - mi);
  }
}

// Exact-area coverage of one closed outline per window over its sample
// grid: edges (N, 4, E) with the closing edge already forced, n_edges (N),
// px / py (N, npix). Block 256; grid (npix / 256, N).
__global__ void __launch_bounds__(256)
    polygon_coverage_kernel(const float* __restrict__ edges,
                            const int* __restrict__ n_edges,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ aa, uint8_t* __restrict__ inside,
                            int E, int npix) {
  __shared__ float s_edges[4 * kMaxEdges];
  const int w = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * E; i += blockDim.x)
    s_edges[i] = edges[(size_t)w * 4 * E + i];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const size_t at = (size_t)w * npix + p;
  const float xlo = px[at] - 0.5f;
  const float ylo = py[at] - 0.5f;
  const int ne = min(n_edges[w], E);
  float area = 0.0f;
  for (int e = 0; e < ne; ++e) {
    area = area + edge_contrib(s_edges[e], s_edges[E + e], s_edges[2 * E + e],
                               s_edges[3 * E + e], xlo, ylo);
  }
  area = fabsf(area);
  aa[at] = fminf(area, 1.0f);
  inside[at] = area >= 0.5f ? 1 : 0;
}

}  // namespace flowgen

extern "C" int flowgen_object_window(const float* edges, const int* meta,
                                     const float* fmeta, const int* win,
                                     const uint8_t* atlas, float* frames,
                                     float* flow, int N, int B, int H, int W,
                                     int T, int SH, int SW, int cy0, int cx0,
                                     int max_wh,
                                     int max_ww, int C, int E, int tex_sampled,
                                     int use_aa, int emit_flow, void* stream) {
  using namespace flowgen;
  if (C != kMaxComps || E != kMaxEdges || N <= 0 || max_wh <= 0 ||
      max_ww <= 0 || (emit_flow && flow == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (max_ww + kTileW - 1) / kTileW;
  const int tiles_y = (max_wh + kTileH - 1) / kTileH;
  const dim3 block(kTileW, kTileH);
  const dim3 grid(tiles_x * tiles_y, N);
  object_window_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      edges, meta, fmeta, win, atlas, frames, flow, B, H, W, T, SH, SW, cy0,
      cx0, tiles_x, tex_sampled, use_aa, emit_flow);
  return (int)cudaGetLastError();
}

extern "C" int flowgen_polygon_coverage(const float* edges, const int* n_edges,
                                        const float* px, const float* py,
                                        float* aa, uint8_t* inside, int N,
                                        int E, int npix, void* stream) {
  if (E > flowgen::kMaxEdges || N <= 0 || npix <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((npix + 255) / 256, N);
  flowgen::polygon_coverage_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      edges, n_edges, px, py, aa, inside, E, npix);
  return (int)cudaGetLastError();
}
