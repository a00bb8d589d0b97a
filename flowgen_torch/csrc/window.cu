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
// samples, so painter's order holds per pixel and no two CTAs write one
// pixel). object_window reads and writes the frame and flow planes in place
// at the window's origin, and reads its texture straight from the
// quad-packed atlas: frame 0 copies the object's centre crop, frame 1
// samples the crop at the motion-inverse positions with the reflect fold
// (the JAX renderer's XLA sample_bilinear_quad, here inside the kernel).
//
// What bounds them. A window pixel evaluates about 45 float operations for
// each edge of each polygon primitive (190 for an ellipse) against at most
// 52 bytes of planes (object_window) or 13 bytes of grids and outputs
// (polygon_coverage). Evaluated densely that is operations; but most
// windows are full frames around objects that cover a small part of them,
// and most (edge, pixel) terms are exactly +-0: every row outside the
// edge's y-span, every cell right of the edge. Both kernels therefore
// evaluate only the terms that can be non-zero (coverage.cuh's culls) and
// stage only the surviving edges with their pixel-independent constants,
// not the whole padded table. object_window works on 8 x 128 tiles, shares
// each edge's row terms across a row's pixels, and leaves the planes of a
// pixel group untouched when nothing reached it; what remains is the
// surviving terms' arithmetic, the I/O of the pixels the object reaches,
// and a prologue per tile (the tables' staging and two barriers per polygon
// primitive) that every tile of the largest window pays, reached or not.
// polygon_coverage works on 8 x 32 tiles of its grid, closes the outline
// itself (its wrapper launches nothing but the output allocations), and
// writes every point: its bytes are the grid's and the outputs'.
//
// Both sum a polygon's edges 0..n_edges-1 in order, as the dense
// _area_accumulate does, one pixel's sum on one thread (skipped terms are
// +-0); coverage.cuh:edge_term is that loop body for a cell whose
// lower-left corner is (xlo, ylo) = (centre - 0.5), and object_window splits
// it into its row and column parts with the same expressions. The file is
// compiled with -fmad=false and keeps the JAX order of operations.

#include <cuda_runtime.h>
#include <math.h>
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

// The culls (coverage.cuh: edges by rows and columns, ellipses by their
// extent) skip only terms that are +-0 or an ellipse coverage that is 0.
// A pixel group none of whose terms survived has m = +0, and the kernel
// neither reads nor writes it. That equals the dense blend for whole-valued
// frames (rintf(f * 1 + t * 0) = f; the renderer's frames hold whole
// values) up to the sign of a zero: where a frame or flow value is -0 the
// dense form may write +0 (-0 + +0), the kernel leaves -0.
constexpr int kOwGroups = 4;                        // 32-pixel groups a row
constexpr int kOwCols = 32 * kOwGroups;             // tile width

// One object's window pass per window: coverage over its primitives with the
// composite screen algebra, round(f (1 - m) + t m), and the flow overwrite
// under the binary mask. Block (32, 8): warp w takes tile row w, lane l the
// pixels l + 32 k, k < 4, of it. Grid (8 x 128 tiles of the largest window,
// windows). Per polygon primitive the CTA stages the edges that survive its
// tile's culls, in edge order; each warp culls them again for its row and
// per 32-pixel group and shares an edge's row terms (r0, r1, ta, tb and the
// crossings) across its pixels. At least 4 CTAs an SM (64 registers): the
// planes' I/O is latency-bound and wants the warps.
__global__ void __launch_bounds__(kTileW* kTileH, 4)
    object_window_kernel(const float* __restrict__ edges,
                         const int* __restrict__ meta,
                         const float* __restrict__ fmeta,
                         const int* __restrict__ win,
                         const uint8_t* __restrict__ atlas, float* frames,
                         float* flow, int B, int H, int W, int T, int SH,
                         int SW, int cy0, int cx0, int tiles_x,
                         int tex_sampled, int use_aa, int emit_flow,
                         float ell_cull_m, float ell_aniso) {
  __shared__ float4 s_rec[kMaxEdges][3];
  __shared__ float s_ell[kMaxComps][kEll];
  __shared__ int s_meta[kMeta];
  __shared__ int s_cnt[4];
  const int w = blockIdx.y;
  const int b = win[w * kWin + 0];
  const int wh = win[w * kWin + 1];
  const int ww = win[w * kWin + 2];
  const int tex = win[w * kWin + 3];
  const int i0 = (blockIdx.x / tiles_x) * kTileH;
  const int j0 = (blockIdx.x % tiles_x) * kOwCols;
  // Windows outside the planes or the atlas are skipped whole (the
  // renderer never passes one; this keeps every access in bounds).
  if (i0 >= wh || j0 >= ww || b < 0 || b >= B || tex < 0 || tex >= T) return;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kMeta; i += kTileW * kTileH) s_meta[i] = meta[w * kMeta + i];
  __syncthreads();
  const int n_prims = min(s_meta[0], kMaxComps);
  const int x0 = s_meta[1];
  const int y0 = s_meta[2];
  if (y0 < 0 || x0 < 0 || y0 + wh > H || x0 + ww > W) return;
  const float* fm = fmeta + (size_t)w * kFmeta;
  if (tid < n_prims && s_meta[3 + kMaxComps + tid] == 0)
    ellipse_record(fm + 6 + tid * 8, s_ell[tid], ell_cull_m, ell_aniso);
  __syncthreads();

  const int warp = threadIdx.y;
  const int lane = threadIdx.x;
  const int i = i0 + warp;
  const bool row_in = i < wh;
  // Cell lower-left corners: xlo = px, ylo = py (exact for whole px, py).
  const float t_ylo = (float)i0 + (float)y0;
  const float t_yhi = (float)min(i0 + kTileH, wh) + (float)y0;
  const float t_xlo = (float)j0 + (float)x0;
  const float ylo = (float)i + (float)y0;
  const float ylo1 = ylo + 1.0f;
  float xlo[kOwGroups], gx[kOwGroups], acc_aa[kOwGroups];
  int acc_in[kOwGroups];
#pragma unroll
  for (int k = 0; k < kOwGroups; ++k) {
    xlo[k] = (float)(j0 + lane + 32 * k) + (float)x0;
    gx[k] = (float)(j0 + 32 * k) + (float)x0;   // the group's smallest xlo
    acc_aa[k] = 0.0f;
    acc_in[k] = 0;
  }
  unsigned live = 0;   // bit k: a term of pixel group k survived

  const size_t ce = (size_t)kMaxComps * kMaxEdges;
  for (int c = 0; c < n_prims; ++c) {
    const bool additive = s_meta[3 + c] != 0;
    // The composite screen algebra for pixel group k and this primitive.
    auto combine = [&](int k, float aa, int ins) {
      if (additive) {
        acc_aa[k] = 1.0f - (1.0f - acc_aa[k]) * (1.0f - aa);
        acc_in[k] = max(acc_in[k], ins);
      } else {
        acc_aa[k] = acc_aa[k] * (1.0f - aa);
        acc_in[k] = acc_in[k] * (1 - ins);
      }
    };
    if (s_meta[3 + kMaxComps + c] != 0) {
      const int ne = min(s_meta[3 + 2 * kMaxComps + c], kMaxEdges);
      // Stage the edges that survive the tile's culls, in edge order.
      bool keep = false;
      float4 rec[3];
      if (tid < ne) {
        const float* eb = edges + (size_t)w * 4 * ce + c * kMaxEdges + tid;
        edge_record(eb[0], eb[ce], eb[2 * ce], eb[3 * ce], rec);
        keep = edge_rows_live(rec[2], t_ylo, t_yhi) &&
               edge_cols_live(rec[1], t_xlo);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (warp < 4 && lane == 0) s_cnt[warp] = __popc(bal);
      __syncthreads();
      const int n_kept = s_cnt[0] + s_cnt[1] + s_cnt[2] + s_cnt[3];
      if (keep) {
        int at = __popc(bal & ((1u << lane) - 1u));
        for (int v = 0; v < warp; ++v) at += s_cnt[v];
        s_rec[at][0] = rec[0];
        s_rec[at][1] = rec[1];
        s_rec[at][2] = rec[2];
      }
      __syncthreads();
      float area[kOwGroups];
#pragma unroll
      for (int k = 0; k < kOwGroups; ++k) area[k] = 0.0f;
      for (int e = 0; e < n_kept && row_in; ++e) {
        const float4 cut = s_rec[e][2];
        if (!edge_rows_live(cut, ylo, ylo1)) continue;
        const float4 r0v = s_rec[e][0];
        const float4 r1v = s_rec[e][1];
        const float ax = r0v.x, ay = r0v.y, dx = r0v.z, dy = r0v.w;
        const float inv_dx = r1v.x, inv_dy = r1v.y, hdx = r1v.z;
        const float r0 = (ylo - ay) * inv_dy;
        const float r1 = (ylo1 - ay) * inv_dy;
        const float ta = clipf(fminf(r0, r1), 0.0f, 1.0f);
        const float tb = clipf(fmaxf(r0, r1), 0.0f, 1.0f);
        const float xta = ax + ta * dx;
        const float xtb = ax + tb * dx;
#pragma unroll
        for (int k = 0; k < kOwGroups; ++k) {
          if (!edge_cols_live(r1v, gx[k])) continue;
          live |= 1u << k;
          const float xl = xlo[k];
          const float s0 = (xl - ax) * inv_dx;
          const float s1 = ((xl + 1.0f) - ax) * inv_dx;
          const float smin = fminf(s0, s1);
          const float smax = fmaxf(s0, s1);
          const float hmid = ax - xl;
          const float p = clipf(smin, ta, tb);
          const float q = clipf(smax, ta, tb);
          const float ga = clipf(xta - xl, 0.0f, 1.0f);
          const float gb = clipf(xtb - xl, 0.0f, 1.0f);
          const float mid = hmid + (p + q) * hdx;
          const float integral =
              (ga * (p - ta) + mid * (q - p)) + gb * (tb - q);
          area[k] = area[k] + dy * integral;
        }
      }
#pragma unroll
      for (int k = 0; k < kOwGroups; ++k) {
        const float a = fabsf(area[k]);
        combine(k, fminf(a, 1.0f), a >= 0.5f ? 1 : 0);
      }
    } else {
      const float* e = s_ell[c];
      const bool rows_live = row_in && ell_rows_live(e, ylo, ylo1);
#pragma unroll
      for (int k = 0; k < kOwGroups; ++k) {
        float aa = 0.0f;
        if (rows_live && ell_cols_live(e, gx[k], gx[k] + 32.0f)) {
          live |= 1u << k;
          const float cx = xlo[k] + 0.5f;
          const float cy = ylo + 0.5f;
          const float ux = ((e[0] * cx + e[1] * cy) + e[2]) / e[6];
          const float uy = ((e[3] * cx + e[4] * cy) + e[5]) / e[7];
          aa = ellipse_chord_coverage(ux, uy, e[8], e[9], e[10], e[11]);
        }
        combine(k, aa, aa >= 0.5f ? 1 : 0);
      }
    }
  }
  if (!row_in) return;

  float mm[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) mm[q] = fm[q];
  const float py = ylo;
  const int gy = y0 + i;
#pragma unroll
  for (int k = 0; k < kOwGroups; ++k) {
    const int j = j0 + lane + 32 * k;
    if (!(live >> k & 1u) || j >= ww) continue;
    const bool inside = acc_in[k] != 0;
    const float m = use_aa ? acc_aa[k] : (inside ? 1.0f : 0.0f);
    const float px = xlo[k];
    const int gxi = x0 + j;
    float t[3];
    if (tex_sampled) {
      const float sx = (mm[0] * px + mm[1] * py) + mm[2];
      const float sy = (mm[3] * px + mm[4] * py) + mm[5];
      sample_quad(atlas, tex, SH, SW, cy0, cx0, H, W, sx, sy, t);
    } else {
      const uint8_t* row =
          atlas + (((size_t)tex * SH + cy0 + gy) * SW + cx0 + gxi) * 12;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) t[ch] = (float)row[ch];
    }
    float* fp = frames + (((size_t)b * H + gy) * W + gxi) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      fp[ch] = rintf(fp[ch] * (1.0f - m) + t[ch] * m);
    }
    if (emit_flow) {
      const float ofx = ((mm[0] * px + mm[1] * py) + mm[2]) - px;
      const float ofy = ((mm[3] * px + mm[4] * py) + mm[5]) - py;
      const float mi = inside ? 1.0f : 0.0f;
      float* fl = flow + (((size_t)b * H + gy) * W + gxi) * 2;
      fl[0] = ofx * mi + fl[0] * (1.0f - mi);
      fl[1] = ofy * mi + fl[1] * (1.0f - mi);
    }
  }
}

// Exact-area coverage of one closed outline per window over its sample
// grid: points (N, E, 2) of which the first n_edges (N) are real, closed in
// the kernel (edge e runs from point e to point e + 1, edge n_edges - 1
// back to point 0, as polygon_coverage_pallas builds its table), px / py
// (N, h, w). Block (32, 8), one point a thread; grid (8 x 32 tiles, N).
// A CTA reduces its points' cell corners to a box (any grid: nothing
// assumes one x per column or one y per row), stages in edge order the
// edges that can reach a cell of the box (coverage.cuh's row and column
// culls) with their constants, and each point sums the staged edges that
// its own cell does not cull. A point no edge reached gets +0 and 0, as
// the dense sum gives. A point with a NaN coordinate opens the box, so its
// tile culls nothing.
__global__ void __launch_bounds__(kTileW* kTileH)
    polygon_coverage_kernel(const float* __restrict__ pts,
                            const int* __restrict__ n_edges,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ aa, uint8_t* __restrict__ inside,
                            int E, int h, int w, int tiles_x) {
  __shared__ float4 s_rec[kMaxEdges][3];
  __shared__ float s_box[kTileH][3];
  __shared__ int s_cnt[4];
  const int win = blockIdx.y;
  const int warp = threadIdx.y;
  const int lane = threadIdx.x;
  const int tid = warp * kTileW + lane;
  const int i = (blockIdx.x / tiles_x) * kTileH + warp;
  const int j = (blockIdx.x % tiles_x) * kTileW + lane;
  const bool live = i < h && j < w;
  const size_t at = ((size_t)win * h + i) * w + j;
  float xlo = 0.0f, ylo = 0.0f;
  float bx0 = INFINITY, by0 = INFINITY, by1 = -INFINITY;
  if (live) {
    xlo = px[at] - 0.5f;
    ylo = py[at] - 0.5f;
    const bool open = isnan(xlo) || isnan(ylo);
    bx0 = open ? -INFINITY : xlo;
    by0 = open ? -INFINITY : ylo;
    by1 = open ? INFINITY : ylo;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bx0 = fminf(bx0, __shfl_xor_sync(0xffffffffu, bx0, o));
    by0 = fminf(by0, __shfl_xor_sync(0xffffffffu, by0, o));
    by1 = fmaxf(by1, __shfl_xor_sync(0xffffffffu, by1, o));
  }
  if (lane == 0) {
    s_box[warp][0] = bx0;
    s_box[warp][1] = by0;
    s_box[warp][2] = by1;
  }
  const int ne = max(min(n_edges[win], E), 0);
  float4 rec[3];
  if (tid < ne) {
    const float* a = pts + ((size_t)win * E + tid) * 2;
    const float* b = pts + ((size_t)win * E + (tid + 1 < ne ? tid + 1 : 0)) * 2;
    edge_record(a[0], a[1], b[0], b[1], rec);
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kTileH; ++v) {
    bx0 = fminf(bx0, s_box[v][0]);
    by0 = fminf(by0, s_box[v][1]);
    by1 = fmaxf(by1, s_box[v][2]);
  }
  const bool keep = tid < ne && edge_rows_live(rec[2], by0, by1 + 1.0f) &&
                    edge_cols_live(rec[1], bx0);
  const unsigned bal = __ballot_sync(0xffffffffu, keep);
  if (warp < 4 && lane == 0) s_cnt[warp] = __popc(bal);
  __syncthreads();
  const int n_kept = s_cnt[0] + s_cnt[1] + s_cnt[2] + s_cnt[3];
  if (keep) {
    int k = __popc(bal & ((1u << lane) - 1u));
    for (int v = 0; v < warp; ++v) k += s_cnt[v];
    s_rec[k][0] = rec[0];
    s_rec[k][1] = rec[1];
    s_rec[k][2] = rec[2];
  }
  __syncthreads();
  if (!live) return;
  const float ylo1 = ylo + 1.0f;
  float area = 0.0f;
  for (int e = 0; e < n_kept; ++e) {
    const float4 r1v = s_rec[e][1];
    if (!edge_rows_live(s_rec[e][2], ylo, ylo1) || !edge_cols_live(r1v, xlo))
      continue;
    area = area + edge_term(s_rec[e][0], r1v, xlo, ylo);
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
                                     int use_aa, int emit_flow,
                                     float ell_cull_m, float ell_aniso,
                                     void* stream) {
  using namespace flowgen;
  if (C != kMaxComps || E != kMaxEdges || N <= 0 || max_wh <= 0 ||
      max_ww <= 0 || (emit_flow && flow == nullptr) || !(ell_aniso >= 1.0f) ||
      !(ell_cull_m >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (max_ww + kOwCols - 1) / kOwCols;
  const int tiles_y = (max_wh + kTileH - 1) / kTileH;
  const dim3 block(kTileW, kTileH);
  const dim3 grid(tiles_x * tiles_y, N);
  object_window_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      edges, meta, fmeta, win, atlas, frames, flow, B, H, W, T, SH, SW, cy0,
      cx0, tiles_x, tex_sampled, use_aa, emit_flow, ell_cull_m, ell_aniso);
  return (int)cudaGetLastError();
}

extern "C" int flowgen_polygon_coverage(const float* pts, const int* n_edges,
                                        const float* px, const float* py,
                                        float* aa, uint8_t* inside, int N,
                                        int E, int h, int w, void* stream) {
  using namespace flowgen;
  if (E > kMaxEdges || N <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const dim3 block(kTileW, kTileH);
  const dim3 grid(tiles_x * tiles_y, N);
  polygon_coverage_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pts, n_edges, px, py, aa, inside, E, h, w, tiles_x);
  return (int)cudaGetLastError();
}
