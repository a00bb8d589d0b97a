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
// (a cluster for the warp) owns one block: it reduces the block's smallest
// tap index, then computes.
// The bank's 17 doublings are chaotic, so the lerp keeps the JAX package's
// det_lerp exactly (p0 + round((p1 - p0) * t)), and the file is compiled
// with -fmad=false.
//
// What bounds them. hwarp_rows must move 4 + 4 + 4/C bytes an element of
// (M, C, R, Sp) planes (read the plane, write the result, and read the
// displacement row that the field's C channels share once: 10 bytes for the
// bank's C = 2) and does a few operations, so bytes bound it. What keeps a
// straightforward version off that bound: one CTA per channel block reads
// the shared displacement once per channel, the block minimum is a barrier
// with no load in flight across it, and large CTAs quantise into partial
// waves (1.09 waves of 1024-thread CTAs at 768^2). So this one lerps all C
// channel blocks of a field from one displacement row where the blocks
// allow it (read for the minimum, then again from cache for the lerp),
// splits each block over a cluster of small CTAs that share the band
// minimum through distributed shared memory, and keeps a thread's rows and
// four coalesced lanes unrolled so their loads are in flight together.
// The coarse solve is a small sequential fixed point (9 lookups along each
// coarse column): one CTA per (field, 128-lane tile), latency-bound, a
// small part of a doubling.

#include <cooperative_groups.h>
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
// row, over the G = M * C * R stacked rows (width Sp) of (M, C, R, Sp)
// planes; row g = (m * C + c) * R + r reads displacement row m * R + r.
//
// The band is defined per block of row_tile stacked rows x 128 lanes. A
// unit of work is one band block, or, when R % row_tile == 0, the C blocks
// of one field that share their displacement rows (and so their positions
// and their band): those are lerped together from one pass over the
// displacement. When R % row_tile != 0 a block straddles two channels and
// keeps the stacked definition. A unit is split over a cluster of
// kHwarpCluster CTAs of 256 threads (32 lanes x 8 rows, 4 lanes a thread 32
// apart, ITEMS rows a thread): each reduces the smallest left tap of its
// rows, the cluster combines the partial minima through distributed shared
// memory, then each CTA lerps its rows, reading the displacement again
// (from cache). Grid: one cluster per unit.
constexpr int kHwarpRows = 8;       // blockDim.y
constexpr int kHwarpLaneStep = 32;  // blockDim.x; a thread's 4 lanes are 32 apart
constexpr int kHwarpCluster = 8;    // CTAs sharing one unit's band minimum

template <int ITEMS>
__global__ void __launch_bounds__(kHwarpLaneStep* kHwarpRows)
    hwarp_rows_kernel(const float* __restrict__ src,
                      const float* __restrict__ disp, float* __restrict__ out,
                      int Sp, int C, int R, int scan, int merged) {
  constexpr int K = kHwarpCluster;
  constexpr int rows = ITEMS * kHwarpRows;   // stacked (or field) rows a CTA
  constexpr int row_tile = K * rows;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int s_warp_min[kHwarpRows];
  __shared__ int s_part;
  const int rank = (int)cluster.block_rank();
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int lane_tiles = Sp / kLanes;
  const int blocks_per_field = R / row_tile;
  const int CR = C * R;
  const int unit = blockIdx.x / K;
  const int grp = unit / lane_tiles;
  const int x = (unit % lane_tiles) * kLanes + tx;
  // Row i of this CTA: displacement row drow_of(i); output rows orow +
  // c * R for the C channels of a merged unit, orow alone otherwise.
  const int first = rank * rows;
  int m = 0, r0 = 0;
  if (merged) {
    m = grp / blocks_per_field;
    r0 = (grp % blocks_per_field) * row_tile + first;
  }
  const int g0 = grp * row_tile + first;
  auto drow_of = [&](int i) -> size_t {
    if (merged) return (size_t)m * R + r0 + i;
    const int g = g0 + i;
    return (size_t)(g / CR) * R + (g % R);
  };

  int mn = INT_MAX;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = ty + kHwarpRows * q;
    const float* d = disp + drow_of(i) * Sp + x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xf = (float)(x + kHwarpLaneStep * j);
      mn = min(mn, left_tap(__fadd_rn(xf, __ldg(d + kHwarpLaneStep * j)), Sp));
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  if (tx == 0) s_warp_min[ty] = mn;
  __syncthreads();
  if (tx == 0 && ty == 0) {
    int v = s_warp_min[0];
    for (int k = 1; k < kHwarpRows; ++k) v = min(v, s_warp_min[k]);
    s_part = v;
  }
  cluster.sync();
  int bmin = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k)
    bmin = min(bmin, *cluster.map_shared_rank(&s_part, k));
  int lo, hi;
  band_of(bmin, lane_tiles, scan, &lo, &hi);

  const int n_out = merged ? C : 1;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = ty + kHwarpRows * q;
    const float* d = disp + drow_of(i) * Sp + x;
    float uu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      uu[j] = __fadd_rn((float)(x + kHwarpLaneStep * j),
                        __ldg(d + kHwarpLaneStep * j));
    const size_t orow = merged ? ((size_t)m * C * R + r0 + i) : (size_t)(g0 + i);
    for (int c = 0; c < n_out; ++c) {
      const size_t row = orow + (size_t)c * R;
      const float* s = src + row * Sp;
      float* o = out + row * Sp + x;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[kHwarpLaneStep * j] = banded_lerp_clamped(s, uu[j], Sp, lo, hi);
    }
  }
  // No CTA leaves while a peer may still read its partial minimum.
  cluster.sync();
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

namespace {

template <int ITEMS>
int launch_hwarp(const float* src, const float* disp, float* out, int G,
                 int Sp, int C, int R, int scan, cudaStream_t stream) {
  using namespace flowgen;
  constexpr int row_tile = kHwarpCluster * ITEMS * kHwarpRows;
  const int merged = R % row_tile == 0;
  const int groups = merged ? (G / C) / row_tile : G / row_tile;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kHwarpCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kHwarpCluster * groups * (Sp / kLanes));
  cfg.blockDim = dim3(kHwarpLaneStep, kHwarpRows);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaError_t e = cudaLaunchKernelEx(&cfg, hwarp_rows_kernel<ITEMS>, src,
                                     disp, out, Sp, C, R, scan, merged);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flowgen_hwarp_rows(const float* src, const float* disp,
                                  float* out, int G, int Sp, int CR, int R,
                                  int row_tile, int scan, void* stream) {
  using namespace flowgen;
  if (Sp % kLanes || R <= 0 || CR % R || G % CR || G % row_tile)
    return (int)cudaErrorInvalidValue;
  const int C = CR / R;
  cudaStream_t s = (cudaStream_t)stream;
  switch (row_tile) {
    case 128: return launch_hwarp<2>(src, disp, out, G, Sp, C, R, scan, s);
    case 256: return launch_hwarp<4>(src, disp, out, G, Sp, C, R, scan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
