// Warp-field kernels of the mode-9 bank producer, on NVIDIA Hopper: the
// elementary field, the coarse column-inverse solve with its x4 upsample,
// and the row-tiled horizontal warp.
//
// Replaces flowgen/warpfields/pallas_fields.py:
//   * coarse_solve_kernel + upsample4_kernel (or upsample2_kernel) <-
//     coarse_gdisp_batch (its pallas_call on _coarse_solve_kernel and the
//     XLA around it: the strided subsample, transposes, scale and pads
//     before, the slice, transpose and log2(stride) _upsample2_plane after);
//   * hwarp_rows_kernel <- _hwarp_kernel (pallas_call in _hwarp_rows).
//
// Both read their two bilinear taps per element through the TPU kernels'
// banded rule (ops/pallas_resample.py:_banded_tap_pair): per block of
// positions (all rows of a field x 128 lanes for the solve, row_tile x 128
// for the warp) a band of `scan` 128-lane source tiles starts at the tile of
// the block's smallest left tap, and a tap outside it reads 0. So the CTAs
// of one block reduce the block's smallest tap index, then compute.
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
//
// coarse_gdisp must read the coarse subsample of D's two channels once and
// write the full-size plane once, so bytes bound it too (the write is 8x
// the read). Its solve is a short sequential fixed point (9 banded lookups
// along each coarse column): a chain of steps, each a block-wide minimum
// and a dependent load, which one CTA per block (16 CTAs at 768^2) would
// walk alone. So the solve
//   * splits each (field, 128-lane tile) block over kSolveSplit = 16 CTAs
//     (256 CTAs at 768^2), each owning a slab of rows whose iterate stays
//     in registers for all the steps;
//   * stages its rows of both planes in shared memory once, read straight
//     from D's strided coarse samples (transposed, y scaled by 1/stride, no
//     copy in PyTorch): the lanes of its tile and a halo of kSolveHalo on
//     each side, which holds every tap of displacements under stride *
//     kSolveHalo px (128 at the bank's stride 4); a tap the band allows
//     outside the halo reads D itself, so any input and any stride give the
//     plain version's result;
//   * needs a block minimum only where the band can move (more than `scan`
//     tiles in the lattice: from 1536^2 up; at 768^2 every band is [0, 256)
//     and no CTA waits on another) and never at the first step (d = 0: the
//     block's smallest tap is its first lane); there the block's CTAs form
//     a cluster, and each pushes its minimum into every peer's slot for the
//     step with red.async, completing on the peer's mbarrier, and waits on
//     its own: no cluster-wide barrier (and no GPU-scope fence) a step;
//   * writes the coarse result untransposed through shared memory, so the
//     upsample reads and writes along rows.
// A slab holds at most 64 rows in registers (fields up to 4096 px wide at
// stride 4); past that coarse_solve_wide_kernel takes the same blocks,
// steps and exchange with the iterate in global memory and every tap read
// from D. At the bank's stride 4, upsample4_kernel then writes each fine
// 4x4 block from its 2x2 coarse neighbourhood: the rounded (a + b) * 0.5
// steps of two _upsample2 stages (rows, then columns, twice, the last node
// replicated), one float4 store a fine row. (Writing those blocks in the
// solve's epilogue instead, with a seam kernel for the tiles' last lanes,
// measured slower at 768^2: PERF.md.) Other strides take log2(stride)
// launches of upsample2_kernel, one _upsample2 stage each (none at stride
// 1, where the solve writes the output). The stride and the step count are
// run-time arguments; stride 4 is also a compile-time case of the solve.
//
// elementary_field_kernel replaces no TPU kernel: the JAX package's
// warpfields/fields.py:elementary_field is a fori_loop over the displacers
// that XLA fuses. Run as eager PyTorch, it is some 65 full-plane kernels a
// displacer (about 4,400 launches and ~30 ms of device time a bank epoch),
// so the port has this kernel instead. What bounds it: it writes only its
// output (8 bytes a pixel and direction) but does 43 to 53 float32
// operations a (pixel, displacer) pair by motion kind, none of them fusable
// (-fmad=false keeps the eager roundings), so the fp32 issue rate bounds
// it: 4 x 768^2 pixels x 63 displacers at 128 lanes x 132 SMs x 1.98 GHz
// is about 0.21 ms. What the design does about that: one pass, the
// sums in registers, a block's displacer constants staged once in shared
// memory and read as four broadcast float4 loads a displacer for four
// pixels, the motion branch uniform across the block, nothing culled (the
// exp never returns an exact 0, so skipping a term could move a bit).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace flowgen {

constexpr int kLanes = 128;

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

// ---------------------------------------------------------------------------
// Coarse column-inverse solve
// ---------------------------------------------------------------------------

constexpr int kCoarse = 4;             // the bank's lattice stride (two x2 upsamples)
constexpr int kSolveSplit = 16;        // CTAs a block (non-portable cluster)
constexpr int kSolveRows = 4;          // least rows of threads a CTA
constexpr int kSolveHalo = 32;         // staged lanes each side of a tile
constexpr int kSolveWin = kLanes + 2 * kSolveHalo;
constexpr int kSolveStride = kSolveWin + 1;   // odd: staging spreads banks
constexpr int kSolveMaxItems = 8;      // rows a thread
constexpr int kSolveMaxThreads = 1024;
// Most rows a slab holds in registers; longer slabs take the wide kernel.
constexpr int kSolveMaxRows = kSolveMaxItems * (kSolveMaxThreads / kLanes);
constexpr int kWideThreads = 512;
constexpr int kStageBatch = 8;         // loads a thread keeps in flight (x2)

// Distributed shared memory and mbarriers (PTX, sm_90): a CTA's 32-bit
// shared address, the same variable of cluster peer `rank`, and an mbarrier
// whose phase completes when its one arrival (with the bytes it expects)
// and those bytes of remote red.async operations are in.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "wait_%=:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra wait_%=;\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// min into the int at shared::cluster address `dst`, completing 4 bytes on
// the mbarrier at shared::cluster address `bar` (the same CTA's).
__device__ __forceinline__ void red_min_async(uint32_t dst, int v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.min.s32 "
      "[%0], %1, [%2];" ::"r"(dst),
      "r"(v), "r"(bar)
      : "memory");
}

// max into the unsigned at shared::cluster address `dst`, completing 4
// bytes on the mbarrier at shared::cluster address `bar` (the same CTA's).
__device__ __forceinline__ void red_max_async(uint32_t dst, unsigned v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.max.u32 "
      "[%0], %1, [%2];" ::"r"(dst),
      "r"(v), "r"(bar)
      : "memory");
}

// The solve's planes, read in place from D (N, Hd, Wd, 2) by its element
// strides at a power-of-two lattice stride s: dyT[n, r, l] = D[n, s l, s r,
// 1] * yscale (yscale = 1/s, exact), dxT[n, r, l] = D[n, s l, s r, 0].
// STRIDE is s where it is a compile-time case (the bank's kCoarse), 0 where
// it is read from `stride`.
template <int STRIDE>
struct CoarseSrc {
  const float* D;
  long long sN, sH, sW, sC;
  float yscale;
  int stride;

  __device__ __forceinline__ const float* at(int n, int l, int r) const {
    const int s = STRIDE ? STRIDE : stride;
    return D + n * sN + (long long)(s * l) * sH + (long long)(s * r) * sW;
  }
  __device__ __forceinline__ float dy(const float* p) const {
    return __fmul_rn(__ldg(p + sC), yscale);
  }
  __device__ __forceinline__ float dx(const float* p) const { return __ldg(p); }
};

__device__ __forceinline__ float mid(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

// Fine rows 4i..4i+3, columns 4j..4j+3 of _upsample2(_upsample2(gd)) for
// an (h, w) plane gd, from c00 = gd[i][j], c01 = gd[i][j1], c10 = gd[i1][j],
// c11 = gd[i1][j1], i1 = min(i + 1, h - 1), j1 = min(j + 1, w - 1), into
// o (the fine block's first element; fine rows W4 apart). The first stage's
// nodes (2i + ka, 2j + kb), ka, kb in 0..2 clipped to (2h - 1, 2w - 1),
// come from those four values; each stage takes its row midpoints first,
// then the column midpoints of those, and replicates its last node.
__device__ __forceinline__ void fine_block(float c00, float c01, float c10,
                                           float c11, int i, int j, int h,
                                           int w, float* __restrict__ o,
                                           size_t W4) {
  // gd at coarse row ii in {i, i1} and column jj in {j, j1}.
  auto at = [&](int ii, int jj) {
    return ii != i ? (jj != j ? c11 : c10) : (jj != j ? c01 : c00);
  };
  float u[3][3];
#pragma unroll
  for (int ka = 0; ka < 3; ++ka) {
    const int a = min(2 * i + ka, 2 * h - 1);
    const int ia = a >> 1;
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      const int b = min(2 * j + kb, 2 * w - 1);
      const int jb = b >> 1;
      auto row = [&](int jj) {
        const float v = at(ia, jj);
        return (a & 1) ? mid(v, at(min(ia + 1, h - 1), jj)) : v;
      };
      const float v = row(jb);
      u[ka][kb] = (b & 1) ? mid(v, row(min(jb + 1, w - 1))) : v;
    }
  }
#pragma unroll
  for (int ry = 0; ry < 4; ++ry) {
    const int ka = ry >> 1;
    float v[4];
#pragma unroll
    for (int rx = 0; rx < 4; ++rx) {
      const int kb = rx >> 1;
      auto row = [&](int k) {
        return (ry & 1) ? mid(u[ka][k], u[ka + 1][k]) : u[ka][k];
      };
      const float r = row(kb);
      v[rx] = (rx & 1) ? mid(r, row(kb + 1)) : r;
    }
    *reinterpret_cast<float4*>(o + ry * W4) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The block minimum of a solve step across the kSolveSplit CTAs of a
// cluster: each CTA pushes its own minimum into every peer's slot for the
// step (red.async, completing 4 bytes on the peer's mbarrier) and waits
// only for the pushes into its own slot. The two barriers take the steps
// by parity, so a peer at most one step ahead never lands in the wrong
// phase: steps 1, 2, 3, ... use barrier it & 1 for the ((it - 1) >> 1)-th
// time, so that is the phase each waits for. No CTA leaves while a peer may
// still push into it: each waits for all of them at every step.
//
// StepSlots, the bank's case (stride 4, fewer than kSolveMaxSteps steps),
// gives each step a slot of its own. StepKeys takes any other stride or
// step count: two slots by parity that are never reset. A step writes
// key(it, m) = (tag << 16) | (0xFFFF - m), tag = (it + 1) >> 1, with max,
// so its keys outrank the ones its slot held two steps before, and the
// largest key is the smallest m; a peer can push a slot's next step only
// after this CTA has pushed the step between, which it does after reading
// the slot. That holds up to kSolveMaxIter steps (16-bit tags) and
// lattices under 65536 lanes. (StepKeys on the bank's case too cost 1.5%
// of a call at 3072^2 and 15% at 4608^2, where the wide solve took more
// registers; PERF.md.)
constexpr int kSolveMaxSteps = 16;
constexpr int kSolveMaxIter = 2 * 0xFFFF;

// Every CTA of the cluster has started and set its slots and barriers
// before any pushes into them (a CTA barrier alone without `exchange`).
__device__ __forceinline__ void exchange_init(uint64_t* bar, bool exchange,
                                              int tid) {
  if (exchange && tid < 2) mbar_init(&bar[tid], 1);
  if (exchange) {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

struct StepSlots {
  int cta_min[kSolveMaxSteps];    // this CTA's minimum a step
  int block_min[kSolveMaxSteps];  // the block's, pushed by every CTA
  uint64_t bar[2];                // steps by parity

  __device__ void init(bool exchange, int tid) {
    if (tid < kSolveMaxSteps) {
      cta_min[tid] = INT_MAX;
      block_min[tid] = INT_MAX;
    }
    exchange_init(bar, exchange, tid);
  }
  // The block's smallest of every thread's `m` at step `it` (1 or more);
  // every thread of the CTA calls it.
  __device__ int reduce(int m, int it, int tid) {
    m = __reduce_min_sync(0xffffffffu, m);
    if ((tid & 31) == 0) atomicMin(&cta_min[it], m);
    __syncthreads();
    const int p = it & 1;
    if (tid == 0) mbar_arrive_expect(&bar[p], 4 * kSolveSplit);
    if (tid < kSolveSplit)
      red_min_async(peer_addr(smem_addr(&block_min[it]), tid), cta_min[it],
                    peer_addr(smem_addr(&bar[p]), tid));
    mbar_wait(&bar[p], ((it - 1) >> 1) & 1);
    return block_min[it];
  }
};

struct StepKeys {
  unsigned cta_key[2];    // this CTA's key a step, by parity
  unsigned block_key[2];  // the block's, pushed by every CTA
  uint64_t bar[2];        // steps by parity

  __device__ void init(bool exchange, int tid) {
    if (tid < 2) {
      cta_key[tid] = 0u;
      block_key[tid] = 0u;
    }
    exchange_init(bar, exchange, tid);
  }
  // As StepSlots::reduce; `m` a lane index, or INT_MAX for none.
  __device__ int reduce(int m, int it, int tid) {
    m = __reduce_min_sync(0xffffffffu, m);
    const int p = it & 1;
    const unsigned key =
        ((unsigned)((it + 1) >> 1) << 16) | (unsigned)(0xFFFF - min(m, 0xFFFF));
    if ((tid & 31) == 0) atomicMax(&cta_key[p], key);
    __syncthreads();
    if (tid == 0) mbar_arrive_expect(&bar[p], 4 * kSolveSplit);
    if (tid < kSolveSplit)
      red_max_async(peer_addr(smem_addr(&block_key[p]), tid), cta_key[p],
                    peer_addr(smem_addr(&bar[p]), tid));
    mbar_wait(&bar[p], ((it - 1) >> 1) & 1);
    return 0xFFFF - (int)(block_key[p] & 0xFFFFu);
  }
};

// STRIDE = kCoarse is the bank's case, whose launches take fewer than
// kSolveMaxSteps steps; STRIDE = 0 takes any stride and step count.
template <int STRIDE>
using StepExchange =
    std::conditional_t<STRIDE == kCoarse, StepSlots, StepKeys>;

// gd[n, w, x] = dxT[n, x, y*] with w = y* + dyT[n, x, y*]: n_iter
// fixed-point lerps d <- dyT(w - d) along each coarse row x, then dxT(w - d);
// gd is (N, Lv, R), untransposed. Block (128, rows of threads); grid
// kSolveSplit * N * n_src CTAs, kSolveSplit consecutive CTAs per (field,
// tile) block, each owning rows [rank * rows_cta, +rows_cta), at most
// kSolveMaxRows, and, when the band can move, forming a cluster. A thread's
// rows past the CTA's last repeat that row: the same values, so no minimum
// changes, and they are not written. Where the band cannot move, lanes past
// Lv are not computed (each lane's steps are its own); where it can, they
// are, for the block minimum.
// Dynamic shared memory: 2 * rows_cta * kSolveStride floats.
template <int ITEMS, int STRIDE>
__global__ void __launch_bounds__(kSolveMaxThreads)
    coarse_solve_kernel(CoarseSrc<STRIDE> src, float* __restrict__ gd, int R,
                        int Lv, int rows_cta, int n_iter, int scan) {
  extern __shared__ float s_src[];
  __shared__ StepExchange<STRIDE> xs;
  const int n_src = (Lv + kLanes - 1) / kLanes;
  const bool exchange = n_src > scan;   // else every band starts at tile 0
  const int blk = blockIdx.x / kSolveSplit;
  const int rank = blockIdx.x % kSolveSplit;
  const int n = blk / n_src;
  const int t = blk % n_src;
  const int rt = blockDim.y;
  const int nthreads = kLanes * rt;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int r0 = rank * rows_cta;
  const int nrows = max(min(R - r0, rows_cta), 0);
  const int wlo = max(t * kLanes - kSolveHalo, 0);
  const int whi = min(t * kLanes + kLanes + kSolveHalo, Lv);
  const int wn = whi - wlo;
  float* s_dy = s_src;
  float* s_dx = s_src + rows_cta * kSolveStride;

  // Stage: consecutive threads take consecutive rows (x = 4r, 16 bytes
  // apart in the bank's layout) of one coarse y; a thread's (row, lane)
  // advances by nthreads without a division, and the loads of a batch are
  // all in flight before their stores.
  if (nrows > 0) {
    const int total = nrows * wn;
    const int dj = nthreads / nrows;
    const int dr = nthreads - dj * nrows;
    int rr = tid % nrows, j = tid / nrows;
    for (int k = tid; k < total; k += kStageBatch * nthreads) {
      float vy[kStageBatch], vx[kStageBatch];
      int at[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        at[b] = -1;
        if (k + b * nthreads < total) {
          const float* p = src.at(n, wlo + j, r0 + rr);
          vy[b] = src.dy(p);
          vx[b] = src.dx(p);
          at[b] = rr * kSolveStride + j;
        }
        rr += dr;
        j += dj;
        if (rr >= nrows) {
          rr -= nrows;
          ++j;
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        if (at[b] >= 0) {
          s_dy[at[b]] = vy[b];
          s_dx[at[b]] = vx[b];
        }
      }
    }
  }
  xs.init(exchange, tid);

  const int lane = t * kLanes + threadIdx.x;
  // A warp of lanes past Lv only computes where it counts in the minimum.
  const bool idle = nrows == 0 || (!exchange && (lane & ~31) >= Lv);
  const float wpos = (float)lane;
  const float lvm1 = (float)(Lv - 1);
  float d[ITEMS], fx[ITEMS];
  int u0[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) d[q] = 0.0f;

  for (int it = 0; it <= n_iter; ++it) {
    // Positions and left taps of this step.
    int m = INT_MAX;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const float uc = fminf(fmaxf(__fsub_rn(wpos, d[q]), 0.0f), lvm1);
      const float uf = floorf(uc);
      fx[q] = __fsub_rn(uc, uf);
      u0[q] = (int)uf;
      m = min(m, u0[q]);
    }
    // d = 0 at the first step: the smallest left tap is the tile's first
    // lane (t * 128 < Lv).
    int bmin = t * kLanes;
    if (it > 0 && exchange) bmin = xs.reduce(idle ? INT_MAX : m, it, tid);
    int lo, hi;
    band_of(bmin, n_src, scan, &lo, &hi);
    const unsigned band = (unsigned)(hi - lo);
    const bool last = it == n_iter;
    const float* plane = last ? s_dx : s_dy;
    if (idle) continue;
    // Fast path: both taps (a, a + 1 < Lv) of every item staged, with no
    // branch between items.
    bool staged = true;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      staged &= (unsigned)(u0[q] - wlo) < (unsigned)(wn - 1);
    if (staged) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int rr = min((int)threadIdx.y + rt * q, nrows - 1);
        const float* row = plane + rr * kSolveStride - wlo;
        const int a = u0[q];
        const float v0 = row[a];
        const float v1 = row[a + 1];
        const float p0 = (unsigned)(a - lo) < band ? v0 : 0.0f;
        const float p1 = (unsigned)(a + 1 - lo) < band ? v1 : 0.0f;
        d[q] = __fadd_rn(p0, __fmul_rn(__fsub_rn(p1, p0), fx[q]));
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int rr = min((int)threadIdx.y + rt * q, nrows - 1);
      const float* row = plane + rr * kSolveStride;
      const int a = u0[q];
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = e ? min(a + 1, Lv - 1) : a;
        p[e] = 0.0f;
        if ((unsigned)(u - lo) >= band) continue;
        if (u >= wlo && u < whi) {
          p[e] = row[u - wlo];
        } else {
          const float* g = src.at(n, u, r0 + rr);
          p[e] = last ? src.dx(g) : src.dy(g);
        }
      }
      d[q] = __fadd_rn(p[0], __fmul_rn(__fsub_rn(p[1], p[0]), fx[q]));
    }
  }

  // Write gd[n, lane, r0 + rr] through shared memory: each lane's rows are
  // contiguous in gd.
  __syncthreads();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int rr = threadIdx.y + rt * q;
    if (rr < nrows) s_dy[rr * kSolveStride + threadIdx.x] = d[q];
  }
  __syncthreads();
  if (nrows > 0) {
    const int total = nrows * min(Lv - t * kLanes, kLanes);
    const int dl = nthreads / nrows;
    const int dr = nthreads - dl * nrows;
    int rr = tid % nrows, l = tid / nrows;
    float* g = gd + ((size_t)n * Lv + t * kLanes) * R + r0;
    for (int k = tid; k < total; k += nthreads) {
      g[(size_t)l * R + rr] = s_dy[rr * kSolveStride + l];
      rr += dr;
      l += dl;
      if (rr >= nrows) {
        rr -= nrows;
        ++l;
      }
    }
  }
}

// The same solve for slabs longer than kSolveMaxRows (fields wider than
// 4096 px): coarse_solve_kernel's blocks, bands and exchange, with the
// iterate kept in `dbuf` between steps and every tap read from D. dbuf
// holds (N, Ld, R): Ld = n_src * 128 lanes where the band can move (lanes
// past Lv count in the minimum), Lv where it cannot (they are not
// computed). A CTA's threads walk its (lane, row) positions, consecutive
// threads on consecutive rows, whose dbuf entries and D samples lie
// close. Grid and clusters as coarse_solve_kernel's; block kWideThreads.
template <int STRIDE>
__global__ void __launch_bounds__(kWideThreads)
    coarse_solve_wide_kernel(CoarseSrc<STRIDE> src, float* __restrict__ dbuf,
                             float* __restrict__ gd, int R, int Lv,
                             int rows_cta, int n_iter, int scan) {
  __shared__ StepExchange<STRIDE> xs;
  const int n_src = (Lv + kLanes - 1) / kLanes;
  const bool exchange = n_src > scan;
  const int Ld = exchange ? n_src * kLanes : Lv;
  const int blk = blockIdx.x / kSolveSplit;
  const int rank = blockIdx.x % kSolveSplit;
  const int n = blk / n_src;
  const int t = blk % n_src;
  const int tid = threadIdx.x;
  const int r0 = rank * rows_cta;
  const int nrows = max(min(R - r0, rows_cta), 0);
  const int total = nrows * min(Ld - t * kLanes, kLanes);
  float* db = dbuf + ((size_t)n * Ld + t * kLanes) * R + r0;
  const float lvm1 = (float)(Lv - 1);
  xs.init(exchange, tid);

  for (int it = 0; it <= n_iter; ++it) {
    int bmin = t * kLanes;   // d = 0 at the first step, as above
    if (it > 0 && exchange) {
      int m = INT_MAX;
      for (int k = tid; k < total; k += kWideThreads) {
        const int rr = k % nrows, l = k / nrows;
        const float w = (float)(t * kLanes + l);
        const float uc =
            fminf(fmaxf(__fsub_rn(w, db[(size_t)l * R + rr]), 0.0f), lvm1);
        m = min(m, (int)floorf(uc));
      }
      bmin = xs.reduce(m, it, tid);
    }
    int lo, hi;
    band_of(bmin, n_src, scan, &lo, &hi);
    const bool last = it == n_iter;
    for (int k = tid; k < total; k += kWideThreads) {
      const int rr = k % nrows, l = k / nrows;
      const int lane = t * kLanes + l;
      const float d = it > 0 ? db[(size_t)l * R + rr] : 0.0f;
      const float uc = fminf(fmaxf(__fsub_rn((float)lane, d), 0.0f), lvm1);
      const float uf = floorf(uc);
      const float fx = __fsub_rn(uc, uf);
      const int a = (int)uf;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = e ? min(a + 1, Lv - 1) : a;
        p[e] = 0.0f;
        if (u < lo || u >= hi) continue;
        const float* g = src.at(n, u, r0 + rr);
        p[e] = last ? src.dx(g) : src.dy(g);
      }
      const float v = __fadd_rn(p[0], __fmul_rn(__fsub_rn(p[1], p[0]), fx));
      if (!last)
        db[(size_t)l * R + rr] = v;
      else if (lane < Lv)
        gd[((size_t)n * Lv + lane) * R + r0 + rr] = v;
    }
  }
}

// out (N, 4h, 4w) = _upsample2(_upsample2(gd)) for gd (N, h, w): one
// thread per coarse node (n, i, j) writes its fine block; grid
// (ceil(w / 128), h, N).
__global__ void __launch_bounds__(kLanes)
    upsample4_kernel(const float* __restrict__ gd, float* __restrict__ out,
                     int h, int w) {
  const int j = blockIdx.x * kLanes + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= w) return;
  const float* g = gd + (size_t)n * h * w;
  const int i1 = min(i + 1, h - 1);
  const int j1 = min(j + 1, w - 1);
  const size_t W4 = (size_t)4 * w;
  fine_block(__ldg(g + (size_t)i * w + j), __ldg(g + (size_t)i * w + j1),
             __ldg(g + (size_t)i1 * w + j), __ldg(g + (size_t)i1 * w + j1), i, j,
             h, w, out + ((size_t)n * 4 * h + (size_t)4 * i) * W4 + (size_t)4 * j,
             W4);
}

// out (N, 2h, 2w) = _upsample2(gd) for gd (N, h, w), the other strides'
// step: rows first (node 2i = gd[i], 2i + 1 the rounded midpoint of rows i
// and min(i + 1, h - 1)), then columns likewise; one thread per coarse node
// writes its 2x2 block, two float2 stores. Grid (ceil(w / 128), h, N).
__global__ void __launch_bounds__(kLanes)
    upsample2_kernel(const float* __restrict__ gd, float* __restrict__ out,
                     int h, int w) {
  const int j = blockIdx.x * kLanes + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= w) return;
  const float* g = gd + (size_t)n * h * w;
  const int i1 = min(i + 1, h - 1);
  const int j1 = min(j + 1, w - 1);
  const float c00 = __ldg(g + (size_t)i * w + j);
  const float c01 = __ldg(g + (size_t)i * w + j1);
  // The row stage at rows 2i, 2i + 1 and columns j, j1; the last row and
  // column take the midpoint with themselves, as the replicated node does.
  const float r10 = mid(c00, __ldg(g + (size_t)i1 * w + j));
  const float r11 = mid(c01, __ldg(g + (size_t)i1 * w + j1));
  const size_t W2 = (size_t)2 * w;
  float* o = out + ((size_t)n * 2 * h + (size_t)2 * i) * W2 + (size_t)2 * j;
  *reinterpret_cast<float2*>(o) = make_float2(c00, mid(c00, c01));
  *reinterpret_cast<float2*>(o + W2) = make_float2(r10, mid(r10, r11));
}

__global__ void noop_kernel() {}

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

// ---------------------------------------------------------------------------
// Elementary field
// ---------------------------------------------------------------------------

// A displacer's constants as the wrapper packs them (warpfields/fields.py:
// _KERNEL_CONSTANTS): kind (as a float), cx, cy, c, s, f, tx, ty, sup_cx,
// sup_cy, a, b, ratio, rinv. Staged as 16 floats, four float4 loads a
// displacer: f is kept as f - 1 and -b is added beside b, the values the
// eager expressions form from them.
constexpr int kFieldConsts = 14;
constexpr int kFieldRecord = 16;
constexpr int kFieldThreads = 256;
constexpr int kFieldPixels = 4;      // pixels a thread, kFieldThreads apart
constexpr int kFieldChunk = 128;     // displacers staged at once (8 KB)

// The float32 roundings of ops/detmath.py's constants, as the eager ops
// round a Python float against a float32 tensor.
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kExpC0 = 0x1.a0d2cep-13f;
constexpr float kExpC1 = 0x1.6e879cp-10f;
constexpr float kExpC2 = 0x1.11121p-7f;
constexpr float kExpC3 = 0x1.555382p-5f;
constexpr float kExpC4 = 0x1.555554p-3f;
constexpr float kExpC5 = 0x1p-1f;

// ops/detmath.py:det_exp: the clamp at -87 (a NaN passes, as in
// torch.clamp), k = floor(x * log2(e) + 0.5), the two-part ln 2 reduction,
// the Horner polynomial, and the scale 2^k built from its exponent bits.
__device__ __forceinline__ float det_exp(float x) {
  x = x < -87.0f ? -87.0f : x;
  const float k = floorf(__fadd_rn(__fmul_rn(x, kLog2e), 0.5f));
  const float r = __fsub_rn(__fsub_rn(x, __fmul_rn(k, kLn2Hi)),
                            __fmul_rn(k, kLn2Lo));
  float p = kExpC0;
  p = __fadd_rn(__fmul_rn(p, r), kExpC1);
  p = __fadd_rn(__fmul_rn(p, r), kExpC2);
  p = __fadd_rn(__fmul_rn(p, r), kExpC3);
  p = __fadd_rn(__fmul_rn(p, r), kExpC4);
  p = __fadd_rn(__fmul_rn(p, r), kExpC5);
  const float e = __fadd_rn(__fadd_rn(__fmul_rn(p, __fmul_rn(r, r)), r), 1.0f);
  const float scale = __uint_as_float((uint32_t)((int)k + 127) << 23);
  return __fmul_rn(e, scale);
}

// out (M, 2, S, S): for each direction m and lattice pixel (x * stride,
// y * stride), the sum over the N displacers, in index order from +0, of
// the motion (translation, rotation or zoom by `kind`) weighted by the
// rotated Gaussian support: warpfields/fields.py:_displacer_term, each
// operation rounded on its own in the eager expression's order. Grid:
// (pixel tiles of kFieldThreads * kFieldPixels, M); a block's direction is
// uniform, so it stages its displacers' constants in shared memory, chunk
// by chunk, and every thread takes the same motion branch.
__global__ void __launch_bounds__(kFieldThreads)
    elementary_field_kernel(const float* __restrict__ consts,
                            float* __restrict__ out, int N, int S,
                            float stride) {
  __shared__ __align__(16) float s_k[kFieldChunk * kFieldRecord];
  const int m = blockIdx.y;
  const int plane = S * S;
  const int p0 = blockIdx.x * (kFieldThreads * kFieldPixels) + threadIdx.x;
  float px[kFieldPixels], py[kFieldPixels], fx[kFieldPixels], fy[kFieldPixels];
#pragma unroll
  for (int i = 0; i < kFieldPixels; ++i) {
    const int p = p0 + i * kFieldThreads;
    px[i] = __fmul_rn((float)(p % S), stride);
    py[i] = __fmul_rn((float)(p / S), stride);
    fx[i] = 0.0f;
    fy[i] = 0.0f;
  }
  const float* src = consts + (size_t)m * N * kFieldConsts;
  for (int d0 = 0; d0 < N; d0 += kFieldChunk) {
    const int n = min(kFieldChunk, N - d0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kFieldConsts; i += kFieldThreads) {
      const float v = src[(size_t)d0 * kFieldConsts + i];
      const int q = i % kFieldConsts;
      float* rec = s_k + (i / kFieldConsts) * kFieldRecord;
      if (q < 12) rec[q] = q == 5 ? __fsub_rn(v, 1.0f) : v;
      if (q == 11) rec[12] = -v;
      if (q >= 12) rec[q + 1] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float4* rec = reinterpret_cast<const float4*>(s_k) + 4 * j;
      const float4 k0 = rec[0];   // kind, cx, cy, c
      const float4 k1 = rec[1];   // s, f - 1, tx, ty
      const float4 k2 = rec[2];   // sup_cx, sup_cy, a, b
      const float4 k3 = rec[3];   // -b, ratio, rinv
#pragma unroll
      for (int i = 0; i < kFieldPixels; ++i) {
        float mx, my;
        if (k0.x == 0.0f) {
          mx = k1.z;
          my = k1.w;
        } else {
          const float dx = __fsub_rn(px[i], k0.y);
          const float dy = __fsub_rn(py[i], k0.z);
          if (k0.x == 1.0f) {
            mx = __fsub_rn(__fsub_rn(__fmul_rn(k0.w, dx), __fmul_rn(k1.x, dy)),
                           dx);
            my = __fsub_rn(__fadd_rn(__fmul_rn(k1.x, dx), __fmul_rn(k0.w, dy)),
                           dy);
          } else {
            mx = __fmul_rn(k1.y, dx);
            my = __fmul_rn(k1.y, dy);
          }
        }
        const float ex = __fsub_rn(px[i], k2.x);
        const float ey = __fsub_rn(py[i], k2.y);
        const float rx = __fadd_rn(__fmul_rn(k2.z, ex), __fmul_rn(k2.w, ey));
        const float ry = __fmul_rn(
            __fadd_rn(__fmul_rn(k3.x, ex), __fmul_rn(k2.z, ey)), k3.y);
        const float r2 = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
        const float w = det_exp(__fmul_rn(-r2, k3.z));
        fx[i] = __fadd_rn(fx[i], __fmul_rn(mx, w));
        fy[i] = __fadd_rn(fy[i], __fmul_rn(my, w));
      }
    }
  }
  float* o = out + (size_t)m * 2 * plane;
#pragma unroll
  for (int i = 0; i < kFieldPixels; ++i) {
    const int p = p0 + i * kFieldThreads;
    if (p < plane) {
      o[p] = fx[i];
      o[plane + p] = fy[i];
    }
  }
}

}  // namespace flowgen

namespace {

// Launch one of the solve kernels over kSolveSplit CTAs a (field, tile)
// block, a cluster of them where the band can move. Its attributes (room
// for `smem` bytes, clusters of 16) are set at every launch: they hold for
// the current device only.
template <typename... Params, typename... Args>
int launch_solve(void (*kernel)(Params...), int N, int n_src, bool exchange,
                 dim3 block, int smem, cudaStream_t stream, Args... args) {
  using namespace flowgen;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = exchange ? kSolveSplit : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kSolveSplit * N * n_src);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The floats of scratch that flowgen_coarse_solve needs for a solve of N
// fields, Lv lanes by R rows, with bands of `scan` tiles: N * Ld * R where
// the slab takes the wide kernel (more than kSolveMaxRows rows a CTA; Ld:
// Lv rounded up to 128 lanes where the band can move, else Lv), else 0.
extern "C" long long flowgen_coarse_scratch_floats(int N, int Lv, int R,
                                                   int scan) {
  using namespace flowgen;
  const int rows_cta = (R + kSolveSplit - 1) / kSolveSplit;
  if (rows_cta <= kSolveMaxRows) return 0;
  const int n_src = (Lv + kLanes - 1) / kLanes;
  const long long Ld = n_src > scan ? (long long)n_src * kLanes : Lv;
  return (long long)N * Ld * R;
}

// The column-inverse solve of D (N, Hd, Wd, 2), element strides sN, sH, sW,
// sC, on its lattice of power-of-two stride `stride`: gd (N, Lv = Hd /
// stride, R = Wd / stride), n_iter fixed-point steps (at most
// kSolveMaxIter), Lv under 65536. The bank's case (stride 4, fewer than
// kSolveMaxSteps steps) is a compile-time case; any other reads the stride
// at run time and exchanges through StepKeys. Slabs of more than
// kSolveMaxRows rows (R over 1024) take the wide kernel, which keeps its
// iterate in `scratch`, scratch_floats long, apart from gd: at least
// flowgen_coarse_scratch_floats(N, Lv, R, scan) floats, or the call fails.
extern "C" int flowgen_coarse_solve(const float* D, long long sN, long long sH,
                                    long long sW, long long sC, int stride,
                                    float* gd, float* scratch,
                                    long long scratch_floats, int N, int Lv,
                                    int R, int n_iter, int scan, void* stream) {
  using namespace flowgen;
  if (N <= 0 || R <= 0 || Lv <= 0 || Lv > 0xFFFF || n_iter < 0 ||
      n_iter > kSolveMaxIter || scan <= 0 || stride <= 0 ||
      (stride & (stride - 1)) ||
      scratch_floats < flowgen_coarse_scratch_floats(N, Lv, R, scan))
    return (int)cudaErrorInvalidValue;
  const int rows_cta = (R + kSolveSplit - 1) / kSolveSplit;
  const int n_src = (Lv + kLanes - 1) / kLanes;
  const bool exchange = n_src > scan;
  const float yscale = 1.0f / (float)stride;   // exact: a power of two
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto src, auto wide, auto k2, auto k3, auto k4, auto k6,
                 auto k8) {
    if (rows_cta > kSolveMaxRows)
      return launch_solve(wide, N, n_src, exchange, dim3(kWideThreads), 0, s,
                          src, scratch, gd, R, Lv, rows_cta, n_iter, scan);
    int rt = kSolveRows;
    while (rt * kSolveMaxItems < rows_cta) rt *= 2;
    const int items = (rows_cta + rt - 1) / rt;
    const int smem = 2 * rows_cta * kSolveStride * (int)sizeof(float);
    auto solve = [&](auto kernel) {
      return launch_solve(kernel, N, n_src, exchange, dim3(kLanes, rt), smem,
                          s, src, gd, R, Lv, rows_cta, n_iter, scan);
    };
    switch (items) {
      case 1:
      case 2: return solve(k2);
      case 3: return solve(k3);
      case 4: return solve(k4);
      case 5:
      case 6: return solve(k6);
      default: return solve(k8);
    }
  };
  if (stride == kCoarse && n_iter < kSolveMaxSteps) {
    constexpr int S = kCoarse;
    return run(CoarseSrc<S>{D, sN, sH, sW, sC, yscale, stride},
               coarse_solve_wide_kernel<S>, coarse_solve_kernel<2, S>,
               coarse_solve_kernel<3, S>, coarse_solve_kernel<4, S>,
               coarse_solve_kernel<6, S>, coarse_solve_kernel<8, S>);
  }
  return run(CoarseSrc<0>{D, sN, sH, sW, sC, yscale, stride},
             coarse_solve_wide_kernel<0>, coarse_solve_kernel<2, 0>,
             coarse_solve_kernel<3, 0>, coarse_solve_kernel<4, 0>,
             coarse_solve_kernel<6, 0>, coarse_solve_kernel<8, 0>);
}

// out (N, 4h, 4w) = two x2 upsamples of gd (N, h, w), both contiguous.
extern "C" int flowgen_upsample4(const float* gd, float* out, int N, int h,
                                 int w, void* stream) {
  using namespace flowgen;
  if (N <= 0 || h <= 0 || w <= 0 || h > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kLanes - 1) / kLanes, h, N);
  upsample4_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(gd, out, h, w);
  return (int)cudaGetLastError();
}

// out (N, 2h, 2w) = one x2 upsample of gd (N, h, w), both contiguous.
extern "C" int flowgen_upsample2(const float* gd, float* out, int N, int h,
                                 int w, void* stream) {
  using namespace flowgen;
  if (N <= 0 || h <= 0 || w <= 0 || h > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kLanes - 1) / kLanes, h, N);
  upsample2_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(gd, out, h, w);
  return (int)cudaGetLastError();
}

// An empty kernel of one warp: the time of a launch that does no work.
extern "C" int flowgen_noop(void* stream) {
  flowgen::noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
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

// out (M, 2, S, S) = the elementary fields of M directions of N displacers
// each, consts (M, N, kFieldConsts) as warpfields/fields.py packs them, on
// the lattice of spacing `stride`; both contiguous float32. S * S must fit
// an int.
extern "C" int flowgen_elementary_field(const float* consts, float* out, int M,
                                        int N, int S, float stride,
                                        void* stream) {
  using namespace flowgen;
  if (M <= 0 || M > 65535 || N < 0 || S <= 0 || S > 46340)
    return (int)cudaErrorInvalidValue;
  const int per_block = kFieldThreads * kFieldPixels;
  const dim3 grid((S * S + per_block - 1) / per_block, M);
  elementary_field_kernel<<<grid, kFieldThreads, 0, (cudaStream_t)stream>>>(
      consts, out, N, S, stride);
  return (int)cudaGetLastError();
}
