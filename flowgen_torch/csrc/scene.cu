// Scene kernel: renders a batch of flowgen scenes (both frames, the forward
// flow and, when asked, the inverse flow and the painter's id images) on
// NVIDIA Hopper.
//
// Replaces the TPU megakernel flowgen/ops/pallas_scene.py:scene_render_pallas
// (kernel body _make_scene_kernel), all of its branches: the rigid branch,
// the frame-1 texture sub-windows of the quadrant modes 11 and 13
// (tsplit == 2; the quadrant itself is composed into the tables and the
// rot90 slab copies on the host), the mode-9 warp branch (has_warp; device
// functions in warp.cuh), inverse flow and id images.
//
// What bounds it. Bytes: 2 frames of packed RGB plus 2 flow planes per sample
// written once (16 bytes a pixel; inverse flow adds 8, id images 8) and the
// texels the output depends on, read once (a pixel that a later object
// covers fully needs no texel from below it). Next to them, the exact-area coverage costs one trapezoid integral
// (~45 float operations) per (polygon edge, owned pixel) pair that survives
// the row-block cull. On mode-7 scenes at the main path's shapes the two
// bounds are within a few tens of percent of each other (chip_smoke.py
// prints both). The kernel's time is far above either: each CTA pays a
// prologue (the background's resample, the work list's binning, and per
// unit that meets it the staging of its edges behind barriers) that the
// device work per pixel does not amortise (PERF.md).
//
// Design. The TPU kernel keeps whole-frame accumulators resident in VMEM
// (about 3 MB at 512x384) and walks (object, tile) work units in painter's
// order over 192x256 windows. That does not fit in shared memory, so here:
//   * each CTA owns one 8x32 pixel tile of one (sample, frame) and keeps its
//     pixels' colour and flow in registers, one pixel a thread;
//   * it computes the background (the two-pass resample of the randomized
//     crop, reflect fold per static 192x256 background tile, rounded to u8)
//     and the affine flow init for those pixels;
//   * it bins the frame's work list once, one unit a thread: the units whose
//     ownership rectangle meets the CTA tile, compacted in painter's order
//     (ballot and a prefix over the warps), so the loop below walks only
//     those, not every unit of the frame;
//   * for each unit it met, it stages in shared memory only the edges that
//     can add a term to a cell it evaluates (stage_unit_edges: the TPU
//     kernel's culls, then coverage.cuh's exact ones), with their
//     pixel-independent constants, and each pixel the unit owns computes
//     coverage, texture, blend and flow overwrite.
// Painter's order is kept per pixel, so no atomics are needed. CTA tiles are
// 8 rows high and aligned to 8, like the TPU kernel's window row blocks, so
// its edge and ellipse row-block culls are block-uniform here.
//
// Each pixel takes the frame-1 coefficients, row-block start w0 and column
// window c0 of the one work unit whose ownership rectangle holds it, in that
// unit's window geometry, so the clips of the staged resample are the TPU
// kernel's. Rounding is round-half-even (rintf); the file is compiled with
// -fmad=false and IEEE division and square root.
//
// Mode 9 (scene_kernel<true>). A deforming object's frame-1 pixel, and a
// deforming background's, reads its source at 2x2 taps of the displaced
// u8-rounded intermediate; the kernel recomputes coverage, texture or
// background at each tap instead of staging a halo (warp.cuh), so such a
// pixel costs four coverage evaluations and 16 texel loads. Its taps lie on
// the unit's expanded window, displaced by as much as the bank's fields
// move (beyond WARP_D = 48 px: ROADMAP.md), so the cells a CTA evaluates
// for such a unit are measured from its pixels' taps before its edges are
// staged. The warp planes
// add about 8 bytes a displaced pixel and 8 a forward-field pixel to the
// bytes above; the recomputed coverage moves the operations count up.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "coverage.cuh"
#include "resample.cuh"

namespace flowgen {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kWinH = 192;
constexpr int kWinW = 256;
constexpr int kMaxTiles = 9;
constexpr int kSlabMargin = 256;
constexpr int kMaxEdges = 120;   // edge slots per primitive
constexpr float kEllCullM = 2.0f;

// bgm / objmeta / tilemeta layouts (flowgen_torch/ops/scene.py).
constexpr int kBgmT0 = 0, kBgmT1 = 6, kBgmSrcW = 12, kBgmSrcH = 13;
constexpr int kBgmPix = 16, kBgmFaff = 24, kBgmIpix = 32, kBgmSize = 40;
constexpr int kOmiTex = 3, kOmiNPrims = 4, kOmiAddBits = 5, kOmiPolyBits = 6;
constexpr int kOmiWarp = 7, kOmiNEdges = 8, kOmiSlot = 15, kOmiSize = 16;
constexpr int kOmfMotion = 0, kOmfEll = 8, kOmfRaw = 64, kOmfExt = 72;
constexpr int kOmfSize = 88;
// Id image values (flowgen_torch/config.py): background, first object slot.
constexpr int kBgId = 1, kFgIdBase = 10;
constexpr int kTmiSize = 8, kTmfSize = 8;

struct SceneParams {
  const int* worklist;  // (B, 2, K*9)
  const int* n_units;   // (B, 2)
  const int* bg_meta;   // (B, 3)
  const int* omi;       // (B, K, 2, 16)
  const float* omf;     // (B, K, 2, 88)
  const int* tmi;       // (B, K, 2, 9, 8)
  const float* tmf;     // (B, K, 2, 9, 8)
  const float* bgm;     // (B, 40)
  const float* edges;   // (B, K, 2, 4, EP)
  const int* slabs;     // (T, SHs, SWs)
  const int* bgslabs;   // (Tb, SHb, SWb)
  const float* aux;     // mode 9: (N, 4, H, W) [gdisp, vdisp, flow x, y]
  const float* bgaux;   // mode 9: (N, 2, H + 2*BG_EY, W) [gdisp, vdisp]
  const int* bg_band;   // mode 9: (N, n_bg_tiles, ww / 128) pass-1 band tiles
  int* frames;          // (B, 2, H, W)
  float* flow;          // (B, 2 or 4, H, W): forward, then inverse planes
  int* ids;             // emit_masks: (B, 2, H, W)
  int B, K, EP, H, W, T, SHs, SWs, Tb, SHb, SWb, P, PBG, CWO, CWB;
  int xscan, yscan, xscanb, yscanb;   // the TPU kernel's band scan counts
  int tsplit;           // frame-1 texture sub-windows per axis (1 or 2)
  int use_aa, bg_only, inverse_flow, emit_masks;
};

constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxPrims = 7;
constexpr int kPool = kMaxPrims * kMaxEdges;  // staged edge records

// One work unit's edges as a CTA stages them: primitive c's records are
// rec[start[c] .. start[c] + count[c]), in edge order; rec[i][0] = (ax, ay,
// dx, dy), rec[i][1] = (inv_dx, inv_dy, 0.5 dx, the edge's row blocks
// [rb0, rb1) as the int rb0 | rb1 << 16).
struct StagedEdges {
  float4 (*rec)[2];
  int* start;
  int* count;
};

// Stages the edges of one unit (omi row om, edge table eg of row length EP)
// that can add a term to a cell the CTA evaluates: the unit's coverage is
// evaluated on its window at (y0w, x0w), wh rows, at cells whose lower-left
// corners lie in [xlo, inf) x [ylo, yhi - 1] and whose row blocks lie in
// [cb0, cb1]. An edge is kept when it passes the TPU kernel's own culls
// (not entirely left of the window; its row blocks, computed as the TPU
// kernel does, meet [cb0, cb1]) and coverage.cuh's exact row and column
// culls. unit_coverage repeats the row-block test per (edge, pixel), so a
// pixel sums today's terms in today's order less terms that are +-0. Two
// primitives a round, one per half of the CTA, compacted by ballot and a
// prefix over the half's 4 warps; wcnt holds the warps' counts (two
// buffers, so one barrier a round). Every thread of the CTA calls it.
__device__ void stage_unit_edges(const int* om, const float* eg, int EP,
                                 int y0w, int x0w, int wh, int cb0, int cb1,
                                 float xlo, float ylo, float yhi,
                                 float4 (*pool)[2], int* start, int* count,
                                 int (*wcnt)[kTileH]) {
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int warp = threadIdx.y, lane = threadIdx.x;
  const int half = tid >> 7, e = tid & 127;
  const int nprims = om[kOmiNPrims];
  const int poly_bits = om[kOmiPolyBits];
  const float oxf = (float)x0w, oyf = (float)y0w;
  const int nb = wh >> 3;
  int running = 0;
  for (int r = 0; 2 * r < nprims; ++r) {
    const int c = 2 * r + half;
    bool keep = false;
    float4 rec[3];
    int blocks = 0;
    if (c < nprims && ((poly_bits >> c) & 1) && e < om[kOmiNEdges + c]) {
      const float* pe = eg + c * kMaxEdges + e;
      const float ax = pe[0], ay = pe[EP], bx = pe[2 * EP], by = pe[3 * EP];
      const int rlo = floor_i(fminf(ay, by) - oyf) - 1;
      const int rhi = floor_i(fmaxf(ay, by) - oyf);
      const int rb0 = min(max(rlo, 0), wh) >> 3;
      const int rb1 = min((min(max(rhi, -1), wh - 1) >> 3) + 1, nb);
      edge_record(ax, ay, bx, by, rec);
      keep = fmaxf(ax, bx) >= oxf && rb0 <= cb1 && cb0 < rb1 &&
             edge_rows_live(rec[2], ylo, yhi) && edge_cols_live(rec[1], xlo);
      blocks = rb0 | (rb1 << 16);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    int* wc = wcnt[r & 1];
    if (lane == 0) wc[warp] = __popc(bal);
    __syncthreads();
    const int n0 = wc[0] + wc[1] + wc[2] + wc[3];
    const int n1 = wc[4] + wc[5] + wc[6] + wc[7];
    if (keep) {
      int at = running + (half ? n0 : 0) + __popc(bal & ((1u << lane) - 1u));
      for (int v = 4 * half; v < warp; ++v) at += wc[v];
      pool[at][0] = rec[0];
      pool[at][1] = make_float4(rec[1].x, rec[1].y, rec[1].z,
                                __int_as_float(blocks));
    }
    if (tid < 2 && 2 * r + tid < kMaxPrims) {
      start[2 * r + tid] = running + (tid ? n0 : 0);
      count[2 * r + tid] = tid ? n1 : n0;
    }
    running += n0 + n1;
  }
  __syncthreads();
}

// Composite coverage of one unit at pixel (x, y): per-primitive exact area,
// then the screen algebra in primitive order (the TPU kernel's
// coverage_into). The edges of polygon primitives come staged (st).
__device__ void unit_coverage(const int* om, const float* of,
                              const StagedEdges& st, int x, int y, int y0w,
                              int x0w, int wh, float* aa_out, float* in_out) {
  const float oxf = (float)x0w, oyf = (float)y0w;
  const int nb = wh >> 3;
  const int rb = (y - y0w) >> 3;
  const float xlo = (float)(x - x0w) + oxf;
  const float ylo = (float)(y - y0w) + oyf;
  const int nprims = om[kOmiNPrims];
  const int add_bits = om[kOmiAddBits];
  const int poly_bits = om[kOmiPolyBits];
  float aa_acc = 0.0f, in_acc = 0.0f;
  for (int c = 0; c < nprims; ++c) {
    float area_ref = 0.0f;
    if ((poly_bits >> c) & 1) {
      const int e0 = st.start[c], e1 = e0 + st.count[c];
      float area = 0.0f;
      for (int e = e0; e < e1; ++e) {
        const float4 r1v = st.rec[e][1];
        // The TPU kernel's row-block cull: only the 8-row blocks an edge's
        // y-span touches.
        const int blocks = __float_as_int(r1v.w);
        if (rb < (blocks & 0xffff) || rb >= (blocks >> 16)) continue;
        area = area + edge_term(st.rec[e][0], r1v, xlo, ylo);
      }
      area = fabsf(area);
      area_ref = fminf(area, 1.0f) + (area >= 0.5f ? 2.0f : 0.0f);
    } else {
      const float* el = of + kOmfEll + c * 8;
      const float ymn = of[kOmfExt + 2 * c] - kEllCullM;
      const float ymx = of[kOmfExt + 2 * c + 1] + kEllCullM;
      const int rb0 = min(max(floor_i(ymn - oyf) - 1, 0), wh) >> 3;
      const int rb1 = (min(max(floor_i(ymx - oyf), -1), wh - 1) >> 3) + 1;
      if (rb >= rb0 && rb < min(rb1, nb)) {
        const float cx = (float)(x - x0w) + (oxf + 0.5f);
        const float cy = (float)(y - y0w) + (oyf + 0.5f);
        const float rx = el[6], ry = el[7];
        const float ux = ((el[0] * cx + el[1] * cy) + el[2]) / rx;
        const float uy = ((el[3] * cx + el[4] * cy) + el[5]) / ry;
        const float aa_e = ellipse_chord_coverage(ux, uy, el[0] / rx,
                                                  el[1] / rx, el[3] / ry,
                                                  el[4] / ry);
        area_ref = aa_e + (aa_e >= 0.5f ? 2.0f : 0.0f);
      }
    }
    const float aa = area_ref - (area_ref >= 2.0f ? 2.0f : 0.0f);
    const float ins = area_ref >= 2.0f ? 1.0f : 0.0f;
    if ((add_bits >> c) & 1) {
      aa_acc = 1.0f - (1.0f - aa_acc) * (1.0f - aa);
      in_acc = fmaxf(in_acc, ins);
    } else {
      aa_acc = aa_acc * (1.0f - aa);
      in_acc = in_acc * (1.0f - ins);
    }
  }
  *aa_out = aa_acc;
  *in_out = in_acc;
}

}  // namespace flowgen

#include "warp.cuh"

namespace flowgen {

// kWarp: the mode-9 instantiation. The rigid one holds none of the warp
// code, so its register count (and occupancy) is the rigid branch's own.
// Both are held to a number of CTAs an SM, chosen by measurement
// (tools/scene_launch_bounds.py builds other values and times them;
// PERF.md): the rigid one to FLOWGEN_SCENE_CTAS_RIGID, the warp one to
// FLOWGEN_SCENE_CTAS_WARP.
#ifndef FLOWGEN_SCENE_CTAS_RIGID
#define FLOWGEN_SCENE_CTAS_RIGID 4
#endif
#ifndef FLOWGEN_SCENE_CTAS_WARP
#define FLOWGEN_SCENE_CTAS_WARP 4
#endif
template <bool kWarp>
__global__ void __launch_bounds__(
    kTileW* kTileH, kWarp ? FLOWGEN_SCENE_CTAS_WARP : FLOWGEN_SCENE_CTAS_RIGID)
    scene_kernel(const SceneParams p) {
  __shared__ float4 s_pool[kPool][2];
  __shared__ int s_units[kThreads];
  __shared__ int s_start[kMaxPrims], s_count[kMaxPrims];
  __shared__ int s_wcnt[2][kTileH];
  __shared__ int s_box[kTileH][3];
  const int frame = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const int cx0 = blockIdx.x * kTileW;
  const int cy0 = blockIdx.y * kTileH;
  const int x = cx0 + threadIdx.x;
  const int y = cy0 + threadIdx.y;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int H = p.H, W = p.W;
  const int wh = min(kWinH, H), ww = min(kWinW, W);
  const bool inside = x < W && y < H;
  const float xf = (float)x, yf = (float)y;

  // ---- background: owner = the last static window tile covering (x, y) ----
  const float* bgm = p.bgm + (size_t)b * kBgmSize;
  const WarpFrame g = warp_frame(H, W);
  const bool bg_warp = kWarp && p.bg_meta[b * 3 + 1] != 0;
  const int bslot = p.bg_meta[b * 3 + 2];
  const int Pp = ((max(p.P, p.PBG) + 127) / 128) * 128;
  int val = 0;
  float flx = 0.0f, fly = 0.0f;
  if (inside) {
    const int oy = y >= H - wh ? H - wh : (y / wh) * wh;
    const int ox = x >= W - ww ? W - ww : (x / ww) * ww;
    const int btid = p.bg_meta[b * 3];
    const int* bslab = p.bgslabs + (size_t)btid * p.SHb * p.SWb;
    float co[6];
    fold_coeffs(bgm + (frame ? kBgmT1 : kBgmT0), (float)ox + 0.5f * (float)ww,
                (float)oy + 0.5f * (float)wh, bgm[kBgmSrcW], bgm[kBgmSrcH],
                (float)kSlabMargin, co);
    float rgb[3];
    if (frame == 1 && bg_warp) {
      const size_t pl = (size_t)g.HB * W;
      const int nty = (H + wh - 1) / wh, ntx = (W + ww - 1) / ww;
      const int bt = (y >= H - wh ? nty - 1 : y / wh) * ntx +
                     (x >= W - ww ? ntx - 1 : x / ww);
      const int band = p.bg_band[((size_t)bslot * nty * ntx + bt) * (ww / 128) +
                                 (x - ox) / 128];
      warp_bg_pixel(g, bgm, bslab, p.SHb, p.SWb, p.PBG, p.CWB,
                    p.bgaux + (size_t)bslot * 2 * pl,
                    p.bgaux + ((size_t)bslot * 2 + 1) * pl, band, x, y, oy,
                    rgb);
    } else {
      const int w0 = pass1_row_start(co, ox, oy, wh, ww, p.PBG, p.SHb);
      const int c0 = col_window(co, ox, w0, ww, p.PBG, p.CWB, p.SWb);
      two_pass_pixel(bslab, p.SWb, w0, c0, p.CWB, p.PBG, co, x, y, rgb);
    }
    val = pack3(rintf(rgb[0]), rintf(rgb[1]), rintf(rgb[2]));
    // Affine flow init, forward in frame 0 and inverse in frame 1: each
    // product rounded on its own (-fmad=false).
    const float* m = bgm + (frame ? kBgmIpix : kBgmPix);
    flx = ((m[0] * xf + m[1] * yf) + m[2]) - xf;
    fly = ((m[3] * xf + m[4] * yf) + m[5]) - yf;
    if (frame == 0 && bg_warp) {
      // Forward field of the background at the moved positions, x2
      // magnitude, inside the 2W x 2H big texture; added once per
      // static background tile holding the pixel, in tile order.
      const float mvx = ((m[0] * xf + m[1] * yf) + m[2]) + 0.5f * (float)W;
      const float mvy = ((m[3] * xf + m[4] * yf) + m[5]) + 0.5f * (float)H;
      const float inb = (mvx >= 0.0f && mvx < 2.0f * (float)W &&
                         mvy >= 0.0f && mvy < 2.0f * (float)H) ? 1.0f : 0.0f;
      float fa[6];
      two_pass_split(bgm + kBgmFaff, fa);
      const size_t pl = (size_t)H * W;
      const float* wfx_pl = p.aux + ((size_t)bslot * 4 + 2) * pl;
      const float* wfy_pl = p.aux + ((size_t)bslot * 4 + 3) * pl;
      for (int ty = 0; ty < (H + wh - 1) / wh; ++ty) {
        for (int tx = 0; tx < (W + ww - 1) / ww; ++tx) {
          const int y0s = min(ty * wh, H - wh), x0s = min(tx * ww, W - ww);
          if (y < y0s || y >= y0s + wh || x < x0s || x >= x0s + ww) continue;
          const float wx = resample_plane_pixel(wfx_pl, H, W, fa, y0s, x0s, wh,
                                                ww, p.P, Pp, p.xscanb,
                                                p.yscanb, x, y);
          const float wy = resample_plane_pixel(wfy_pl, H, W, fa, y0s, x0s, wh,
                                                ww, p.P, Pp, p.xscanb,
                                                p.yscanb, x, y);
          flx = flx + (2.0f * wx) * inb;
          fly = fly + (2.0f * wy) * inb;
        }
      }
    }
  }

  // ---- object units in painter's order ----
  const bool track_flow = frame == 0 || p.inverse_flow;
  int idv = kBgId;
  if (!p.bg_only) {
    const int K = p.K;
    const int maxw = K * kMaxTiles;
    const int n = p.n_units[b * 2 + frame];
    const int* wl = p.worklist + ((size_t)b * 2 + frame) * maxw;
    const int warp = threadIdx.y, lane = threadIdx.x;
    const StagedEdges st = {s_pool, s_start, s_count};
    for (int base = 0; base < n; base += kThreads) {
      // Bin a chunk of the work list, one unit a thread: the units whose
      // ownership rectangle meets this CTA's tile, compacted into s_units
      // in painter's order (ballot, then a prefix over the 8 warps).
      bool hit = false;
      int wu = 0;
      if (base + tid < n) {
        wu = wl[base + tid];
        const int k = wu / kMaxTiles;
        const int* tm = p.tmi + ((((size_t)b * K + k) * 2 + frame) * kMaxTiles +
                                 (wu - k * kMaxTiles)) * kTmiSize;
        hit = !(tm[3] <= cy0 || tm[2] >= cy0 + kTileH || tm[5] <= cx0 ||
                tm[4] >= cx0 + kTileW);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      __syncthreads();  // the previous chunk's readers are done
      if (lane == 0) s_wcnt[0][warp] = __popc(bal);
      __syncthreads();
      int n_hit = 0, at = __popc(bal & ((1u << lane) - 1u));
#pragma unroll
      for (int v = 0; v < kTileH; ++v) {
        at += v < warp ? s_wcnt[0][v] : 0;
        n_hit += s_wcnt[0][v];
      }
      if (hit) s_units[at] = wu;
      for (int j = 0; j < n_hit; ++j) {
        __syncthreads();  // s_units is written; the last unit's readers are done
        const int u = s_units[j];
        const int k = u / kMaxTiles;
        const int t = u - k * kMaxTiles;
        const size_t kf = ((size_t)b * K + k) * 2 + frame;
        const int* tm = p.tmi + (kf * kMaxTiles + t) * kTmiSize;
        const int oy0 = tm[2], oy1 = tm[3], ox0 = tm[4], ox1 = tm[5];
        const int* om = p.omi + kf * kOmiSize;
        const float* of = p.omf + kf * kOmfSize;
        const int y0w = tm[0] & ~7;
        const int x0w = tm[1] & ~127;
        const bool own = inside && y >= oy0 && y < oy1 && x >= ox0 && x < ox1;
        const bool warping = kWarp && om[kOmiWarp] != 0;
        const size_t pl = (size_t)H * W;
        const float* slot_aux =
            warping ? p.aux + (size_t)om[kOmiSlot] * 4 * pl : nullptr;
        // The cells the CTA evaluates for this unit: its owned pixels on the
        // unit's window, or, for a deforming frame 1, the pixels' taps on
        // the expanded window, reduced over the CTA (WARP_D does not bound
        // the displacements, so the box is measured, not assumed).
        int sy0 = y0w, sx0 = x0w, swh = wh;
        int r0 = max(cy0, oy0) - y0w, r1 = min(cy0 + kTileH, oy1) - 1 - y0w;
        int cl = max(cx0, ox0) - x0w;
        if (kWarp && frame == 1 && warping) {
          const WarpTaps tp =
              warp_taps(g, slot_aux, slot_aux + pl, x, y, y0w, x0w);
          int lo = own ? tp.tv.i0 : INT_MAX, hi = own ? tp.tv.i1 : INT_MIN;
          cl = own ? min(tp.tu[0].i0, tp.tu[1].i0) : INT_MAX;
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          cl = __reduce_min_sync(0xffffffffu, cl);
          if (lane == 0) {
            s_box[warp][0] = lo;
            s_box[warp][1] = hi;
            s_box[warp][2] = cl;
          }
          __syncthreads();
#pragma unroll
          for (int v = 0; v < kTileH; ++v) {
            lo = min(lo, s_box[v][0]);
            hi = max(hi, s_box[v][1]);
            cl = min(cl, s_box[v][2]);
          }
          sy0 = tp.ey0;
          sx0 = tp.ex0;
          swh = g.whE;
          r0 = lo;
          r1 = hi;
        }
        const float fy0 = (float)sy0, fx0 = (float)sx0;
        stage_unit_edges(om, p.edges + kf * 4 * p.EP, p.EP, sy0, sx0, swh,
                         r0 >> 3, r1 >> 3, (float)cl + fx0, (float)r0 + fy0,
                         ((float)r1 + fy0) + 1.0f, s_pool, s_start, s_count,
                         s_wcnt);
        if (!own) continue;
        const int* slab = p.slabs + (size_t)om[kOmiTex] * p.SHs * p.SWs;
        // ins: the binary mask (the warped one for a deforming frame 1).
        float aa = 0.0f, ins = 0.0f, mm;
        float tex[3];
        if (frame == 1 && warping) {
          warp_unit_pixel(g, om, of, st, slot_aux, slot_aux + pl, slab,
                          p.SHs, p.SWs, p.P, p.CWO, p.use_aa, x, y, y0w, x0w,
                          &mm, &ins, tex);
        } else {
          unit_coverage(om, of, st, x, y, y0w, x0w, wh, &aa, &ins);
          mm = p.use_aa ? aa : ins;
          if (frame == 0) {
            const int sy = (kSlabMargin + y0w) & ~7;
            const int sx = (kSlabMargin + x0w) & ~127;
            unpack3(__ldg(slab + (size_t)(sy + y - y0w) * p.SWs + sx + (x - x0w)),
                    tex);
          } else if (p.tsplit == 1) {
            float co[6];
            const float* tc = p.tmf + (kf * kMaxTiles + t) * kTmfSize;
#pragma unroll
            for (int i = 0; i < 6; ++i) co[i] = tc[i];
            const int w0 = pass1_row_start(co, x0w, y0w, wh, ww, p.P, p.SHs);
            const int c0 = col_window(co, x0w, w0, ww, p.P, p.CWO, p.SWs);
            two_pass_pixel(slab, p.SWs, w0, c0, p.CWO, p.P, co, x, y, tex);
          } else {
            // The pixel's texture sub-window: the raw residual affine folded
            // at the sub-window's centre with the source's reflect periods,
            // then the two-pass resample of that sub-window's row block.
            const int whs = wh / p.tsplit, wws = ww / p.tsplit;
            const int oy = y0w + ((y - y0w) / whs) * whs;
            const int ox = x0w + ((x - x0w) / wws) * wws;
            float co[6];
            fold_coeffs(of + kOmfRaw, (float)ox + 0.5f * (float)wws,
                        (float)oy + 0.5f * (float)whs, of[kOmfRaw + 6],
                        of[kOmfRaw + 7], (float)kSlabMargin, co);
            const int w0 = pass1_row_start(co, ox, oy, whs, wws, p.P, p.SHs);
            const int c0 = col_window(co, ox, w0, wws, p.P, p.CWO, p.SWs);
            two_pass_pixel(slab, p.SWs, w0, c0, p.CWO, p.P, co, x, y, tex);
          }
        }
        float f[3];
        unpack3(val, f);
        const float om1 = 1.0f - mm;
        val = pack3(rintf(f[0] * om1 + tex[0] * mm), rintf(f[1] * om1 + tex[1] * mm),
                    rintf(f[2] * om1 + tex[2] * mm));
        // The painter's id: the object's slot where the binary mask is 1.
        if (ins >= 1.0f) idv = kFgIdBase + k;
        if (track_flow) {
          // Frame 1's OMF_MOTION is the inverse motion.
          const float* mo = of + kOmfMotion;
          const float ofx = ((mo[0] * xf + mo[1] * yf) + mo[2]) - xf;
          const float ofy = ((mo[3] * xf + mo[4] * yf) + mo[5]) - yf;
          flx = ofx * ins + flx * (1.0f - ins);
          fly = ofy * ins + fly * (1.0f - ins);
          if (frame == 0 && warping) {
            // + forward field at the moved position, inside the frame, under
            // the same mask.
            const float mvx = (mo[0] * xf + mo[1] * yf) + mo[2];
            const float mvy = (mo[3] * xf + mo[4] * yf) + mo[5];
            const float inb = ((mvx >= 0.0f && mvx < (float)W && mvy >= 0.0f &&
                                mvy < (float)H) ? 1.0f : 0.0f) * ins;
            float co[6];
            two_pass_split(mo, co);
            const float wx = resample_plane_pixel(slot_aux + 2 * pl, H, W, co,
                                                  y0w, x0w, wh, ww, p.P, Pp,
                                                  p.xscan, p.yscan, x, y);
            const float wy = resample_plane_pixel(slot_aux + 3 * pl, H, W, co,
                                                  y0w, x0w, wh, ww, p.P, Pp,
                                                  p.xscan, p.yscan, x, y);
            flx = flx + wx * inb;
            fly = fly + wy * inb;
          }
        }
      }
    }
  }

  if (inside) {
    const size_t pix = (size_t)y * W + x;
    p.frames[((size_t)b * 2 + frame) * H * W + pix] = val;
    if (track_flow) {
      const size_t c0 = (size_t)b * (p.inverse_flow ? 4 : 2) + 2 * frame;
      p.flow[c0 * H * W + pix] = flx;
      p.flow[(c0 + 1) * H * W + pix] = fly;
    }
    if (p.emit_masks) p.ids[((size_t)b * 2 + frame) * H * W + pix] = idv;
  }
}

}  // namespace flowgen

extern "C" int flowgen_scene_render(
    const int* worklist, const int* n_units, const int* bg_meta,
    const int* omi, const float* omf, const int* tmi, const float* tmf,
    const float* bgm, const float* edges, const int* slabs,
    const int* bgslabs, const float* aux, const float* bgaux,
    const int* bg_band, int* frames, float* flow, int* ids, int B, int K,
    int EP, int H, int W, int T, int SHs, int SWs, int Tb, int SHb, int SWb,
    int P, int PBG, int CWO, int CWB, int xscan, int yscan, int xscanb,
    int yscanb, int tsplit, int has_warp, int use_aa, int bg_only,
    int inverse_flow, int emit_masks, void* stream) {
  flowgen::SceneParams p;
  p.worklist = worklist;
  p.n_units = n_units;
  p.bg_meta = bg_meta;
  p.omi = omi;
  p.omf = omf;
  p.tmi = tmi;
  p.tmf = tmf;
  p.bgm = bgm;
  p.edges = edges;
  p.slabs = slabs;
  p.bgslabs = bgslabs;
  p.aux = aux;
  p.bgaux = bgaux;
  p.bg_band = bg_band;
  p.frames = frames;
  p.flow = flow;
  p.ids = ids;
  p.B = B;
  p.K = K;
  p.EP = EP;
  p.H = H;
  p.W = W;
  p.T = T;
  p.SHs = SHs;
  p.SWs = SWs;
  p.Tb = Tb;
  p.SHb = SHb;
  p.SWb = SWb;
  p.P = P;
  p.PBG = PBG;
  p.CWO = CWO;
  p.CWB = CWB;
  p.xscan = xscan;
  p.yscan = yscan;
  p.xscanb = xscanb;
  p.yscanb = yscanb;
  p.tsplit = tsplit;
  p.use_aa = use_aa;
  p.bg_only = bg_only;
  p.inverse_flow = inverse_flow;
  p.emit_masks = emit_masks;
  const dim3 block(flowgen::kTileW, flowgen::kTileH);
  const dim3 grid((W + flowgen::kTileW - 1) / flowgen::kTileW,
                  (H + flowgen::kTileH - 1) / flowgen::kTileH, 2 * B);
  if (has_warp)
    flowgen::scene_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  else
    flowgen::scene_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
