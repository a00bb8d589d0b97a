// Scene kernel: renders a batch of flowgen scenes (both frames and the
// forward flow) on NVIDIA Hopper.
//
// Replaces the TPU megakernel flowgen/ops/pallas_scene.py:scene_render_pallas
// (kernel body _make_scene_kernel), rigid branch with tsplit == 1: no mode-9
// warps, no quadrant sub-windows, no inverse flow, no id images.
//
// What bounds it. Bytes: 2 frames of packed RGB plus 2 flow planes per sample
// written once (16 bytes a pixel) and the texels the output depends on, read
// once (a pixel that a later object covers fully needs no texel from below
// it). Next to them, the exact-area coverage costs one trapezoid integral
// (~45 float operations) per (polygon edge, owned pixel) pair that survives
// the row-block cull. On mode-7 scenes at the main path's shapes the two
// bounds are within a few tens of percent of each other (chip_smoke.py
// prints both); the kernel's own time is far above either, set by each
// thread's serial edge loop and the per-unit walk of the work list.
//
// Design. The TPU kernel keeps whole-frame accumulators resident in VMEM
// (about 3 MB at 512x384) and walks (object, tile) work units in painter's
// order over 192x256 windows. That does not fit in shared memory, so here:
//   * each CTA owns one 8x32 pixel tile of one (sample, frame) and keeps its
//     pixels' colour and flow in registers, one pixel a thread;
//   * it computes the background (the two-pass resample of the randomized
//     crop, reflect fold per static 192x256 background tile, rounded to u8)
//     and the affine flow init for those pixels;
//   * it walks the frame's work list in painter's order, skipping every unit
//     whose ownership rectangle misses the CTA tile (a block-uniform test);
//   * for a unit that meets the tile, it stages the unit's polygon edges in
//     shared memory and each pixel the unit owns computes coverage, texture,
//     blend and flow overwrite.
// Painter's order is kept per pixel, so no atomics are needed. CTA tiles are
// 8 rows high and aligned to 8, like the TPU kernel's window row blocks, so
// its edge and ellipse row-block culls are block-uniform here.
//
// Each pixel takes the frame-1 coefficients, row-block start w0 and column
// window c0 of the one work unit whose ownership rectangle holds it, in that
// unit's window geometry, so the clips of the staged resample are the TPU
// kernel's. Rounding is round-half-even (rintf); the file is compiled with
// -fmad=false and IEEE division and square root.

#include <cuda_runtime.h>
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
constexpr int kEdgePool = 896;   // edge-table row length
constexpr float kEllCullM = 2.0f;

// bgm / objmeta / tilemeta layouts (flowgen_torch/ops/scene.py).
constexpr int kBgmT0 = 0, kBgmT1 = 6, kBgmSrcW = 12, kBgmSrcH = 13;
constexpr int kBgmPix = 16, kBgmSize = 40;
constexpr int kOmiTex = 3, kOmiNPrims = 4, kOmiAddBits = 5, kOmiPolyBits = 6;
constexpr int kOmiNEdges = 8, kOmiSize = 16;
constexpr int kOmfMotion = 0, kOmfEll = 8, kOmfExt = 72, kOmfSize = 88;
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
  int* frames;          // (B, 2, H, W)
  float* flow;          // (B, 2, H, W)
  int B, K, EP, H, W, T, SHs, SWs, Tb, SHb, SWb, P, PBG, CWO, CWB;
  int use_aa, bg_only;
};

// Composite coverage of one unit at pixel (x, y): per-primitive exact area,
// then the screen algebra in primitive order (the TPU kernel's
// coverage_into). Edges of polygon primitives are staged in sedges.
__device__ void unit_coverage(const int* om,
                              const float* of, const float (*sedges)[kEdgePool],
                              int x, int y, int y0w, int x0w, int wh,
                              float* aa_out, float* in_out) {
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
      const int ne = om[kOmiNEdges + c];
      const int base = c * kMaxEdges;
      float area = 0.0f;
      for (int e = 0; e < ne; ++e) {
        const float ax = sedges[0][base + e];
        const float ay = sedges[1][base + e];
        const float bx = sedges[2][base + e];
        const float by = sedges[3][base + e];
        // The TPU kernel's culls: only the 8-row blocks an edge's y-span
        // touches, and no edge entirely left of the window.
        const int rlo = floor_i(fminf(ay, by) - oyf) - 1;
        const int rhi = floor_i(fmaxf(ay, by) - oyf);
        const int rb0 = min(max(rlo, 0), wh) >> 3;
        const int rb1 = (min(max(rhi, -1), wh - 1) >> 3) + 1;
        if (!(fmaxf(ax, bx) >= oxf) || rb < rb0 || rb >= min(rb1, nb)) continue;
        area = area + edge_contrib(ax, ay, bx, by, xlo, ylo);
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

__global__ void __launch_bounds__(kTileW* kTileH)
    scene_kernel(const SceneParams p) {
  __shared__ float sedges[4][kEdgePool];
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
  int val = 0;
  float flx = 0.0f, fly = 0.0f;
  if (inside) {
    const int oy = y >= H - wh ? H - wh : (y / wh) * wh;
    const int ox = x >= W - ww ? W - ww : (x / ww) * ww;
    float co[6];
    fold_coeffs(bgm + (frame ? kBgmT1 : kBgmT0), (float)ox + 0.5f * (float)ww,
                (float)oy + 0.5f * (float)wh, bgm[kBgmSrcW], bgm[kBgmSrcH],
                (float)kSlabMargin, co);
    const int btid = p.bg_meta[b * 3];
    const int* bslab = p.bgslabs + (size_t)btid * p.SHb * p.SWb;
    const int w0 = pass1_row_start(co, ox, oy, wh, ww, p.PBG, p.SHb);
    const int c0 = col_window(co, ox, w0, ww, p.PBG, p.CWB, p.SWb);
    float rgb[3];
    two_pass_pixel(bslab, p.SWb, w0, c0, p.CWB, p.PBG, co, x, y, rgb);
    val = pack3(rintf(rgb[0]), rintf(rgb[1]), rintf(rgb[2]));
    // Affine flow init: each product rounded on its own (-fmad=false).
    const float* m = bgm + kBgmPix;
    flx = ((m[0] * xf + m[1] * yf) + m[2]) - xf;
    fly = ((m[3] * xf + m[4] * yf) + m[5]) - yf;
  }

  // ---- object units in painter's order ----
  if (!p.bg_only) {
    const int K = p.K;
    const int maxw = K * kMaxTiles;
    const int n = p.n_units[b * 2 + frame];
    const int* wl = p.worklist + ((size_t)b * 2 + frame) * maxw;
    for (int j = 0; j < n; ++j) {
      const int u = wl[j];
      const int k = u / kMaxTiles;
      const int t = u - k * kMaxTiles;
      const size_t kf = ((size_t)b * K + k) * 2 + frame;
      const int* tm = p.tmi + (kf * kMaxTiles + t) * kTmiSize;
      const int oy0 = tm[2], oy1 = tm[3], ox0 = tm[4], ox1 = tm[5];
      // Block-uniform skip of units whose ownership misses this CTA.
      if (oy1 <= cy0 || oy0 >= cy0 + kTileH || ox1 <= cx0 ||
          ox0 >= cx0 + kTileW)
        continue;
      const int* om = p.omi + kf * kOmiSize;
      const float* of = p.omf + kf * kOmfSize;
      const int nprims = om[kOmiNPrims];
      const int poly_bits = om[kOmiPolyBits];
      const float* eg = p.edges + kf * 4 * p.EP;
      __syncthreads();  // the previous unit's readers are done
      for (int c = 0; c < nprims; ++c) {
        if (!((poly_bits >> c) & 1)) continue;
        const int ne = om[kOmiNEdges + c];
        for (int i = tid; i < 4 * ne; i += kTileW * kTileH) {
          const int r = i / ne;
          const int e = i - r * ne;
          sedges[r][c * kMaxEdges + e] = eg[(size_t)r * p.EP + c * kMaxEdges + e];
        }
      }
      __syncthreads();
      const bool own = inside && y >= oy0 && y < oy1 && x >= ox0 && x < ox1;
      if (!own) continue;
      const int y0w = tm[0] & ~7;
      const int x0w = tm[1] & ~127;
      float aa, ins;
      unit_coverage(om, of, sedges, x, y, y0w, x0w, wh, &aa, &ins);
      const float mm = p.use_aa ? aa : ins;
      const int* slab = p.slabs + (size_t)om[kOmiTex] * p.SHs * p.SWs;
      float tex[3];
      if (frame == 0) {
        const int sy = (kSlabMargin + y0w) & ~7;
        const int sx = (kSlabMargin + x0w) & ~127;
        unpack3(__ldg(slab + (size_t)(sy + y - y0w) * p.SWs + sx + (x - x0w)),
                tex);
      } else {
        float co[6];
        const float* tc = p.tmf + (kf * kMaxTiles + t) * kTmfSize;
#pragma unroll
        for (int i = 0; i < 6; ++i) co[i] = tc[i];
        const int w0 = pass1_row_start(co, x0w, y0w, wh, ww, p.P, p.SHs);
        const int c0 = col_window(co, x0w, w0, ww, p.P, p.CWO, p.SWs);
        two_pass_pixel(slab, p.SWs, w0, c0, p.CWO, p.P, co, x, y, tex);
      }
      float f[3];
      unpack3(val, f);
      const float om1 = 1.0f - mm;
      val = pack3(rintf(f[0] * om1 + tex[0] * mm), rintf(f[1] * om1 + tex[1] * mm),
                  rintf(f[2] * om1 + tex[2] * mm));
      if (frame == 0) {
        const float* mo = of + kOmfMotion;
        const float ofx = ((mo[0] * xf + mo[1] * yf) + mo[2]) - xf;
        const float ofy = ((mo[3] * xf + mo[4] * yf) + mo[5]) - yf;
        flx = ofx * ins + flx * (1.0f - ins);
        fly = ofy * ins + fly * (1.0f - ins);
      }
    }
  }

  if (inside) {
    const size_t pix = (size_t)y * W + x;
    p.frames[((size_t)b * 2 + frame) * H * W + pix] = val;
    if (frame == 0) {
      p.flow[((size_t)b * 2 + 0) * H * W + pix] = flx;
      p.flow[((size_t)b * 2 + 1) * H * W + pix] = fly;
    }
  }
}

}  // namespace flowgen

extern "C" int flowgen_scene_render(
    const int* worklist, const int* n_units, const int* bg_meta,
    const int* omi, const float* omf, const int* tmi, const float* tmf,
    const float* bgm, const float* edges, const int* slabs,
    const int* bgslabs, int* frames, float* flow, int B, int K, int EP, int H,
    int W, int T, int SHs, int SWs, int Tb, int SHb, int SWb, int P, int PBG,
    int CWO, int CWB, int use_aa, int bg_only, void* stream) {
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
  p.frames = frames;
  p.flow = flow;
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
  p.use_aa = use_aa;
  p.bg_only = bg_only;
  const dim3 block(flowgen::kTileW, flowgen::kTileH);
  const dim3 grid((W + flowgen::kTileW - 1) / flowgen::kTileW,
                  (H + flowgen::kTileH - 1) / flowgen::kTileH, 2 * B);
  flowgen::scene_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
