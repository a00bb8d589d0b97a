// The standalone two-pass affine resampler on NVIDIA Hopper: a (wh, ww)
// window of a packed-RGB padded slab through an output -> slab affine.
//
// Replaces flowgen/ops/pallas_resample.py:affine_resample_pallas (its
// pallas_call stages the slab's whole rows [w0, w0+P) from
// pass1_row_start and runs resample_rows_in_kernel over them). Per pixel the
// two passes collapse into resample.cuh:two_pass_pixel; the row start is
// pass1_row_start, the column window the whole slab width. Block (32, 8);
// grid over the window. Compiled with -fmad=false, as the scene kernel.
// Bound by bytes (the window written once, the slab texels of its footprint
// read once): 3.3 MB for a 384x512 window, a microsecond at the card's
// memory rate, so a call's time is mostly the launch's own cost and one
// round trip of reads and writes (PERF.md). The row start, uniform over
// the launch, is computed once a block by its first thread, not in every
// thread. Forms that resample 2 or 4 pixels a thread or write a row
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

__global__ void __launch_bounds__(256)
    affine_resample_kernel(const int* __restrict__ slab, Coeffs coeffs,
                           float* __restrict__ out, int SH, int SW, int x0,
                           int y0, int wh, int ww, int P) {
  float co[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) co[k] = coeffs.v[k];
  __shared__ int w0_s;
  if (threadIdx.x == 0 && threadIdx.y == 0)
    w0_s = pass1_row_start(co, x0, y0, wh, ww, P, SH);
  __syncthreads();
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int i = blockIdx.y * 8 + threadIdx.y;
  if (i >= wh || j >= ww) return;
  float v[3];
  two_pass_pixel(slab, SW, w0_s, 0, SW, P, co, x0 + j, y0 + i, v);
  float* o = out + ((size_t)i * ww + j) * 3;
  o[0] = v[0];
  o[1] = v[1];
  o[2] = v[2];
}

}  // namespace flowgen

// The six coefficients come by value, so a call copies nothing to the card.
extern "C" int flowgen_affine_resample(const int* slab, float A, float B,
                                       float C, float c, float d, float f,
                                       float* out, int SH, int SW, int x0,
                                       int y0, int wh, int ww, int P,
                                       void* stream) {
  if (wh <= 0 || ww <= 0 || P <= 0 || P > SH) return (int)cudaErrorInvalidValue;
  const flowgen::Coeffs co = {{A, B, C, c, d, f}};
  const dim3 block(32, 8);
  const dim3 grid((ww + 31) / 32, (wh + 7) / 8);
  flowgen::affine_resample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      slab, co, out, SH, SW, x0, y0, wh, ww, P);
  return (int)cudaGetLastError();
}
