// Photometric augmentation on NVIDIA Hopper: FlowNet's colour, gamma,
// brightness, contrast and per-frame Gaussian noise over a batch of image
// pairs.
//
// Replaces flowgen/ops/photometric.py:augment_batch. In the JAX package that
// is XLA, not Pallas: XLA fuses it into one elementwise loop. Per value:
// threefry2x32 of the value's flat index in its (H, W, 3) frame under the
// (sample, frame) noise key (JAX's partitionable random bits), the uniform on
// [nextafter(-1, 0), 1), XLA:CPU's float32 erf_inv (with its log1p and log),
// glibc's powf in float64 for the gamma, the shared map, the noise and the
// clip. Every function restates flowgen_torch/_fp.py operation for
// operation, and __fmaf_rn stands exactly where _fp restates an XLA
// contraction; the file is compiled with -fmad=false and exact division and
// square root, so the kernels equal ops/photometric.py:augment_batch_plain
// bit for bit.
//
// Two kernels a call. photometric_table_kernel (one block a sample) draws
// the sample's scalars and both frames' noise keys once, and tabulates the
// shared map (colour, gamma, brightness, contrast: a function of the
// channel and the input value alone) at the 256 whole levels of each
// channel, into a per-sample record. photometric_kernel then reads the
// record into shared memory and gives each thread groups of 4 whole pixels
// (12 values, 3 float4 loads and stores, channels fixed at compile time).
// A value that is a whole level in [0, 255] (what the renderers write, -0
// included) reads the table; any other value takes the direct expression
// on the same device functions. Both arms give the same bits for a level,
// since they evaluate one function on one float32 input.
//
// What bounds it: the int32 work of threefry (74 operations a value) at the
// card's int32 rate, about twice the time of its bytes (8 a value;
// PERF.md). The table takes float64 pow off the per-value path; what is left
// a value is the hash, erf_inv and one shared-memory read, about 210
// instructions in all, so the issue slots come before the int32 lanes.
// erf_inv's two polynomials are branches, its log's frexpf is bit
// arithmetic and the direct arm is one branch a group, to keep that count
// down.

#include <cuda_runtime.h>
#include <stdint.h>

namespace flowgen {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // groups of 4 pixels a thread
// Blocks of the value pass an SM holds: 4 caps it at 64 registers a thread
// (3 blocks at the 80 it takes uncapped; measured by
// tools/torch_photometric_variants.py).
constexpr int kValueBlocks = 4;
constexpr int kLevels = 256;
constexpr uint32_t kAuxPhotometric = 101;

// The per-sample record: the map's table (channel-major, 3 x 256 floats),
// then the draws. 784 words, a multiple of 4 (float4 copies).
constexpr int kRecSigma = 3 * kLevels;      // noise sigma times sqrt(2)
constexpr int kRecKey = kRecSigma + 1;      // frame 0's key, frame 1's key
constexpr int kRecColor = kRecKey + 4;      // colour / 255, 3 floats
constexpr int kRecGamma = kRecColor + 3;
constexpr int kRecBright = kRecGamma + 1;
constexpr int kRecContrast = kRecBright + 1;
constexpr int kRecord = 784;
static_assert(kRecContrast < kRecord && kRecord % 4 == 0, "record layout");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// threefry2x32, 20 rounds, of the counter (x0, x1) under (k0, k1); returns
// the xor of the two output words (JAX's 32-bit random bits), or the pair.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ uint32_t random_word(uint32_t k0, uint32_t k1,
                                                uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float32 from 32 random bits: 23 of them as the
// mantissa of [1, 2), minus 1, scaled and shifted with one rounding, held
// at lo from below (streams.uniform).
__device__ __forceinline__ float uniform(uint32_t bits, float lo, float span) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(__fmaf_rn(u, span, lo), lo);
}

// _fp.log: XLA:CPU's Cephes log with its contractions. xc is a positive
// normal or +inf (fmaxf drops a NaN), so frexpf is its exponent field and
// its mantissa under the exponent of 0.5 (an inf's result is replaced
// below).
__device__ __forceinline__ float xla_log(float x) {
  const float xc = fmaxf(x, __int_as_float(0x00800000));  // 2^-126
  const int bits = __float_as_int(xc);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  float e = (float)((bits >> 23) - 126);
  const bool fold = m < 0.707106781186547524f;
  const float z = fold ? (m - 1.0f) + m : m - 1.0f;
  e = fold ? e - 1.0f : e;
  const float z2 = z * z;
  const float z3 = z2 * z;
  float y = __fmaf_rn(__fmaf_rn(7.0376836292e-2f, z, -1.1514610310e-1f), z,
                      1.1676998740e-1f);
  const float y1 = __fmaf_rn(__fmaf_rn(-1.2420140846e-1f, z, 1.4249322787e-1f),
                             z, -1.6668057665e-1f);
  const float y2 = __fmaf_rn(__fmaf_rn(2.0000714765e-1f, z, -2.4999993993e-1f),
                             z, 3.3333331174e-1f);
  y = __fmaf_rn(__fmaf_rn(y, z3, y1), z3, y2);
  y = __fmaf_rn(y, z3, e * -2.12194440e-4f);
  float out = __fmaf_rn(0.693359375f, e, (z - z2 * 0.5f) + y);
  if (x == 0.0f) out = -__int_as_float(0x7F800000);
  if (x < 0.0f) out = __int_as_float(0x7FC00000);
  if (x == __int_as_float(0x7F800000)) out = x;
  return out;
}

// _fp.log1p: XLA's elemental log1p (Cephes rational below sqrt(2) - 1).
// For the finite x that erf_inv passes, the Horner sums' first steps
// fma(0, x, c) are c, and start there.
__device__ __forceinline__ float xla_log1p(float x) {
  const float num[7] = {4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
                        6.5787325942061044846969e0f,  2.9911919328553073277375e1f,
                        6.0949667980987787057556e1f,  5.7112963590585538103336e1f,
                        2.0039553499201281259648e1f};
  const float den[7] = {1.0f,
                        1.5062909083469192043167e1f,
                        8.3047565967967209469434e1f,
                        2.2176239823732856465394e2f,
                        3.0909872225312059774938e2f,
                        2.1642788614495947685003e2f,
                        6.0118660497603843919306e1f};
  const float x2 = x * x;
  float pn = num[0], pd = den[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    pn = __fmaf_rn(pn, x, num[i]);
    pd = __fmaf_rn(pd, x, den[i]);
  }
  float s = __fdiv_rn(pn, pd);
  s = x + (x * x2 * s + x2 * -0.5f);
  return fabsf(x) < 0.41421356237309504880f ? s : xla_log(x + 1.0f);
}

// _fp.erf_inv: CHLO's float32 erf_inv (Giles), Horner steps contracted.
// The two polynomials are two branches (not a select of each coefficient):
// w >= 5 takes 0.3% of the uniform draws, so most warps run one.
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float lo_c[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                         -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                         -0.00417768164f,  0.246640727f,    1.50140941f};
  const float hi_c[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                         -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                         0.00943887047f,   1.00167406f,     2.83297682f};
  const float w = -xla_log1p(x * -x);
  float p;
  if (w < 5.0f) {
    const float t = w - 2.5f;
    p = lo_c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, t, lo_c[i]);
  } else {
    const float t = __fsqrt_rn(w) - 3.0f;
    p = hi_c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, t, hi_c[i]);
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

// glibc's powf tables (_fp._POW_LOG2_TAB, _POW_EXP2_TAB).
__device__ const double kLog2Tab[16][2] = {
    {0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2},
    {0x1.571ed4aaf883dp+0, -0x1.b0b6832d4fca4p-2},
    {0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2},
    {0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2},
    {0x1.30d190c8864a5p+0, -0x1.01d9bf3f2b631p-2},
    {0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3},
    {0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3},
    {0x1.12358f08ae5bap+0, -0x1.960cbbf788d5cp-4},
    {0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5},
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.e608cfd9a47acp-1, 0x1.338ca9f24f53dp-4},
    {0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3},
    {0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3},
    {0x1.9c2d163a1aa2dp-1, 0x1.40645f0c6651cp-2},
    {0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2},
    {0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2}};
__device__ const unsigned long long kExp2Tab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

// _fp.pow: glibc's powf for positive normal x and |y log2 x| < 126, in
// float64 without contraction, rounded once to float32.
__device__ __forceinline__ float glibc_powf(float x, float y) {
  const uint32_t ix = __float_as_uint(x);
  const uint32_t tmp = ix - 0x3F330000u;
  const int i = (int)((tmp >> 19) & 15u);
  const uint32_t top = tmp & 0xFF800000u;
  const uint32_t iz = ix - top;
  const int k = (int)top >> 23;
  const double z = (double)__uint_as_float(iz);
  const double invc = __ldg(&kLog2Tab[i][0]), logc = __ldg(&kLog2Tab[i][1]);
  const double r = z * invc - 1.0;
  const double y0 = logc + (double)k;
  const double r2 = r * r;
  const double q = 0x1.27616c9496e0bp-2 * r + -0x1.71969a075c67ap-2;
  const double p = 0x1.ec70a6ca7baddp-2 * r + -0x1.7154748bef6c8p-1;
  const double r4 = r2 * r2;
  double q2 = 0x1.71547652ab82bp+0 * r + y0;
  q2 = p * r2 + q2;
  const double logx = q * r4 + q2;
  const double ylogx = (double)y * logx;
  const double shift = 0x1.8p+47;
  const double kd = (ylogx + shift) - shift;
  const double rr = ylogx - kd;
  const long long ki = (long long)(kd * 32.0);
  const double s = __longlong_as_double(
      (long long)__ldg(&kExp2Tab[ki & 31]) + ki * (1ll << 47));
  const double zz = 0x1.c6af84b912394p-5 * rr + 0x1.ebfce50fac4f3p-3;
  const double rr2 = rr * rr;
  double yy = 0x1.62e42ff0c52d6p-1 * rr + 1.0;
  yy = zz * rr2 + yy;
  return __double2float_rn(yy * s);
}

// The shared map of one value: colour, gamma, brightness and contrast.
__device__ __forceinline__ float shared_map(float x, float color, float gamma,
                                            float bright, float contrast) {
  float y = fmaxf(x * color, 1e-6f);
  y = glibc_powf(y, gamma);
  y = (y + bright) + -0.5f;
  return __fmaf_rn(y, contrast, 0.5f);
}

struct Consts {
  float c_lo, c_span, g_lo, g_span, k_lo, k_span, n_lo, n_span, bright_k;
};

// One block a sample. Warp 0 derives the sample's draws from its key
// (lanes 0-8 in parallel), then each thread tabulates one level of each
// channel.
__global__ void __launch_bounds__(kThreads)
    photometric_table_kernel(const long long* __restrict__ root,
                             const long long* __restrict__ indices,
                             float* __restrict__ records, Consts cs) {
  __shared__ float draws[8];  // colour x3, gamma, bright, contrast, sigma
  const int b = blockIdx.x, tid = threadIdx.x;
  float* __restrict__ rec = records + (size_t)b * kRecord;
  if (tid < 32) {
    // sample_key, fold_in(AUX_PHOTOMETRIC), then key j of the 7-way split.
    uint32_t s0 = 0, s1 = (uint32_t)indices[b];
    threefry((uint32_t)root[0], (uint32_t)root[1], s0, s1);
    uint32_t a0 = 0, a1 = kAuxPhotometric;
    threefry(s0, s1, a0, a1);
    const int lane = tid;
    // Lanes 0-2 colour word 0-2, 3 gamma, 4 brightness, 5 contrast, 6
    // noise sigma, 7 and 8 the two frames' noise keys.
    const uint32_t j = lane < 3 ? 0u : (uint32_t)(lane - 2);
    uint32_t k0 = 0, k1 = j;
    threefry(a0, a1, k0, k1);
    if (lane == 7 || lane == 8) {
      uint32_t* key = reinterpret_cast<uint32_t*>(rec + kRecKey);
      key[2 * (lane - 7)] = k0;
      key[2 * (lane - 7) + 1] = k1;
    } else if (lane < 7) {
      const uint32_t bits = random_word(k0, k1, lane < 3 ? (uint32_t)lane : 0u);
      float d;
      if (lane < 3) {
        d = uniform(bits, cs.c_lo, cs.c_span) * 0.00392156886f;
      } else if (lane == 3) {
        d = uniform(bits, cs.g_lo, cs.g_span);
      } else if (lane == 4) {
        d = xla_erf_inv(uniform(bits, -0.99999994f, 2.0f)) * cs.bright_k;
      } else if (lane == 5) {
        d = uniform(bits, cs.k_lo, cs.k_span) + 1.0f;
      } else {
        d = uniform(bits, cs.n_lo, cs.n_span) * 1.41421354f;
      }
      draws[lane] = d;
    }
  }
  __syncthreads();
  const float gamma = draws[3], bright = draws[4], contrast = draws[5];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rec[c * kLevels + tid] =
        shared_map((float)tid, draws[c], gamma, bright, contrast);
  if (tid < 3) rec[kRecColor + tid] = draws[tid];
  if (tid == 3) rec[kRecGamma] = gamma;
  if (tid == 4) rec[kRecBright] = bright;
  if (tid == 5) rec[kRecContrast] = contrast;
  if (tid == 6) rec[kRecSigma] = draws[6];
}

// x + 2^23 holds x's nearest integer in its low mantissa bits: x is whole
// when subtracting 2^23 gives x back, and a level in [0, 255] (-0 too)
// when those bits are 2^23's plus 0..255. Returns the level, or -1.
__device__ __forceinline__ int whole_level(float x) {
  const float y = x + 8388608.0f;
  const uint32_t level = __float_as_uint(y) - 0x4B000000u;
  return level <= 255u && y - 8388608.0f == x ? (int)level : -1;
}

// The noise and the clip of one mapped value at flat index idx.
__device__ __forceinline__ float add_noise(float m, uint32_t idx, uint32_t k0,
                                           uint32_t k1, float sigma) {
  const float e =
      xla_erf_inv(uniform(random_word(k0, k1, idx), -0.99999994f, 2.0f));
  return fminf(fmaxf(__fmaf_rn(e, sigma, m), 0.0f), 1.0f) * 255.0f;
}

// Grid (chunks of a frame's pixel groups, 2 frames, B samples). kVec: every
// frame starts 16-byte aligned and holds whole groups (n % 12 == 0), so a
// group is three float4; otherwise scalar accesses with a tail.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kValueBlocks)
    photometric_kernel(const float* __restrict__ records,
                       const float* __restrict__ img0,
                       const float* __restrict__ img1,
                       float* __restrict__ out0, float* __restrict__ out1,
                       int n) {
  __shared__ __align__(16) float rec[kRecord];
  const int b = blockIdx.z, frame = blockIdx.y, tid = threadIdx.x;
  if (tid < kRecord / 4)
    reinterpret_cast<float4*>(rec)[tid] =
        reinterpret_cast<const float4*>(records + (size_t)b * kRecord)[tid];
  __syncthreads();
  const uint32_t* key = reinterpret_cast<const uint32_t*>(rec + kRecKey);
  const uint32_t k0 = key[2 * frame], k1 = key[2 * frame + 1];
  const float sigma = rec[kRecSigma];
  const float* __restrict__ src = (frame ? img1 : img0) + (size_t)b * n;
  float* __restrict__ dst = (frame ? out1 : out0) + (size_t)b * n;
  const int ngroups = (n + 11) / 12;
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int q = (blockIdx.x * kGroups + g) * kThreads + tid;
    if (q >= ngroups) break;
    const int base = 12 * q;
    float v[12];
    if (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(src + base);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 t = __ldcs(s4 + k);
        v[4 * k] = t.x;
        v[4 * k + 1] = t.y;
        v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) v[k] = base + k < n ? src[base + k] : 0.0f;
    }
    // The map: the table for whole levels; any other value (none on the
    // renderers' frames) takes the direct expression, behind one branch a
    // group.
    float m[12];
    bool whole = true;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const int level = whole_level(v[k]);
      whole &= level >= 0;
      m[k] = rec[(k % 3) * kLevels + (level & 0xFF)];
    }
    if (!whole) {
#pragma unroll
      for (int k = 0; k < 12; ++k)
        if (whole_level(v[k]) < 0)
          m[k] = shared_map(v[k], rec[kRecColor + k % 3], rec[kRecGamma],
                            rec[kRecBright], rec[kRecContrast]);
    }
#pragma unroll
    for (int k = 0; k < 12; ++k)
      v[k] = add_noise(m[k], (uint32_t)(base + k), k0, k1, sigma);
    if (kVec) {
      float4* d4 = reinterpret_cast<float4*>(dst + base);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        __stcs(d4 + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                   v[4 * k + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k)
        if (base + k < n) dst[base + k] = v[k];
    }
  }
}

}  // namespace flowgen

// root (2,) and indices (B,) are int64 tensors of uint32 values on the card;
// images (B, n) float32 each; records (B, 784) float32 scratch. The nine
// constants come by value (ops/photometric.py:kernel_constants).
extern "C" int flowgen_photometric(const long long* root,
                                   const long long* indices, const float* img0,
                                   const float* img1, float* out0, float* out1,
                                   float* records, int B, int n, float c_lo,
                                   float c_span, float g_lo, float g_span,
                                   float k_lo, float k_span, float n_lo,
                                   float n_span, float bright_k, void* stream) {
  using namespace flowgen;
  if (B <= 0 || n <= 0 || n % 3 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Consts cs = {c_lo, c_span, g_lo,  g_span,  k_lo,
                     k_span, n_lo, n_span, bright_k};
  photometric_table_kernel<<<B, kThreads, 0, st>>>(root, indices, records, cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (n + 11) / 12;
  const dim3 grid((ngroups + kGroups * kThreads - 1) / (kGroups * kThreads), 2,
                  B);
  const bool vec = n % 12 == 0 &&
                   ((uintptr_t)img0 | (uintptr_t)img1 | (uintptr_t)out0 |
                    (uintptr_t)out1) % 16 == 0;
  if (vec)
    photometric_kernel<true><<<grid, kThreads, 0, st>>>(records, img0, img1, out0, out1, n);
  else
    photometric_kernel<false><<<grid, kThreads, 0, st>>>(records, img0, img1, out0, out1, n);
  return (int)cudaGetLastError();
}
