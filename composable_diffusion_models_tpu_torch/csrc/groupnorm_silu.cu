// groupnorm_silu: SiLU(GroupNorm(x)) over an NHWC tensor seen as
// (B, HW, C) with C fastest, statistics per sample and per group of
// C / groups channels, affine scale and bias (C,) in float32.
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// groupnorm_silu / _gn_silu_kernel (launched by _gn_silu_pallas).
//
// Numerics follow the Pallas body: one-pass float32 statistics
// (var = E[x^2] - E[x]^2, eps inside the rsqrt), the affine folded into one
// FMA per element (a = inv * scale, b = bias - mean * a, y = x * a + b),
// y * sigmoid(y), one rounding to x's type at the store. The variance is
// clamped at 0 (the Pallas body does not clamp and would return NaN there;
// the package's XLA path clamps).
//
// Bound on the H100: memory. Each element is read, takes ~10 operations
// and is written: well under 1 FLOP per byte moved.
// Design: the TPU kernel holds one whole sample in VMEM (one grid step per
// sample). A (64*64, 64) bf16 sample is 512 KB and does not fit a block's
// 227 KB of shared memory, so the work is two passes over row splits of a
// sample:
//   1. gn_stats_kernel: block (sample, split) sums x and x^2 per channel
//      over its rows with 16-byte loads, folds the channels into groups and
//      writes (sum, sum of squares) per group to a float32 scratch
//      [B][splits][groups][2]. No atomics: the result does not depend on
//      the order in which blocks finish.
//   2. gn_apply_kernel: block (sample, split) adds the sample's split
//      partials in a fixed order, builds a[c] and b[c] in shared memory and
//      streams its rows through x * a + b and SiLU.
// Both kernels cover the whole batch in one grid each. The apply grid
// walks the blocks in reverse, so it starts on what the stats pass read
// last and finds the tail of it still in the 50 MB L2; a tensor that fits
// L2 (all but the widest on the UNet paths) is read from DRAM once.
// Cutting the batch into L2-sized chunks with a stats/apply pair each was
// measured and was slower at every shape (smaller grids, more launches).
#include "attention.cuh"

namespace cdm {

constexpr int GN_THREADS = 256;

// Thread layout shared by both kernels: the C channels of a row are
// nvc = C / VEC vectors of 16 bytes; thread t owns vector t % nvc of rows
// t / nvc, t / nvc + rpi, ... where rpi = GN_THREADS / nvc rows are in
// flight per block iteration. Threads beyond rpi * nvc idle.

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int hw,
                int c, int groups, int splits, int rows_per_split) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float s_sum[GN_THREADS * VEC];
  __shared__ float s_sq[GN_THREADS * VEC];
  const int nvc = c / VEC, rpi = GN_THREADS / nvc;
  const int b = blockIdx.x / splits, s = blockIdx.x % splits;
  const int vcol = threadIdx.x % nvc, r = threadIdx.x / nvc;
  const int row0 = s * rows_per_split;
  const int row1 = min(hw, row0 + rows_per_split);

  float sum[VEC], sq[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum[i] = sq[i] = 0.f;
  if (r < rpi) {
    const T* base = x + (size_t)b * hw * c + vcol * VEC;
    for (int row = row0 + r; row < row1; row += rpi) {
      float v[VEC];
      load_f<T, VEC>(base + (size_t)row * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sum[i] += v[i];
        sq[i] = fmaf(v[i], v[i], sq[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s_sum[r * c + vcol * VEC + i] = sum[i];
      s_sq[r * c + vcol * VEC + i] = sq[i];
    }
  }
  __syncthreads();
  // per channel over the rpi row slots (thread ch touches column ch only)
  for (int ch = threadIdx.x; ch < c; ch += GN_THREADS) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < rpi; ++rr) {
      a += s_sum[rr * c + ch];
      q += s_sq[rr * c + ch];
    }
    s_sum[ch] = a;
    s_sq[ch] = q;
  }
  __syncthreads();
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += GN_THREADS) {
    float a = 0.f, q = 0.f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      a += s_sum[ch];
      q += s_sq[ch];
    }
    float* dst = part + (((size_t)b * splits + s) * groups + g) * 2;
    dst[0] = a;
    dst[1] = q;
  }
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ part,
                const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out, int hw,
                int c, int groups, int splits, int rows_per_split,
                float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];  // a[c], b[c], mean[groups], inv[groups]
  float* s_a = smem;
  float* s_b = smem + c;
  float* s_mean = smem + 2 * c;
  float* s_inv = s_mean + groups;
  const int nvc = c / VEC, rpi = GN_THREADS / nvc;
  const int blk = gridDim.x - 1 - blockIdx.x;  // reverse: see the header
  const int b = blk / splits, s = blk % splits;
  const int cg = c / groups;

  for (int g = threadIdx.x; g < groups; g += GN_THREADS) {
    float a = 0.f, q = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* src = part + (((size_t)b * splits + sp) * groups + g) * 2;
      a += src[0];
      q += src[1];
    }
    const float n = (float)hw * (float)cg;
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    s_mean[g] = mean;
    s_inv[g] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += GN_THREADS) {
    const int g = ch / cg;
    const float a = s_inv[g] * scale[ch];
    s_a[ch] = a;
    s_b[ch] = bias[ch] - s_mean[g] * a;
  }
  __syncthreads();

  const int vcol = threadIdx.x % nvc, r = threadIdx.x / nvc;
  if (r >= rpi) return;
  float a[VEC], bb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = s_a[vcol * VEC + i];
    bb[i] = s_b[vcol * VEC + i];
  }
  const int row0 = s * rows_per_split;
  const int row1 = min(hw, row0 + rows_per_split);
  const size_t base = (size_t)b * hw * c + vcol * VEC;
  for (int row = row0 + r; row < row1; row += rpi) {
    float v[VEC];
    load_f<T, VEC>(x + base + (size_t)row * c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = fmaf(v[i], a[i], bb[i]);
      v[i] = y / (1.0f + expf(-y));
    }
    store_f<T, VEC>(out + base + (size_t)row * c, v);
  }
}

template <typename T>
static int launch(const void* x, const void* scale, const void* bias,
                  void* part, void* out, int n, int hw, int c, int groups,
                  int splits, float eps, cudaStream_t stream) {
  const int rows_per_split = (hw + splits - 1) / splits;
  const size_t smem = (size_t)(2 * c + 2 * groups) * sizeof(float);
  gn_stats_kernel<T><<<n * splits, GN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), hw, c, groups,
      splits, rows_per_split);
  gn_apply_kernel<T><<<n * splits, GN_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(part),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), hw, c, groups, splits, rows_per_split, eps);
  return (int)cudaGetLastError();
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. x and out (n, hw, c) contiguous, c a
// multiple of 16 bytes / element size and at most 256 such vectors;
// scale, bias (c,) float32; part a float32 scratch of n * splits * groups
// * 2; splits row splits (blocks) per sample. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for
// arguments outside those limits.
extern "C" int groupnorm_silu_launch(int dtype, const void* x,
                                     const void* scale, const void* bias,
                                     void* part, void* out, int n, int hw,
                                     int c, int groups, int splits,
                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || n < 1 || hw < 1 || groups < 1 ||
      splits < 1 || c % groups || c % vec || c / vec > cdm::GN_THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::launch<float>(x, scale, bias, part, out, n, hw, c, groups,
                              splits, eps, s);
  return cdm::launch<cdm::bf16>(x, scale, bias, part, out, n, hw, c, groups,
                                splits, eps, s);
}
