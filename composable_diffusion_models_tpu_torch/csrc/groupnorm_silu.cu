// groupnorm_silu: SiLU(GroupNorm(x)) over an NHWC tensor seen as
// (B, HW, C) with C fastest, statistics per sample and per group of
// C / groups channels, affine scale and bias (C,) in float32. The tensor
// may come in up to two channel parts (B, HW, C0) and (B, HW, C1) that are
// normalised as their concatenation (B, HW, C0 + C1) without building it
// (groupnorm_silu_split: the UNet's up blocks hand over [x, skip]); a group
// may straddle the two parts. Each part is written to its own output.
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// groupnorm_silu / _gn_silu_kernel (launched by _gn_silu_pallas), and
// carries its sibling groupnorm_silu_split, which the JAX package leaves
// to the compiler.
//
// Numerics follow the Pallas body: one-pass float32 statistics
// (var = E[x^2] - E[x]^2, eps inside the rsqrt), the affine folded into one
// FMA per element (a = inv * scale, b = bias - mean * a, y = x * a + b),
// y * sigmoid(y), one rounding to x's type at the store. The variance is
// clamped at 0 (the Pallas body does not clamp and would return NaN there;
// the package's XLA path clamps). From the group sums on, the float32
// kernel takes the plain version's operations and roundings one by one
// (ops/kernels.py: sums times 1 / n, rsqrtf, products and differences not
// contracted, one FMA, y times 1 / (1 + expf(-y))): where the sums come out
// equal, so do the outputs, bit for bit; only the order of the sums
// differs. The bfloat16 kernel evaluates the sigmoid as y / (1 + exp(-y))
// with __expf and __fdividef (ex2.approx and rcp.approx: ~2 float32 ulps,
// 2^-15 of a bf16 ulp before the rounding at the store; for y below -87
// the divisor passes 2^126, __fdividef returns 0 and the exact quotient is
// under 1e-35 in size). No atomics anywhere: partial sums meet in a fixed
// order, so the result does not depend on the order in which blocks run.
//
// Bound on the H100: memory. Each element is read, takes ~10 operations
// and is written: well under 1 FLOP per byte moved. The least traffic is
// one read and one write. The TPU kernel holds one whole sample in VMEM; a
// (64 * 64, 64) bf16 sample is 512 KB and does not fit a block's 227 KB of
// shared memory, so a sample is read twice, the second time out of L2 as
// far as it is still there.
//
// Two grids over (sample, row split, part), 4 blocks of 256 threads to an
// SM (64 registers a thread):
//   1. gn_stats_kernel sums x and x^2 per channel over its rows with
//      16-byte loads, four rows in flight a thread, folds the channels into
//      the concatenation's groups and writes (sum, sum of squares) per group
//      to a float32 scratch [B][splits][parts][groups][2].
//   2. gn_apply_kernel adds the sample's partials over splits and parts in
//      a fixed order, builds a[c] and b[c] in shared memory and streams its
//      rows through x * a + b and SiLU. Its grid walks the blocks in
//      reverse, so it starts on what the stats pass read last and finds the
//      tail of it still in the 50 MB L2; a tensor that fits L2 is read from
//      device memory once.
// The 32 warps an SM hide the sums, the barrier and the SiLU (2
// special-function operations an element, 16 a clock an SM) behind the
// memory traffic. A one-read design (a thread-block cluster holding the
// sample in shared memory) was built and measured: one block of 1024
// threads to an SM runs those phases one after the other and was the slower
// route at the UNet's widest launch, where it saved the second read; it is
// not kept.
#include "attention.cuh"

namespace cdm {

constexpr int GN_THREADS = 256;
constexpr int GN_SLOTS = 2048;   // floats of a reduction scratch array
constexpr int GN_UNROLL = 4;     // rows a thread keeps in flight

// One call's tensors. Part p has c[p] channels, the channels off(p) ..
// off(p) + c[p] - 1 of the concatenation; cg channels make a group there.
struct GnArgs {
  const void* x0;
  const void* x1;
  void* out0;
  void* out1;
  int c0, c1;
  int n_parts;
  const float* scale;
  const float* bias;
  float* scratch;
  int hw, groups, cg;
  int splits, rows_per_split;  // blocks per sample and part, and rows each
  float eps;
  // selected, not indexed: an index would send the whole struct to local
  // memory in every thread
  __device__ __forceinline__ const void* x(int p) const { return p ? x1 : x0; }
  __device__ __forceinline__ void* out(int p) const { return p ? out1 : out0; }
  __host__ __device__ __forceinline__ int c(int p) const { return p ? c1 : c0; }
  __device__ __forceinline__ int off(int p) const { return p ? c0 : 0; }
};

// Thread layout of every loop over rows: the c channels of a row are
// nvc = c / VEC vectors of 16 bytes; thread t owns vector t % nvc of rows
// t / nvc, t / nvc + rpi, ... where rpi = GN_THREADS / nvc rows are in
// flight per block iteration. Threads beyond rpi * nvc idle.

// Per-channel sum and sum of squares over rows row0 .. row1 - 1 of a
// (rows, c) matrix at base, left in s_sum[ch], s_sq[ch] (each GN_SLOTS
// floats, c at most GN_SLOTS). The threads' partial sums meet per channel in
// a fixed order, through the scratch. Ends with a barrier.
template <typename T>
__device__ void channel_sums(const T* __restrict__ base, int c, int row0,
                             int row1, float* s_sum, float* s_sq) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvc = c / VEC, rpi = GN_THREADS / nvc;
  const int vcol = threadIdx.x % nvc, r = threadIdx.x / nvc;
  float sum[VEC], sq[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum[i] = sq[i] = 0.f;
  if (r < rpi) {
    // GN_UNROLL rows in flight per thread; rows past the end add zeros
    for (int row = row0 + r; row < row1; row += GN_UNROLL * rpi) {
      float v[GN_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        const int rr = row + u * rpi;
        if (rr < row1) {
          load_f<T, VEC>(base + (size_t)rr * c + vcol * VEC, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sum[i] += v[u][i];
          sq[i] = fmaf(v[u][i], v[u][i], sq[i]);
        }
    }
  }
  // Where the vectors of a row divide a warp (nvc a power of two below 32),
  // the warp's rows meet by shuffles first and the warp is one slot; else
  // every row slot r is a slot of its own.
  const bool by_warp = nvc < 32 && (nvc & (nvc - 1)) == 0;
  if (by_warp) {
    for (int o = nvc; o < 32; o *= 2)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], o);
      }
  }
  const int slots = by_warp ? GN_THREADS / 32 : rpi;
  const int slot = by_warp ? threadIdx.x / 32 : r;
  const bool writes = by_warp ? threadIdx.x % 32 < nvc : r < rpi;
  // slots_per_pass slots go through the scratch at a time, in slot order; a
  // thread carries the running sums of channels threadIdx.x, + GN_THREADS, ...
  constexpr int CPT = GN_SLOTS / GN_THREADS;  // channels a thread at most
  const int slots_per_pass = GN_SLOTS / c;
  float tot_a[CPT], tot_q[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) tot_a[k] = tot_q[k] = 0.f;
  for (int first = 0; first < slots; first += slots_per_pass) {
    if (writes && slot >= first && slot < first + slots_per_pass) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s_sum[(slot - first) * c + vcol * VEC + i] = sum[i];
        s_sq[(slot - first) * c + vcol * VEC + i] = sq[i];
      }
    }
    __syncthreads();
    const int n_slots = min(slots_per_pass, slots - first);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int ch = threadIdx.x + k * GN_THREADS;
      if (ch < c)
        for (int rr = 0; rr < n_slots; ++rr) {
          tot_a[k] += s_sum[rr * c + ch];
          tot_q[k] += s_sq[rr * c + ch];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int ch = threadIdx.x + k * GN_THREADS;
    if (ch < c) {
      s_sum[ch] = tot_a[k];
      s_sq[ch] = tot_q[k];
    }
  }
  __syncthreads();
}

// dst[2g], dst[2g + 1] = this part's share of group g: the sums over its
// channels that lie in the group, zero where it has none.
__device__ void group_fold(const float* s_sum, const float* s_sq, int c,
                           int off, int cg, int groups, float* dst) {
  for (int g = threadIdx.x; g < groups; g += GN_THREADS) {
    const int lo = max(g * cg, off) - off;
    const int hi = min((g + 1) * cg, off + c) - off;
    float a = 0.f, q = 0.f;
    for (int ch = lo; ch < hi; ++ch) {
      a += s_sum[ch];
      q += s_sq[ch];
    }
    dst[2 * g] = a;
    dst[2 * g + 1] = q;
  }
}

// s_a[ch], s_b[ch] of y = x * a + b for the part's channels, from the
// groups' totals tot[2g], tot[2g + 1]. The plain version's operations and
// roundings one by one (ops/kernels.py, _gn_affine: sums times 1 / n, the
// square, the difference, rsqrt, the products), none contracted into an
// FMA, so that equal sums give the same a and b bit for bit. Ends with a
// barrier.
__device__ void affine(const GnArgs& g, int p, const float* tot, float* s_a,
                       float* s_b) {
  const float inv_n = 1.0f / ((float)g.hw * (float)g.cg);
  const int off = g.off(p);
  for (int ch = threadIdx.x; ch < g.c(p); ch += GN_THREADS) {
    const int grp = (off + ch) / g.cg;
    const float mean = __fmul_rn(tot[2 * grp], inv_n);
    const float var = fmaxf(
        __fsub_rn(__fmul_rn(tot[2 * grp + 1], inv_n), __fmul_rn(mean, mean)),
        0.f);
    const float a =
        __fmul_rn(rsqrtf(__fadd_rn(var, g.eps)), g.scale[off + ch]);
    s_a[ch] = a;
    s_b[ch] = __fsub_rn(g.bias[off + ch], __fmul_rn(mean, a));
  }
  __syncthreads();
}

// y * sigmoid(y). float32 as the plain version's two operations: the
// sigmoid 1 / (1 + expf(-y)) with an IEEE division, then the product.
// bfloat16 takes the hardware approximations (see the header): the
// accurate forms cost ~4x the instructions and made the apply pass as long
// in instruction slots as in memory time.
template <typename T> __device__ __forceinline__ float silu(float y) {
  return y * (1.0f / (1.0f + expf(-y)));
}
template <> __device__ __forceinline__ float silu<bf16>(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

// dst[row] = SiLU(src[row] * a + b) for rows row0 .. row1 - 1.
template <typename T>
__device__ void apply_rows(const T* __restrict__ src, T* __restrict__ dst,
                           int c, int row0, int row1, const float* s_a,
                           const float* s_b) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvc = c / VEC, rpi = GN_THREADS / nvc;
  const int vcol = threadIdx.x % nvc, r = threadIdx.x / nvc;
  if (r >= rpi) return;
  float a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = s_a[vcol * VEC + i];
    b[i] = s_b[vcol * VEC + i];
  }
  for (int row = row0 + r; row < row1; row += GN_UNROLL * rpi) {
    float v[GN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int rr = row + u * rpi;
      if (rr < row1)
        load_f<T, VEC>(src + (size_t)rr * c + vcol * VEC, v[u]);
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int rr = row + u * rpi;
      if (rr < row1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          v[u][i] = silu<T>(fmaf(v[u][i], a[i], b[i]));
        store_f<T, VEC>(dst + (size_t)rr * c + vcol * VEC, v[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const GnArgs g) {
  __shared__ float s_sum[GN_SLOTS];
  __shared__ float s_sq[GN_SLOTS];
  const int b = blockIdx.x / g.splits, s = blockIdx.x % g.splits;
  const int p = blockIdx.y, c = g.c(p);
  const int row0 = s * g.rows_per_split;
  const int row1 = min(g.hw, row0 + g.rows_per_split);
  channel_sums<T>(
      static_cast<const T*>(g.x(p)) + (size_t)b * g.hw * c, c, row0, row1,
      s_sum, s_sq);
  group_fold(
      s_sum, s_sq, c, g.off(p), g.cg, g.groups,
      g.scratch + (((size_t)b * g.splits + s) * g.n_parts + p) * g.groups * 2);
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const GnArgs g) {
  extern __shared__ float smem[];  // a[c], b[c], tot[2 * groups]
  const int p = blockIdx.y, c = g.c(p);
  float* s_a = smem;
  float* s_b = smem + c;
  float* s_tot = smem + 2 * c;
  const int blk = gridDim.x - 1 - blockIdx.x;  // reverse: see the header
  const int b = blk / g.splits, s = blk % g.splits;
  for (int grp = threadIdx.x; grp < g.groups; grp += GN_THREADS) {
    float a = 0.f, q = 0.f;
    const float* src = g.scratch + (size_t)b * g.splits * g.n_parts *
                                       g.groups * 2 + 2 * grp;
    for (int i = 0; i < g.splits * g.n_parts; ++i) {
      a += src[(size_t)i * g.groups * 2];
      q += src[(size_t)i * g.groups * 2 + 1];
    }
    s_tot[2 * grp] = a;
    s_tot[2 * grp + 1] = q;
  }
  __syncthreads();
  affine(g, p, s_tot, s_a, s_b);
  const int row0 = s * g.rows_per_split;
  const int row1 = min(g.hw, row0 + g.rows_per_split);
  const size_t base = (size_t)b * g.hw * c;
  apply_rows<T>(static_cast<const T*>(g.x(p)) + base,
                static_cast<T*>(g.out(p)) + base, c, row0, row1, s_a, s_b);
}

template <typename T>
static int launch(GnArgs g, int n, cudaStream_t stream) {
  const int c_max = g.c0 > g.c1 ? g.c0 : g.c1;
  g.rows_per_split = (g.hw + g.splits - 1) / g.splits;
  const dim3 grid(n * g.splits, g.n_parts);
  const size_t smem = (size_t)(2 * c_max + 2 * g.groups) * sizeof(float);
  gn_stats_kernel<T><<<grid, GN_THREADS, 0, stream>>>(g);
  gn_apply_kernel<T><<<grid, GN_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16, of every part. n_parts 1 or 2; part p
// is x[p] and out[p], (n, hw, c[p]) contiguous, c[p] a multiple of 16 bytes /
// element size and at most 256 such vectors (x1, out1, c1 are ignored for
// one part). scale, bias (c0 + c1,) float32; groups divides c0 + c1.
// `splits` row splits (blocks) per sample and part; scratch is float32 of
// n * splits * n_parts * groups * 2. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for arguments outside
// those limits.
extern "C" int groupnorm_silu_launch(int dtype, int n_parts, const void* x0,
                                     const void* x1, void* out0, void* out1,
                                     int c0, int c1, const void* scale,
                                     const void* bias, void* scratch, int n,
                                     int hw, int groups, int splits, float eps,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || n_parts < 1 || n_parts > 2 || n < 1 ||
      hw < 1 || groups < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n_parts == 1) c1 = 0;
  if ((c0 + c1) % groups || c0 < 1 || c0 % vec ||
      c0 / vec > cdm::GN_THREADS || c1 % vec || c1 / vec > cdm::GN_THREADS ||
      (n_parts == 2 && c1 < 1))
    return (int)cudaErrorInvalidValue;
  cdm::GnArgs g;
  g.x0 = x0;
  g.x1 = x1;
  g.out0 = out0;
  g.out1 = out1;
  g.c0 = c0;
  g.c1 = c1;
  g.n_parts = n_parts;
  g.scale = static_cast<const float*>(scale);
  g.bias = static_cast<const float*>(bias);
  g.scratch = static_cast<float*>(scratch);
  g.hw = hw;
  g.groups = groups;
  g.cg = (c0 + c1) / groups;
  g.splits = splits;
  g.rows_per_split = 0;
  g.eps = eps;
  if (dtype == 0) return cdm::launch<float>(g, n, s);
  return cdm::launch<cdm::bf16>(g, n, s);
}
