// matmul: out = a @ b for a (M, K) and b (K, N), both read through their
// row and column strides, out (M, N) contiguous in a's type.
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// matmul / _matmul_kernel (the PCA codec's encode and decode product).
//
// Numerics follow the Pallas body: the inputs widen to float32, the sum
// over K is kept in float32, one rounding to a's type at the store. The
// products are true float32 fused multiply-adds on the CUDA cores for both
// input types (no TF32; a product of two bf16 values is exact in float32),
// so the result differs from another float32 product by summation order
// only.
//
// Bound on the H100: the PCA codec's shapes are memory-bound (encode reads
// an (N_data, D) matrix once for 2 to 64 output columns; decode writes a
// (B, D) matrix from a depth of 2 to 64); a large square product is bound
// by operations.
// Design: the TPU kernel gives each (256, 256) output tile the whole
// zero-padded K extent in VMEM. A block's 227 KB of shared memory cannot
// hold such a panel (256 x 12288 floats are 12 MB), so a block owns a
// BM x BN output tile and walks K in BK-deep steps: the A and B tiles go
// through registers into shared memory (A transposed, so that a thread's
// TM rows sit side by side), the loads of step k + 1 are issued before the
// products of step k, and each thread keeps a TM x TN block of sums in
// registers. Nothing is padded in memory: loads past M, N or K give 0 and
// stores past M or N are dropped, so any M, N, K >= 1 is served. Two tile
// shapes share the one kernel template: 128 x 128 x 8 with 8 x 8 sums per
// thread where that grid still fills the card, 64 x 64 x 16 with 4 x 4
// sums per thread for everything else.
// The 2-D latent's encode (N <= 8 output columns from rows of thousands of
// elements) has no use for an output tile: almost all of its work is
// reading A once. matmul_rows_kernel gives each row of A to four warps of
// a block; a lane reads elements 32 apart, eight loads in flight, and
// multiplies each into its N sums against B's row (B is a few KB and stays
// in L1); a shuffle tree and a fixed-order sum over the four warps end the
// row. No shared-memory staging, no barrier inside the K loop, and no
// atomics: the result is the same on every run.
// Tensor cores (wgmma), TMA and a deeper pipeline are left to a later
// change; the times beside the library's product are kept in PERF.md.
#include "attention.cuh"

namespace cdm {

template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ src, long long rs, long long cs, int row0, int col0,
    int n_rows, int n_cols, int tid, float (&reg)[ROWS * COLS / THREADS]) {
#pragma unroll
  for (int i = 0; i < ROWS * COLS / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = row0 + idx / COLS, c = col0 + idx % COLS;
    reg[i] = (r < n_rows && c < n_cols)
                 ? to_f(src[(long long)r * rs + (long long)c * cs])
                 : 0.f;
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ out, int m, int n, int k, long long a_rs,
              long long a_cs, long long b_rs, long long b_cs) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "tiles must divide evenly among the threads");
  constexpr int A_PER = BM * BK / THREADS, B_PER = BK * BN / THREADS;
  __shared__ __align__(16) float s_a[BK][BM + 4];  // A tile, transposed
  __shared__ __align__(16) float s_b[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[A_PER], rb[B_PER];
  load_tile<T, BM, BK, THREADS>(a, a_rs, a_cs, m0, 0, m, k, tid, ra);
  load_tile<T, BK, BN, THREADS>(b, b_rs, b_cs, 0, n0, k, n, tid, rb);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      s_a[idx % BK][idx / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      s_b[idx / BN][idx % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < k) {  // the next step's loads fly during this step's FMAs
      load_tile<T, BM, BK, THREADS>(a, a_rs, a_cs, m0, k0 + BK, m, k, tid, ra);
      load_tile<T, BK, BN, THREADS>(b, b_rs, b_cs, k0 + BK, n0, k, n, tid, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = s_a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = s_b[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < n) out[(size_t)r * n + c] = from_f<T>(acc[i][j]);
    }
  }
}

constexpr int ROWS_THREADS = 256;  // 8 warps: 2 rows of A, 4 warps each
constexpr int ROWS_WPR = 4;        // warps per row
constexpr int ROWS_MAXN = 8;       // most output columns (N a template value)
constexpr int ROWS_UNROLL = 8;     // loads of A in flight per lane

// N output columns, a's column stride 1
template <typename T, int N>
__global__ void __launch_bounds__(ROWS_THREADS, 4)
matmul_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int m, int k, long long a_rs,
                   long long b_rs, long long b_cs) {
  constexpr int WARPS = ROWS_THREADS / 32, ROWS = WARPS / ROWS_WPR;
  __shared__ float part[WARPS][N];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp / ROWS_WPR;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  if (row < m) {
    const T* ar = a + (long long)row * a_rs;
    // 32 * ROWS_UNROLL elements per warp and step, dealt to the row's
    // warps in turn
    constexpr int STEP = 32 * ROWS_UNROLL;
    for (int base = (warp % ROWS_WPR) * STEP; base < k;
         base += STEP * ROWS_WPR) {
      float av[ROWS_UNROLL];
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u) {
        const int kk = base + u * 32 + lane;
        av[u] = kk < k ? to_f(ar[kk]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u) {
        const int kk = base + u * 32 + lane;
        if (kk < k) {
          const T* br = b + (long long)kk * b_rs;
#pragma unroll
          for (int j = 0; j < N; ++j)
            acc[j] = fmaf(av[u], to_f(br[j * b_cs]), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    if (lane == 0) part[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < ROWS * N) {
    const int r = threadIdx.x / N, j = threadIdx.x % N;
    const int orow = blockIdx.x * ROWS + r;
    if (orow < m) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < ROWS_WPR; ++w) sum += part[r * ROWS_WPR + w][j];
      out[(size_t)orow * N + j] = from_f<T>(sum);
    }
  }
}

// picks the instantiation whose N is n (1 <= n <= ROWS_MAXN)
template <typename T, int N = 1>
static int launch_rows(const void* a, const void* b, void* out, int m, int n,
                       int k, long long a_rs, long long b_rs, long long b_cs,
                       cudaStream_t stream) {
  if constexpr (N > ROWS_MAXN) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N)
      return launch_rows<T, N + 1>(a, b, out, m, n, k, a_rs, b_rs, b_cs,
                                   stream);
    constexpr int ROWS = ROWS_THREADS / 32 / ROWS_WPR;
    matmul_rows_kernel<T, N><<<(m + ROWS - 1) / ROWS, ROWS_THREADS, 0,
                               stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(out), m, k, a_rs, b_rs, b_cs);
    return (int)cudaGetLastError();
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static int launch_tiles(const void* a, const void* b, void* out, int m, int n,
                        int k, long long a_rs, long long a_cs, long long b_rs,
                        long long b_cs, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(out), m, n, k, a_rs, a_cs, b_rs, b_cs);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* a, const void* b, void* out, int m, int n,
                  int k, long long a_rs, long long a_cs, long long b_rs,
                  long long b_cs, cudaStream_t s) {
  if (n <= ROWS_MAXN && a_cs == 1)
    return launch_rows<T>(a, b, out, m, n, k, a_rs, b_rs, b_cs, s);
  if ((long long)((m + 127) / 128) * ((n + 127) / 128) >= 132)
    return launch_tiles<T, 128, 128, 8, 8, 8>(a, b, out, m, n, k, a_rs, a_cs,
                                              b_rs, b_cs, s);
  return launch_tiles<T, 64, 64, 16, 4, 4>(a, b, out, m, n, k, a_rs, a_cs,
                                           b_rs, b_cs, s);
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16 (a, b and out alike). a (m, k) and
// b (k, n) with row and column strides in elements; out (m, n) contiguous.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside those limits (m, n < 1,
// k < 0, more than 65535 column tiles).
extern "C" int matmul_launch(int dtype, const void* a, const void* b,
                             void* out, int m, int n, int k, long long a_rs,
                             long long a_cs, long long b_rs, long long b_cs,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || m < 1 || n < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::launch<float>(a, b, out, m, n, k, a_rs, a_cs, b_rs, b_cs, s);
  return cdm::launch<cdm::bf16>(a, b, out, m, n, k, a_rs, a_cs, b_rs, b_cs,
                                s);
}
