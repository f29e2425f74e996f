// matmul: out = a @ b for a (M, K) and b (K, N), both read through their
// row and column strides, out (M, N) contiguous in a's type.
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// matmul / _matmul_kernel (the PCA codec's encode and decode product).
//
// Numerics follow the Pallas body: the inputs widen to float32, the sum
// over K is kept in float32, one rounding to a's type at the store. No
// route uses TF32: a float32 product is a true float32 fused multiply-add
// on the CUDA cores, and a product of two bf16 values is exact in float32,
// whether an FMA or a tensor core (wgmma, fp32 accumulators) takes it. So
// the result differs from another float32 product by summation order only.
//
// Four routes; ops/kernels.py::matmul_route picks one from the dtype, the
// shape and the strides and passes it in, and this file checks that the
// route can take the arguments.
//
// ROUTE_ROWS (N <= 8, a's rows contiguous: the codec's encode, (N_data, D)
// x (D, 2)). Bound by reading A once. There is no output tile to speak of:
// matmul_rows_kernel gives each row of A to four warps of a block; a lane
// reads elements 32 apart, eight loads in flight, and multiplies each into
// its N sums against B's row (B is a few KB and stays in L1); a shuffle
// tree and a fixed-order sum over the four warps end the row. No atomics:
// the same result on every run.
//
// ROUTE_SMALL_K (K <= SMALL_K_MAX: the codec's decode, (B, 2) x (2, D)).
// Bound by writing the output once. A thread owns one 16-byte vector of
// columns (4 float32 or 8 bf16 outputs) of SK_ROWS rows: it reads its
// K x 16 bytes of B into registers and the rows' K values of A (warp-wide
// broadcasts) all at once, so a block waits for one round trip to memory
// and not one a row; each output is a chain of fp32 FMAs in k order,
// stored as one 16-byte vector. Nothing goes through shared memory.
//
// ROUTE_WGMMA (bf16, rows of both operands 16-byte aligned, K >= 64 when
// the wrapper picks it). Bound by operations at large sizes (989 TFLOP/s).
// A block owns a 128 x BN output tile (BN 256, or 128 where N <= 128) and
// is three warpgroups: one thread of warpgroup 0 copies 64-deep k-tiles of
// A and B into a 192 KB ring of 128-byte-swizzled stages (4 at BN 256, 6
// at 128) with TMA (boxes past M, N and K land as zeros), the bytes
// counted down on the stage's "full" mbarrier. (16-byte cp.async from the
// whole warpgroup fed the ring at a third of that rate: 0.089 against
// 0.031 ms at 2048^3 on an H100.) Warpgroups 1 and 2 take 64 rows each and
// issue wgmma m64nBNk16 from the stage (descriptors, fp32 accumulators in
// registers), keep one k-tile's group in flight and hand a stage back
// through its "empty" mbarrier once the group that read it has completed.
// Either major of either operand is read in
// place: a K-major operand (a row-major A, a b.t() view) as rows of 64 k,
// an MN-major one (an a.t() view, a row-major B) as panels of 64 columns
// with the descriptor's transpose bit set, so no view is ever copied; the
// tensor maps are encoded on the host at each launch.
// The accumulators are rounded once and stored with guards at the edges.
//
// ROUTE_TILES (everything else: float32 at large K, bf16 rows that are not
// 16-byte aligned). Bound by operations (67 TFLOP/s float32). An SGEMM: a
// block owns a 128 x 128 tile, walking K in steps of 8 (64 x 64 in steps of
// 16 where the larger grid would not fill the card), through two
// shared-memory stages with one barrier a step; the next step's tiles are
// loaded into registers (coalesced along whichever of the operand's
// strides is 1) while this step's products run; two blocks an SM. 8 warps
// tile the block, 8 x 4 lanes a warp, and a thread reads its 8 x 8 (or
// 4 x 4) operands as float4 broadcasts from rows 32 and columns 16 apart,
// so shared-memory reads are conflict-free. Each output is a chain of fp32
// FMAs in k order.
#include "attention.cuh"
#include "hopper.cuh"

namespace cdm {

constexpr int ROUTE_ROWS = 0, ROUTE_SMALL_K = 1, ROUTE_WGMMA = 2,
              ROUTE_TILES = 3;
constexpr int SMALL_K_MAX = 8;  // deepest product the small-K route takes

// ================================================================= rows
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

// ============================================================== small K
constexpr int SK_THREADS = 256;
constexpr int SK_ROWS = 4;  // rows a thread: their loads of A fly together

// Element e of 16 bytes of T held as four 32-bit words, and its bits:
// constant indices keep the words in registers.
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t (&w)[4], int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const uint32_t x = w[e / 2];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}
__device__ __forceinline__ uint32_t bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits_of(bf16 x) {
  return __bfloat16_as_ushort(x);
}

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
matmul_small_k_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, int m, int n, int k,
                      long long a_rs, long long a_cs, long long b_rs,
                      long long b_cs) {
  constexpr int VEC = 16 / sizeof(T);  // outputs a thread and row
  constexpr int EPW = 4 / sizeof(T);   // elements a 32-bit word
  const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * VEC;
  if (c0 >= n) return;  // no barrier below
  const int nv = min(VEC, n - c0);
  // this thread's columns of B's K rows, 16 bytes a row as they lie in
  // memory (zeros past N and K)
  uint32_t bw[SMALL_K_MAX][4];
  const bool vec_b = nv == VEC && b_cs == 1 && (b_rs % VEC) == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
#pragma unroll
  for (int kk = 0; kk < SMALL_K_MAX; ++kk) {
#pragma unroll
    for (int w = 0; w < 4; ++w) bw[kk][w] = 0u;
    if (kk < k) {
      const T* br = b + (long long)kk * b_rs + (long long)c0 * b_cs;
      if (vec_b) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(br));
        bw[kk][0] = raw.x;
        bw[kk][1] = raw.y;
        bw[kk][2] = raw.z;
        bw[kk][3] = raw.w;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (e < nv)
            bw[kk][e / EPW] |= bits_of(br[(long long)e * b_cs])
                               << (16 * (e % EPW));
      }
    }
  }
  const bool vec_out = nv == VEC && (n % VEC) == 0;
  for (int r0 = blockIdx.y * SK_ROWS; r0 < m; r0 += gridDim.y * SK_ROWS) {
    // the group's rows of A, all asked for before the first product
    float av[SK_ROWS][SMALL_K_MAX];
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i) {
      const T* ar = a + (long long)min(r0 + i, m - 1) * a_rs;
#pragma unroll
      for (int kk = 0; kk < SMALL_K_MAX; ++kk)
        av[i][kk] = kk < k ? to_f(ar[(long long)kk * a_cs]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i) {
      if (r0 + i >= m) break;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < SMALL_K_MAX; ++kk) {
        if (kk < k) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = fmaf(av[i][kk], word_elem<T>(bw[kk], e), acc[e]);
        }
      }
      T* orow = out + (size_t)(r0 + i) * n + c0;
      if (vec_out) {
        store_f<T, VEC>(orow, acc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (e < nv) orow[e] = from_f<T>(acc[e]);
      }
    }
  }
}

template <typename T>
static int launch_small_k(const void* a, const void* b, void* out, int m,
                          int n, int k, long long a_rs, long long a_cs,
                          long long b_rs, long long b_cs, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int gx = (n + SK_THREADS * VEC - 1) / (SK_THREADS * VEC);
  const int gy = min((m + SK_ROWS - 1) / SK_ROWS, 65535);
  matmul_small_k_kernel<T><<<dim3(gx, gy), SK_THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), m, n, k, a_rs, a_cs, b_rs, b_cs);
  return (int)cudaGetLastError();
}

// ================================================================ tiles

// (row, k) element of an operand tile, k-fastest or row-fastest: the
// thread order that reads contiguous memory when the operand's unit stride
// is along k or along the rows
template <int ROWS, int BK, int THREADS>
__device__ __forceinline__ void tile_coords(int tid, int i, bool k_fast,
                                            int& r, int& kk) {
  const int idx = tid + i * THREADS;
  if (k_fast) {
    r = idx / BK;
    kk = idx % BK;
  } else {
    r = idx % ROWS;
    kk = idx / ROWS;
  }
}

// two blocks an SM: at most 128 registers a thread
template <typename T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, 2)
matmul_tiles_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int m, int n, int k, long long a_rs,
                    long long a_cs, long long b_rs, long long b_cs) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  constexpr int TM = WM / 8, TN = WN / 4;  // a thread's: 8 x 4 lanes a warp
  constexpr int GM = TM / 4, GN = TN / 4;  // float4 groups, 32 / 16 apart
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 groups");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "tiles must divide evenly among the threads");
  constexpr int A_PER = BM * BK / THREADS, B_PER = BK * BN / THREADS;
  __shared__ __align__(16) float s_a[2][BK][BM + 4];  // A tile, transposed
  __shared__ __align__(16) float s_b[2][BK][BN + 4];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tm = lane / 4, tn = lane % 4;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool a_kfast = a_cs == 1 || a_rs != 1;
  const bool b_kfast = !(b_cs == 1 || b_rs != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int r, kk;
      tile_coords<BM, BK, THREADS>(tid, i, a_kfast, r, kk);
      ra[i] = (m0 + r < m && k0 + kk < k)
                  ? to_f(a[(long long)(m0 + r) * a_rs +
                           (long long)(k0 + kk) * a_cs])
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int c, kk;
      tile_coords<BN, BK, THREADS>(tid, i, b_kfast, c, kk);
      rb[i] = (n0 + c < n && k0 + kk < k)
                  ? to_f(b[(long long)(k0 + kk) * b_rs +
                           (long long)(n0 + c) * b_cs])
                  : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int r, kk;
      tile_coords<BM, BK, THREADS>(tid, i, a_kfast, r, kk);
      s_a[buf][kk][r] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int c, kk;
      tile_coords<BN, BK, THREADS>(tid, i, b_kfast, c, kk);
      s_b[buf][kk][c] = rb[i];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k; k0 += BK) {
    const bool more = k0 + BK < k;
    if (more) load(k0 + BK);  // in flight during this step's products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            &s_a[buf][kk][wm0 + g * 32 + tm * 4]);
        av[4 * g] = t.x; av[4 * g + 1] = t.y;
        av[4 * g + 2] = t.z; av[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            &s_b[buf][kk][wn0 + g * 16 + tn * 4]);
        bv[4 * g] = t.x; bv[4 * g + 1] = t.y;
        bv[4 * g + 2] = t.z; bv[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other stage was last read before the previous step's barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const bool vec = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + wm0 + (i / 4) * 32 + tm * 4 + i % 4;
    if (r >= m) continue;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int c = n0 + wn0 + g * 16 + tn * 4;
      T* o = out + (size_t)r * n + c;
      if (vec && c + 4 <= n) {
        const float v[4] = {acc[i][4 * g], acc[i][4 * g + 1],
                            acc[i][4 * g + 2], acc[i][4 * g + 3]};
        if constexpr (sizeof(T) == 4) {
          store_f<T, 4>(o, v);
        } else {
          uint2 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = from_f<T>(v[j]);
          *reinterpret_cast<uint2*>(o) = raw;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) o[j] = from_f<T>(acc[i][4 * g + j]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
static int launch_tiles(const void* a, const void* b, void* out, int m, int n,
                        int k, long long a_rs, long long a_cs, long long b_rs,
                        long long b_cs, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_tiles_kernel<T, BM, BN, BK, WARPS_M, WARPS_N>
      <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(out), m, n, k, a_rs, a_cs, b_rs, b_cs);
  return (int)cudaGetLastError();
}

// ================================================================ wgmma
constexpr int WG = 128;           // threads of a warpgroup
constexpr int MMA_BM = 128;       // output rows a block: 64 a consumer
constexpr int MMA_BK = 64;        // k-tile: one 128-byte row of bf16
constexpr int MMA_PANEL = 64 * 128;  // 64 rows of 128 bytes
constexpr int MMA_RING = 192 * 1024;

template <int BN> struct MmaTile {
  static constexpr int A_BYTES = MMA_BM * 128;  // either major
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = MMA_RING / STAGE;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE +
                                 2 * STAGES * 8;
};

// The operands' tensor maps: A as (k, m) rows when K-major, (m, k) when
// M-major; B as (n, k) when N-major, (k, n) when K-major; the inner
// dimension first, 64 elements (128 bytes) of it a box row, 128-byte
// swizzled: the layouts the descriptors read (hopper.cuh).
struct MmaMaps {
  CUtensorMap a, b;
};

// One thread of warpgroup 0: every k-tile of the block's A rows and B
// columns into the ring with TMA, as far ahead as there are free stages;
// the copies complete on the stage's "full" mbarrier, which is told the
// stage's bytes first. Boxes past M, N or K land as zeros.
template <int BN, int TA, int TB>
__device__ void mma_produce(const MmaMaps* maps, int k, int m0, int n0,
                            uint32_t ring, uint32_t full0, uint32_t empty0) {
  using Tile = MmaTile<BN>;
  const uint64_t ma = reinterpret_cast<uint64_t>(&maps->a);
  const uint64_t mb = reinterpret_cast<uint64_t>(&maps->b);
  const int nkt = (k + MMA_BK - 1) / MMA_BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % Tile::STAGES;
    mbar_wait(empty0 + 8 * s, ((kt / Tile::STAGES) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, Tile::STAGE);
    const uint32_t sa = ring + s * Tile::STAGE, sb = sa + Tile::A_BYTES;
    const int k0 = kt * MMA_BK;
    if constexpr (TA == 0) {
      tma_load_2d(sa, ma, k0, m0, full);
    } else {
      tma_load_2d(sa, ma, m0, k0, full);
      tma_load_2d(sa + MMA_PANEL, ma, m0 + 64, k0, full);
    }
    if constexpr (TB == 1) {
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        tma_load_2d(sb + p * MMA_PANEL, mb, n0 + 64 * p, k0, full);
    } else {
      tma_load_2d(sb, mb, k0, n0, full);
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* out, int m, int n, int r,
                                           int c, float v0, float v1) {
  if (r >= m) return;
  bf16* o = out + (size_t)r * n + c;
  if ((n & 1) == 0 && c + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < n) o[0] = __float2bfloat16_rn(v0);
    if (c + 1 < n) o[1] = __float2bfloat16_rn(v1);
  }
}

template <int BN, int TA, int TB>
__global__ void __launch_bounds__(3 * WG, 1)
matmul_wgmma_kernel(const __grid_constant__ MmaMaps maps,
                    bf16* __restrict__ out, int m, int n, int k) {
  using Tile = MmaTile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(base);
  const uint32_t full0 = ring + Tile::STAGES * Tile::STAGE;
  const uint32_t empty0 = full0 + 8 * Tile::STAGES;
  const int m0 = blockIdx.x * MMA_BM, n0 = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival and bytes
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      mma_produce<BN, TA, TB>(&maps, k, m0, n0, ring, full0, empty0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // warpgroup and warp through a shuffle, so that the compiler sees them
  // as uniform: no wgmma behind a branch it takes for divergent
  const int ctid = threadIdx.x - WG;
  const int wg = __shfl_sync(0xffffffffu, ctid / WG, 0);
  const int warp = __shfl_sync(0xffffffffu, (ctid / 32) % 4, 0);
  const int lane = ctid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int nkt = (k + MMA_BK - 1) / MMA_BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % Tile::STAGES;
    mbar_wait(full0 + 8 * s, (kt / Tile::STAGES) & 1);
    const uint32_t sa = ring + s * Tile::STAGE + wg * MMA_PANEL;
    const uint32_t sb = ring + s * Tile::STAGE + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MMA_BK / 16; ++j) {
      const uint64_t da = TA == 0 ? sw128_desc(sa + j * 32, 16)
                                  : sw128_desc(sa + j * 16 * 128, MMA_PANEL);
      const uint64_t db = TB == 1 ? sw128_desc(sb + j * 16 * 128, MMA_PANEL)
                                  : sw128_desc(sb + j * 32, 16);
      Wgmma<BN>::template ss<TA, TB>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-tile's group has completed
    if (kt > 0 && lane == 0)
      mbar_arrive(empty0 + 8 * ((kt - 1) % Tile::STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  const int r = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    store_pair(out, m, n, r, c, acc[4 * j], acc[4 * j + 1]);
    store_pair(out, m, n, r + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// A bf16 matrix of `outer` rows of `inner` contiguous elements, `stride`
// elements apart, read in boxes of 64 x box_outer (a stride is read only
// where there is more than one row)
static bool encode_map(CUtensorMap* map, const void* base, long long inner,
                       long long outer, long long stride, int box_outer) {
  const long long dims[2] = {inner, outer};
  const long long strides[1] = {outer == 1 ? (inner + 7) / 8 * 8 : stride};
  const int box[2] = {64, box_outer};
  return encode_bf16_map(map, base, 2, dims, strides, box);
}

template <int BN, int TA, int TB>
static int launch_wgmma_tile(const void* a, const void* b, void* out, int m,
                             int n, int k, long long a_rs, long long a_cs,
                             long long b_rs, long long b_cs,
                             cudaStream_t s) {
  MmaMaps maps;
  const bool ok =
      (TA == 0 ? encode_map(&maps.a, a, k, m, a_rs, MMA_BM)
               : encode_map(&maps.a, a, m, k, a_cs, MMA_BK)) &&
      (TB == 1 ? encode_map(&maps.b, b, n, k, b_rs, MMA_BK)
               : encode_map(&maps.b, b, k, n, b_cs, BN));
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto kern = matmul_wgmma_kernel<BN, TA, TB>;
  const size_t smem = MmaTile<BN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + MMA_BM - 1) / MMA_BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, 3 * WG, smem, s>>>(maps, static_cast<bf16*>(out), m, n, k);
  return (int)cudaGetLastError();
}

// The major of an operand with `rows` x `cols` elements: 0 when its rows
// are contiguous (column stride 1) and 16-byte aligned, 1 when its columns
// are, -1 when neither. A dimension of extent 1 takes any stride.
static int major_of(int rows, int cols, long long rs, long long cs) {
  if ((cs == 1 || cols == 1) && (rs % 8 == 0 || rows == 1)) return 0;
  if ((rs == 1 || rows == 1) && (cs % 8 == 0 || cols == 1)) return 1;
  return -1;
}

template <int BN>
static int launch_wgmma_bn(int a_major, int b_major, const void* a,
                           const void* b, void* out, int m, int n, int k,
                           long long a_rs, long long a_cs, long long b_rs,
                           long long b_cs, cudaStream_t s) {
  // A (m, k): row-major is K-major (TA 0). B (k, n): row-major is N-major
  // (TB 1), a b.t() view K-major (TB 0).
  if (a_major == 0 && b_major == 0)
    return launch_wgmma_tile<BN, 0, 1>(a, b, out, m, n, k, a_rs, a_cs, b_rs,
                                       b_cs, s);
  if (a_major == 0)
    return launch_wgmma_tile<BN, 0, 0>(a, b, out, m, n, k, a_rs, a_cs, b_rs,
                                       b_cs, s);
  if (b_major == 0)
    return launch_wgmma_tile<BN, 1, 1>(a, b, out, m, n, k, a_rs, a_cs, b_rs,
                                       b_cs, s);
  return launch_wgmma_tile<BN, 1, 0>(a, b, out, m, n, k, a_rs, a_cs, b_rs,
                                     b_cs, s);
}

static int launch_wgmma(const void* a, const void* b, void* out, int m,
                        int n, int k, long long a_rs, long long a_cs,
                        long long b_rs, long long b_cs, cudaStream_t s) {
  const int a_major = major_of(m, k, a_rs, a_cs);
  const int b_major = major_of(k, n, b_rs, b_cs);
  if (a_major < 0 || b_major < 0 || k < 1 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return (int)cudaErrorInvalidValue;
  if (n > 128)
    return launch_wgmma_bn<256>(a_major, b_major, a, b, out, m, n, k, a_rs,
                                a_cs, b_rs, b_cs, s);
  return launch_wgmma_bn<128>(a_major, b_major, a, b, out, m, n, k, a_rs,
                              a_cs, b_rs, b_cs, s);
}

template <typename T>
static int launch(int route, const void* a, const void* b, void* out, int m,
                  int n, int k, long long a_rs, long long a_cs,
                  long long b_rs, long long b_cs, cudaStream_t s) {
  switch (route) {
    case ROUTE_ROWS:
      if (n > ROWS_MAXN || a_cs != 1) return (int)cudaErrorInvalidValue;
      return launch_rows<T>(a, b, out, m, n, k, a_rs, b_rs, b_cs, s);
    case ROUTE_SMALL_K:
      if (k > SMALL_K_MAX) return (int)cudaErrorInvalidValue;
      return launch_small_k<T>(a, b, out, m, n, k, a_rs, a_cs, b_rs, b_cs,
                               s);
    case ROUTE_WGMMA:
      if constexpr (sizeof(T) != 2) {
        return (int)cudaErrorInvalidValue;
      } else {
        return launch_wgmma(a, b, out, m, n, k, a_rs, a_cs, b_rs, b_cs, s);
      }
    case ROUTE_TILES:
      if ((long long)((m + 127) / 128) * ((n + 127) / 128) >= 132)
        return launch_tiles<T, 128, 128, 8, 2, 4>(a, b, out, m, n, k, a_rs,
                                                  a_cs, b_rs, b_cs, s);
      return launch_tiles<T, 64, 64, 16, 2, 4>(a, b, out, m, n, k, a_rs,
                                               a_cs, b_rs, b_cs, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16 (a, b and out alike). a (m, k) and
// b (k, n) with row and column strides in elements; out (m, n) contiguous.
// route: one of the ROUTE_* values above. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments
// outside the limits (m, n < 1, k < 0, a grid too large) or that the route
// cannot take (ROWS: n > 8 or a's column stride not 1; SMALL_K: k > 8;
// WGMMA: not bfloat16, k < 1, an operand with neither stride 1 and the
// other a multiple of 8, or a pointer not 16-byte aligned).
extern "C" int matmul_launch(int dtype, const void* a, const void* b,
                             void* out, int m, int n, int k, long long a_rs,
                             long long a_cs, long long b_rs, long long b_cs,
                             int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || m < 1 || n < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::launch<float>(route, a, b, out, m, n, k, a_rs, a_cs, b_rs,
                              b_cs, s);
  return cdm::launch<cdm::bf16>(route, a, b, out, m, n, k, a_rs, a_cs, b_rs,
                                b_cs, s);
}
