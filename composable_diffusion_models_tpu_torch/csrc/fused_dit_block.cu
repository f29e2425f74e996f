// fused_dit_block: one adaLN-folded DiT block over a (B, T, D) token
// stream, with the per-step modulation already folded into the weights:
//
//   x += proj(attention(LN(x) @ Wqkv + bqkv)) ;  x += gelu(LN(x) @ W1 + b1) @ W2 + b2
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// fused_dit_block / _dit_block_kernel.
//
// Bound on the H100: operations. Per token row the four GEMMs cost
// 2 * 12 * D^2 FLOP (1.57 MFLOP at D=256) against 2 * D * 2 bytes of
// stream traffic in bf16, and the folded weights (12 D^2 values, 1.5 MiB
// in bf16) are read once per launch. At the serving batch (2048 images of
// 4 tokens) that is 12.9 GFLOP against ~10 MB: ~13 us at the 989 TFLOP/s
// bf16 tensor-core peak, ~3 us at 3.35 TB/s.
//
// Design. The TPU kernel holds all four weight matrices in VMEM; a Hopper
// block has 227 KB of shared memory, less than the 1.5 MiB of weights. So
// the roles flip: a tile of MT token rows (whole images) stays resident in
// shared memory for the whole block -- the residual x, the LayerNorm
// output, and the 4D-wide buffer that holds first qkv, then the attention
// output (written over q in place), then the GELU hidden -- and the weights
// stream through in 32 x 128 k-tiles from L2, where all 1.5 MiB stay
// resident across the blocks of a launch. Nothing but x goes to or from
// device memory. The bf16 GEMMs run on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulation), 8 warps as 2 x 4 over a 64 x 128 output
// chunk; the fp32 variant (for holding the kernel to its plain version
// without bf16 rounding) runs the same tiling as fp32 FMAs. Attention is
// per image and head with no packing mask (attention.cuh).
//
// Numerics follow the Pallas kernel: LayerNorm with fp32 stats (clamped
// one-pass variance, eps 1e-6, no affine) rounded to the stream type; each
// GEMM accumulates in fp32, adds its bias in fp32 and rounds once; GELU
// (tanh form) of the rounded value, rounded again; residual adds of two
// stream-type values, rounded once.
#include "attention.cuh"

namespace cdm {

constexpr int NTHREADS = 256;  // 8 warps
constexpr int KT = 32;         // weight rows per staged k-tile
constexpr int NC = 128;        // output columns per GEMM chunk
constexpr int PAD = 8;         // row padding (elements): conflict-free rows

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// Ws[KT][NC + PAD] = W[k0 : k0 + KT, n0 : n0 + NC], zero beyond column N
template <typename T>
__device__ __forceinline__ void stage_w(const T* W, int N, int k0, int n0,
                                        T* Ws) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = NC / VEC;
  for (int v = threadIdx.x; v < KT * VPR; v += NTHREADS) {
    const int r = v / VPR, c = (v % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + c < N)
      val = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
    *reinterpret_cast<uint4*>(Ws + r * (NC + PAD) + c) = val;
  }
}

// ------------------------------------------------------------- epilogues
template <typename T> struct EpiStore {  // dst = T(acc + bias)
  T* dst; int ld; const T* bias;
  __device__ void operator()(int r, int c, float v) const {
    dst[r * ld + c] = from_f<T>(v + to_f(bias[c]));
  }
};

template <typename T> struct EpiGelu {  // dst = T(gelu(T(acc + bias)))
  T* dst; int ld; const T* bias;
  __device__ void operator()(int r, int c, float v) const {
    dst[r * ld + c] = from_f<T>(gelu_tanh(round_to<T>(v + to_f(bias[c]))));
  }
};

template <typename T> struct EpiResidual {  // x = T(x + T(acc + bias))
  T* x; int ld; const T* bias;
  __device__ void operator()(int r, int c, float v) const {
    x[r * ld + c] =
        from_f<T>(to_f(x[r * ld + c]) + round_to<T>(v + to_f(bias[c])));
  }
};

// --------------------------------------------------------------- GEMMs
// out = A @ W through the epilogue, for the tile's MT rows. A: shared
// [MT][lda]; W: global [K][N] row-major, K a multiple of KT, N of 8.
// Ends with a barrier, so the next phase sees every result.
template <int MT, class Epi>
__device__ void tile_gemm(const bf16* A, int lda, const bf16* W, int K, int N,
                          bf16* Ws, const Epi& epi) {
  static_assert(MT == 64, "the mma tiling covers 64 rows: 2 x 4 warps");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;  // 32 rows x 32 columns each
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8, lcol = (lane / 16) * 8;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      __syncthreads();  // every warp is done with the previous k-tile
      stage_w(W, N, k0, n0, Ws);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], A + (wm * 32 + mi * 16 + lrow) * lda + k0 + kk +
                                 lcol);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4_trans(
              b[nj], Ws + (kk + lrow) * (NC + PAD) + wn * 32 + nj * 16 + lcol);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                     b[ni / 2][(ni % 2) * 2 + 1]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wm * 32 + mi * 16 + lane / 4;
        const int c = n0 + wn * 32 + ni * 8 + (lane % 4) * 2;
        if (c < N) {
          epi(r, c, acc[mi][ni][0]);
          epi(r, c + 1, acc[mi][ni][1]);
          epi(r + 8, c, acc[mi][ni][2]);
          epi(r + 8, c + 1, acc[mi][ni][3]);
        }
      }
  }
  __syncthreads();
}

template <int MT, class Epi>
__device__ void tile_gemm(const float* A, int lda, const float* W, int K,
                          int N, float* Ws, const Epi& epi) {
  constexpr int RM = MT / 8;  // rows per warp; each lane owns 4 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      __syncthreads();
      stage_w(W, N, k0, n0, Ws);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float4 b =
            *reinterpret_cast<const float4*>(Ws + kk * (NC + PAD) + lane * 4);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = A[(warp * RM + r) * lda + k0 + kk];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
    }
    const int c = n0 + lane * 4;
    if (c < N) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(warp * RM + r, c + j, acc[r][j]);
    }
  }
  __syncthreads();
}

// Y[r] = T(LN(X[r])) for the tile's MT rows: fp32 stats, clamped one-pass
// variance, eps 1e-6, no affine. One warp per row.
template <typename T, int MT>
__device__ void layer_norm(const T* X, int ldx, T* Y, int ldy, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < MT; r += NTHREADS / 32) {
    float s = 0.f, ss = 0.f;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float v[VEC];
      load_f<T, VEC>(X + r * ldx + c, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / d;
    const float var = fmaxf(0.f, ss / d - mu * mu);
    const float inv = 1.f / sqrtf(var + 1e-6f);
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float v[VEC];
      load_f<T, VEC>(X + r * ldx + c, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = (v[e] - mu) * inv;
      store_f<T, VEC>(Y + r * ldy + c, v);
    }
  }
  __syncthreads();
}

// Shared memory of one block, in bytes: X and A [MT][D + PAD], the wide
// buffer [MT][4D + PAD], the weight k-tile [KT][NC + PAD].
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int mt, int d) {
  return sizeof(T) * ((size_t)mt * (d + PAD) * 2 + (size_t)mt * (4 * d + PAD) +
                      (size_t)KT * (NC + PAD));
}

// ---------------------------------------------------------------- kernel
template <typename T, int MT, int HD>
__global__ void __launch_bounds__(NTHREADS)
fused_dit_block_kernel(const T* tok, const T* wqkv, const T* bqkv,
                       const T* wpr, const T* bpr, const T* w1, const T* b1,
                       const T* w2, const T* b2, T* out, int n_img, int n_tok,
                       int d, int imgs_per_tile, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = d + PAD, ldq = 4 * d + PAD;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* A = X + MT * ldx;
  T* Q = A + MT * ldx;
  T* Ws = Q + MT * ldq;
  const int n_heads = d / HD;
  const int img0 = blockIdx.x * imgs_per_tile;
  const int imgs = min(imgs_per_tile, n_img - img0);
  const int rows = imgs * n_tok;
  const size_t g0 = (size_t)img0 * n_tok * d;
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = d / VEC;

  // residual tile in; rows past the tile's images are zero
  for (int v = threadIdx.x; v < MT * vpr; v += NTHREADS) {
    const int r = v / vpr, c = (v % vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(tok + g0 + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(X + r * ldx + c) = val;
  }
  __syncthreads();

  // attention half: qkv into Q[:, 0:3D], attention output over Q[:, 0:D]
  layer_norm<T, MT>(X, ldx, A, ldx, d);
  tile_gemm<MT>(A, ldx, wqkv, d, 3 * d, Ws, EpiStore<T>{Q, ldq, bqkv});
  for (int p = threadIdx.x; p < imgs * n_heads * n_tok; p += NTHREADS) {
    const int im = p / (n_heads * n_tok), rem = p % (n_heads * n_tok);
    T* img = Q + im * n_tok * ldq;
    attend_query<T, HD>(img, ldq, img, ldq, rem % n_tok, rem / n_tok, n_tok,
                        d, scale);
  }
  __syncthreads();
  tile_gemm<MT>(Q, ldq, wpr, d, d, Ws, EpiResidual<T>{X, ldx, bpr});

  // MLP half: GELU hidden into Q[:, 0:4D]
  layer_norm<T, MT>(X, ldx, A, ldx, d);
  tile_gemm<MT>(A, ldx, w1, d, 4 * d, Ws, EpiGelu<T>{Q, ldq, b1});
  tile_gemm<MT>(Q, ldq, w2, 4 * d, d, Ws, EpiResidual<T>{X, ldx, b2});

  for (int v = threadIdx.x; v < rows * vpr; v += NTHREADS) {
    const int r = v / vpr, c = (v % vpr) * VEC;
    *reinterpret_cast<uint4*>(out + g0 + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(X + r * ldx + c);
  }
}

template <typename T, int MT, int HD>
static int launch(const void* const* p, void* out, int n_img, int n_tok,
                  int d, float scale, cudaStream_t stream) {
  auto kern = fused_dit_block_kernel<T, MT, HD>;
  const size_t smem = smem_bytes<T>(MT, d);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int imgs_per_tile = MT / n_tok;
  const int grid = (n_img + imgs_per_tile - 1) / imgs_per_tile;
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<T*>(out), n_img, n_tok, d,
      imgs_per_tile, scale);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
static int dispatch_hd(int hd, const void* const* p, void* out, int n_img,
                       int n_tok, int d, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, MT, 16>(p, out, n_img, n_tok, d, scale, s);
    case 32: return launch<T, MT, 32>(p, out, n_img, n_tok, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. mt: token rows per block (64 for
// bfloat16; 16, 32 or 64 for float32), chosen by the caller so that
// smem_bytes fits in a block (ops/kernels.py mirrors the formula); a size
// that does not fit fails in cudaFuncSetAttribute and is returned. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported combination.
extern "C" int fused_dit_block_launch(
    int dtype, const void* tok, const void* wqkv, const void* bqkv,
    const void* wpr, const void* bpr, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, int n_img, int n_tok, int d,
    int hd, int mt, float scale, void* stream) {
  const void* p[9] = {tok, wqkv, bqkv, wpr, bpr, w1, b1, w2, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tok < 1 || n_tok > mt || d % cdm::KT != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && mt == 64)
    return cdm::dispatch_hd<cdm::bf16, 64>(hd, p, out, n_img, n_tok, d, scale, s);
  if (dtype == 0 && mt == 64)
    return cdm::dispatch_hd<float, 64>(hd, p, out, n_img, n_tok, d, scale, s);
  if (dtype == 0 && mt == 32)
    return cdm::dispatch_hd<float, 32>(hd, p, out, n_img, n_tok, d, scale, s);
  if (dtype == 0 && mt == 16)
    return cdm::dispatch_hd<float, 16>(hd, p, out, n_img, n_tok, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
