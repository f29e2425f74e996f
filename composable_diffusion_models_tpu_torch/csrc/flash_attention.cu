// flash_attention: softmax(q k^T * scale) v for q (B, H, Nq, D) and k, v
// (B, H, Nk, D), any Nq and Nk, D in {16, 32, 64, 128}, float32 or
// bfloat16, to out (B, H, Nq, D) in q's type. Every tensor comes with its
// (batch, head, row) strides in elements; the last axis has stride 1.
//
// Replaces: composable_diffusion_models_tpu/ops/attention.py,
// flash_attention / _flash_kernel.
//
// Numerics follow the Pallas body: q, k, v widened to float32, q scaled
// before the score product, scores, softmax and accumulator in float32
// with the blockwise running (max, denominator, accumulator) state, the
// running max started at -1e30 (not -inf, so exp(m_prev - m_new) is never
// NaN on the first block), the probabilities not rounded, acc / l rounded
// once at the store. Keys beyond Nk are masked by their index in the score
// tile: there is no padded key block and no bias column, so at Nk = 2 a
// query computes 2 scores (the TPU kernel pads to 128).
//
// Bound on the H100: at the UNet's cross-attention shapes (Nk = 2) memory,
// q read once and out written once; at long contexts (4096 x 4096 x 64)
// operations. The TPU kernel widens to float32 before both products, so
// the faithful products here are float32 FMAs on the CUDA cores, not bf16
// tensor-core MMAs.
// Design: a block of 128 threads owns BQ consecutive queries of one
// (batch, head). TPQ = D / 32 (at least 1) neighbouring lanes share a
// query, each holding an interleaved slice of q and of the accumulator in
// registers; their partial scores meet in a butterfly shuffle. K and V
// stream through shared memory in tiles of BK = 4096 / D keys, widened to
// float32 once per block, and are read as float4 broadcasts. Scores are
// taken 8 keys at a time (the score tile), so the running state is updated
// with one rescale per 8 keys.
#include "attention.cuh"

namespace cdm {

constexpr int FA_THREADS = 128;
constexpr int FA_KS = 8;  // keys per score tile
constexpr float FA_NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
      __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
      __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

struct Strides {
  long long b, h, n;
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int n_heads, int nq, int nk, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int q_blocks) {
  constexpr int DP = D < 32 ? D : 32;   // elements of a query per thread
  constexpr int TPQ = D / DP;           // threads per query
  constexpr int BQ = FA_THREADS / TPQ;  // queries per block
  constexpr int BK = 4096 / D;          // keys per shared-memory tile
  constexpr int NCH = DP / 4;           // float4 chunks per thread
  constexpr int ROW4 = D / 4;           // float4 chunks per key row
  __shared__ float4 sk[BK * ROW4];
  __shared__ float4 sv[BK * ROW4];

  const int bh = blockIdx.x / q_blocks, qb = blockIdx.x % q_blocks;
  const int b = bh / n_heads, h = bh % n_heads;
  const int part = threadIdx.x % TPQ;
  const int qi = qb * BQ + threadIdx.x / TPQ;
  const bool live = qi < nq;
  // a thread past the last query keeps the block's barriers and shuffles
  // company on the last query's row and stores nothing
  const T* qrow = q + b * qs.b + h * qs.h + (long long)(live ? qi : nq - 1) * qs.n;

  // thread `part` of a query owns float4 chunks part, part + TPQ, ...
  float4 qr[NCH], acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float4 t = load4(qrow + (c * TPQ + part) * 4);
    qr[c] = make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = FA_NEG, l = 0.f;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    const int kn = min(BK, nk - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int idx = threadIdx.x; idx < kn * ROW4; idx += FA_THREADS) {
      const int j = idx / ROW4, c = idx % ROW4;
      sk[idx] = load4(kb + (long long)(k0 + j) * ks.n + c * 4);
      sv[idx] = load4(vb + (long long)(k0 + j) * vs.n + c * 4);
    }
    __syncthreads();
    for (int j0 = 0; j0 < kn; j0 += FA_KS) {
      float s[FA_KS];
#pragma unroll
      for (int jj = 0; jj < FA_KS; ++jj) {
        float d = 0.f;
        if (j0 + jj < kn) {
          const float4* kr = sk + (j0 + jj) * ROW4 + part;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float4 kk = kr[c * TPQ];
            d = fmaf(qr[c].x, kk.x, d);
            d = fmaf(qr[c].y, kk.y, d);
            d = fmaf(qr[c].z, kk.z, d);
            d = fmaf(qr[c].w, kk.w, d);
          }
        }
        s[jj] = d;
      }
#pragma unroll
      for (int off = TPQ / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int jj = 0; jj < FA_KS; ++jj)
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
      }
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < FA_KS; ++jj) {
        if (j0 + jj >= kn) s[jj] = FA_NEG;  // masked by index
        m_new = fmaxf(m_new, s[jj]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[c].x *= alpha;
        acc[c].y *= alpha;
        acc[c].z *= alpha;
        acc[c].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < FA_KS; ++jj) {
        if (j0 + jj < kn) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* vr = sv + (j0 + jj) * ROW4 + part;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float4 vv = vr[c * TPQ];
            acc[c].x = fmaf(p, vv.x, acc[c].x);
            acc[c].y = fmaf(p, vv.y, acc[c].y);
            acc[c].z = fmaf(p, vv.z, acc[c].z);
            acc[c].w = fmaf(p, vv.w, acc[c].w);
          }
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  T* orow = o + b * os.b + h * os.h + (long long)qi * os.n;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    store4(orow + (c * TPQ + part) * 4,
           make_float4(acc[c].x / l, acc[c].y / l, acc[c].z / l,
                       acc[c].w / l));
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int n_batch, int n_heads, int nq, int nk,
                  const long long* st, float scale, cudaStream_t stream) {
  constexpr int TPQ = D < 32 ? 1 : D / 32;
  constexpr int BQ = FA_THREADS / TPQ;
  const int q_blocks = (nq + BQ - 1) / BQ;
  const long long grid = (long long)n_batch * n_heads * q_blocks;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_attention_kernel<T, D><<<(unsigned)grid, FA_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_heads, nq, nk, qs, ks,
      vs, os, scale, q_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(int d, const void* q, const void* k, const void* v,
                      void* o, int n_batch, int n_heads, int nq, int nk,
                      const long long* st, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, n_batch, n_heads, nq, nk, st, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, n_batch, n_heads, nq, nk, st, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, n_batch, n_heads, nq, nk, st, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, n_batch, n_heads, nq, nk, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides on the
// host, (batch, head, row) of q, k, v and out in that order; every one a
// multiple of 4 and every pointer 16-byte aligned (the kernel moves 4
// elements at a time). nq, nk >= 1. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported
// dtype, head width or size.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int n_batch, int n_heads, int nq,
                                      int nk, int d,
                                      const long long* strides, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_batch < 1 || n_heads < 1 || nq < 1 || nk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::dispatch_d<float>(d, q, k, v, o, n_batch, n_heads, nq, nk,
                                  strides, scale, s);
  if (dtype == 1)
    return cdm::dispatch_d<cdm::bf16>(d, q, k, v, o, n_batch, n_heads, nq,
                                      nk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
