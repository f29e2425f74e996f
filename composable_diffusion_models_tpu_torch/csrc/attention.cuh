// Device code shared by the two kernels of the DiT serving path:
// element conversions, 16-byte vector loads/stores, and the per-image,
// per-head, per-query short-sequence attention routine.
//
// The TPU kernels (composable_diffusion_models_tpu/ops/pallas_kernels.py,
// _short_attn_kernel and the attention half of _dit_block_kernel) pack
// 128 // T images into one MXU-sized row block behind a block-diagonal
// -1e30 mask. That mask exists only to fit the TPU's 128-row matrix unit.
// Here one thread owns one (image, head, query) triple and loops over that
// image's T keys: no packing, no mask, no cross-image work.
//
// Numerics follow the Pallas kernel: fp32 scores and softmax
// (exp(s - max) / sum), the probabilities rounded to the input type before
// the value product, fp32 accumulation, one rounding of the output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cdm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, returned as float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// N consecutive elements (N a multiple of 16 bytes) as floats; p 16-byte
// aligned, in global or shared memory
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&out)[N]) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(N % VEC == 0, "row length must be whole 16-byte vectors");
#pragma unroll
  for (int v = 0; v < N / VEC; ++v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p + v * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[v * VEC + i] = to_f(e[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&in)[N]) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(N % VEC == 0, "row length must be whole 16-byte vectors");
#pragma unroll
  for (int v = 0; v < N / VEC; ++v) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(in[v * VEC + i]);
    *reinterpret_cast<uint4*>(p + v * VEC) = raw;
  }
}

// A tile of rows addressed as (row, column): at(r, c) points at the 16-byte
// vector that starts at column c (a multiple of 16 bytes of elements) of row
// r. RowMajor is a plain row-major matrix; a kernel that keeps its tile in
// another shared-memory layout passes its own address function.
template <typename T> struct RowMajor {
  T* p;
  int ld;
  __device__ __forceinline__ T* at(int r, int c) const {
    return p + (size_t)r * ld + c;
  }
};

// HD elements of row r from column c on, one 16-byte vector at a time
template <typename T, int HD, class Tile>
__device__ __forceinline__ void load_row(const Tile& t, int r, int c,
                                         float (&out)[HD]) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(HD % VEC == 0, "head width must be whole 16-byte vectors");
#pragma unroll
  for (int v = 0; v < HD / VEC; ++v)
    load_f<T, VEC>(t.at(r, c + v * VEC),
                   reinterpret_cast<float(&)[VEC]>(out[v * VEC]));
}

template <typename T, int HD, class Tile>
__device__ __forceinline__ void store_row(const Tile& t, int r, int c,
                                          const float (&in)[HD]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < HD / VEC; ++v)
    store_f<T, VEC>(t.at(r, c + v * VEC),
                    reinterpret_cast<const float(&)[VEC]>(in[v * VEC]));
}

template <typename T, int HD, class Tile>
__device__ __forceinline__ float score(const float (&q)[HD], const Tile& t,
                                       int r, int c, float scale) {
  float kf[HD];
  load_row<T, HD>(t, r, c, kf);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < HD; ++e) s = fmaf(q[e], kf[e], s);
  return s * scale;
}

constexpr int SHORT_T = 8;  // sequences whose scores a thread keeps

// Attention output of query i, head h, for one image whose packed qkv rows
// ([q | k | v] x [head] x [HD]) are rows 0 .. n_tok - 1 of in. The HD outputs
// go to row i, columns h * HD .. of out. out may alias in: the query row is
// read in full before the output is written, and no other (i, h) reads it.
template <typename T, int HD, class In, class Out>
__device__ void attend_query(const In& in, const Out& out, int i, int h,
                             int n_tok, int d, float scale) {
  float q[HD];
  load_row<T, HD>(in, i, h * HD, q);
  const int kc = d + h * HD, vc = 2 * d + h * HD;
  float acc[HD];
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;
  if (n_tok <= SHORT_T) {
    // few keys: each score is computed once and kept; the values and the
    // order of every sum are those of the three passes below
    float s[SHORT_T];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < SHORT_T; ++j)
      if (j < n_tok) {
        s[j] = score<T, HD>(q, in, j, kc, scale);
        m = fmaxf(m, s[j]);
      }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < SHORT_T; ++j)
      if (j < n_tok) {
        s[j] = expf(s[j] - m);
        l += s[j];
      }
#pragma unroll
    for (int j = 0; j < SHORT_T; ++j)
      if (j < n_tok) {
        const float p = round_to<T>(s[j] / l);
        float v[HD];
        load_row<T, HD>(in, j, vc, v);
#pragma unroll
        for (int e = 0; e < HD; ++e) acc[e] = fmaf(p, v[e], acc[e]);
      }
  } else {
    float m = -INFINITY;
    for (int j = 0; j < n_tok; ++j)
      m = fmaxf(m, score<T, HD>(q, in, j, kc, scale));
    float l = 0.f;
    for (int j = 0; j < n_tok; ++j)
      l += expf(score<T, HD>(q, in, j, kc, scale) - m);
    for (int j = 0; j < n_tok; ++j) {
      const float p =
          round_to<T>(expf(score<T, HD>(q, in, j, kc, scale) - m) / l);
      float v[HD];
      load_row<T, HD>(in, j, vc, v);
#pragma unroll
      for (int e = 0; e < HD; ++e) acc[e] = fmaf(p, v[e], acc[e]);
    }
  }
  store_row<T, HD>(out, i, h * HD, acc);
}

}  // namespace cdm
