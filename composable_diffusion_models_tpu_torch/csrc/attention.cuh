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

template <typename T, int HD>
__device__ __forceinline__ float score(const float (&q)[HD], const T* k,
                                       float scale) {
  float kf[HD];
  load_f<T, HD>(k, kf);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < HD; ++e) s = fmaf(q[e], kf[e], s);
  return s * scale;
}

// Attention output of query i, head h, for one image whose packed qkv rows
// ([q | k | v] x [head] x [HD], row stride ld) start at img. The HD outputs
// go to out + i * ld_out + h * HD. out may alias img: the query row is read
// in full before the output is written, and no other (i, h) reads it.
template <typename T, int HD>
__device__ void attend_query(const T* img, int ld, T* out, int ld_out, int i,
                             int h, int n_tok, int d, float scale) {
  float q[HD];
  load_f<T, HD>(img + (size_t)i * ld + h * HD, q);
  const T* kb = img + d + h * HD;
  const T* vb = img + 2 * d + h * HD;
  float m = -INFINITY;
  for (int j = 0; j < n_tok; ++j)
    m = fmaxf(m, score<T, HD>(q, kb + (size_t)j * ld, scale));
  float l = 0.f;
  for (int j = 0; j < n_tok; ++j)
    l += expf(score<T, HD>(q, kb + (size_t)j * ld, scale) - m);
  float acc[HD];
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;
  for (int j = 0; j < n_tok; ++j) {
    const float p = round_to<T>(
        expf(score<T, HD>(q, kb + (size_t)j * ld, scale) - m) / l);
    float v[HD];
    load_f<T, HD>(vb + (size_t)j * ld, v);
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = fmaf(p, v[e], acc[e]);
  }
  store_f<T, HD>(out + (size_t)i * ld_out + h * HD, acc);
}

}  // namespace cdm
