// blend_eps: sum_i w_i * eps_i / sum_i w_i over the leading expert axis of
// a contiguous (K, n) stack, weights (K,) float32 in device memory.
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// blend_eps / _blend_kernel.
//
// Numerics follow the Pallas body: the accumulator and the weight sum
// start at 0 and take the experts in order i = 0..K-1 in float32
// (acc = acc + w_i * eps_i as a rounded product and a rounded add, no
// fused multiply-add), one IEEE division acc / wsum, one rounding to the
// stack's type at the store. That is also the plain version's order, so in
// float32 the two agree bit for bit, at both item widths below.
//
// Bound on the H100: memory. Each output element reads K inputs and takes
// 2K + 1 operations: under 1 FLOP per byte. The stacks the samplers blend
// are small (1024 floats on the latent path), so there the bound is the
// latency of one launch and one round trip to memory; at the largest
// served stack (393,216 floats a plane) it is the bytes in flight.
// Design: the TPU kernel is one program that holds the whole stack in VMEM.
// Here a thread owns one item of the output (one 16-byte vector, or one
// element on the scalar route), consecutive threads consecutive items so
// that every load of a warp is coalesced, and reads the matching item of
// each of the K planes; the grid covers the stack (ops/kernels.py
// blend_route).
// * K is a template parameter for K = 1..4, so a thread issues all its
//   loads (the K weights, a broadcast that L1 serves, and its K items)
//   before its first add, keeps the items as loaded until their adds, and
//   sums the weights while the items are in flight: one round trip to
//   memory, not one for each expert. Other K take the run-time-K kernel,
//   which loads KG planes at once.
// * Plane i starts i * n elements in, so the vector route needs n to be a
//   multiple of the vector width (and 16-byte aligned pointers, which the
//   wrapper checks). A peel of each plane's unaligned head does not align
//   the K planes with each other and with the output at once, so a ragged
//   n (no served shape has one) takes the scalar route: the same kernels
//   with items of one element.
#include "attention.cuh"

namespace cdm {

constexpr int BLEND_THREADS = 256;
constexpr int KG = 4;  // planes the run-time-K kernel loads at once

__device__ __forceinline__ float blend_one(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// an item of W elements as loaded: one 16-byte vector, or one element. A
// thread keeps its items in this form until their adds, so that a bf16
// item takes 4 registers in flight, not 8
template <typename T, int W> struct Item { uint4 raw; };
template <typename T> struct Item<T, 1> { T raw; };

// plane i's item j
template <typename T, int W>
__device__ __forceinline__ void load_item(const T* eps, size_t items, int i,
                                          size_t j, Item<T, W>& x) {
  const T* p = eps + ((size_t)i * items + j) * W;
  if constexpr (W == 1)
    x.raw = p[0];
  else
    x.raw = *reinterpret_cast<const uint4*>(p);
}

// element e of an item, as a float
template <typename T, int W>
__device__ __forceinline__ float item_f(const Item<T, W>& x, int e) {
  return to_f(reinterpret_cast<const T*>(&x.raw)[e]);
}

// divides the sums by wsum and stores them as item j
template <typename T, int W>
__device__ __forceinline__ void store_item(T* out, size_t j, float (&acc)[W],
                                           float wsum) {
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = __fdiv_rn(acc[e], wsum);
  if constexpr (W == 1)
    out[j] = from_f<T>(acc[0]);
  else
    store_f<T, W>(out + j * W, acc);
}

// K known: every load before the first add
template <typename T, int W, int K>
__global__ void __launch_bounds__(BLEND_THREADS)
blend_fixed(const T* __restrict__ eps, const float* __restrict__ w,
            T* __restrict__ out, size_t items, int) {
  const size_t j = (size_t)blockIdx.x * BLEND_THREADS + threadIdx.x;
  if (j >= items) return;
  float wv[K];
  Item<T, W> x[K];
#pragma unroll
  for (int i = 0; i < K; ++i) wv[i] = __ldg(w + i);
#pragma unroll
  for (int i = 0; i < K; ++i) load_item<T, W>(eps, items, i, j, x[i]);
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) wsum = __fadd_rn(wsum, wv[i]);
  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < W; ++e)
      acc[e] = blend_one(acc[e], wv[i], item_f(x[i], e));
  store_item<T, W>(out, j, acc, wsum);
}

// any K: KG planes' loads (and weights) at a time, the adds in order
template <typename T, int W>
__global__ void __launch_bounds__(BLEND_THREADS)
blend_any(const T* __restrict__ eps, const float* __restrict__ w,
          T* __restrict__ out, size_t items, int k) {
  const size_t j = (size_t)blockIdx.x * BLEND_THREADS + threadIdx.x;
  if (j >= items) return;
  float acc[W], wsum = 0.f;
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  for (int i0 = 0; i0 < k; i0 += KG) {
    float wv[KG];
    Item<T, W> x[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      // past the last plane: plane k - 1 again, its adds skipped
      const int i = i0 + g < k ? i0 + g : k - 1;
      wv[g] = __ldg(w + i);
      load_item<T, W>(eps, items, i, j, x[g]);
    }
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (i0 + g >= k) break;
      wsum = __fadd_rn(wsum, wv[g]);
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[e] = blend_one(acc[e], wv[g], item_f(x[g], e));
    }
  }
  store_item<T, W>(out, j, acc, wsum);
}

template <typename T>
using BlendFn = void (*)(const T*, const float*, T*, size_t, int);

template <typename T, int W>
static BlendFn<T> kernel_for(int k) {
  switch (k) {
    case 1: return blend_fixed<T, W, 1>;
    case 2: return blend_fixed<T, W, 2>;
    case 3: return blend_fixed<T, W, 3>;
    case 4: return blend_fixed<T, W, 4>;
    default: return blend_any<T, W>;
  }
}

template <typename T>
static int launch(const void* eps, const void* w, void* out, size_t n, int k,
                  int width, unsigned grid, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if ((width != VEC && width != 1) ||
      (width > 1 && ((uintptr_t)eps % 16 || (uintptr_t)out % 16)))
    return (int)cudaErrorInvalidValue;
  size_t items = n / width;
  if ((size_t)grid * BLEND_THREADS < items) return (int)cudaErrorInvalidValue;
  BlendFn<T> fn = width == VEC ? kernel_for<T, VEC>(k) : kernel_for<T, 1>(k);
  const T* e = static_cast<const T*>(eps);
  const float* wf = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  void* args[] = {&e, &wf, &o, &items, &k};
  cudaLaunchKernel((const void*)fn, dim3(grid), dim3(BLEND_THREADS), args, 0,
                   s);
  return (int)cudaGetLastError();
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. eps (k, n) contiguous, w (k,) float32,
// out (n,) in eps's type. The route (ops/kernels.py blend_route): width,
// the elements of an item (16 bytes' worth, which needs n a multiple of it
// and eps and out 16-byte aligned, or 1); grid, the blocks of 256 threads,
// one item a thread, at least enough to cover the n / width items. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside those limits.
extern "C" int blend_eps_launch(int dtype, const void* eps, const void* w,
                                void* out, long long n, int k, int width,
                                int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || n < 1 || k < 1 || width < 1 ||
      n % width || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::launch<float>(eps, w, out, (size_t)n, k, width,
                              (unsigned)grid, s);
  return cdm::launch<cdm::bf16>(eps, w, out, (size_t)n, k, width,
                                (unsigned)grid, s);
}
