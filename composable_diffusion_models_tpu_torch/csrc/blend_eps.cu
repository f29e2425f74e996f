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
// float32 the two agree bit for bit.
//
// Bound on the H100: memory. Each output element reads K inputs and takes
// 2K + 1 operations: under 1 FLOP per byte.
// Design: the TPU kernel is one program that holds the whole stack in VMEM.
// Here the n output elements are spread over a grid-stride loop; a thread
// owns one 16-byte vector of the output at a time and reads the matching
// vector of each of the K planes, so every plane is read once, coalesced.
// The K weights are read from device memory by every thread (a broadcast
// from L1): the host never sees them, so a sampler loop that blends once
// per step never waits for the card. K is a run-time value. Plane i starts
// n elements after plane i - 1, so the vector path needs n to be a multiple
// of the vector width; the elements past the last whole vector (all of
// them when n is not such a multiple) take the scalar loop of the same
// kernel.
#include "attention.cuh"

namespace cdm {

constexpr int BLEND_THREADS = 256;

__device__ __forceinline__ float blend_one(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

template <typename T>
__global__ void __launch_bounds__(BLEND_THREADS)
blend_kernel(const T* __restrict__ eps, const float* __restrict__ w,
             T* __restrict__ out, size_t n, int k) {
  constexpr int VEC = 16 / sizeof(T);
  float wsum = 0.f;
  for (int i = 0; i < k; ++i) wsum = __fadd_rn(wsum, __ldg(w + i));

  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nvec = (n % VEC == 0) ? n / VEC : 0;
  for (size_t v = tid; v < nvec; v += stride) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int i = 0; i < k; ++i) {
      const float wi = __ldg(w + i);
      float x[VEC];
      load_f<T, VEC>(eps + (size_t)i * n + v * VEC, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = blend_one(acc[e], wi, x[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], wsum);
    store_f<T, VEC>(out + v * VEC, acc);
  }
  for (size_t j = nvec * VEC + tid; j < n; j += stride) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i)
      acc = blend_one(acc, __ldg(w + i), to_f(eps[(size_t)i * n + j]));
    out[j] = from_f<T>(__fdiv_rn(acc, wsum));
  }
}

template <typename T>
static int launch(const void* eps, const void* w, void* out, size_t n, int k,
                  cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t items = (n % VEC == 0) ? n / VEC : n;
  // enough blocks to fill 132 SMs several times over, no more
  size_t blocks = (items + BLEND_THREADS - 1) / BLEND_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  blend_kernel<T><<<(unsigned)blocks, BLEND_THREADS, 0, stream>>>(
      static_cast<const T*>(eps), static_cast<const float*>(w),
      static_cast<T*>(out), n, k);
  return (int)cudaGetLastError();
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. eps (k, n) contiguous and 16-byte
// aligned, w (k,) float32, out (n,) in eps's type and 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside those limits.
extern "C" int blend_eps_launch(int dtype, const void* eps, const void* w,
                                void* out, long long n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || n < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cdm::launch<float>(eps, w, out, (size_t)n, k, s);
  return cdm::launch<cdm::bf16>(eps, w, out, (size_t)n, k, s);
}
