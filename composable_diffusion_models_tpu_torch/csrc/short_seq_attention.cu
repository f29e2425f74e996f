// short_seq_attention: softmax(Q K^T / sqrt(hd)) V for every head of every
// image, from a packed (B, T, 3D) qkv tensor in [q | k | v] x [head] x [hd]
// layout, to (B, T, D).
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// short_seq_attention / _short_attn_kernel.
//
// Bound on the H100: memory. At the serving shape (T=4, D=256, 8 heads)
// an image's attention is 8 heads x 4 x 4 scores over 32 wide rows: 16
// kFLOP against 6 KB read and 2 KB written in bf16, about 2 FLOP per byte,
// far below the ~295 FLOP/byte where the tensor cores become the limit.
// Design: one thread per (image, head, query), 256 threads a block, grid
// over all B * H * T triples with the ragged tail masked (any B). Each
// thread reads its query row once and the image's key and value rows of
// its head with 16-byte vector loads. At the serving shape a warp's 32
// threads are exactly one image's (head, query) pairs, so every row comes
// from DRAM once and the repeats hit L1.
// No shared memory, no tensor cores: the work is a few FMAs per byte.
// Head widths 8, 16, 32, 48 and 64 (a head is whole 16-byte vectors).
#include "attention.cuh"

namespace cdm {

template <typename T, int HD>
__global__ void __launch_bounds__(256)
short_seq_attention_kernel(const T* qkv, T* out, int n_img, int n_tok,
                           int n_heads, float scale) {
  const int per_img = n_heads * n_tok;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n_img * per_img) return;
  const int b = (int)(p / per_img);
  const int rem = (int)(p % per_img);
  const int h = rem / n_tok, i = rem % n_tok;
  const int d = n_heads * HD;
  const RowMajor<const T> in{qkv + (size_t)b * n_tok * 3 * d, 3 * d};
  const RowMajor<T> dst{out + (size_t)b * n_tok * d, d};
  attend_query<T, HD>(in, dst, i, h, n_tok, d, scale);
}

template <typename T, int HD>
static int launch(const void* qkv, void* out, int n_img, int n_tok,
                  int n_heads, float scale, cudaStream_t stream) {
  const long long total = (long long)n_img * n_heads * n_tok;
  const int grid = (int)((total + 255) / 256);
  short_seq_attention_kernel<T, HD><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n_img, n_tok,
      n_heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(int hd, const void* qkv, void* out, int n_img,
                       int n_tok, int n_heads, float scale,
                       cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(qkv, out, n_img, n_tok, n_heads, scale, s);
    case 16: return launch<T, 16>(qkv, out, n_img, n_tok, n_heads, scale, s);
    case 32: return launch<T, 32>(qkv, out, n_img, n_tok, n_heads, scale, s);
    case 48: return launch<T, 48>(qkv, out, n_img, n_tok, n_heads, scale, s);
    case 64: return launch<T, 64>(qkv, out, n_img, n_tok, n_heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported
// dtype or head width.
extern "C" int short_seq_attention_launch(int dtype, const void* qkv,
                                          void* out, int n_img, int n_tok,
                                          int n_heads, int hd, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cdm::dispatch_hd<float>(hd, qkv, out, n_img, n_tok, n_heads,
                                   scale, s);
  if (dtype == 1)
    return cdm::dispatch_hd<cdm::bf16>(hd, qkv, out, n_img, n_tok, n_heads,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}
