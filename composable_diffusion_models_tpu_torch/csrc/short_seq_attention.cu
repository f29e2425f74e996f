// short_seq_attention: softmax(Q K^T / sqrt(hd)) V for every head of every
// image, from a packed (B, T, 3D) qkv tensor in [q | k | v] x [head] x [hd]
// layout, to (B, T, D).
//
// Replaces: composable_diffusion_models_tpu/ops/pallas_kernels.py,
// short_seq_attention / _short_attn_kernel.
//
// Bound on the H100: memory. At the serving shape (T=4, D=256, 8 heads)
// an image's attention is 8 heads x 4 x 4 scores over 32 wide rows: 16
// kFLOP against 6 KB read and 2 KB written in bf16, about 2 FLOP per byte;
// at profile_dit's T = 16 about 8, still far below the ~295 FLOP/byte where
// the tensor cores become the limit. The least time is the bytes over
// 3.35 TB/s: 25.17 MB, 7.5 us at (768, 16, 768) in bf16.
//
// Design (images of 9 to 16 tokens, profile_dit's 16 among them, whose
// keys and values fit a block's staging room: the "staged" kernel). A block owns whole images, as many
// as give it one thread per (image, head, query), packed up to 128, and
// as few as keep two blocks an SM busy: it copies their key and value
// rows into shared memory once, with coalesced 16-byte loads, eight in
// flight a thread, widened to float32 there (every query of a head reads
// the same rows: widened once, not once a thread), heads and rows padded
// by 16 bytes so that the threads of a warp fall in different banks. Each
// thread reads its own query row (64 contiguous bytes of bf16 at heads of
// 32) from global memory, keeps its T scores in registers, so that each
// score is computed once (one pass of score FMAs, not three), and writes
// its output, rounded, over its key row in shared memory once every
// thread is done with the keys; the block then stores the outputs with
// coalesced 16-byte stores. Every score FMA, the max, the sum and every
// value FMA keep the values and the order of the walk below
// (attention.cuh: its three passes past 8 tokens), so the output is that
// walk's, bit for bit. On an H100 80GB HBM3 at 700 W, profile_dit's
// (768, 16, 768) in bf16 takes 0.0174 ms, against 0.0394 for the walk and
// a 0.0075 ms bound. What holds it: its ~6 blocks an SM make one round,
// so the loads and the arithmetic follow each other, and every score and
// value FMA reads its operand from shared memory (two queries a thread,
// which halve those reads, cost warps and ran slower: 0.0189 ms).
//
// Other images take the first design's walk (the "global" kernel): one
// thread per (image, head, query), 256 a block, reading the key and value
// rows of its head from global memory / L1 with 16-byte loads; up to
// SHORT_T = 8 tokens (the serving path's 4) it keeps its scores too, and
// a warp's 32 threads are one image's (head, query) pairs, so every row
// comes from DRAM once and the repeats hit L1; past 16 tokens, or where
// the keys and values do not fit, three passes over the keys (max, sum,
// product). The staged kernel was also built to keep 32 and 64 scores
// (faster than the three passes there too, the same bits), but those
// fully unrolled kernels under the same launch bound took minutes to
// build, more than the whole build may take.
//
// No tensor cores: the work is a few FMAs per byte. Head widths 8, 16, 32,
// 48 and 64 (a head is whole 16-byte vectors), float32 and bfloat16, any B
// and T.
#include "attention.cuh"

namespace cdm {

constexpr int STAGED_THREADS = 256;     // threads of a block at most
constexpr int STAGED_PACK = 128;        // threads images are packed to
constexpr int KEPT = 16;                // scores a thread keeps at most
constexpr int STAGED_SMEM = 96 * 1024;  // staging room of one block
constexpr int STAGED_MIN_GRID = 264;    // blocks that keep 132 SMs busy

// Shared-memory floats of one staged row: the K and V of every head, each
// at a stride of HD + 4, and 4 more
__host__ __device__ constexpr int staged_ld(int n_heads, int hd) {
  return 2 * n_heads * (hd + 4) + 4;
}

// Attention of one (image, head, query) with the scores kept: q the query
// in float32, K and V the head's 8 < n_tok <= KEPT key and value rows.
// The arithmetic is attend_query's three passes (attention.cuh) on the
// same values, in their compiled form, where score * scale - max is one
// FMA. The loops run over all KEPT keys without a branch, so that the
// compiler can overlap the keys' FMA chains: keys past n_tok read row
// n_tok - 1 and are dropped by selects from the max and the sum, and by a
// zero probability from the value sums (fmaf(0, v, acc) is acc: acc is
// never -0). Returns the output, rounded to T, in acc.
template <typename T, int HD>
__device__ void attend_kept(const float (&q)[HD], const RowMajor<float>& K,
                            const RowMajor<float>& V, int n_tok,
                            float scale, float (&acc)[HD]) {
  float s[KEPT];  // the scores' sums before the scale, then p
#pragma unroll
  for (int j = 0; j < KEPT; ++j)
    s[j] = score<float, HD>(q, K, min(j, n_tok - 1), 0, 1.f);
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < KEPT; ++j) m = j < n_tok ? fmaxf(m, s[j] * scale) : m;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < KEPT; ++j) {
    s[j] = expf(fmaf(s[j], scale, -m));
    l = j < n_tok ? l + s[j] : l;
  }
  // the probabilities before the value sums: a division's slow path is a
  // branch
#pragma unroll
  for (int j = 0; j < KEPT; ++j) s[j] = j < n_tok ? round_to<T>(s[j] / l) : 0.f;
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < KEPT; ++j) {
    float v[HD];
    load_row<float, HD>(V, min(j, n_tok - 1), 0, v);
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = fmaf(s[j], v[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = round_to<T>(acc[e]);
}

// Blocks of STAGED_THREADS an SM that the registers of attend_kept allow:
// the query or the output (HD), the scores (KEPT) and ~24 more a thread.
// As a launch bound it keeps the compiler from spending registers on
// overlapping more of the keys' chains than it can keep warps for.
constexpr int staged_min_blocks(int hd) {
  return 65536 / (STAGED_THREADS * (hd + KEPT + 24));
}

// per_block images of n_tok tokens a block, blockDim.x >= per_block *
// n_heads * n_tok threads
template <typename T, int HD>
__global__ void __launch_bounds__(STAGED_THREADS, staged_min_blocks(HD))
short_seq_staged_kernel(const T* qkv, T* out, int n_img, int n_tok,
                        int n_heads, int per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int BATCH = 8;             // loads a thread keeps in flight
  float* kv = reinterpret_cast<float*>(smem_raw);
  const int d = n_heads * HD, ld = staged_ld(n_heads, HD);
  const int img0 = blockIdx.x * per_block;
  const int imgs = min(per_block, n_img - img0);
  const int n_rows = imgs * n_tok;
  const T* src = qkv + (size_t)img0 * n_tok * 3 * d;
  // shared-memory float of column c (0 .. 2D: K, then V) of staged row r
  const auto at = [&](int r, int c) {
    return kv + r * ld + c / HD * (HD + 4) + c % HD;
  };
  // K and V: vector v is row v / vkv, columns D + v % vkv * VEC ..
  const int vkv = 2 * d / VEC, n_in = n_rows * vkv;
  for (int v0 = threadIdx.x; v0 < n_in; v0 += BATCH * blockDim.x) {
    uint4 raw[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int v = v0 + b * blockDim.x;
      if (v < n_in)
        raw[b] = *reinterpret_cast<const uint4*>(
            src + (size_t)(v / vkv) * 3 * d + d + v % vkv * VEC);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int v = v0 + b * blockDim.x;
      if (v < n_in) {
        float f[VEC];
        load_f<T, VEC>(reinterpret_cast<const T*>(&raw[b]), f);
        store_f<float, VEC>(at(v / vkv, v % vkv * VEC), f);
      }
    }
  }
  // this thread's (image, head, query), its query from global memory
  const int per_img = n_heads * n_tok, p = threadIdx.x;
  const bool mine = p < imgs * per_img;
  const int im = p / per_img, h = p % per_img / n_tok, i = p % n_tok;
  float q[HD], acc[HD];
  if (mine) load_f<T, HD>(src + (size_t)(im * n_tok + i) * 3 * d + h * HD, q);
  __syncthreads();
  if (mine) {
    float* img = kv + im * n_tok * ld;
    attend_kept<T, HD>(q, RowMajor<float>{img + h * (HD + 4), ld},
                       RowMajor<float>{img + (n_heads + h) * (HD + 4), ld},
                       n_tok, scale, acc);
  }
  __syncthreads();
  // the outputs over the keys: column c of output row r at at(r, c)
  if (mine) store_row<float, HD>(RowMajor<float>{kv, ld}, im * n_tok + i,
                                 h * (HD + 4), acc);
  __syncthreads();
  T* dst = out + (size_t)img0 * n_tok * d;
  const int vout = d / VEC;
  for (int v = threadIdx.x; v < n_rows * vout; v += blockDim.x) {
    float f[VEC];
    load_f<float, VEC>(at(v / vout, v % vout * VEC), f);
    store_f<T, VEC>(dst + v * VEC, f);
  }
}

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

// Images a staged block holds: one thread each of their (image, head,
// query) triples, packed up to STAGED_PACK threads, within the staging
// room, and few enough for STAGED_MIN_GRID blocks where there are images
// enough; 0 for the global kernel: images of up to SHORT_T tokens (whose
// scores it keeps too), or that do not fit.
static int staged_per_block(int n_img, int n_tok, int n_heads, int hd) {
  const size_t img_bytes =
      (size_t)n_tok * staged_ld(n_heads, hd) * sizeof(float);
  const int threads = n_heads * n_tok;  // an image's
  if (n_tok <= SHORT_T || n_tok > KEPT ||
      threads > STAGED_THREADS || img_bytes > STAGED_SMEM)
    return 0;
  int per_block = STAGED_PACK / threads;
  const int fit = (int)(STAGED_SMEM / img_bytes);
  const int spread = n_img / STAGED_MIN_GRID;
  if (per_block > fit) per_block = fit;
  if (per_block > spread) per_block = spread;
  return per_block > 1 ? per_block : 1;
}

template <typename T, int HD>
static int launch_staged(const void* qkv, void* out, int n_img, int n_tok,
                         int n_heads, int per_block, float scale,
                         cudaStream_t stream) {
  const size_t smem =
      (size_t)per_block * n_tok * staged_ld(n_heads, HD) * sizeof(float);
  const auto kern = short_seq_staged_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (per_block * n_heads * n_tok + 31) / 32 * 32;
  const int grid = (n_img + per_block - 1) / per_block;
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(qkv),
                                        static_cast<T*>(out), n_img, n_tok,
                                        n_heads, per_block, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
static int launch(const void* qkv, void* out, int n_img, int n_tok,
                  int n_heads, float scale, cudaStream_t stream) {
  const int per_block = staged_per_block(n_img, n_tok, n_heads, HD);
  if (per_block > 0)
    return launch_staged<T, HD>(qkv, out, n_img, n_tok, n_heads, per_block,
                                scale, stream);
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
// launch (0 on success), the error of raising the kernel's shared memory,
// or cudaErrorInvalidValue for an unsupported dtype or head width.
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
