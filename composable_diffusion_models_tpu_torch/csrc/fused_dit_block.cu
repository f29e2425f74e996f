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
// the roles flip: a tile of 64 token rows (whole images) stays resident in
// shared memory for the whole block -- the residual x and the 4D-wide
// buffer that holds first qkv, then the attention output (written over q in
// place), then the GELU hidden -- and the weights stream through from L2.
// Nothing but x goes to or from device memory.
//
// The bf16 kernel (the one the serving path runs) is warp-specialised,
// 3 warpgroups a block, one block an SM:
//   * Warpgroup 0 produces. It walks the k-tiles (32 x 128) of all four
//     weight matrices in the order the consumers take them and copies each
//     into a ring of 8 stages with 16-byte cp.async, as far ahead as there
//     are free stages: across k-tiles, N chunks and GEMMs, so the next
//     GEMM's first tiles load during this one's epilogue and during
//     LayerNorm and attention. A thread leaves, behind its copies of a tile,
//     an arrival on the stage's "full" mbarrier that fires when they have
//     landed (cp.async.mbarrier.arrive.noinc); it never waits for data. The
//     copies are cp.async and not TMA tensor copies for two reasons, both
//     measured: the folded weights are new tensors at every launch, so four
//     tensor maps would be encoded on the host per launch, on a path whose
//     pace the host sets; and with TMA (one thread issuing, with and
//     without multicast to a cluster of 2 or 4 blocks) the kernel was no
//     faster, because the weight stream is not what holds it (below).
//   * Warpgroups 1 and 2 consume with wgmma.mma_async m64n128k16 (bf16 in,
//     fp32 accumulators in registers), B from the stage through a
//     shared-memory descriptor. A GEMM's 128-column output chunks are taken
//     two at a time, one by each warpgroup, whole, and the pair's k-tiles
//     alternate in the ring, so both warpgroups run at once whatever the
//     number of chunks. For the qkv and W1 GEMMs A = LN(x) sits in
//     registers: each thread normalises its own wgmma fragments straight
//     from x (64 registers at D = 256, kept across the GEMM's chunks), so
//     LN(x) needs no buffer and that room goes to the ring. For the proj
//     and W2 GEMMs A comes from the wide buffer through a descriptor. One
//     k-tile's group of wgmma stays in flight while the next is sent; a
//     stage goes back through its "empty" mbarrier once the group that read
//     it has completed. No block-wide barrier remains inside a GEMM. The
//     tile was written through the generic proxy and wgmma reads through
//     the async proxy: the consumer's fence.proxy.async after its wait on
//     "full" stands between the two.
// Registers: setmaxnreg gives the producer 40 and the consumers 232.
// Shared-memory layouts follow wgmma's canonical 128-byte-swizzled forms.
// The wide buffer (A operand, K-major) is panels of 64 rows x 64 columns,
// a row 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). A weight stage (B operand, N-major: the folded weights are
// (K, N) row-major and are read as they are, through the descriptor's
// transpose bit) is two panels of 32 k-rows x 64 columns in the same
// swizzle. Attention and the epilogues address the panels through one
// function (sw_off). The residual x is only read and written by threads and
// stays row-major, padded.
//
// What holds the bf16 kernel after this (phase clocks read inside the
// kernel at the serving shape): not the tensor cores and not L2 (a quarter
// of the blocks take the same time) but everything that is not wgmma, run by
// 8 warps an SM with nothing to hide a latency behind: the epilogues
// (bias, GELU, rounding, swizzled stores) take as long as the k-loops, and
// attention, LayerNorm and the tile's load and store another third. Every
// block still reads all 12 D^2 weights from L2 (1.57 MB x 128 blocks = 201
// MB per launch).
//
// The cluster route serves bf16 images of 65 to 256 tokens at D <= 256
// (the shapes gate's dit_p4_d256_l8: 256 tokens at D = 256), which the
// 64-row tile cannot hold. Every phase of the block but attention works on
// one token row at a time, so an image is cut into n = ceil(T / 64) blocks
// of 64 consecutive rows, launched as one thread-block cluster of n
// (cudaLaunchKernelEx, cluster dimension (n, 1, 1), grid B * n). Each block
// is the wgmma kernel above on its 64 rows (rows past T in the last block
// are zero on load and never stored), its wide buffer grown where needed
// so that four 8 KB staging panels lie past the 3D columns of qkv.
// Attention, the only step that mixes rows, runs on the tensor cores as
// the TPU kernel's does on the MXU: the two consumer warpgroups take the
// heads in turn, and per head S = Q_h K^T and O = P V_h are wgmma products
// of the block's 64 query rows against 64-key chunks of the image's K and
// V, which each warpgroup moves, chunk by chunk and one chunk ahead, from
// the cluster's blocks (16-byte loads through distributed shared memory,
// the peer's address from mapa) into its own two staging panels, since
// wgmma reads no distributed shared memory (cluster_attention). Keys past
// T are -inf before the max. Numerics: fp32 scores from the tensor cores,
// exp(s - max) / sum in fp32 (expf), probabilities rounded to bf16 before
// the value product, fp32 accumulation and one rounding; the score and
// value sums run in the tensor cores' order, the row sums over the row's
// four lanes. Two cluster barriers (barrier.cluster arrive.release /
// wait.acquire, every thread of the cluster arriving at each):
//   1. after the qkv epilogue: every block's K and V are in place;
//   2. arrived after attention, waited for before the W1 epilogue writes
//      over Q[:, 0:4D]: no peer still reads this block's K and V.
// The peers' reads are the staging loads of attention, and each is
// complete (its value stored into the reader's own panel) before the
// reader arrives at barrier 2; a block's last access to a peer comes
// before that arrival, and no block passes barrier 2, let alone exits,
// before every block has arrived, so none exits while a peer still reads
// its shared memory. The producer warpgroup arrives at both too: at
// barrier 1 when it starts (it publishes nothing), and at barrier 2 after
// waiting for barrier 1, which it does before its first W1 tile, once
// every qkv and proj tile is in the ring: the tiles it waits on a free
// stage for until then are all consumed before the consumers wait at
// barrier 2, so neither side waits for the other in a circle. What bounds
// it now (an H100 80GB HBM3 at 700 W): the waves and, within one, what
// holds the one-block route. One block an SM and 30 clusters of 4 at once,
// so the gate's 64 images of 256 tokens (256 blocks) run in 3 waves of
// ~0.18 ms: 0.545 ms against 2.21 ms for the first design's scalar walk
// and 1.93 ms for the plain version. A wave of 64 blocks takes as long as
// one of 120 (0.183 / 0.182 ms), though every block reads all 12 D^2
// weights through L2 (1.57 MB a block, 403 MB a launch at the gate's
// shape): the weight stream does not hold it, so the ring is not
// multicast to the cluster (TMA multicast would cut the L2 reads 4x).
//
// The rows route is the float32 kernel: fp32 FMAs on the CUDA cores over
// one staged weight k-tile at a time, 8 warps, a tile of 16, 32 or 64 rows
// with X, LN(x) and the wide buffer [rows][4D + 8] in shared memory. It
// holds the block to its plain version without bf16 rounding; only checks
// run it.
//
// The wide route serves bf16 streams wider than the wgmma kernel's 256
// (the frontier's dit_p14_d384_l6: 4 tokens of 384, heads of 48), whose
// 64-row tile needs 314,048 bytes at D = 384 against the 232,448 a block
// may use. A tile is 32 token rows (whole images of T <= 32): X, LN(x)
// [32][D + 8] and the wide buffer [32][4D + 8], row-major and padded, which
// leaves room for a weight ring up to D = 576. The tile belongs to one
// thread-block cluster of n = 1 to 4 blocks (n divides the heads; the
// wrapper picks it by a wave model, ops/kernels.py block_split), and block
// r of it computes the r-th n-th of every GEMM's output columns, so it
// reads an n-th of every weight (the scalar kernel this replaced ran 32
// blocks at the frontier's batch of 256, each reading all 3.54 MB of
// weights one synchronous k-tile at a time, with fp32 FMAs).
//   * qkv: block r computes the q, k and v columns of its H / n heads
//     (segments of D / n columns at 0, D and 2D, stored past the D columns
//     of o in the wide buffer) and runs their attention locally
//     (attend_query: T <= 32 keys need no tensor cores), writing o over
//     columns r D / n ..;
//   * it stores its o columns into every peer's wide buffer through
//     distributed shared memory (the peer's address from mapa); a cluster
//     barrier; proj computes D / n columns of x += proj(o) + b with K = D,
//     which go to every peer's X the same way; a barrier; each block takes
//     LayerNorm of whole rows from its full copy of X;
//   * W1 computes 4D / n hidden columns (GELU), sent to every peer's wide
//     buffer; a barrier; W2 computes the block's D / n output columns with
//     K = 4D, added to X and written straight to device memory.
// Four cluster barriers (barrier.cluster arrive.release / wait.acquire,
// every thread of the cluster): 0 is arrived at on entry and waited for
// before the first store into a peer (every block has started), 1-3 follow
// the exchanges. A block writes into a peer only columns the peer neither
// reads nor writes until the barrier after it, and no remote access
// follows barrier 3, so a block may exit whenever it is done.
// Warp specialised, 3 warpgroups: the last produces, the first two consume.
// The weights stream by TMA (one 2-D tensor map a weight, encoded on the
// host at every launch) in boxes of 32 columns x 64 k-rows (4 KB, 64-byte
// swizzled, so that the frontier's 96-column head segments need no
// padding) into a ring of 3 stages of 24 KB (2 of 4 KB at D = 576): a tile
// is up to 192 columns x 64 k-rows of one GEMM (more rows for a narrower
// chunk), a full and an empty mbarrier a stage. One warp of the producer
// issues a tile's boxes as soon as its stage is free, across chunks and
// GEMMs, so the next GEMM's first tiles land during this one's epilogue,
// attention and the exchanges. The consumers run the GEMMs on the tensor
// cores as mma.sync m16n8k16 (bf16 in, fp32 accumulators): warp w holds
// m16 tile w % 2 of every fourth n8 tile of a chunk (the same count for
// every warp), A from the padded row-major tiles by ldmatrix, B from the
// stage by ldmatrix.trans (32 k-rows, two k16 steps, an instruction; the
// next 32 k-rows' fragments asked for before these products); the padding
// and the swizzle make every ldmatrix conflict-free. Measured on the way
// (an H100 80GB HBM3 at 700 W): 16-byte cp.async copies, issued by the
// consumers, stalled them (the copies an SM may have in flight were the
// limit, and the compute waited behind each issue); 1-D bulk copies of the
// row pieces were slower still; boxes of 2 KB streamed slower than 4 KB
// ones. With the stream behind a producer, what bounds the route is
// the ldmatrix traffic of the products (each B fragment read by two warps,
// each A fragment by four); wgmma (M = 64, half of it padding, A from
// registers, B read in place from the stage as an MN-major 64-byte-swizzled
// operand) was right but no faster, its epilogues on half the warps.
// Rounding sites: those of the wgmma kernel (LayerNorm with fp32 statistics,
// attention and the epilogues as there); only the order of the fp32 sums
// inside a GEMM and a LayerNorm differs.
// Head widths 16, 32, 48 and 64 on every route (attend_query loads a head
// as whole 16-byte vectors: 48 is 6 of bf16, 12 of float32).
//
// Numerics follow the Pallas kernel: LayerNorm with fp32 stats (clamped
// one-pass variance, eps 1e-6, no affine) rounded to the stream type; each
// GEMM accumulates in fp32, adds its bias in fp32 and rounds once; GELU
// (tanh form) of the rounded value, rounded again; residual adds of two
// stream-type values, rounded once. The two types evaluate the GELU
// differently between those two roundings. float32: x * 0.5 (1 + tanhf(u)),
// u = sqrt(2 / pi) (x + 0.044715 x^3), as the plain version does. bfloat16:
// the same function as x / (1 + exp(-2u)) with __expf and __fdividef
// (ex2.approx, rcp.approx: ~2 float32 ulps, 2^-15 of a bf16 ulp, before
// the rounding to bf16). It saturates as the tanh form does: for x > ~10
// exp(-2u) is 0 and the result is x; for x < ~-10 the divisor passes 2^126,
// where __fdividef returns 0 and the tanh form x * 0.5 (1 - 1) does too.
#include "attention.cuh"
#include "hopper.cuh"

namespace cdm {

constexpr int NTHREADS = 256;  // the rows and wide routes: 8 warps
constexpr int KT = 32;         // weight rows per staged k-tile
constexpr int NC = 128;        // output columns per GEMM chunk
constexpr int PAD = 8;         // row padding (elements): conflict-free rows

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// tanh-GELU for a bf16 result. 0.5 (1 + tanh(u)) is sigmoid(2u), so
// gelu(x) = x / (1 + exp(-2u)): one ex2.approx and one rcp.approx (~2
// float32 ulps, 2^-15 of a bf16 ulp, gone in the rounding that follows)
// where tanhf costs ~5x the instructions of the whole epilogue.
__device__ __forceinline__ float gelu_tanh16(float x) {
  const float k2 = 2.0f * 0.7978845608028654f;  // 2 sqrt(2 / pi)
  return __fdividef(x, 1.0f + __expf(-k2 * (x + 0.044715f * (x * x * x))));
}

// ============================================== the rows route (float32)

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
    x[r * ld + c] = from_f<T>(to_f(x[r * ld + c]) +
                              round_to<T>(v + to_f(bias[c])));
  }
};

// out = A @ W through the epilogue, for the tile's MT rows, fp32 FMAs. A:
// shared [MT][lda]; W: global [K][N] row-major, K a multiple of KT, N of 8.
// Ends with a barrier, so the next phase sees every result.
template <int MT, typename T, class Epi>
__device__ void tile_gemm(const T* A, int lda, const T* W, int K, int N,
                          T* Ws, const Epi& epi) {
  constexpr int RM = MT / 8;  // rows per warp; each lane owns 4 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      __syncthreads();  // every warp is done with the previous k-tile
      stage_w(W, N, k0, n0, Ws);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float4 b =
            *reinterpret_cast<const float4*>(Ws + kk * (NC + PAD) + lane * 4);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = to_f(A[(warp * RM + r) * lda + k0 + kk]);
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

// Mean and 1 / sqrt(var + 1e-6) of one row of d elements, by one warp:
// fp32 stats, clamped one-pass variance.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int d, int lane,
                                          float& mu, float& inv) {
  constexpr int VEC = 16 / sizeof(T);
  float s = 0.f, ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float v[VEC];
    load_f<T, VEC>(row + c, v);
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
  mu = s / d;
  inv = 1.f / sqrtf(fmaxf(0.f, ss / d - mu * mu) + 1e-6f);
}

// Y[r] = T(LN(X[r])) for the tile's MT rows, no affine. One warp per row.
template <int MT, typename T>
__device__ void layer_norm(const T* X, int ldx, T* Y, int ldy, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < MT; r += NTHREADS / 32) {
    float mu, inv;
    row_stats(X + r * ldx, d, lane, mu, inv);
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

// Shared memory of one rows-route block, in bytes: X and A [MT][D + PAD],
// the wide buffer [MT][4D + PAD], the weight k-tile [KT][NC + PAD], all of
// the stream type.
__host__ __device__ constexpr size_t smem_bytes_rows(int mt, int d,
                                                     int elem) {
  return (size_t)elem * ((size_t)mt * (d + PAD) * 2 +
                         (size_t)mt * (4 * d + PAD) + (size_t)KT * (NC + PAD));
}

template <typename T, int MT, int HD>
__global__ void __launch_bounds__(NTHREADS)
fused_dit_block_rows_kernel(const T* tok, const T* wqkv, const T* bqkv,
                            const T* wpr, const T* bpr, const T* w1,
                            const T* b1, const T* w2, const T* b2, T* out,
                            int n_img, int n_tok, int d, int imgs_per_tile,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);
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
  layer_norm<MT>(X, ldx, A, ldx, d);
  tile_gemm<MT>(A, ldx, wqkv, d, 3 * d, Ws, EpiStore<T>{Q, ldq, bqkv});
  for (int p = threadIdx.x; p < imgs * n_heads * n_tok; p += NTHREADS) {
    const int im = p / (n_heads * n_tok), rem = p % (n_heads * n_tok);
    const RowMajor<T> img{Q + im * n_tok * ldq, ldq};
    attend_query<T, HD>(img, img, rem % n_tok, rem / n_tok, n_tok, d, scale);
  }
  __syncthreads();
  tile_gemm<MT>(Q, ldq, wpr, d, d, Ws, EpiResidual<T>{X, ldx, bpr});

  // MLP half: GELU hidden into Q[:, 0:4D]
  layer_norm<MT>(X, ldx, A, ldx, d);
  tile_gemm<MT>(A, ldx, w1, d, 4 * d, Ws, EpiGelu<T>{Q, ldq, b1});
  tile_gemm<MT>(Q, ldq, w2, 4 * d, d, Ws, EpiResidual<T>{X, ldx, b2});

  for (int v = threadIdx.x; v < rows * vpr; v += NTHREADS) {
    const int r = v / vpr, c = (v % vpr) * VEC;
    *reinterpret_cast<uint4*>(out + g0 + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(X + r * ldx + c);
  }
}

// ==================================================== bfloat16 kernel
constexpr int MT16 = 64;          // token rows per block: wgmma's M
constexpr int WG = 128;           // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;
constexpr int THREADS16 = 3 * WG;
constexpr int STAGES = 8;         // weight stages in the ring
constexpr int MAX_D = 256;        // widest stream the 64-row tile fits
constexpr int A_REGS = MAX_D / 16 * 4;  // LN(x) as wgmma A fragments
constexpr int PANEL_BYTES = MT16 * 128;         // 64 rows x 64 bf16
constexpr int HALF_BYTES = KT * 128;            // 32 k-rows x 64 bf16
constexpr int STAGE_BYTES = 2 * HALF_BYTES;     // one half per consumer

// Byte offset of element (r, c) in a buffer of 128-byte-swizzled panels of
// 64 columns: the layout wgmma reads (see the header).
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return (uint32_t)((c >> 6) * PANEL_BYTES + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// Rows row0 .. of a swizzled buffer as a tile for attention.cuh
struct SwTile {
  unsigned char* base;
  int row0;
  __device__ __forceinline__ bf16* at(int r, int c) const {
    return reinterpret_cast<bf16*>(base + sw_off(row0 + r, c));
  }
};

// Barrier over the 256 consumer threads only (the producer runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// ------------------------------------------------- thread-block clusters
constexpr int MAX_CLUSTER = 4;  // blocks of one image: T <= 4 x 64

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster arrives (this thread's earlier writes are
// released to the cluster) / waits until all have arrived (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The generic address of p (in this block's shared memory) in the shared
// memory of the cluster's block `rank`
__device__ __forceinline__ void* cluster_map(void* p, int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<void*>(out);
}

// The ring: stage s is STAGE_BYTES at stage0 + s * STAGE_BYTES. Producer
// and consumers count the same tiles t = 0, 1, ...; tile t lives in stage
// t % STAGES in round t / STAGES. empty[s] completes a phase each time the
// stage is handed back, whoever held it. A stage has one "full" mbarrier
// per consumer warpgroup, full[w][s], which completes a phase for each tile
// of w's that lands there: a warpgroup only ever waits for the next phase of
// its own barrier, so it cannot mistake an older phase for the one it wants,
// however far the other warpgroup has run ahead in the ring.
struct Ring {
  uint32_t stage0, full0, empty0;
  __device__ __forceinline__ uint32_t stage(int s) const {
    return stage0 + s * STAGE_BYTES;
  }
  __device__ __forceinline__ uint32_t full(int w, int s) const {
    return full0 + 8 * (w * STAGES + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return empty0 + 8 * s;
  }
};

struct Weight {
  const bf16* w;
  int k, n;
};

// The producer's walk over the k-tiles of the four GEMMs, in the consumers'
// order: a GEMM's chunks two at a time, the pair's k-tiles in turn (see
// gemm_wgmma).
struct TileWalk {
  int g, pair0, k0, w;
  __device__ void next(const Weight (&gemms)[4]) {
    const int K = gemms[g].k, N = gemms[g].n;
    if (w == 0 && pair0 + NC < N) { w = 1; return; }
    w = 0;
    if ((k0 += KT) < K) return;
    k0 = 0;
    if ((pair0 += 2 * NC) < N) return;
    pair0 = 0;
    ++g;
  }
};

// k-tiles of GEMM g in the ring
__device__ __forceinline__ int gemm_tiles(const Weight& g) {
  return g.k / KT * ((g.n + NC - 1) / NC);
}

// Warpgroup 0: copies every k-tile into the ring, as far ahead as there are
// free stages. Each thread copies its 4 vectors of a tile with cp.async and
// leaves an arrival on the tile's "full" barrier that fires when those
// copies have landed (cp.async.mbarrier.arrive.noinc): the thread itself
// never waits for data, only for a free stage. In a cluster it also
// arrives at the cluster's two barriers (see the header).
__device__ void produce_weights(const Weight (&gemms)[4], const Ring& ring,
                                bool cluster) {
  const int p = threadIdx.x;  // 0 .. WG - 1
  int total = 0;
  for (int g = 0; g < 4; ++g) total += gemm_tiles(gemms[g]);
  const int first_w1 = gemm_tiles(gemms[0]) + gemm_tiles(gemms[1]);
  if (cluster) cluster_arrive();  // barrier 1
  TileWalk at{0, 0, 0, 0};
  for (int t = 0; t < total; ++t) {
    if (cluster && t == first_w1) {
      cluster_wait();    // barrier 1
      cluster_arrive();  // barrier 2
    }
    const int s = t % STAGES;
    // the consumer has released what this stage held a round ago
    mbar_wait(ring.empty(s), ((t / STAGES) & 1) ^ 1);
    const bf16* W = gemms[at.g].w;
    const int N = gemms[at.g].n, n0 = at.pair0 + at.w * NC;
#pragma unroll
    for (int i = 0; i < KT * (NC / 8) / WG; ++i) {
      const int idx = p + WG * i;
      const int kr = idx / (NC / 8), cn = idx % (NC / 8);
      const int col = n0 + cn * 8;
      const bool in = col < N;  // columns past N are zero
      cp_async16(ring.stage(s) + (cn >> 3) * HALF_BYTES + kr * 128 +
                     (((cn & 7) ^ (kr & 7)) << 4),
                 W + (size_t)(at.k0 + kr) * N + (in ? col : 0), in ? 16 : 0);
    }
    // one arrival on the tile's "full" barrier when this thread's copies
    // of it have landed
    cp_async_arrive_noinc(ring.full(at.w, s));
    at.next(gemms);
  }
  cp_async_wait<0>();
  if (cluster) cluster_wait();  // barrier 2
}

// Epilogues of the bf16 GEMMs, on a pair of neighbouring columns c, c + 1
// (c even) of row r; v0, v1 are the fp32 sums with the bias added.
struct EpiStore16 {  // Q = bf16(acc + bias)
  unsigned char* q;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(q + sw_off(r, c)) =
        __floats2bfloat162_rn(v0, v1);
  }
};

struct EpiGelu16 {  // Q = bf16(gelu(bf16(acc + bias)))
  unsigned char* q;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(q + sw_off(r, c)) =
        __floats2bfloat162_rn(gelu_tanh16(round_to<bf16>(v0)),
                              gelu_tanh16(round_to<bf16>(v1)));
  }
};

struct EpiResidual16 {  // x = bf16(x + bf16(acc + bias))
  bf16* x; int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(x + r * ld + c);
    const float2 old = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(old.x + round_to<bf16>(v0),
                               old.y + round_to<bf16>(v1));
  }
};

// Where a consumer thread stands: its warpgroup (0 or 1), its warp there
// and its lane. The first two come through a shuffle so that the compiler
// sees them as uniform over the warp: wgmma must not sit behind a branch it
// takes for divergent.
struct Consumer {
  int wg, warp, lane;
  __device__ Consumer() {
    const int ctid = threadIdx.x - WG;
    wg = __shfl_sync(0xffffffffu, ctid / WG, 0);
    warp = __shfl_sync(0xffffffffu, (ctid / 32) % 4, 0);
    lane = ctid % 32;
  }
};

// The consumers' place in the stream of work: t counts the ring's tiles
// across all four GEMMs. A GEMM's 128-column output chunks are taken two at a
// time, the first by warpgroup 0 and the second by warpgroup 1, and the
// pair's k-tiles alternate in the ring, so that both warpgroups run at once
// whatever the number of chunks (the W2 and proj GEMMs have two); each
// counts the other's tiles without touching them.
struct Progress {
  int t;
  uint32_t seen;  // bit s: parity of this warpgroup's next phase of full[s]
};

// One k-tile (32 deep) of a 64 x 128 product: two wgmma. RS: A from the
// fragments of columns kt * 32 .., else from the swizzled panels at a_base.
template <bool RS>
__device__ __forceinline__ void mma_tile(float (&acc)[64],
                                         const uint32_t (&afrag)[A_REGS],
                                         uint32_t a_base, int kt,
                                         uint32_t stage) {
#pragma unroll
  for (int j = 0; j < KT / 16; ++j) {
    const uint64_t db = sw128_desc(stage + j * 16 * 128, HALF_BYTES);
    if constexpr (RS) {
      const int kk = kt * (KT / 16) + j;
      Wgmma<128>::rs<1>(acc, afrag[4 * kk], afrag[4 * kk + 1],
                        afrag[4 * kk + 2], afrag[4 * kk + 3], db, 1);
    } else {
      const int k = kt * KT + 16 * j;
      Wgmma<128>::ss<0, 1>(
          acc,
          sw128_desc(a_base + (k >> 6) * PANEL_BYTES + (k & 63) * 2, 16), db,
          1);
    }
  }
}

// Warpgroups 1 and 2: out = A @ W through the epilogue for the tile's 64
// rows. A: K columns, either this thread's register fragments (RS; K at
// most MAX_D) or swizzled panels at shared address a_base. A warpgroup
// computes its chunk of every pair, whole (64 x 128, one wgmma wide), and
// steps over the other's tiles. bias: the N column biases. The caller fences
// and synchronises the consumers afterwards.
template <bool RS, class Epi>
__device__ void gemm_wgmma(const Consumer& me,
                           const uint32_t (&afrag)[A_REGS], uint32_t a_base,
                           int K, int N, const bf16* __restrict__ bias,
                           const Ring& ring, Progress& at, const Epi& epi) {
  for (int pair0 = 0; pair0 < N; pair0 += 2 * NC) {
    // the pair's chunks (one, at the ragged end) share the ring tile by tile
    const int in_pair = pair0 + NC < N ? 2 : 1;
    const int first = at.t + me.wg;  // this warpgroup's first tile
    at.t += K / KT * in_pair;
    if (me.wg >= in_pair) continue;
    const int n0 = pair0 + me.wg * NC;
    // This thread's 16 column pairs of the chunk's bias, asked for before
    // the k-loop: behind the epilogue's stores the compiler would order
    // each load after the store before it, one L2 round trip a pair.
    const int c0 = n0 + (me.lane % 4) * 2;
    uint32_t bias_raw[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bias_raw[j] = c0 + 8 * j < N ? __ldg(reinterpret_cast<const uint32_t*>(
                                         bias + c0 + 8 * j))
                                   : 0u;
    // Columns past N are zeros in the stage: no branch stands around a
    // wgmma.
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int pending = -1;  // stage whose wgmma group is still in flight
    // the k-tile of index kt; with RS the loop is unrolled so that the
    // fragments are indexed by constants
    auto k_tile = [&](int kt) {
      const int s = (first + kt * in_pair) % STAGES;
      mbar_wait(ring.full(me.wg, s), (at.seen >> s) & 1);
      at.seen ^= 1u << s;
      // the tile was written by cp.async (generic proxy) and is read by
      // wgmma (async proxy): the proxy fence stands between the two, on
      // this side of the barrier that ordered them
      fence_proxy_async();
      wgmma_fence();
      mma_tile<RS>(acc, afrag, a_base, kt, ring.stage(s));
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's group has completed
      if (pending >= 0 && me.lane == 0) mbar_arrive(ring.empty(pending));
      pending = s;
    };
    if constexpr (RS) {
#pragma unroll
      for (int kt = 0; kt < MAX_D / KT; ++kt)
        if (kt * KT < K) k_tile(kt);
    } else {
      for (int kt = 0; kt * KT < K; ++kt) k_tile(kt);
    }
    wgmma_wait<0>();
    if (me.lane == 0) mbar_arrive(ring.empty(pending));
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    const int r = me.warp * 16 + me.lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
      if (c < N) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bias_raw[j]));
        epi(r, c, acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        epi(r + 8, c, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
      }
    }
  }
}

// Barrier over the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
}

// One head's K or V over the 64 rows of one block of the cluster, as a
// consumer warpgroup moves it into its own shared memory: loaded from the
// block's swizzled wide buffer (16-byte loads through distributed shared
// memory), stored as 64 key rows of 128 bytes, 128-byte swizzled, the
// head's HD columns first. Those bytes are both the K-major B of
// S = Q K^T and the MN-major B of P V (see hopper.cuh).
template <int HD>
struct HeadChunk {
  static constexpr int VPR = HD / 8;           // 16-byte vectors a key row
  static constexpr int PER = MT16 * VPR / WG;  // vectors a thread moves
  static_assert(MT16 * VPR % WG == 0, "a chunk is whole vectors a thread");
  uint4 v[PER];
  // columns col0 .. col0 + HD - 1 of the rows of cluster block `rank`
  __device__ __forceinline__ void load(unsigned char* q, int rank, int col0,
                                       int t) {
    const unsigned char* src =
        static_cast<const unsigned char*>(cluster_map(q, rank));
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = t + WG * i, r = idx / VPR, e = idx % VPR;
      v[i] = *reinterpret_cast<const uint4*>(src + sw_off(r, col0 + 8 * e));
    }
  }
  __device__ __forceinline__ void store(unsigned char* buf, int t) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = t + WG * i, r = idx / VPR, e = idx % VPR;
      *reinterpret_cast<uint4*>(buf + sw128_chunk(r, e)) = v[i];
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The cluster route's attention, by one consumer warpgroup: heads wg,
// wg + 2, ... for the block's 64 query rows over the image's n_tok keys,
// which n_cta blocks of 64 rows hold. A head walks 4 n_cta chunks of 64
// keys, each moved into one of the warpgroup's two staging panels at
// `stage` while the tensor cores work on the chunk in the other: K of
// blocks 0 .. n_cta - 1 twice, then K and V of each block in turn. Per K
// chunk, S = Q_h K^T by m64n64k16 wgmma (Q_h read in place from the wide
// buffer, K-major), fp32 accumulators, times the scale, keys past n_tok
// -inf. The first pass takes the rows' max, the second their sum of
// exp(s - max), the third p = bf16(exp(s - max) / sum) as the A fragments
// of O += P V_h (m64n64k16 wgmma, P from registers, V MN-major; at heads
// narrower than 64 the columns past HD are computed and dropped), and O
// is rounded once to bf16 over Q_h. Recomputing S (the same products on
// the same operands, so the same values) keeps one chunk of scores in
// registers rather than the whole row of up to 256. A row's max and sum
// meet over the four lanes that hold it. Every block's K and V are in
// place (cluster barrier 1) when this starts.
template <int HD>
__device__ void cluster_attention(const Consumer& me, unsigned char* Q,
                                  unsigned char* stage, int n_cta, int n_tok,
                                  int d, float scale) {
  const int n_heads = d / HD;
  if (me.wg >= n_heads) return;
  const int t = (threadIdx.x - WG) % WG;
  const int walk = 4 * n_cta;  // chunks of one head
  const uint32_t q_addr = smem_u32(Q), st_addr = smem_u32(stage);
  HeadChunk<HD> next;
  // chunk i of head h's walk into panel p
  const auto fetch = [&](int h, int i, int p) {
    const bool v = i >= 2 * n_cta && ((i - 2 * n_cta) & 1);
    const int c = i < 2 * n_cta ? i % n_cta : (i - 2 * n_cta) >> 1;
    next.load(Q, c, (v ? 2 : 1) * d + h * HD, t);
    next.store(stage + p * PANEL_BYTES, t);
    fence_proxy_async();  // written by threads, read by wgmma
  };
  fetch(me.wg, 0, 0);
  warpgroup_sync(me.wg);
  int item = 0;  // chunks walked; chunk `item` sits in panel item % 2
  const int r = me.warp * 16 + me.lane / 4;  // rows r and r + 8
  for (int h = me.wg; h < n_heads; h += 2) {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float oacc[32];
    uint32_t pf[4][4];  // P of the chunk; k16 step kk: blocks 2 kk, 2 kk + 1
    for (int i = 0; i < walk; ++i, ++item) {
      const int pass = i < n_cta ? 0 : i < 2 * n_cta ? 1 : 2;
      const bool pv = pass == 2 && ((i - 2 * n_cta) & 1);
      const int c = pass < 2 ? i % n_cta : (i - 2 * n_cta) >> 1;
      const uint32_t buf = st_addr + (item & 1) * PANEL_BYTES;
      float sc[32];
      wgmma_fence();
      if (pv) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64>::rs<1>(oacc, pf[kk][0], pf[kk][1], pf[kk][2], pf[kk][3],
                           sw128_desc(buf + kk * 16 * 128, PANEL_BYTES), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int col = h * HD + 16 * kk;
          Wgmma<64>::ss<0, 0>(
              sc,
              sw128_desc(q_addr + (col >> 6) * PANEL_BYTES + (col & 63) * 2,
                         16),
              sw128_desc(buf + kk * 32, 16), kk > 0);
        }
      }
      wgmma_commit();
      // the next chunk of the walk, or the first of this warpgroup's next
      // head, into the other panel while the product runs
      if (i + 1 < walk) fetch(h, i + 1, (item + 1) & 1);
      else if (h + 2 < n_heads) fetch(h + 2, 0, (item + 1) & 1);
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        asm volatile("" : "+f"(oacc[k])::"memory");
        asm volatile("" : "+f"(sc[k])::"memory");
      }
      warpgroup_sync(me.wg);
      if (pv) continue;
      // registers 4 j + e: row r, key 64 c + 8 j + 2 (lane % 4) + e; 4 j +
      // 2 + e: row r + 8, the same key
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = MT16 * c + 8 * j + 2 * (me.lane % 4) + e < n_tok;
          const float s0 = in ? sc[4 * j + e] * scale : -INFINITY;
          const float s1 = in ? sc[4 * j + 2 + e] * scale : -INFINITY;
          if (pass == 0) {
            m0 = fmaxf(m0, s0);
            m1 = fmaxf(m1, s1);
          } else if (pass == 1) {
            l0 += expf(s0 - m0);
            l1 += expf(s1 - m1);
          } else {
            sc[4 * j + e] = expf(s0 - m0) / l0;
            sc[4 * j + 2 + e] = expf(s1 - m1) / l1;
          }
        }
      }
      if (pass == 2) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* s = &sc[8 * kk];
          pf[kk][0] = pack_bf16(s[0], s[1]);
          pf[kk][1] = pack_bf16(s[2], s[3]);
          pf[kk][2] = pack_bf16(s[4], s[5]);
          pf[kk][3] = pack_bf16(s[6], s[7]);
        }
      } else if (i == n_cta - 1) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
      } else if (i == 2 * n_cta - 1) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, o);
          l1 += __shfl_xor_sync(0xffffffffu, l1, o);
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) oacc[k] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = h * HD + 8 * j + 2 * (me.lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(Q + sw_off(r, col)) =
          __floats2bfloat162_rn(oacc[4 * j], oacc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(Q + sw_off(r + 8, col)) =
          __floats2bfloat162_rn(oacc[4 * j + 2], oacc[4 * j + 3]);
    }
  }
}

// afrag = bf16(LN(X)) for the 64 rows as this thread's wgmma A fragments,
// k-step kk in afrag[4 kk .. 4 kk + 3]. The rows' statistics go through
// stats[0..63] (mean) and stats[64..127] (1 / sqrt(var + eps)), four
// consumer threads per row. X is complete when this is called; the GEMM
// that follows does not write it.
template <bool CLUSTER>
__device__ void layer_norm16(const Consumer& me, const bf16* X, int ldx,
                             int d, float* stats,
                             uint32_t (&afrag)[A_REGS]) {
  {
    const int ctid = threadIdx.x - WG;
    const int r = ctid / 4, q = ctid % 4;  // row, and its quarter of 16-byte
    float s = 0.f, ss = 0.f;               // vectors q, q + 4, ...
    for (int c = q * 8; c < d; c += 32) {
      float v[8];
      load_f<bf16, 8>(X + r * ldx + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
#pragma unroll
    for (int o = 2; o > 0; o /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (q == 0) {
      const float mu = s / d;
      stats[r] = mu;
      stats[MT16 + r] = 1.f / sqrtf(fmaxf(0.f, ss / d - mu * mu) + 1e-6f);
    }
  }
  consumer_sync();
  const int r0 = me.warp * 16 + me.lane / 4, r1 = r0 + 8;
  const float mu0 = stats[r0], inv0 = stats[MT16 + r0];
  const float mu1 = stats[r1], inv1 = stats[MT16 + r1];
  const auto norm2 = [](const bf16* p, float mu, float inv) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    const __nv_bfloat162 y =
        __floats2bfloat162_rn((v.x - mu) * inv, (v.y - mu) * inv);
    return *reinterpret_cast<const uint32_t*>(&y);
  };
  // on the cluster route every fragment is written, zeros past D, so that
  // none lives on from one GEMM's LN(x) to the next: the cluster's
  // attention has the registers between
#pragma unroll
  for (int kk = 0; kk < MAX_D / 16; ++kk) {
    if (kk * 16 < d) {
      const int c = kk * 16 + (me.lane % 4) * 2;
      afrag[4 * kk + 0] = norm2(X + r0 * ldx + c, mu0, inv0);
      afrag[4 * kk + 1] = norm2(X + r1 * ldx + c, mu1, inv1);
      afrag[4 * kk + 2] = norm2(X + r0 * ldx + c + 8, mu0, inv0);
      afrag[4 * kk + 3] = norm2(X + r1 * ldx + c + 8, mu1, inv1);
    } else if (CLUSTER) {
#pragma unroll
      for (int k = 0; k < 4; ++k) afrag[4 * kk + k] = 0u;
    }
  }
}

__host__ __device__ constexpr int panels(int cols) { return (cols + 63) / 64; }

// Panels of the wide buffer: 4D columns; on the cluster route at least
// the 3D columns of qkv and, beyond them, the attention's staging panels
// (two for each consumer warpgroup), which are free until the W1 epilogue
__host__ __device__ constexpr int wide_panels(int d, bool cluster) {
  return cluster && panels(3 * d) + 4 > panels(4 * d) ? panels(3 * d) + 4
                                                      : panels(4 * d);
}

// Shared memory of one bf16 block, in bytes: up to 1024 to align the
// panels, the wide buffer as panels, the ring, X [64][D + PAD], the rows'
// LayerNorm statistics, 3 * STAGES mbarriers.
__host__ __device__ constexpr size_t smem_bytes_bf16(int d, bool cluster) {
  return 1024 + (size_t)wide_panels(d, cluster) * PANEL_BYTES +
         (size_t)STAGES * STAGE_BYTES + (size_t)MT16 * (d + PAD) * 2 +
         2 * MT16 * sizeof(float) + 3 * STAGES * 8;
}
static_assert(smem_bytes_bf16(MAX_D, true) <= 232448,
              "a block's shared memory");
static_assert(smem_bytes_bf16(MAX_D - KT, true) <= 232448,
              "a block's shared memory");

// tile: the images a block holds (whole images of n_tok <= 64 rows), or,
// launched as clusters (CLUSTER) for images of n_tok > 64, the blocks of
// one image (the cluster's size). The two routes are two instantiations:
// compiled into one kernel, the cluster's attention took registers from
// the one-block route's code, which then ran 4% slower at the serving
// shape on an H100.
template <int HD, bool CLUSTER>
__global__ void __launch_bounds__(THREADS16, 1)
fused_dit_block_bf16_kernel(const bf16* tok, const bf16* wqkv,
                            const bf16* bqkv, const bf16* wpr,
                            const bf16* bpr, const bf16* w1, const bf16* b1,
                            const bf16* w2, const bf16* b2, bf16* out,
                            int n_img, int n_tok, int d, int tile,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: panels start on 1024 bytes
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr bool cluster = CLUSTER;
  unsigned char* Q = base;
  unsigned char* Ws = Q + wide_panels(d, cluster) * PANEL_BYTES;
  const int ldx = d + PAD;
  bf16* X = reinterpret_cast<bf16*>(Ws + STAGES * STAGE_BYTES);
  float* stats = reinterpret_cast<float*>(X + MT16 * ldx);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 2 * MT16);
  const Ring ring{smem_u32(Ws), smem_u32(bars), smem_u32(bars + 2 * STAGES)};

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(0, s), WG);  // every producer thread
      mbar_init(ring.full(1, s), WG);
      mbar_init(ring.empty(s), 4);     // lane 0 of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer needs few registers; the consumers hold the accumulators
  // and LN(x): 128 x 40 + 256 x 232 of the SM's 65536
  if (threadIdx.x < WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const Weight gemms[4] = {
        {wqkv, d, 3 * d}, {wpr, d, d}, {w1, d, 4 * d}, {w2, 4 * d, d}};
    produce_weights(gemms, ring, cluster);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ctid = threadIdx.x - WG;
  const Consumer me;
  const int n_heads = d / HD;
  // this block's rows of the stream: whole images, or the cluster rank's
  // 64 rows of one image
  int imgs = 1, row0 = 0, rows;
  size_t g0;
  if (cluster) {
    row0 = cluster_rank() * MT16;
    rows = min(MT16, n_tok - row0);
    g0 = ((size_t)(blockIdx.x / tile) * n_tok + row0) * d;
  } else {
    const int img0 = blockIdx.x * tile;
    imgs = min(tile, n_img - img0);
    rows = imgs * n_tok;
    g0 = (size_t)img0 * n_tok * d;
  }
  const int vpr = d / 8;
  const uint32_t q_addr = smem_u32(Q);
  uint32_t afrag[A_REGS];  // LN(x), the A operand of the qkv and W1 GEMMs
  Progress at{0, 0};
  // residual tile in; rows past the tile's images are zero
  for (int v = ctid; v < MT16 * vpr; v += CONSUMERS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(tok + g0 + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(X + r * ldx + c) = val;
  }
  consumer_sync();

  // attention half: qkv into Q[:, 0:3D], attention output over Q[:, 0:D]
  layer_norm16<CLUSTER>(me, X, ldx, d, stats, afrag);
  gemm_wgmma<true>(me, afrag, 0, d, 3 * d, bqkv, ring, at, EpiStore16{Q});
  if (cluster) {
    fence_proxy_async();  // Q is read by wgmma below
    cluster_arrive();  // barrier 1: every block's K and V are in place
    cluster_wait();
    cluster_attention<HD>(
        me, Q, Q + (panels(3 * d) + 2 * me.wg) * PANEL_BYTES, tile, n_tok, d,
        scale);
  } else {
    consumer_sync();
    for (int p = ctid; p < imgs * n_heads * n_tok; p += CONSUMERS) {
      const int im = p / (n_heads * n_tok), rem = p % (n_heads * n_tok);
      const SwTile img{Q, im * n_tok};
      attend_query<bf16, HD>(img, img, rem % n_tok, rem / n_tok, n_tok, d,
                             scale);
    }
  }
  fence_proxy_async();
  if (cluster) cluster_arrive();  // barrier 2: done with the peers
  consumer_sync();
  gemm_wgmma<false>(me, afrag, q_addr, d, d, bpr, ring, at,
                    EpiResidual16{X, ldx});
  consumer_sync();

  // MLP half: GELU hidden into Q[:, 0:4D]
  layer_norm16<CLUSTER>(me, X, ldx, d, stats, afrag);
  if (cluster) cluster_wait();  // barrier 2: no peer reads K, V
  gemm_wgmma<true>(me, afrag, 0, d, 4 * d, b1, ring, at, EpiGelu16{Q});
  fence_proxy_async();
  consumer_sync();
  gemm_wgmma<false>(me, afrag, q_addr, 4 * d, d, b2, ring, at,
                    EpiResidual16{X, ldx});
  consumer_sync();

  for (int v = ctid; v < rows * vpr; v += CONSUMERS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(out + g0 + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(X + r * ldx + c);
  }
}

// ================================================ the wide route (bf16)
constexpr int MTW = 32;          // token rows of a wide-route tile
constexpr int NCH_MAX = 384;     // widest N chunk of a wide-route GEMM
constexpr int NT_MAX = NCH_MAX / 2 / 32;  // n8 tiles a consumer warp holds
constexpr int THREADS_W = NTHREADS + WG;  // 2 consumer warpgroups, 1 producer
constexpr int BOXC = 32;         // a weight box: 32 columns (64 bytes) ..
constexpr int BOXR = 64;         // .. x 64 k-rows
constexpr int BOX_BYTES = BOXC * BOXR * 2;
constexpr size_t SMEM_LIMIT = 232448;     // bytes a block may use

// Shared memory of a wide-route tile, in bytes: X and LN(x) [32][D + PAD],
// the wide buffer [32][4D + PAD], the ring's (up to) 2 x 4 mbarriers and
// up to 1024 to align the ring
__host__ __device__ constexpr size_t smem_bytes_wide_tile(int d) {
  return 2 * ((size_t)2 * MTW * (d + PAD) + (size_t)MTW * (4 * d + PAD)) +
         8 * 8 + 1024;
}

// One stage of the weight ring: 32 k-rows of nch columns, as a tile of 64
// k-rows of a chunk of nch / 2 columns (or more rows of a narrower chunk)
__host__ __device__ constexpr size_t wide_stage_bytes(int nch) {
  return 2 * (size_t)KT * nch;
}

// The ring beside the tile: the widest N chunk (a multiple of 64 up to 384)
// whose three stages fit, else two stages of 64 columns (D = 576); {0, 0}
// where nothing fits
struct WideRing {
  int nch, stages;
};
__host__ __device__ constexpr WideRing wide_ring(int d) {
  for (int nch = NCH_MAX; nch >= 64; nch -= 64)
    if (smem_bytes_wide_tile(d) + 3 * wide_stage_bytes(nch) <= SMEM_LIMIT)
      return {nch, 3};
  if (smem_bytes_wide_tile(d) + 2 * wide_stage_bytes(64) <= SMEM_LIMIT)
    return {64, 2};
  return {0, 0};
}

__host__ __device__ constexpr size_t smem_bytes_wide(int d) {
  return smem_bytes_wide_tile(d) +
         (size_t)wide_ring(d).stages * wide_stage_bytes(wide_ring(d).nch);
}
static_assert(wide_ring(384).nch == 384 && wide_ring(576).stages == 2,
              "the frontier's width takes whole chunks; D = 576 fits");

// Four 8 x 8 matrices of 16-bit elements from shared memory (the rows
// whose addresses lanes 0-7, 8-15, 16-23, 24-31 give), as mma.sync's A
// fragment of a 16 x 16 tile
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8 x 8 matrices transposed: of a 32 (k) x 8 (n) tile stored
// k-row-major, rows from lanes 0-31, the B fragments of its two k16 steps
// ({r0, r1} and {r2, r3})
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) @ b (16 x 8, bf16): b0, b1 the B
// fragment. c[0..1]: row lane / 4, columns 2 (lane % 4) + {0, 1}; c[2..3]:
// row lane / 4 + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One GEMM of a wide-route block: n of its weight's columns (bias b), K =
// k, in segments of seg columns, segment s at global column s * D + rank *
// seg (qkv: three of D / n; the others one, seg = n). The ring holds each
// segment padded to whole boxes (pseg columns; at the frontier's widths
// there is no padding), and a chunk is up to nch / 2 of those padded
// columns.
struct WideGemm {
  const bf16* b;
  int k, n, seg;
  __device__ __forceinline__ int pseg() const {
    return (seg + BOXC - 1) / BOXC * BOXC;
  }
  __device__ __forceinline__ int padded() const { return n / seg * pseg(); }
  // the global column of padded column pc
  __device__ __forceinline__ int col(int pc, int d, int rank) const {
    return pc / pseg() * d + rank * seg + pc % pseg();
  }
  // k-rows of a tile of a chunk pw wide in a ring of nch-column stages: a
  // stage's worth (64 at the widest chunk, more at a narrow one); its last
  // tile may be cut short at k, a multiple of 32
  __device__ __forceinline__ int depth(int pw, int nch) const {
    return BOXR * max(1, nch / 2 / pw);
  }
};

// The wide route's kernel arguments, read in place from the parameter bank
// (__grid_constant__): the four weights' tensor maps (boxes of 32 columns x
// 64 k-rows, 64-byte swizzled) and their GEMMs, qkv, proj, W1, W2.
struct WideParams {
  CUtensorMap map[4];
  WideGemm gemm[4];
  const bf16* tok;
  bf16* out;
  int n_img, n_tok, d, imgs_per_tile, n_cta, nch, stages;
  float scale;
};

// The weight ring of a wide-route block. Stage s holds tile t = s, s +
// stages, ..: full(t) completes a phase when the tile has landed, empty(t)
// when the 8 consumer warps have done with it. The tiles are those of the
// four GEMMs in turn, chunk by chunk (up to nch / 2 padded columns), 64 or
// more k-rows a tile; a tile is stored as panels of its 32-column boxes (depth
// rows of 64 bytes each, 64-byte swizzled: the 16-byte chunk c of row r at
// c ^ (r / 2 % 4)).
struct WideStages {
  const WideParams& p;
  uint32_t ring, bars;
  __device__ __forceinline__ uint32_t stage(int t) const {
    return ring + (uint32_t)((t % p.stages) * wide_stage_bytes(p.nch));
  }
  __device__ __forceinline__ uint32_t full(int t) const {
    return bars + 8 * (t % p.stages);
  }
  __device__ __forceinline__ uint32_t empty(int t) const {
    return bars + 8 * (4 + t % p.stages);
  }
  __device__ __forceinline__ WideGemm at(int i) const {
    return i == 0 ? p.gemm[0] : i == 1 ? p.gemm[1]
         : i == 2 ? p.gemm[2] : p.gemm[3];
  }
};

// The producer warpgroup. Its first warp walks every tile of the four GEMMs
// and, as soon as the consumers have released the tile's stage, lane 0
// tells its full barrier the bytes and lane i issues the TMA copy of box i;
// it never waits for data. Every thread of it arrives at the cluster's
// barriers (see the kernel): at barrier k + 1 before the first tile of GEMM
// k + 1, after waiting for barrier k; every tile the consumers need before
// they arrive at barrier k + 1 is then issued or in flight, so neither side
// waits for the other in a circle.
__device__ void produce_wide(const WideStages& rg, int rank) {
  const WideParams& p = rg.p;
  const int lane = threadIdx.x % 32;
  const bool streams = threadIdx.x / 32 == NTHREADS / 32;  // its first warp
  int t = 0;
  for (int g = 0; g < 4; ++g) {
    if (g > 0) cluster_wait();  // barrier g - 1
    cluster_arrive();           // barrier g
    if (!streams) continue;
    const WideGemm G = rg.at(g);
    const uint64_t map = reinterpret_cast<uint64_t>(
        g == 0 ? &p.map[0] : g == 1 ? &p.map[1]
      : g == 2 ? &p.map[2] : &p.map[3]);
    for (int c0 = 0; c0 < G.padded(); c0 += p.nch / 2) {
      const int pw = min(p.nch / 2, G.padded() - c0);
      const int depth = G.depth(pw, p.nch);
      for (int k0 = 0; k0 < G.k; k0 += depth, ++t) {
        // boxes past k land as zeros (and are never read)
        const int per = (min(depth, G.k - k0) + BOXR - 1) / BOXR;
        const int boxes = pw / BOXC * per;
        mbar_wait(rg.empty(t), (uint32_t)(t / p.stages & 1) ^ 1u);
        if (lane == 0) mbar_expect_tx(rg.full(t), boxes * BOX_BYTES);
        __syncwarp();
        if (lane < boxes)
          tma_load_2d(rg.stage(t) + lane / per * depth * 64 +
                          lane % per * BOX_BYTES,
                      map, G.col(c0 + BOXC * (lane / per), p.d, rank),
                      k0 + BOXR * (lane % per), rg.full(t));
      }
    }
  }
  cluster_wait();  // barrier 3
}

// Y[r] = bf16(LN(X[r])) for the tile's 32 rows, no affine: 8 threads a
// row, each summing every eighth 16-byte vector of it; fp32 stats, clamped
// one-pass variance, eps 1e-6 (row_stats' formula, another order of sums)
__device__ __forceinline__ void layer_norm_wide(const bf16* X, int ldx,
                                                bf16* Y, int d) {
  const int r = threadIdx.x / 8, q = threadIdx.x % 8;
  const bf16* x = X + r * ldx;
  float s = 0.f, ss = 0.f;
#pragma unroll 3
  for (int c = 8 * q; c < d; c += 64) {
    float v[8];
    load_f<bf16, 8>(x + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / d;
  const float inv = 1.f / sqrtf(fmaxf(0.f, ss / d - mu * mu) + 1e-6f);
#pragma unroll 3
  for (int c = 8 * q; c < d; c += 64) {
    float v[8];
    load_f<bf16, 8>(x + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * inv;
    store_f<bf16, 8>(Y + r * ldx + c, v);
  }
  consumer_sync();
}

// Epilogues of the wide route on columns (c, c + 1) of row r (c even: the
// block's own column; gc: its column in the output of D or 4D); v0, v1
// are the fp32 sums with the bias added.
struct EpiQkvW {  // local qkv: Q[r][c] = bf16(acc + bias)
  bf16* q; int ld;
  __device__ __forceinline__ void operator()(int r, int c, int, float v0,
                                             float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(q + r * ld + c) =
        __floats2bfloat162_rn(v0, v1);
  }
};

struct EpiGeluW {  // hidden: H[r][gc] = bf16(gelu(bf16(acc + bias)))
  bf16* h; int ld;
  __device__ __forceinline__ void operator()(int r, int, int gc, float v0,
                                             float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(h + r * ld + gc) =
        __floats2bfloat162_rn(gelu_tanh16(round_to<bf16>(v0)),
                              gelu_tanh16(round_to<bf16>(v1)));
  }
};

struct EpiResidualW {  // X[r][gc] = bf16(X + bf16(acc + bias))
  bf16* x; int ld;
  __device__ __forceinline__ void operator()(int r, int, int gc, float v0,
                                             float v1) const {
    EpiResidual16{x, ld}(r, gc, v0, v1);
  }
};

// out = A @ W through the epilogue for the tile's 32 rows, on the tensor
// cores, by the 8 consumer warps: W is GEMM gi, whose tiles are the ring's
// from t on. A: shared [32][lda], K = G.k columns. Warp w holds m16 tile
// w % 2 of the n8 tiles 4 j + w / 2 of each chunk (pw / 32 of them, the
// same count for every warp; those in a segment's padding are computed and
// dropped). The caller synchronises the consumers afterwards.
template <class Epi>
__device__ __forceinline__ void wide_gemm(const bf16* A, int lda, int gi,
                                          const WideStages& rg, int& t,
                                          int rank, const Epi& epi) {
  const WideGemm G = rg.at(gi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = warp % 2, grp = warp / 2;
  const int pseg = G.pseg(), padded = G.padded(), nch = rg.p.nch;
  // this lane's row address for ldmatrix: row lane % 16 of the m16 tile,
  // columns + 8 for lanes 16-31; and of the B tile's k-row lane, whose
  // swizzle term is the same for every 32 k-rows
  const uint32_t a_lane =
      smem_u32(A + (16 * m + lane % 16) * lda + (lane / 16) * 8);
  const int xo = lane / 2 % 4;
  for (int c0 = 0; c0 < padded; c0 += nch / 2) {
    const int pw = min(nch / 2, padded - c0), depth = G.depth(pw, nch);
    const int nt = pw / 32;  // n8 tiles a warp
    // for each of this warp's n8 tiles: its offset in the stage (its box's
    // panel, its 16-byte chunk swizzled); this thread's column pair there
    // (its own and global) and its bias, if it holds columns
    uint32_t boff[NT_MAX], bias[NT_MAX];
    int jc[NT_MAX], gc[NT_MAX];
    bool ok[NT_MAX];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      const int q = 8 * (4 * j + grp), pc = c0 + q;
      const int s = pc / pseg, e = pc % pseg + 2 * (lane % 4);
      ok[j] = j < nt && pc % pseg < G.seg;
      jc[j] = s * G.seg + e;
      gc[j] = s * rg.p.d + rank * G.seg + e;
      bias[j] = ok[j] ? __ldg(reinterpret_cast<const uint32_t*>(G.b + gc[j]))
                      : 0u;
      boff[j] = (uint32_t)((q / BOXC) * depth * 64 + lane * 64 +
                           ((q % BOXC / 8) ^ xo) * 16);
    }
    float acc[NT_MAX][4];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < G.k; k0 += depth, ++t) {
      const int rows = min(depth, G.k - k0);
      mbar_wait(rg.full(t), (uint32_t)(t / rg.p.stages) & 1u);
      const uint32_t st = rg.stage(t);
      // the fragments of 32 k-rows (two k16 steps): those of the next 32
      // are asked for before the products of these
      uint32_t a[2][4], b[NT_MAX][4];
      const auto load = [&](int kk, uint32_t (&a_)[2][4],
                            uint32_t (&b_)[NT_MAX][4]) {
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
          if (j < nt) ldsm_x4_trans(b_[j], st + boff[j] + kk * 64);
        ldsm_x4(a_[0], a_lane + 2 * (k0 + kk));
        ldsm_x4(a_[1], a_lane + 2 * (k0 + kk + 16));
      };
      load(0, a, b);
      for (int kk = 0; kk < rows; kk += 32) {
        uint32_t an[2][4], bn[NT_MAX][4];
        if (kk + 32 < rows) load(kk + 32, an, bn);
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
          if (j < nt) {  // the same for every warp
            mma_bf16(acc[j], a[0], b[j][0], b[j][1]);
            mma_bf16(acc[j], a[1], b[j][2], b[j][3]);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[0][i] = an[0][i];
          a[1][i] = an[1][i];
#pragma unroll
          for (int j = 0; j < NT_MAX; ++j) b[j][i] = bn[j][i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(rg.empty(t));
    }
    const int r = 16 * m + lane / 4;
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j)
      if (ok[j]) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bias[j]));
        epi(r, jc[j], gc[j], acc[j][0] + b.x, acc[j][1] + b.y);
        epi(r + 8, jc[j], gc[j], acc[j][2] + b.x, acc[j][3] + b.y);
      }
  }
}

// Columns c0 .. c0 + cols - 1 of the first `rows` rows of a row-major
// shared buffer, copied into the same place in every other block of the
// cluster (16-byte stores through distributed shared memory)
__device__ __forceinline__ void to_peers(bf16* buf, int ld, int rows, int c0,
                                         int cols, int n_cta, int rank) {
  bf16* peer[MAX_CLUSTER - 1];
#pragma unroll
  for (int q = 1; q < MAX_CLUSTER; ++q)
    if (q < n_cta)
      peer[q - 1] = static_cast<bf16*>(cluster_map(buf, (rank + q) % n_cta));
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += NTHREADS) {
    const int off = v / vpr * ld + c0 + v % vpr * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(buf + off);
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < n_cta) *reinterpret_cast<uint4*>(peer[q - 1] + off) = val;
  }
}

// One tile of 32 rows (imgs_per_tile whole images) per cluster of n_cta
// blocks; the block of rank r computes the r-th n_cta-th of every GEMM's
// output columns (see the header). Threads 0-255 consume (and do every
// phase but the weight stream), warpgroup 2 produces.
template <int HD>
__global__ void __launch_bounds__(THREADS_W, 1)
fused_dit_block_wide_kernel(const __grid_constant__ WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, n_tok = p.n_tok, n_cta = p.n_cta;
  const int ldx = d + PAD, ldw = 4 * d + PAD;
  bf16* X = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = X + MTW * ldx;
  bf16* Q = A + MTW * ldx;  // o [0, D), then the hidden [0, 4D)
  uint64_t* bars = reinterpret_cast<uint64_t*>(Q + MTW * ldw);
  // the ring's boxes start on 1024 bytes: their swizzle is a function of
  // the address
  const WideStages rg{p, (smem_u32(bars + 8) + 1023u) & ~1023u,
                     smem_u32(bars)};
  const int rank = cluster_rank(), dn = d / n_cta;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(rg.full(s), 1);      // the producer's expect_tx
      mbar_init(rg.empty(s), NTHREADS / 32);  // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the producer needs few registers; the consumers hold the accumulators
  // and two steps of fragments: 128 x 40 + 256 x 232 of the SM's 65536
  if (threadIdx.x >= NTHREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    produce_wide(rg, rank);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  cluster_arrive();  // barrier 0: this block has started

  const int img0 = blockIdx.x / n_cta * p.imgs_per_tile;
  const int imgs = min(p.imgs_per_tile, p.n_img - img0);
  const int rows = imgs * n_tok;
  const size_t g0 = (size_t)img0 * n_tok * d;
  const int vpr = d / 8;
  int t = 0;  // the ring's tiles taken
  // residual tile in; rows past the tile's images are zero
  for (int v = threadIdx.x; v < MTW * vpr; v += NTHREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(p.tok + g0 + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(X + r * ldx + c) = val;
  }
  consumer_sync();

  // attention half: this block's heads' qkv into Q[:, D : D + 3D / n],
  // their attention output over Q[:, rank D / n ..]
  layer_norm_wide(X, ldx, A, d);
  wide_gemm(A, ldx, 0, rg, t, rank, EpiQkvW{Q + d, ldw});
  consumer_sync();
  const int heads = dn / HD;
  for (int i = threadIdx.x; i < imgs * heads * n_tok; i += NTHREADS) {
    const int im = i / (heads * n_tok), rem = i % (heads * n_tok);
    attend_query<bf16, HD>(RowMajor<bf16>{Q + d + im * n_tok * ldw, ldw},
                           RowMajor<bf16>{Q + rank * dn + im * n_tok * ldw,
                                          ldw},
                           rem % n_tok, rem / n_tok, n_tok, dn, p.scale);
  }
  consumer_sync();
  cluster_wait();  // barrier 0: every peer has started
  to_peers(Q, ldw, rows, rank * dn, dn, n_cta, rank);
  cluster_arrive();  // barrier 1: every block's o is in place
  cluster_wait();
  wide_gemm(Q, ldw, 1, rg, t, rank, EpiResidualW{X, ldx});
  consumer_sync();
  to_peers(X, ldx, rows, rank * dn, dn, n_cta, rank);
  cluster_arrive();  // barrier 2: every block's columns of x are in place
  cluster_wait();

  // MLP half: GELU hidden into Q[:, 0:4D]
  layer_norm_wide(X, ldx, A, d);
  wide_gemm(A, ldx, 2, rg, t, rank, EpiGeluW{Q, ldw});
  consumer_sync();
  to_peers(Q, ldw, rows, rank * 4 * dn, 4 * dn, n_cta, rank);
  cluster_arrive();  // barrier 3: the hidden is whole
  cluster_wait();
  wide_gemm(Q, ldw, 3, rg, t, rank, EpiResidualW{X, ldx});
  consumer_sync();

  const int vpb = dn / 8;  // this block's output columns, in vectors
  for (int v = threadIdx.x; v < rows * vpb; v += NTHREADS) {
    const int r = v / vpb, c = rank * dn + (v % vpb) * 8;
    *reinterpret_cast<uint4*>(p.out + g0 + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(X + r * ldx + c);
  }
}

// ------------------------------------------------------------ launches
struct Args {
  const void* p[9];
  void* out;
  int n_img, n_tok, d;
  float scale;
  cudaStream_t stream;
};

// T: the element type of the kernel's ten pointers; mt: token rows a block
template <typename T, class Kernel>
static int launch(Kernel kern, int threads, size_t smem, int mt,
                  const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int imgs_per_tile = mt / a.n_tok;
  const int grid = (a.n_img + imgs_per_tile - 1) / imgs_per_tile;
  kern<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.p[0]), static_cast<const T*>(a.p[1]),
      static_cast<const T*>(a.p[2]), static_cast<const T*>(a.p[3]),
      static_cast<const T*>(a.p[4]), static_cast<const T*>(a.p[5]),
      static_cast<const T*>(a.p[6]), static_cast<const T*>(a.p[7]),
      static_cast<const T*>(a.p[8]), static_cast<T*>(a.out), a.n_img, a.n_tok,
      a.d, imgs_per_tile, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int MT, int HD>
static int launch_rows_hd(const Args& a) {
  return launch<T>(fused_dit_block_rows_kernel<T, MT, HD>, NTHREADS,
                   smem_bytes_rows(MT, a.d, sizeof(T)), MT, a);
}

template <typename T, int MT>
static int launch_rows(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch_rows_hd<T, MT, 16>(a);
    case 32: return launch_rows_hd<T, MT, 32>(a);
    case 48: return launch_rows_hd<T, MT, 48>(a);
    case 64: return launch_rows_hd<T, MT, 64>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// A launch configuration of clusters of n_cta blocks. attr is filled and
// pointed to.
static cudaLaunchConfig_t cluster_config(int grid, int threads, size_t smem,
                                         int n_cta, cudaStream_t stream,
                                         cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_cta;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// n_cta: 1 is the one-block route (whole images of up to 64 rows a block),
// 2 .. MAX_CLUSTER the cluster route. max_clusters: when not null, the
// clusters the card can hold at once is written there and nothing runs.
template <int HD>
static int launch_bf16_hd(const Args& a, int n_cta, int* max_clusters) {
  if (n_cta == 1)
    return launch<bf16>(fused_dit_block_bf16_kernel<HD, false>, THREADS16,
                        smem_bytes_bf16(a.d, false), MT16, a);
  const auto kern = fused_dit_block_bf16_kernel<HD, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes_bf16(a.d, true));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(a.n_img * n_cta, THREADS16, smem_bytes_bf16(a.d, true),
                     n_cta, a.stream, attr);
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(
      max_clusters, kern, &cfg);
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(a.p[0]),
      static_cast<const bf16*>(a.p[1]), static_cast<const bf16*>(a.p[2]),
      static_cast<const bf16*>(a.p[3]), static_cast<const bf16*>(a.p[4]),
      static_cast<const bf16*>(a.p[5]), static_cast<const bf16*>(a.p[6]),
      static_cast<const bf16*>(a.p[7]), static_cast<const bf16*>(a.p[8]),
      static_cast<bf16*>(a.out), a.n_img, a.n_tok, a.d, n_cta, a.scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static int launch_bf16(int hd, const Args& a, int n_cta,
                       int* max_clusters = nullptr) {
  if (a.d > MAX_D) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_bf16_hd<16>(a, n_cta, max_clusters);
    case 32: return launch_bf16_hd<32>(a, n_cta, max_clusters);
    case 48: return launch_bf16_hd<48>(a, n_cta, max_clusters);
    case 64: return launch_bf16_hd<64>(a, n_cta, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// The wide route: a tile of 32 rows (whole images) to a cluster of n_cta
// blocks. max_clusters: as for launch_bf16_hd. The four tensor maps are
// encoded on the host at every launch (the folded weights are new tensors
// at every call).
template <int HD>
static int launch_wide_hd(const Args& a, int n_cta, int* max_clusters) {
  const auto kern = fused_dit_block_wide_kernel<HD>;
  const size_t smem = smem_bytes_wide(a.d);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const WideRing rg = wide_ring(a.d);
  const int d = a.d, dn = a.d / n_cta;
  WideParams p{{},
               {{static_cast<const bf16*>(a.p[2]), d, 3 * dn, dn},
                {static_cast<const bf16*>(a.p[4]), d, dn, dn},
                {static_cast<const bf16*>(a.p[6]), d, 4 * dn, 4 * dn},
                {static_cast<const bf16*>(a.p[8]), 4 * d, dn, dn}},
               static_cast<const bf16*>(a.p[0]), static_cast<bf16*>(a.out),
               a.n_img, a.n_tok, d, MTW / a.n_tok, n_cta, rg.nch, rg.stages,
               a.scale};
  const int tiles = (a.n_img + p.imgs_per_tile - 1) / p.imgs_per_tile;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(tiles * n_cta, THREADS_W, smem, n_cta, a.stream, attr);
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(
      max_clusters, kern, &cfg);
  // weight i (qkv, proj, W1, W2) is (K, N) row-major: K = 4D for W2
  const int wn[4] = {3 * d, d, 4 * d, d};
  for (int i = 0; i < 4; ++i) {
    const long long dims[2] = {wn[i], i == 3 ? 4 * d : d};
    const long long strides[1] = {wn[i]};
    const int box[2] = {BOXC, BOXR};
    if (!encode_bf16_map(&p.map[i], a.p[1 + 2 * i], 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// n_cta: blocks a tile, 1 to 4, dividing the heads
static int launch_wide(int hd, const Args& a, int n_cta,
                       int* max_clusters = nullptr) {
  if (a.d <= MAX_D || !wide_ring(a.d).stages || a.n_tok > MTW ||
      n_cta < 1 || n_cta > MAX_CLUSTER || (a.d / hd) % n_cta)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_wide_hd<16>(a, n_cta, max_clusters);
    case 32: return launch_wide_hd<32>(a, n_cta, max_clusters);
    case 48: return launch_wide_hd<48>(a, n_cta, max_clusters);
    case 64: return launch_wide_hd<64>(a, n_cta, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. mt: token rows per block and n_cta:
// blocks per image or tile, which together name the route: mt 64 in
// bfloat16 is the wgmma kernel (D <= 256), with n_cta 1 for whole images of
// up to 64 tokens a block, or n_cta = ceil(n_tok / 64), 2 to 4, for the
// cluster route; 32 in bfloat16 the wide route (D > 256, whole images of up
// to 32 tokens a tile, n_cta 1 to 4 blocks a tile, dividing the heads); 16,
// 32 or 64 in float32 the rows route, n_cta 1. The caller chooses them so
// that the block's shared memory fits (ops/kernels.py mirrors
// smem_bytes_rows, smem_bytes_bf16 and smem_bytes_wide); a size that does
// not fit fails in cudaFuncSetAttribute and is returned. hd: 16, 32, 48 or
// 64. Returns cudaGetLastError() after the launch (0 on success), the
// launch's own error, or cudaErrorInvalidValue for an unsupported
// combination.
extern "C" int fused_dit_block_launch(
    int dtype, const void* tok, const void* wqkv, const void* bqkv,
    const void* wpr, const void* bpr, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, int n_img, int n_tok, int d,
    int hd, int mt, int n_cta, float scale, void* stream) {
  const cdm::Args a{{tok, wqkv, bqkv, wpr, bpr, w1, b1, w2, b2}, out, n_img,
                    n_tok, d, scale, static_cast<cudaStream_t>(stream)};
  if (n_tok < 1 || d % cdm::KT != 0 || d % hd != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && mt == cdm::MTW) return cdm::launch_wide(hd, a, n_cta);
  if (n_cta != 1) {  // the cluster route: exactly the blocks T needs
    if (dtype != 1 || mt != cdm::MT16 || n_cta > cdm::MAX_CLUSTER ||
        n_cta != (n_tok + mt - 1) / mt || n_tok <= mt)
      return (int)cudaErrorInvalidValue;
    return cdm::launch_bf16(hd, a, n_cta);
  }
  if (n_tok > mt) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && mt == 64) return cdm::launch_bf16(hd, a, 1);
  if (dtype == 0 && mt == 64) return cdm::launch_rows<float, 64>(hd, a);
  if (dtype == 0 && mt == 32) return cdm::launch_rows<float, 32>(hd, a);
  if (dtype == 0 && mt == 16) return cdm::launch_rows<float, 16>(hd, a);
  return (int)cudaErrorInvalidValue;
}

// The occupancy of the routes launched as clusters: how many clusters of
// n_cta blocks (each with the route's shared memory at width d: the
// cluster route's up to D = 256, n_cta 2 to 4; the wide route's past it,
// n_cta 1 to 4) the card holds at once, from
// cudaOccupancyMaxActiveClusters. Returns 0 and writes the count to
// *clusters, or the CUDA error.
extern "C" int fused_dit_block_max_clusters(int d, int hd, int n_cta,
                                            int* clusters) {
  if (d % cdm::KT != 0 || d % hd != 0) return (int)cudaErrorInvalidValue;
  if (d > cdm::MAX_D) {
    const cdm::Args a{{}, nullptr, 1, 1, d, 1.f, nullptr};
    return cdm::launch_wide(hd, a, n_cta, clusters);
  }
  const cdm::Args a{{}, nullptr, 1, n_cta * cdm::MT16, d, 1.f, nullptr};
  if (n_cta < 2 || n_cta > cdm::MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  return cdm::launch_bf16(hd, a, n_cta, clusters);
}
