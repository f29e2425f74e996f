// flash_attention: softmax(q k^T * scale) v for q (B, H, Nq, D) and k, v
// (B, H, Nk, D), any Nq and Nk, D in {16, 32, 64, 128, 256}, float32 or
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
// Three routes; ops/attention.py::flash_route picks one from the dtype,
// Nk, D and the strides and passes it in, and this file checks that the
// route can take the arguments.
//
// ROUTE_SHORT (Nk <= 4 and query rows of at most 64 bytes: the UNet's
// cross-attention at its widest site, Nk = 2, D = 16). Bound by memory: q
// read once and out written once. A thread, or TPQ = D / 32 neighbouring
// lanes, owns one query; a block owns all H heads of a run of whole tokens,
// counted over (batch, row), heads fastest, so that no block but the last
// has an idle token and, when the views come from a (B, N, H, D) buffer, a
// warp's 16-byte loads and stores walk contiguous memory: 2-4 query rows
// share each 128-byte line. (At 128-byte rows the tiles route's one
// (batch, head) a block is faster: there the order buys nothing, and its
// warps read K and V as broadcasts.) The block is two-dimensional, (head
// and part, token), so that a thread divides by a run-time value once. The
// K and V rows of the one or two batch elements that the block's queries
// belong to are staged in shared memory once, while the queries' own loads
// are in flight, behind one barrier. A query's arithmetic is ROUTE_TILES'
// step for step: its score a serial fmaf chain over d in the same chunk
// order, 8-key score tiles, expf, then acc / l. So float32 outputs are
// those of the tiles route, bit for bit.
//
// ROUTE_TILES (the rest: float32 past the short route, bfloat16 below the
// tensor cores' limit or with rows not 16-byte aligned). Bound by
// operations at long contexts (4096 x 4096 x 64): the faithful products
// are float32 FMAs on the CUDA cores. A block of 128 threads owns BQ
// consecutive queries of one (batch, head). TPQ lanes share a query, each
// holding an interleaved slice of q and of the accumulator in registers;
// their partial scores meet in a butterfly shuffle. K and V stream through
// shared memory in tiles of BK = 4096 / D keys, widened to float32 once per
// block, and are read as float4 broadcasts. Scores are taken 8 keys at a
// time (the score tile), so the running state is updated with one rescale
// per 8 keys. Heads wider than 128 (the TPU kernel takes any D) take this
// route only: at D = 256 eight lanes share a query, 32 elements each, and
// a shared-memory tile holds 16 keys (16 KB of K and of V, as at D = 128).
//
// ROUTE_WGMMA (bfloat16 from Nk * D = 2048 on, D <= 128). Bound by
// operations: both products on the tensor cores. A block owns 128
// queries of one (batch, head) and is three warpgroups. One thread of warpgroup 0 copies K and V
// tiles of BKV keys (128, or 64 at D = 128) into a 4-stage ring of
// 128-byte-swizzled rows with TMA (keys past Nk land as zeros), the bytes
// counted down on the stage's "full" mbarrier. Warpgroups 1 and 2 own 64
// queries each; every thread keeps the fp32 online-softmax state of its two
// rows in registers. The products
// keep the TPU kernel's float32 operands: k and v are bf16 already, and an
// fp32 operand split into two bf16 terms makes every product exact in fp32:
//   q * scale = qh + ql (ql = 0 when the scale is a power of two, D = 16 and
//   64, and its wgmma is skipped), S = qh k^T (+ ql k^T), wgmma from shared
//   memory, fp32 accumulators;
//   p = exp(s - m) = ph + pl, O = O * alpha + ph V + pl V, wgmma with P from
//   registers (the S accumulators' layout is the A fragment's).
// What the split leaves out is below 2^-16 of each product, far inside the
// bf16 output's rounding. The -1e30 start, the fp32 denominators and the
// single rounding at the store stay.
#include "attention.cuh"
#include "hopper.cuh"

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

constexpr int ROUTE_SHORT = 0, ROUTE_TILES = 1, ROUTE_WGMMA = 2;

// ================================================================ short
constexpr int SHORT_SMEM = 16384;  // bytes of staged K and V a block

// A block of (H * TPQ, R) threads: threadIdx.x the head and the lane's
// part of the query (heads fastest), threadIdx.y one of R whole tokens,
// counted over (batch, row): B * Nq tokens in all, below 2^31.
template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int n_heads,
                   int nq, int nk, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, unsigned n_tokens) {
  constexpr int DP = D < 32 ? D : 32;   // elements of a query per thread
  constexpr int TPQ = D / DP;           // threads per query
  constexpr int NCH = DP / 4;           // float4 chunks per thread
  constexpr int C4 = D / 4;             // 4-element chunks of a row
  constexpr int RS = D + 16 / sizeof(T);  // a staged row: padded 16 bytes
  __shared__ __align__(16) unsigned char kv_raw[SHORT_SMEM];

  const int part = threadIdx.x % TPQ, h = threadIdx.x / TPQ;
  const unsigned R = blockDim.y, tq = blockIdx.x * R + threadIdx.y;
  const bool live = tq < n_tokens;
  // a thread past the last token keeps its query's shuffles company on
  // the last token and stores nothing
  const unsigned tok = live ? tq : n_tokens - 1;
  const unsigned bq = tok / (unsigned)nq;
  const int b = (int)bq, t = (int)(tok - bq * (unsigned)nq);
  const T* qrow = q + b * qs.b + h * qs.h + (long long)t * qs.n;

  // thread `part` of a query owns float4 chunks part, part + TPQ, ...
  float4 qr[NCH], acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float4 tq4 = load4(qrow + (c * TPQ + part) * 4);
    qr[c] = make_float4(tq4.x * scale, tq4.y * scale, tq4.z * scale,
                        tq4.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // K and V of the batch elements the block's tokens belong to (one or two
  // at path B's shapes), staged in shared memory while the query loads
  // fly: rows of D padded by 16 bytes, so that the heads a warp spans fall
  // in different banks. Where they do not fit, every thread reads its rows
  // from device memory instead (the same values, the same arithmetic).
  const unsigned tok_first = blockIdx.x * R;
  const unsigned tok_last = min(tok_first + R, n_tokens) - 1;
  const int b0 = (int)(tok_first / (unsigned)nq);
  const int nb = (int)(tok_last / (unsigned)nq) - b0 + 1;
  const long long rows_ll = (long long)nb * n_heads * nk;
  const bool staged = 2 * rows_ll * RS * (long long)sizeof(T) <= SHORT_SMEM;
  T* sk = reinterpret_cast<T*>(kv_raw);
  T* sv = sk + (staged ? rows_ll : 0) * RS;
  const int ti = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  if (staged) {
    for (int bb = 0; bb < nb; ++bb)
      for (int j = 0; j < nk; ++j)
        for (int hc = ti; hc < n_heads * C4; hc += nt) {
          const int hh = hc / C4, c = hc % C4;
          const int row = (bb * n_heads + hh) * nk + j;
          const long long off = (b0 + bb) * ks.b + hh * ks.h + j * ks.n;
          const long long voff = (b0 + bb) * vs.b + hh * vs.h + j * vs.n;
          store4(sk + row * RS + c * 4, load4(k + off + c * 4));
          store4(sv + row * RS + c * 4, load4(v + voff + c * 4));
        }
  }
  __syncthreads();
  // the block's last warp is partial where H * TPQ does not divide 128;
  // a query's TPQ lanes are in it whole
  const int in_warp = min(32, nt - ti / 32 * 32);
  const unsigned lanes = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1;
  const int kv_row0 = ((b - b0) * n_heads + h) * nk;
  const T* kb = (staged ? sk + kv_row0 * RS : k + b * ks.b + h * ks.h) +
                part * 4;
  const T* vb = (staged ? sv + kv_row0 * RS : v + b * vs.b + h * vs.h) +
                part * 4;
  const long long kn = staged ? RS : ks.n, vn = staged ? RS : vs.n;

  float m = FA_NEG, l = 0.f;
  for (int j0 = 0; j0 < nk; j0 += FA_KS) {
    float s[FA_KS];
#pragma unroll
    for (int jj = 0; jj < FA_KS; ++jj) {
      float d = 0.f;
      if (j0 + jj < nk) {
        const T* kr = kb + (j0 + jj) * kn;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 kk = load4(kr + c * TPQ * 4);
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
        s[jj] += __shfl_xor_sync(lanes, s[jj], off);
    }
    float m_new = m;
#pragma unroll
    for (int jj = 0; jj < FA_KS; ++jj) {
      if (j0 + jj >= nk) s[jj] = FA_NEG;  // masked by index
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
      if (j0 + jj < nk) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const T* vr = vb + (j0 + jj) * vn;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 vv = load4(vr + c * TPQ * 4);
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
    }
    m = m_new;
  }
  if (!live) return;
  T* orow = o + b * os.b + h * os.h + (long long)t * os.n;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    store4(orow + (c * TPQ + part) * 4,
           make_float4(acc[c].x / l, acc[c].y / l, acc[c].z / l,
                       acc[c].w / l));
}

// ================================================================ tiles
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

// ================================================================ wgmma
constexpr int FW_WG = 128;       // threads of a warpgroup
constexpr int FW_STAGES = 4;     // K/V stages in the ring
constexpr int FW_STAGE_BYTES = 32 * 1024;
constexpr int FW_PANEL = 64 * 128;  // 64 rows of 128 bytes

template <int D> struct FwTile {
  static constexpr int BKV = D <= 64 ? 128 : 64;  // keys a stage
  // width of the P V product: V's rows are read as 64-column panels, and
  // at D < 64 the columns past D are computed and dropped
  static constexpr int DN = D < 64 ? 64 : D;
  static constexpr int PANELS = DN / 64;
  static constexpr int KV_BYTES = PANELS * BKV * 128;  // a K or a V tile
  static constexpr int Q_BYTES = PANELS * FW_PANEL;    // 64 rows of qh or ql
  static constexpr int CPR = D / 8;  // 16-byte chunks of a row
  static_assert(2 * KV_BYTES <= FW_STAGE_BYTES, "a stage holds K and V");
  static constexpr size_t SMEM = 1024 + (size_t)FW_STAGES * FW_STAGE_BYTES +
                                 4 * (size_t)Q_BYTES + 2 * FW_STAGES * 8;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 terms of (lo, hi): the rounded pair and what it leaves out
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& h,
                                           uint32_t& l) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  h = *reinterpret_cast<const uint32_t*>(&v);
  l = pack_bf16(lo - r.x, hi - r.y);
}

// K's and V's tensor maps: (D, Nk, H, B), inner first, boxes of (64, BKV,
// 1, 1): BKV key rows of 128 bytes, 128-byte swizzled (the K-major B of
// S = Q K^T and the MN-major B of P V are the same bytes); at D < 64 a row
// past D, and keys past Nk, land as zeros.
struct FwMaps {
  CUtensorMap k, v;
};

// One thread of warpgroup 0: the (batch, head)'s K and V tiles into the
// ring with TMA, as far ahead as there are free stages.
template <int D>
__device__ void fw_produce(const FwMaps* maps, int b, int h, int nk,
                           uint32_t ring, uint32_t full0, uint32_t empty0) {
  using Tile = FwTile<D>;
  const uint64_t mk = reinterpret_cast<uint64_t>(&maps->k);
  const uint64_t mv = reinterpret_cast<uint64_t>(&maps->v);
  const int nkt = (nk + Tile::BKV - 1) / Tile::BKV;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % FW_STAGES;
    mbar_wait(empty0 + 8 * s, ((kt / FW_STAGES) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * Tile::KV_BYTES);
    const uint32_t sk = ring + s * FW_STAGE_BYTES, sv = sk + Tile::KV_BYTES;
#pragma unroll
    for (int p = 0; p < Tile::PANELS; ++p) {
      const uint32_t off = p * Tile::BKV * 128;
      tma_load_4d(sk + off, mk, 64 * p, kt * Tile::BKV, h, b, full);
      tma_load_4d(sv + off, mv, 64 * p, kt * Tile::BKV, h, b, full);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(3 * FW_WG, 1)
flash_wgmma_kernel(const __grid_constant__ FwMaps maps,
                   const bf16* __restrict__ q, bf16* __restrict__ o,
                   int n_heads, int nq, int nk, Strides qs, Strides os,
                   float scale, int q_blocks, int split) {
  using Tile = FwTile<D>;
  constexpr int BKV = Tile::BKV, DN = Tile::DN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(base);
  unsigned char* qsm = base + FW_STAGES * FW_STAGE_BYTES;  // [wg][qh, ql]
  const uint32_t full0 = smem_u32(qsm + 4 * Tile::Q_BYTES);
  const uint32_t empty0 = full0 + 8 * FW_STAGES;
  const int bh = blockIdx.x / q_blocks, qb = blockIdx.x % q_blocks;
  const int b = bh / n_heads, h = bh % n_heads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);      // the producer's arrival and bytes
      mbar_init(empty0 + 8 * s, 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < FW_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      fw_produce<D>(&maps, b, h, nk, ring, full0, empty0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // warpgroup and warp through a shuffle, so that the compiler sees them
  // as uniform: no wgmma behind a branch it takes for divergent
  const int ctid = threadIdx.x - FW_WG;
  const int wg = __shfl_sync(0xffffffffu, ctid / FW_WG, 0);
  const int warp = __shfl_sync(0xffffffffu, (ctid / 32) % 4, 0);
  const int lane = ctid % 32;
  const int row0 = qb * 2 * 64 + wg * 64;  // this warpgroup's first query

  // q * scale in fp32, split into qh + ql, as K-major A tiles
  unsigned char* qh_sm = qsm + wg * 2 * Tile::Q_BYTES;
  unsigned char* ql_sm = qh_sm + Tile::Q_BYTES;
  const bf16* qb_ptr = q + b * qs.b + h * qs.h;
  for (int idx = ctid % FW_WG; idx < 64 * Tile::CPR; idx += FW_WG) {
    const int r = idx / Tile::CPR, c = idx % Tile::CPR;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nq)
      raw = *reinterpret_cast<const uint4*>(
          qb_ptr + (long long)(row0 + r) * qs.n + c * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 hi, lo;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(e[i]);
      split_bf16(x.x * scale, x.y * scale, hw[i], lw[i]);
    }
    const uint32_t off = (c >> 3) * FW_PANEL + sw128_chunk(r, c & 7);
    *reinterpret_cast<uint4*>(qh_sm + off) = hi;
    *reinterpret_cast<uint4*>(ql_sm + off) = lo;
  }
  fence_proxy_async();  // written by threads, read by wgmma
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(FW_WG) : "memory");
  const uint32_t qh_addr = smem_u32(qh_sm), ql_addr = smem_u32(ql_sm);

  float oacc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) oacc[i] = 0.f;
  float m0 = FA_NEG, m1 = FA_NEG, l0 = 0.f, l1 = 0.f;  // rows r and r + 8
  const int nkt = (nk + BKV - 1) / BKV;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % FW_STAGES;
    mbar_wait(full0 + 8 * s, (kt / FW_STAGES) & 1);
    const uint32_t sk = ring + s * FW_STAGE_BYTES, sv = sk + Tile::KV_BYTES;

    // S = (qh + ql) K^T
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk >> 2) * (BKV * 128) + (kk & 3) * 32;
      const uint32_t qoff = (kk >> 2) * FW_PANEL + (kk & 3) * 32;
      Wgmma<BKV>::template ss<0, 0>(sc, sw128_desc(qh_addr + qoff, 16),
                                    sw128_desc(sk + koff, 16), 1);
    }
    if (split) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk >> 2) * (BKV * 128) + (kk & 3) * 32;
        const uint32_t qoff = (kk >> 2) * FW_PANEL + (kk & 3) * 32;
        Wgmma<BKV>::template ss<0, 0>(sc, sw128_desc(ql_addr + qoff, 16),
                                      sw128_desc(sk + koff, 16), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) asm volatile("" : "+f"(sc[i])::"memory");

    // keys past nk, masked by index (the last tile only)
    const int key0 = kt * BKV;
    if (key0 + BKV > nk) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (key0 + 8 * j + 2 * (lane % 4) + e >= nk) {
            sc[4 * j + e] = FA_NEG;
            sc[4 * j + 2 + e] = FA_NEG;
          }
        }
      }
    }
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the row's four lanes
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    const float a0 = expf(m0 - x0), a1 = expf(m1 - x1);
    m0 = x0;
    m1 = x1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      oacc[4 * j] *= a0;
      oacc[4 * j + 1] *= a0;
      oacc[4 * j + 2] *= a1;
      oacc[4 * j + 3] *= a1;
    }
    // p = ph + pl as the A fragments of P V: k16 step kk covers score
    // columns 16 kk .. 16 kk + 15, i.e. the accumulator blocks j = 2 kk
    // (registers 0, 1) and 2 kk + 1 (registers 2, 3)
    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const float p0 = expf(sc[4 * j] - x0), p1 = expf(sc[4 * j + 1] - x0);
      const float p2 = expf(sc[4 * j + 2] - x1),
                  p3 = expf(sc[4 * j + 3] - x1);
      l0 += p0;
      l0 += p1;
      l1 += p2;
      l1 += p3;
      const int kk = j / 2, r = 2 * (j % 2);
      split_bf16(p0, p1, ph[kk][r], pl[kk][r]);
      split_bf16(p2, p3, ph[kk][r + 1], pl[kk][r + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t dv = sw128_desc(sv + kk * 16 * 128, BKV * 128);
      Wgmma<DN>::template rs<1>(oacc, ph[kk][0], ph[kk][1], ph[kk][2],
                                ph[kk][3], dv, 1);
      Wgmma<DN>::template rs<1>(oacc, pl[kk][0], pl[kk][1], pl[kk][2],
                                pl[kk][3], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DN / 2; ++i)
      asm volatile("" : "+f"(oacc[i])::"memory");
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r = row0 + warp * 16 + lane / 4;
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (c >= D) continue;
    if (r < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * os.n + c) =
          __floats2bfloat162_rn(oacc[4 * j] / l0, oacc[4 * j + 1] / l0);
    if (r + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r + 8) * os.n + c) =
          __floats2bfloat162_rn(oacc[4 * j + 2] / l1, oacc[4 * j + 3] / l1);
  }
}

// ============================================================= launches
struct Args {
  const void *q, *k, *v;
  void* o;
  int n_batch, n_heads, nq, nk;
  Strides qs, ks, vs, os;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
static int launch_short(const Args& a) {
  constexpr int TPQ = D < 32 ? 1 : D / 32;
  const long long n_tokens = (long long)a.n_batch * a.nq;
  const int x = a.n_heads * TPQ;  // a token's threads
  if (x > FA_THREADS || n_tokens + FA_THREADS >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int R = FA_THREADS / x;  // whole tokens a block
  flash_short_kernel<T, D><<<(unsigned)((n_tokens + R - 1) / R), dim3(x, R),
                             0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.n_heads, a.nq,
      a.nk, a.qs, a.ks, a.vs, a.os, a.scale, (unsigned)n_tokens);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_tiles(const Args& a) {
  constexpr int TPQ = D < 32 ? 1 : D / 32;
  constexpr int BQ = FA_THREADS / TPQ;
  const int q_blocks = (a.nq + BQ - 1) / BQ;
  const long long grid = (long long)a.n_batch * a.n_heads * q_blocks;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, D><<<(unsigned)grid, FA_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.n_heads, a.nq,
      a.nk, a.qs, a.ks, a.vs, a.os, a.scale, q_blocks);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.n % 8 == 0;
}

template <int D>
static int launch_wgmma(const Args& a) {
  if (!aligned16(a.q, a.qs) || !aligned16(a.k, a.ks) ||
      !aligned16(a.v, a.vs))
    return (int)cudaErrorInvalidValue;
  FwMaps maps;
  const long long dims[4] = {D, a.nk, a.n_heads, a.n_batch};
  const int box[4] = {64, FwTile<D>::BKV, 1, 1};
  const long long kst[3] = {a.ks.n, a.ks.h, a.ks.b};
  const long long vst[3] = {a.vs.n, a.vs.h, a.vs.b};
  if (!encode_bf16_map(&maps.k, a.k, 4, dims, kst, box) ||
      !encode_bf16_map(&maps.v, a.v, 4, dims, vst, box))
    return (int)cudaErrorInvalidValue;
  const auto kern = flash_wgmma_kernel<D>;
  const size_t smem = FwTile<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int q_blocks = (a.nq + 127) / 128;
  const long long grid = (long long)a.n_batch * a.n_heads * q_blocks;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  // q * scale is a bf16 value, and ql zero, when the scale is a power of 2
  int exponent;
  const int split = frexpf(a.scale, &exponent) != 0.5f;
  kern<<<(unsigned)grid, 3 * FW_WG, smem, a.stream>>>(
      maps, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.o),
      a.n_heads, a.nq, a.nk, a.qs, a.os, a.scale, q_blocks, split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_route(int route, const Args& a) {
  switch (route) {
    case ROUTE_SHORT: return launch_short<T, D>(a);
    case ROUTE_TILES: return launch_tiles<T, D>(a);
    case ROUTE_WGMMA:
      if constexpr (sizeof(T) == 2 && D <= 128) return launch_wgmma<D>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_d(int route, int d, const Args& a) {
  switch (d) {
    case 16: return launch_route<T, 16>(route, a);
    case 32: return launch_route<T, 32>(route, a);
    case 64: return launch_route<T, 64>(route, a);
    case 128: return launch_route<T, 128>(route, a);
    case 256: return launch_route<T, 256>(route, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdm

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides on the
// host, (batch, head, row) of q, k, v and out in that order; every one a
// multiple of 4 and every pointer 16-byte aligned (the CUDA-core routes
// move 4 elements at a time). nq, nk >= 1. route: one of the ROUTE_*
// values above; ROUTE_WGMMA takes bfloat16 only, D <= 128, with the q, k
// and v strides multiples of 8 (16-byte rows). Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for an unsupported
// dtype, head width, size (ROUTE_SHORT: B * Nq below 2^31 and H at most
// 128 / max(1, D / 32)), or route.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int n_batch, int n_heads, int nq,
                                      int nk, int d,
                                      const long long* strides, float scale,
                                      int route, void* stream) {
  if (n_batch < 1 || n_heads < 1 || nq < 1 || nk < 1)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const cdm::Args a{q, k, v, o, n_batch, n_heads, nq, nk,
                    {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                    {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                    scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return cdm::dispatch_d<float>(route, d, a);
  if (dtype == 1) return cdm::dispatch_d<cdm::bf16>(route, d, a);
  return (int)cudaErrorInvalidValue;
}
