// Split-KV GQA flash-decode shared by the contiguous and the paged decode
// kernels; they differ only in how a virtual slot maps to a cache row
// (the Slots policies below).
//
// Bound on the H100: the bytes of K and V read (every live slot of every
// kv head once per step, 3.35 TB/s).  At Qwen3-14B's widths (H = 40,
// Hkv = 8, Dh = 128, bf16) and B = 8 at context 2048 that is 67 MB, or
// 0.020 ms; the products are 5 query heads against each K/V row, far
// below the tensor cores' rate.  So the design is about keeping enough
// bytes in flight on every SM, and reading each K/V row once for all G
// query heads of its kv head.
//
// Split rule.  The grid is (n_split, Hkv, B): block (i, kvh, b) streams
// slots [i L, (i + 1) L) of its row, L a multiple of kDecQuantum.  The
// host picks L and n_split = ceil(s_len / L) from s_len, B and Hkv alone
// (kernels/decode_attn.py:plan: about 512 blocks over s_len, at most
// kDecMaxSplit splits), never from pos, which would need a sync.  A
// block reads pos[b] itself: the live slots are [0, n) with n =
// min(s_len, pos + 1), or s_len once a ring has wrapped, and a block
// whose range starts at or past n exits at once, writing nothing.
//
// Inside a block, four warps each take every fourth warp tile of the
// block's range and run their own online softmax over them; no
// __syncthreads is taken inside the slot loop.  The warps' (m, l, acc)
// are merged in shared memory in warp order.
//
// Merge.  With n_live = ceil(n / L) live splits, a block with n_live = 1
// writes the output itself.  Otherwise each live block writes its partial
// (acc[Dh], m, l; f32, m in log2 units) to scratch (B, H, n_split,
// Dh + 2), and the last of them to arrive (an int32 counter per (b,
// kvh), __threadfence before the atomicAdd) merges the n_live partials
// in split order and resets the counter to 0: one launch, and the same
// sums in the same order whichever block comes last, so two calls give
// the same bits.  out = sum_i 2^(m_i - M) acc_i / max(sum_i 2^(m_i - M)
// l_i, 1e-30), M = max_i m_i; a row with no live slot (pos < 0) gets 0.
// With a non-null lse (B, H) f32, the block that writes a (row, head)'s
// output also writes ln 2 (M + log2 l), the natural-log log-sum-exp of its
// scaled scores over the live slots (-inf for a row with none): what a
// caller holding the cache cut along the sequence needs to combine the
// shards' outputs (models/attention.py:distributed_decode_attention).
// The output's arithmetic is the same with or without it.
//
// Bodies (rt_decode_body, kernels/decode_attn.py:body).  bf16, every Dh
// the kernels take (64, 80, 128, 192, 256, all multiples of 16), runs on
// the tensor cores: a warp tile is 16 slots of K and V, copied by cp.async
// (zero-filled past n) into a kDecStages-deep ring of the warp's own
// shared memory, rows padded by 16 bytes so ldmatrix is free of bank
// conflicts.  S = Q·Kᵀ and P·V are mma.sync.m16n8k16 with the G query
// heads padded to 16 rows (32 when G > 16); K goes in by ldmatrix, V by
// ldmatrix.trans, P stays in registers as the A fragment and is split
// into bf16 hi + lo so P·V keeps the f32 reference's tolerance (the
// doubled product costs nothing in a kernel bound by bytes).  f32 runs on
// the CUDA cores: a warp tile is 32 slots, lane j scores slot j from its
// K row read into registers, and each lane accumulates (head, 4-dim)
// pairs of P·V from V rows read into registers; only Q, P (G x 32) and the
// tile's row indices sit in shared memory.
//
// What still holds it back (chip_smoke.py on an H100 SXM, 700 W): at the
// main shape the kernel takes about 1.7x its bound; the rule's L = 512
// runs the 256 live blocks as one wave at two blocks an SM (109 KB of
// shared memory a block at Dh = 128); halving L (two waves) or doubling
// it (half the SMs busy) is slower.  Not measured, but the likely rest:
// each block waits a full memory latency for its first tile and drains
// its last with no block behind it on the SM to hide either.  Short rows pay the same fixed costs on
// less data: the serve run's rows (about 6000 live slots over 8 rows)
// take about 2.6x their bound.  A persistent grid that keeps every SM
// streaming, or TMA copies that need no registers, are the next steps;
// the decode step around the kernel is bound by the host.
//
// int8 caches (rt_flash_decode_int8, rt_paged_flash_decode_int8).  The
// reference's int8 KV variant stores K and V as int8 codes with one f32
// scale per (slot, kv head) and dequantizes in jnp before its decode
// (repro/models/attention.py, scopes vmem_fused:flash_decode_int8 and
// vmem_fused:paged_flash_decode_int8).  Here the same body takes KV =
// int8_t: a block streams the code rows (Dh bytes, still 16-byte
// cp.async chunks) and the tile's scales, and forms code * scale in f32,
// rounded to q's type, which is dequantize_kv(codes, scale, q.dtype)
// bit for bit.  On the tensor cores a warp converts each landed tile into
// a bf16 tile of its own beside its ring, and the rest of the body runs
// unchanged on it; on the CUDA cores the products are formed as the rows
// are read.  So the int8 kernel gives the bits of the bf16 (or f32)
// kernel run on the dequantized cache with the same plan, and reads about
// half the bytes: at B = 8, context 2048 and Qwen3-14B's widths 33.5 MB
// of codes and 1.05 MB of scales.  The split rule is the float kernels'
// (the plan is keyed on q's dtype and Dh alone).  Measured there
// (chip_smoke.py, H100 SXM, 700 W) it takes about 2.9x that bound, only
// 10% less than the bf16 kernel: a warp converts each tile after it lands
// and before its products, with nothing overlapping the conversion, and
// at context 1024 in a serve step (two live splits, one block an SM) it
// is slower than the bf16 kernel.  Converting the next tile while the
// tensor cores work on this one is the next step.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int kDecThreads = 128;  // four warps
constexpr int kDecWarps = kDecThreads / 32;
// most G * Dh a kv head's query heads span: 2048, and G <= 16 at Dh 192
// and 256 (3072 and 4096: nemotron-4-340b's G = 12, recurrentgemma's
// G = 10).  Per head dim, so the f32 body's register arrays stay the size
// they were at Dh 64, 80 and 128.  A multiple of 128: the f32 body gives
// each lane dec_max_gd / 128 (head, chunk) pairs.
__host__ __device__ constexpr int dec_max_gd(int DH) {
  return DH == 256 ? 4096 : DH == 192 ? 3072 : 2048;
}
constexpr int kDecQuantum = 128;  // L is a multiple of this
constexpr int kDecMaxSplit = 64;
constexpr int kDecStages = 3;     // cp.async ring depth (tensor-core body)
constexpr int kTcTile = 16;       // slots of a warp tile, tensor-core body
constexpr int kCcTile = 32;       // slots of a warp tile, CUDA-core body
static_assert(kDecQuantum % (kDecWarps * kCcTile) == 0 &&
                  kDecQuantum % (kDecWarps * kTcTile) == 0,
              "a split is whole warp tiles");

// Contiguous caches (B, S, Hkv, Dh): slot s of row b is cache row b*S + s.
struct ContiguousSlots {
  int S;
  __device__ __forceinline__ size_t row(int b, int s) const {
    return (size_t)b * S + s;
  }
};

// Paged pools (n_pages, page, Hkv, Dh): slot s of row b lives in page
// block_tables[b, s / page] (clipped into the pool) at offset s % page.
struct PagedSlots {
  const int* block_tables;
  int n_p, page, n_pages;
  __device__ __forceinline__ size_t row(int b, int s) const {
    int pg = block_tables[(size_t)b * n_p + s / page];
    pg = min(max(pg, 0), n_pages - 1);
    return (size_t)pg * page + s % page;
  }
};

// q: (B, H, Dh); out: (B, H, Dh); part: (B, H, n_split, Dh + 2) f32
// scratch (unused when n_split == 1); arrivals: (B, Hkv) int32, zero
// between launches.  s_len is the request-level cache length.  K and V
// hold KV elements: T, or int8 codes with f32 scales (one per cache row
// and kv head, k_scale[row * Hkv + kvh]; null for a float cache).
template <typename T, typename KV = T>
struct DecodeArgs {
  const T* q;
  const KV* k;
  const KV* v;
  const float* k_scale;
  const float* v_scale;
  const int* pos;
  T* out;
  float* lse;  // (B, H) f32, natural log; null: not written
  float* part;
  int* arrivals;
  int H, Hkv, G, s_len, ring, L, n_split;
  float scale_log2;  // log2(e) / sqrt(Dh)
};

template <typename KV>
constexpr bool kInt8Kv = std::is_same<KV, int8_t>::value;

struct BlockRange {
  int b, kvh, split;
  int n;       // live slots of the row
  int n_live;  // splits holding live slots
  int start, end;
};

__device__ __forceinline__ BlockRange block_range(const int* pos, int s_len,
                                                  int ring, int L) {
  BlockRange r;
  r.split = blockIdx.x;
  r.kvh = blockIdx.y;
  r.b = blockIdx.z;
  const int p = pos[r.b];
  r.n = (ring && p >= s_len) ? s_len : min(s_len, p + 1);
  r.n_live = r.n > 0 ? (r.n + L - 1) / L : 0;
  r.start = r.split * L;
  r.end = min(r.start + L, r.n);
  return r;
}

// True when the block has nothing to stream; block 0 of a row with no
// live slot writes its zeros.
template <typename T, typename KV>
__device__ __forceinline__ bool block_is_empty(const DecodeArgs<T, KV>& a,
                                               const BlockRange& r, int DH) {
  if (r.split < r.n_live) return false;
  if (r.n_live == 0 && r.split == 0) {
    const size_t head0 = (size_t)r.b * a.H + (size_t)r.kvh * a.G;
    T* ob = a.out + head0 * DH;
    for (int idx = threadIdx.x; idx < a.G * DH; idx += kDecThreads)
      ob[idx] = from_f<T>(0.f);
    if (a.lse != nullptr)
      for (int g = threadIdx.x; g < a.G; g += kDecThreads)
        a.lse[head0 + g] = -INFINITY;
  }
  return true;
}

// The log-sum-exp of a (row, head)'s scaled scores in natural-log units,
// from the merged max M (log2 units, the scores times log2(e) / sqrt(Dh))
// and the sum l of 2^(s - M) over the live slots: ln 2 (M + log2 l).
__device__ __forceinline__ float lse_of(float M, float l) {
  return 0.6931471805599453f * (M + log2f(l));
}

// floats of the merge area: the warps' acc, m and l, and the cross-split
// weights
__host__ __device__ constexpr size_t merge_floats(int G, int DH) {
  return (size_t)kDecWarps * G * DH + 2 * kDecWarps * G +
         (size_t)kDecMaxSplit * G;
}

// The block's warps have written their (acc, m, l) to ws; merge them in
// warp order, then write the output (one live split) or the partial, and
// let the last block of the (b, kvh) merge the partials in split order.
template <typename T, int DH, typename KV>
__device__ void finish_block(float* ws, const DecodeArgs<T, KV>& a,
                             const BlockRange& r) {
  const int G = a.G, GD = G * DH, tid = threadIdx.x;
  const float* Wacc = ws;
  const float* Wm = ws + kDecWarps * GD;
  const float* Wl = Wm + kDecWarps * G;
  float* Wt = ws + kDecWarps * GD + 2 * kDecWarps * G;  // [split][G]
  constexpr int DP = DH + 2;
  const size_t head0 = (size_t)r.b * a.H + (size_t)r.kvh * G;
  T* ob = a.out + head0 * DH;
  __syncthreads();
  for (int idx = tid; idx < GD; idx += kDecThreads) {
    const int g = idx / DH, d = idx - g * DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, Wm[w * G + g]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float e = exp2f(Wm[w * G + g] - M);
      l += e * Wl[w * G + g];
      acc += e * Wacc[w * GD + idx];
    }
    if (r.n_live == 1) {
      ob[idx] = from_f<T>(acc / fmaxf(l, 1e-30f));
      if (a.lse != nullptr && d == 0) a.lse[head0 + g] = lse_of(M, l);
    } else {
      float* pp = a.part + ((head0 + g) * a.n_split + r.split) * DP;
      pp[d] = acc;
      if (d == 0) {
        pp[DH] = M;
        pp[DH + 1] = l;
      }
    }
  }
  if (r.n_live == 1) return;

  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.arrivals + (size_t)r.b * a.Hkv + r.kvh;
    is_last = atomicAdd(cnt, 1) == r.n_live - 1;
    if (is_last) *cnt = 0;  // every live block has arrived
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int g = tid; g < G; g += kDecThreads) {
    const float* pg = a.part + (head0 + g) * a.n_split * DP;
    float M = -INFINITY;
    for (int i = 0; i < r.n_live; ++i) M = fmaxf(M, __ldcg(pg + i * DP + DH));
    float l = 0.f;
    for (int i = 0; i < r.n_live; ++i)
      l += exp2f(__ldcg(pg + i * DP + DH) - M) * __ldcg(pg + i * DP + DH + 1);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if (a.lse != nullptr) a.lse[head0 + g] = lse_of(M, l);
    for (int i = 0; i < r.n_live; ++i)
      Wt[i * G + g] = exp2f(__ldcg(pg + i * DP + DH) - M) * inv;
  }
  __syncthreads();
  for (int idx = tid; idx < GD; idx += kDecThreads) {
    const int g = idx / DH, d = idx - g * DH;
    const float* pg = a.part + (head0 + g) * a.n_split * DP + d;
    float acc = 0.f;
    for (int i = 0; i < r.n_live; ++i)
      acc += Wt[i * G + g] * __ldcg(pg + i * DP);
    ob[idx] = from_f<T>(acc);
  }
}

// ------------------------------------------------ tensor-core body (bf16)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += A (16 x 16 bf16, row) · B (16 x 8 bf16, col).  Lane t
// holds A rows t/4 and t/4 + 8 (a0/a2 and a1/a3, columns 2(t%4) + {0,1}
// and + 8), B column t/4 at rows 2(t%4) + {0,1} (b0) and + 8 (b1), and d
// at rows t/4 (d0, d1) and t/4 + 8 (d2, d3), columns 2(t%4) + {0,1}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's shared memory in the tensor-core body.  Float caches: a ring
// of kDecStages stages, each a bf16 K tile and a V tile of kTcTile rows
// padded to RB bytes.  int8 caches: each stage holds the K and V code
// tiles (kTcTile rows of DH bytes) and their kTcTile + kTcTile f32
// scales, and after the ring one bf16 K tile and one V tile, which the
// warp fills from the stage it is about to use.
template <int DH, bool Q8>
struct TcLayout {
  static constexpr int RB = DH * 2 + 16;            // padded row bytes
  static constexpr int CH = DH / 8;                 // 16-byte chunks a row
  static constexpr int TILE = kTcTile * RB;         // one K or V tile
  static constexpr int CTILE = kTcTile * DH;        // one int8 code tile
  static constexpr int STAGE = Q8 ? 2 * CTILE + 2 * kTcTile * 4 : 2 * TILE;
  static constexpr int WARP_RING = kDecStages * STAGE + (Q8 ? 2 * TILE : 0);
  static_assert((kTcTile * CH) % 32 == 0, "whole copies a lane");
  static_assert((2 * kTcTile * (DH / 16)) % 32 == 0, "whole code copies");
};

// dynamic shared memory of the tensor-core body: Q rows, then the warps'
// rings, which the merge area reuses once the slot loop is done
template <int DH, bool Q8>
constexpr size_t tc_smem_bytes(int MT, int G) {
  using Lay = TcLayout<DH, Q8>;
  const size_t ring = (size_t)kDecWarps * Lay::WARP_RING;
  const size_t merge = sizeof(float) * merge_floats(G, DH);
  return 16 * MT * (size_t)Lay::RB + (ring > merge ? ring : merge);
}

// 4-byte copy to shared memory (the scales), zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <int DH, int MT, typename KV, typename Slots>
__device__ void decode_body(const DecodeArgs<__nv_bfloat16, KV>& a,
                            Slots slots) {
  using bf16 = __nv_bfloat16;
  constexpr bool Q8 = kInt8Kv<KV>;
  using Lay = TcLayout<DH, Q8>;
  constexpr int RB = Lay::RB, CH = Lay::CH, NB = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockRange r = block_range(a.pos, a.s_len, a.ring, a.L);
  if (block_is_empty(a, r, DH)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G;

  // Q rows g < G of this kv head, zero rows up to 16 MT
  unsigned char* qs = smem_raw;
  unsigned char* ring = smem_raw + 16 * MT * RB;
  const bf16* qb = a.q + ((size_t)r.b * a.H + (size_t)r.kvh * G) * DH;
  for (int idx = tid; idx < 16 * MT * CH; idx += kDecThreads) {
    const int row = idx / CH, c = idx - row * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < G) val = ld16(qb + (size_t)row * DH + c * 8);
    *reinterpret_cast<uint4*>(qs + row * RB + c * 16) = val;
  }
  __syncthreads();
  const uint32_t qs_s = sm90::smem_addr(qs);
  unsigned char* wring = ring + warp * Lay::WARP_RING;
  const uint32_t ring_s = sm90::smem_addr(wring);

  // this warp's tiles: t-th starts at start + (warp + 4 t) * kTcTile
  const int span = r.end - r.start;
  constexpr int STEP = kDecWarps * kTcTile;
  const int nt = span > warp * kTcTile
                     ? (span - warp * kTcTile + STEP - 1) / STEP : 0;
  const size_t hstride = (size_t)a.Hkv * DH;
  const KV* kbase = a.k + (size_t)r.kvh * DH;
  const KV* vbase = a.v + (size_t)r.kvh * DH;

  auto issue = [&](int t) {
    const int s0 = r.start + (warp + kDecWarps * t) * kTcTile;
    const uint32_t kdst = ring_s + (t % kDecStages) * Lay::STAGE;
    const int my_s = s0 + (lane & (kTcTile - 1));
    const unsigned long long my_row =
        my_s < r.end ? (unsigned long long)slots.row(r.b, my_s) : 0ull;
    if constexpr (Q8) {
      // K then V codes, 16-byte chunks of DH-byte rows; lanes 0-15 the K
      // scales of the tile's slots, lanes 16-31 the V scales
      constexpr int C8 = DH / 16, PER = kTcTile * C8;
#pragma unroll
      for (int i = 0; i < 2 * PER / 32; ++i) {
        const int idx = lane + 32 * i;
        const int kv = idx / PER, rem = idx - kv * PER;
        const int j = rem / C8, c = rem - j * C8;
        const unsigned long long row = __shfl_sync(0xffffffffu, my_row, j);
        const bool ok = s0 + j < r.end;
        const KV* base = kv ? vbase : kbase;
        sm90::cp_async16(kdst + kv * Lay::CTILE + j * DH + c * 16,
                         ok ? base + (size_t)row * hstride + c * 16 : base,
                         ok);
      }
      const bool ok = my_s < r.end;
      const float* sbase = (lane < kTcTile ? a.k_scale : a.v_scale) + r.kvh;
      cp_async4(kdst + 2 * Lay::CTILE + lane * 4,
                ok ? sbase + (size_t)my_row * a.Hkv : sbase, ok);
    } else {
      const uint32_t vdst = kdst + Lay::TILE;
#pragma unroll
      for (int i = 0; i < kTcTile * CH / 32; ++i) {
        const int idx = lane + 32 * i;
        const int j = idx / CH, c = idx - j * CH;
        const unsigned long long row = __shfl_sync(0xffffffffu, my_row, j);
        const bool ok = s0 + j < r.end;
        const size_t off = (size_t)row * hstride + c * 8;
        sm90::cp_async16(kdst + j * RB + c * 16, ok ? kbase + off : kbase,
                         ok);
        sm90::cp_async16(vdst + j * RB + c * 16, ok ? vbase + off : vbase,
                         ok);
      }
    }
  };

  float o[MT][NB][4];
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nb][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = -INFINITY;
      l_r[mt][h] = 0.f;
    }
  }

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < nt) issue(t);
    sm90::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    if (t + kDecStages - 1 < nt) issue(t + kDecStages - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kDecStages - 1>();
    __syncwarp();
    uint32_t ks = ring_s + (t % kDecStages) * Lay::STAGE;
    if constexpr (Q8) {
      // dequantize the landed codes into the warp's bf16 tiles:
      // bf16(code * scale), as dequantize_kv(codes, scale, bf16) rounds
      constexpr int C8 = DH / 16, PER = kTcTile * C8;
      const unsigned char* st = wring + (t % kDecStages) * Lay::STAGE;
      const float* sc = reinterpret_cast<const float*>(st + 2 * Lay::CTILE);
      unsigned char* cvt = wring + kDecStages * Lay::STAGE;
#pragma unroll
      for (int i = 0; i < 2 * PER / 32; ++i) {
        const int idx = lane + 32 * i;
        const int kv = idx / PER, rem = idx - kv * PER;
        const int j = rem / C8, c = rem - j * C8;
        const uint4 u = *reinterpret_cast<const uint4*>(
            st + kv * Lay::CTILE + j * DH + c * 16);
        const float s = sc[kv * kTcTile + j];
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
        uint32_t o8[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b0 = (int)(signed char)(w[e] & 0xff);
          const int b1 = (int)(signed char)((w[e] >> 8) & 0xff);
          const int b2 = (int)(signed char)((w[e] >> 16) & 0xff);
          const int b3 = (int)(signed char)(w[e] >> 24);
          o8[2 * e] = sm90::pack_bf16((float)b0 * s, (float)b1 * s);
          o8[2 * e + 1] = sm90::pack_bf16((float)b2 * s, (float)b3 * s);
        }
        uint4* dst = reinterpret_cast<uint4*>(cvt + kv * Lay::TILE + j * RB +
                                              c * 32);
        dst[0] = make_uint4(o8[0], o8[1], o8[2], o8[3]);
        dst[1] = make_uint4(o8[4], o8[5], o8[6], o8[7]);
      }
      __syncwarp();
      ks = sm90::smem_addr(cvt);
    }
    const uint32_t vs = ks + Lay::TILE;
    const int s0 = r.start + (warp + kDecWarps * t) * kTcTile;

    // S = Q·Kᵀ: 16 MT rows by the tile's 16 slots (two n8 blocks)
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][0][e] = s[mt][1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + ((lane >> 4) * 8 + (lane & 7)) * RB +
                          (kk * 2 + ((lane >> 3) & 1)) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qs_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   RB + (kk * 2 + (lane >> 4)) * 16);
        mma_bf16(s[mt][0], qa, kb[0], kb[1]);
        mma_bf16(s[mt][1], qa, kb[2], kb[3]);
      }
    }

    // online softmax in log2 units; slot s0 is live, so every row's
    // maximum is finite
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = s0 + nb * 8 + 2 * (lane & 3) + (e & 1);
          s[mt][nb][e] = slot < r.end ? s[mt][nb][e] * a.scale_log2
                                      : -INFINITY;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]),
                         fmaxf(s[mt][1][2 * h], s[mt][1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_r[mt][h], mx);
        const float al = sm90::exp2_ftz(m_r[mt][h] - mn);
        m_r[mt][h] = mn;
        float ps = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[mt][nb][e] = sm90::exp2_ftz(s[mt][nb][e] - mn);
            ps += s[mt][nb][e];
          }
        l_r[mt][h] = l_r[mt][h] * al + ps;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          o[mt][nb][2 * h] *= al;
          o[mt][nb][2 * h + 1] *= al;
        }
      }
      // the S fragment of the two n8 blocks is P's A fragment
      sm90::split_bf16(s[mt][0][0], s[mt][0][1], ph[mt][0], pl[mt][0]);
      sm90::split_bf16(s[mt][0][2], s[mt][0][3], ph[mt][1], pl[mt][1]);
      sm90::split_bf16(s[mt][1][0], s[mt][1][1], ph[mt][2], pl[mt][2]);
      sm90::split_bf16(s[mt][1][2], s[mt][1][3], ph[mt][3], pl[mt][3]);
    }

    // O += P·V, P as hi + lo
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RB +
                                (2 * j + (lane >> 4)) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * j], ph[mt], vb[0], vb[1]);
        mma_bf16(o[mt][2 * j], pl[mt], vb[0], vb[1]);
        mma_bf16(o[mt][2 * j + 1], ph[mt], vb[2], vb[3]);
        mma_bf16(o[mt][2 * j + 1], pl[mt], vb[2], vb[3]);
      }
    }
    __syncwarp();
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the merge area

  float* ws = reinterpret_cast<float*>(ring);
  const int GD = G * DH;
  float* Wm = ws + kDecWarps * GD;
  float* Wl = Wm + kDecWarps * G;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int g = mt * 16 + h * 8 + lane / 4;
      if (g < G) {
        if ((lane & 3) == 0) {
          Wm[warp * G + g] = m_r[mt][h];
          Wl[warp * G + g] = l;
        }
        float* wa = ws + warp * GD + g * DH + 2 * (lane & 3);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          wa[nb * 8] = o[mt][nb][2 * h];
          wa[nb * 8 + 1] = o[mt][nb][2 * h + 1];
        }
      }
    }
  finish_block<bf16, DH>(ws, a, r);
}

// ------------------------------------------------ CUDA-core body (f32)
// Four K or V elements of a row as f32: a float4, or four int8 codes
// times the row's scale (dequantize_kv's product).
__device__ __forceinline__ float4 load4(const float* p, float) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const int8_t* p, float s) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  return make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s,
                     (float)c.w * s);
}

// dynamic shared memory of the CUDA-core body: Q, the tile's row indices,
// P, the rescale factors and the tile's V scales of each warp, and the
// merge area
constexpr size_t cc_smem_bytes(int DH, int G) {
  return sizeof(float) * ((size_t)G * DH) +
         sizeof(unsigned long long) * kDecWarps * kCcTile +
         sizeof(float) * ((size_t)kDecWarps * G * kCcTile + kDecWarps * G +
                          kDecWarps * kCcTile + merge_floats(G, DH));
}

// Both bodies fit the 227 KB of shared memory a block may opt into at the
// largest G each head dim takes (the rings do not depend on G; the merge
// area and the f32 body's Q and P do): 206 KB for the bf16 ring at Dh 256,
// 172 KB for its int8 ring, 94 KB for the f32 body at G = 16; at Dh 192
// 156 KB, 130 KB and 74 KB.
constexpr size_t kSmemOptIn = 227 * 1024;
static_assert(tc_smem_bytes<256, false>(1, 16) <= kSmemOptIn &&
                  tc_smem_bytes<256, true>(1, 16) <= kSmemOptIn &&
                  tc_smem_bytes<192, false>(1, 16) <= kSmemOptIn &&
                  tc_smem_bytes<192, true>(1, 16) <= kSmemOptIn &&
                  cc_smem_bytes(192, 16) <= kSmemOptIn &&
                  tc_smem_bytes<128, false>(1, 16) <= kSmemOptIn &&
                  tc_smem_bytes<64, false>(2, 32) <= kSmemOptIn &&
                  tc_smem_bytes<80, false>(2, 25) <= kSmemOptIn &&
                  cc_smem_bytes(256, 16) <= kSmemOptIn &&
                  cc_smem_bytes(64, 32) <= kSmemOptIn,
              "a decode block's shared memory exceeds the opt-in limit");

template <int DH, int MT, typename KV, typename Slots>
__device__ void decode_body(const DecodeArgs<float, KV>& a, Slots slots) {
  constexpr bool Q8 = kInt8Kv<KV>;
  constexpr int C = DH / 4;                  // float4 chunks of a row
  constexpr int GM = dec_max_gd(DH) / DH;       // most heads of a kv head
  constexpr int NP = dec_max_gd(DH) / 4 / 32;   // (head, chunk) pairs a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockRange r = block_range(a.pos, a.s_len, a.ring, a.L);
  if (block_is_empty(a, r, DH)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, GC = G * C;

  float* Qs = reinterpret_cast<float*>(smem_raw);                  // [G][DH]
  unsigned long long* Rs =
      reinterpret_cast<unsigned long long*>(Qs + G * DH);          // [W][32]
  float* Ps = reinterpret_cast<float*>(Rs + kDecWarps * kCcTile);  // [W][G][32]
  float* As = Ps + kDecWarps * G * kCcTile;                        // [W][G]
  float* Vs = As + kDecWarps * G;                                  // [W][32]
  float* ws = Vs + kDecWarps * kCcTile;
  Rs += warp * kCcTile;
  Ps += warp * G * kCcTile;
  As += warp * G;
  Vs += warp * kCcTile;

  const float* qb = a.q + ((size_t)r.b * a.H + (size_t)r.kvh * G) * DH;
  for (int idx = tid; idx < G * DH; idx += kDecThreads) Qs[idx] = qb[idx];
  __syncthreads();

  const int span = r.end - r.start;
  constexpr int STEP = kDecWarps * kCcTile;
  const int nt = span > warp * kCcTile
                     ? (span - warp * kCcTile + STEP - 1) / STEP : 0;
  const size_t hstride = (size_t)a.Hkv * DH;
  const KV* kbase = a.k + (size_t)r.kvh * DH;
  const KV* vbase = a.v + (size_t)r.kvh * DH;

  float m[GM], l[GM];
  float4 acc[NP];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < nt; ++t) {
    const int s0 = r.start + (warp + kDecWarps * t) * kCcTile;
    const int s = s0 + lane;
    const bool ok = s < r.end;
    const size_t row = ok ? slots.row(r.b, s) : 0;
    Rs[lane] = row;
    float ksc = 1.f;
    if constexpr (Q8) {
      ksc = ok ? __ldg(a.k_scale + row * a.Hkv + r.kvh) : 0.f;
      Vs[lane] = ok ? __ldg(a.v_scale + row * a.Hkv + r.kvh) : 0.f;
    }

    // lane j scores slot s0 + j against the G heads
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    if (ok) {
      const KV* kr = kbase + row * hstride;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 kv = load4(kr + 4 * c, ksc);
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(Qs + g * DH +
                                                               4 * c);
            sc[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        const float x = ok ? sc[g] * a.scale_log2 : -INFINITY;
        const float mn = fmaxf(m[g], warp_max(x));  // lane 0 is live
        const float al = exp2f(m[g] - mn);
        const float p = exp2f(x - mn);
        l[g] = l[g] * al + warp_sum(p);
        m[g] = mn;
        Ps[g * kCcTile + lane] = p;
        if (lane == 0) As[g] = al;
      }
    __syncwarp();

    // lane owns (head, chunk) pairs lane, lane + 32, ... of G x C
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int idx = lane + 32 * i;
      if (idx < GC) {
        const float al = As[idx / C];
        acc[i].x *= al;
        acc[i].y *= al;
        acc[i].z *= al;
        acc[i].w *= al;
      }
    }
    const int nj = min(kCcTile, r.end - s0);
    for (int j = 0; j < nj; ++j) {
      const KV* vr = vbase + (size_t)Rs[j] * hstride;
      const float vsc = Q8 ? Vs[j] : 1.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int idx = lane + 32 * i;
        if (idx < GC) {
          const int g = idx / C, c = idx - g * C;
          const float4 vv = load4(vr + 4 * c, vsc);
          const float p = Ps[g * kCcTile + j];
          acc[i].x += p * vv.x;
          acc[i].y += p * vv.y;
          acc[i].z += p * vv.z;
          acc[i].w += p * vv.w;
        }
      }
    }
    __syncwarp();
  }

  const int GD = G * DH;
  float* Wm = ws + kDecWarps * GD;
  float* Wl = Wm + kDecWarps * G;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        Wm[warp * G + g] = m[g];
        Wl[warp * G + g] = l[g];
      }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int idx = lane + 32 * i;
    if (idx < GC) *reinterpret_cast<float4*>(ws + warp * GD + 4 * idx) = acc[i];
  }
  finish_block<float, DH>(ws, a, r);
}

// ------------------------------------------------------------- host side
inline bool decode_shape_ok(int H, int Hkv, int DH) {
  return Hkv > 0 && H % Hkv == 0 && (H / Hkv) * DH <= dec_max_gd(DH);
}

// The plan the host chose (kernels/decode_attn.py:plan) must cover the
// cache with whole quanta and no split past it.
inline bool decode_plan_ok(int s_len, int L, int n_split) {
  return s_len > 0 && L > 0 && L % kDecQuantum == 0 && n_split >= 1 &&
         n_split <= kDecMaxSplit && (long long)n_split * L >= s_len &&
         (long long)(n_split - 1) * L < s_len;
}

// Calls f(Inst<DH, MT>{}) for the body instance that takes (Dh, G): MT
// 16-row tiles of query heads on the tensor cores (1 for f32).
template <int D, int M>
struct Inst {
  static constexpr int DH = D, MT = M;
};

template <typename T, typename F>
inline int with_instance(int Dh, int G, F&& f) {
  if constexpr (sizeof(T) == 2) {
    if (G > 16 && Dh == 64) return f(Inst<64, 2>{});
    if (G > 16 && Dh == 80) return f(Inst<80, 2>{});
  }
  switch (Dh) {  // G * Dh <= dec_max_gd: G <= 16 at Dh 128, 192 and 256
    case 64: return f(Inst<64, 1>{});
    case 80: return f(Inst<80, 1>{});
    case 128: return f(Inst<128, 1>{});
    case 192: return f(Inst<192, 1>{});
    case 256: return f(Inst<256, 1>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV, int DH, int MT>
inline size_t decode_smem_bytes(int G) {
  if constexpr (sizeof(T) == 2) return tc_smem_bytes<DH, kInt8Kv<KV>>(MT, G);
  return cc_smem_bytes(DH, G);
}

// Fills the launch arguments shared by both kernels; k_scale and v_scale
// are null for a float cache.
template <typename T, typename KV = T>
inline DecodeArgs<T, KV> decode_args(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* pos,
                                     void* out, void* part, void* arrivals,
                                     int H, int Hkv, int Dh, int s_len,
                                     int ring, int L, int n_split,
                                     void* lse = nullptr) {
  DecodeArgs<T, KV> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const KV*>(k);
  a.v = static_cast<const KV*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<T*>(out);
  a.lse = static_cast<float*>(lse);
  a.part = static_cast<float*>(part);
  a.arrivals = static_cast<int*>(arrivals);
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.s_len = s_len;
  a.ring = ring;
  a.L = L;
  a.n_split = n_split;
  a.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(Dh));
  return a;
}

// Launches Kernels::get<T, KV, DH, MT>() (the calling source's __global__
// template at the body instance that takes Dh and G) over the grid
// (n_split, Hkv, B), after checking the shape and the plan.
template <typename T, typename KV, typename Kernels, typename Slots>
inline int launch_decode(const DecodeArgs<T, KV>& a, Slots slots, int B,
                         int Dh, cudaStream_t stream) {
  if (!decode_shape_ok(a.H, a.Hkv, Dh) ||
      !decode_plan_ok(a.s_len, a.L, a.n_split) ||
      (a.n_split > 1 && (a.part == nullptr || a.arrivals == nullptr)) ||
      (kInt8Kv<KV> && (a.k_scale == nullptr || a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  return with_instance<T>(Dh, a.G, [&](auto inst) -> int {
    constexpr int DH = decltype(inst)::DH, MT = decltype(inst)::MT;
    auto kern = Kernels::template get<T, KV, DH, MT>();
    const size_t smem = decode_smem_bytes<T, KV, DH, MT>(a.G);
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.n_split, a.Hkv, B), kDecThreads, smem, stream>>>(a, slots);
    return cudaGetLastError();
  });
}

}  // namespace rt
