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
// vmem_fused:paged_flash_decode_int8).  Here a block streams the code
// rows (Dh bytes, 16-byte cp.async chunks) and the tile's scales, and
// forms bf16(f32(code) * scale), which is dequantize_kv(codes, scale,
// q.dtype) bit for bit; the split rule is the float kernels' (the plan is
// keyed on q's dtype and Dh alone).  So the int8 kernel gives the bits of
// the bf16 (or f32) kernel run on the dequantized cache with the same
// plan, and reads about half the bytes: at B = 8, context 2048 and
// Qwen3-14B's widths 33.5 MB of codes and 1.05 MB of scales, 0.0104 ms.
//
// The scales are not folded out of the element path (K's onto the score
// column, V's into P): that would save the multiply but change the bits
// and the rounding against the reference's dequantize-then-attend.
//
// On the tensor cores the conversion is what bounds it: 4096 codes a
// warp tile against 48 mma.  So no code goes through an integer-to-float
// conversion (a quarter of the f32 rate on sm_90): a byte permute puts
// code + 128 into the mantissa of 2^23 and one add takes 2^23 + 128 off
// (code_f32, exact for all 256 codes), one multiply by the slot's scale
// and one bf16x2 pack round a pair (dequant2; kernels/ref.py:
// dequantize_kv_magic is the same route in torch).  A lane builds its
// mma B fragments in registers straight from the code stage, with no
// bf16 tile and no second trip through shared memory: K's as ldmatrix
// gives them, from two 4-byte reads a row and k16 step; V's (ldmatrix.
// trans's layout) with the columns of each n8 block mapped to head dims
// so that a lane's codes are whole 16-, 8- or 2-byte units of its four
// slot rows.  The loop is software-pipelined: one basic block runs tile
// t's softmax and P·V beside tile t + 1's S = Q·Kᵀ and its K and V
// conversion, so the compiler interleaves the conversion with both
// tiles' dependent chains.  Q rides in tile 0's cp.async group.  The ring
// holds 5 stages of 16-slot code tiles at Dh 64 and 128 (6 at 80) in the
// float ring's bytes, and 4 at Dh 192, 3 at 256, so two blocks share an
// SM where the float kernel runs one; code rows are padded to an odd
// number of 16-byte chunks and the accumulators leave as float4 runs, so
// no fragment read or merge write has a bank conflict.  ptxas: 96-255
// registers, no spills, in every int8 instance (kernels/ptxas.py); their
// SASS holds no I2F on the element path (the three to nine I2F of an
// instance are the integer divisions of block_range and the merge, as
// many as in the bf16 instances).
//
// Measured (tools/decode_ab.py, parent checkout and this one in one call,
// H100 80GB HBM3, 700 W): at B = 8, context 2048 of 4096 and Qwen3-14B's
// widths 0.0250 ms paged and 0.0237 ms contiguous (0.0307 and 0.0290
// before), 2.3-2.4x the bound and below the bf16 kernels' 0.034; at
// nemotron-4-340b's Dh 192, G 12, 0.0425 and 0.0408 (0.0748 and 0.0723
// before); at context 1024 (two live splits, 128 blocks, one an SM)
// 0.0238 and 0.0228 against the bf16 kernels' 0.0211 and 0.0199.  In a
// profiled Qwen3-14B step at context 1024 (chip_smoke.py) the 40 paged
// calls take 0.96 ms, the bf16 kernel's 0.97.  What holds it back (the
// RT_DECODE_PHASES profile, clock cycles of a warp): at context 2048 a
// tile takes 2334, about 1000 instructions (the conversion about 530 of
// them, the rescale of the accumulators 64) from two warps a scheduler,
// so it is bound by instruction issue; at context 1024 one warp a
// scheduler takes 1925 a tile, and the block's start (4.0 K) and merge
// (8.4 K, the split-KV merge the float kernels share) take as long as its
// 8 tiles.  Two variants with a converter warp beside each compute warp
// were measured and not kept: a bf16 K and V staging tile between them
// matched the bf16 kernel at context 1024 (0.0216 ms) but needs 131 KB
// a block, one block an SM, and took 0.035 ms at context 2048 (0.024
// with two code stages, two blocks an SM); a bf16 K tile alone (112 KB,
// two blocks an SM, 128 registers a thread) took 0.0253 and 0.0244 ms.
// On the CUDA cores the products are formed as the rows are read.
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

// A warp's shared memory in the tensor-core body over a float cache: a
// ring of kDecStages stages, each a bf16 K tile and a V tile of kTcTile
// rows padded to RB bytes.  The Q rows take the same padded rows.
template <int DH>
struct TcLayout {
  static constexpr int RB = DH * 2 + 16;            // padded row bytes
  static constexpr int CH = DH / 8;                 // 16-byte chunks a row
  static constexpr int TILE = kTcTile * RB;         // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int WARP_RING = kDecStages * STAGE;
  static_assert((kTcTile * CH) % 32 == 0, "whole copies a lane");
};

// ... over an int8 cache: each stage holds the K and the V code tile
// (kTcTile rows of DH bytes, padded to RB: an odd number of 16-byte
// chunks, so that the 8 rows one fragment load reads lie in 8 different
// bank groups) and their kTcTile + kTcTile f32 scales.  As many stages as
// fit in the float ring's bytes, which keeps as many bytes in flight as
// that ring, and no more than let two blocks share an SM (with their Q
// rows; at one block an SM half the 256 blocks of context 2048 wait for
// a second wave): 5 at Dh 64 and 128, 6 at Dh 80, 4 at Dh 192 and 3 at
// Dh 256, where the float ring runs one block an SM.  A lane reads
// its V codes in units of U bytes (units n, n + 8, ... of a row for lane
// 4n + q): 16 where DH is a multiple of 128, 8 where of 64, else 2.
constexpr int kSmemTwoBlocks = 115712;  // (228 KB - 2 x 1 KB) / 2
template <int DH>
struct Q8Layout {
  static constexpr int RB = DH + ((DH / 16) % 2 ? 0 : 16);
  static constexpr int CTILE = kTcTile * RB;        // one code tile
  static constexpr int STAGE = 2 * CTILE + 2 * kTcTile * 4;
  static constexpr int FIT_RING = TcLayout<DH>::WARP_RING / STAGE;
  static constexpr int FIT_TWO =
      (kSmemTwoBlocks - 16 * TcLayout<DH>::RB) / (kDecWarps * STAGE);
  static constexpr int STAGES = FIT_RING < FIT_TWO ? FIT_RING : FIT_TWO;
  static constexpr int WARP_RING = STAGES * STAGE;
  static constexpr int U = DH % 128 == 0 ? 16 : DH % 64 == 0 ? 8 : 2;
  static_assert(STAGES >= 3 && STAGE % 16 == 0, "a ring of whole stages");
  static_assert((DH / 8) % U == 0, "whole V units a lane");
};

// dynamic shared memory of the tensor-core body: Q rows, then the warps'
// rings, which the merge area reuses once the slot loop is done
template <int DH, bool Q8>
constexpr size_t tc_smem_bytes(int MT, int G) {
  const size_t ring = (size_t)kDecWarps *
                      (Q8 ? Q8Layout<DH>::WARP_RING : TcLayout<DH>::WARP_RING);
  const size_t merge = sizeof(float) * merge_floats(G, DH);
  return 16 * MT * (size_t)TcLayout<DH>::RB + (ring > merge ? ring : merge);
}

// 4-byte copy to shared memory (the scales), zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Q rows g < G of the block's kv head into shared memory at the padded
// row bytes, zero rows up to 16 MT, by cp.async (zero rows zero-filled)
// in the caller's next commit group; visible to the block after its wait
// and a __syncthreads.
template <int DH, int MT>
__device__ __forceinline__ void stage_q_async(uint32_t qs,
                                              const __nv_bfloat16* qb,
                                              int G) {
  constexpr int RB = TcLayout<DH>::RB, CH = TcLayout<DH>::CH;
  for (int idx = threadIdx.x; idx < 16 * MT * CH; idx += kDecThreads) {
    const int row = idx / CH, c = idx - row * CH;
    const bool ok = row < G;
    sm90::cp_async16(qs + row * RB + c * 16,
                     ok ? qb + (size_t)row * DH + c * 8 : qb, ok);
  }
}

// One tile's online softmax in log2 units: S scaled, slots at or past end
// masked (slot s0 is live, so every row's maximum is finite), (m, l)
// updated, o rescaled, and P left as its A fragments, split into bf16
// hi + lo.
template <int MT, int NB>
__device__ __forceinline__ void tile_softmax(
    float (&s)[MT][2][4], float (&m_r)[MT][2], float (&l_r)[MT][2],
    float (&o)[MT][NB][4], uint32_t (&ph)[MT][4], uint32_t (&pl)[MT][4],
    int s0, int end, float scale_log2, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = s0 + nb * 8 + 2 * (lane & 3) + (e & 1);
        s[mt][nb][e] = slot < end ? s[mt][nb][e] * scale_log2 : -INFINITY;
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
}

// After the int8 body's slot loop: the warps' (m, l, acc) into the merge
// area over the rings, then the block's merge (finish_block).  Column c
// of the accumulators' n8 block nb is head dim (c + 8 (nb / U)) U +
// nb % U (q8_v_codes), so lane q holds, for each i, the 2U dims from
// (2q + 8i) U of a row, and stores them as float4 (a scalar store of one
// column would put a row's 32 lanes on one bank).
template <int DH, int U, int MT, int NB, typename KV>
__device__ __forceinline__ void finish_tc(
    unsigned char* ring, const DecodeArgs<__nv_bfloat16, KV>& a,
    const BlockRange& r, const float (&o)[MT][NB][4],
    const float (&m_r)[MT][2], const float (&l_r)[MT][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the merge area
  float* ws = reinterpret_cast<float*>(ring);
  const int G = a.G, GD = G * DH;
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
        float* wa = ws + warp * GD + g * DH;
        static_assert(U % 2 == 0 && NB % U == 0, "float4 runs");
#pragma unroll
        for (int i = 0; i < NB / U; ++i) {
          float* run = wa + (2 * (lane & 3) + 8 * i) * U;
#pragma unroll
          for (int x = 0; x < 2 * U; x += 4) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = x + e < U ? o[mt][U * i + x + e][2 * h]
                               : o[mt][U * i + x + e - U][2 * h + 1];
            *reinterpret_cast<float4*>(run + x) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    }
  finish_block<__nv_bfloat16, DH>(ws, a, r);
}

// The tensor-core body over a bf16 cache.
template <int DH, int MT, typename Slots>
__device__ void decode_body(const DecodeArgs<__nv_bfloat16>& a, Slots slots) {
  using bf16 = __nv_bfloat16;
  using Lay = TcLayout<DH>;
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
  const bf16* kbase = a.k + (size_t)r.kvh * DH;
  const bf16* vbase = a.v + (size_t)r.kvh * DH;

  auto issue = [&](int t) {
    const int s0 = r.start + (warp + kDecWarps * t) * kTcTile;
    const uint32_t kdst = ring_s + (t % kDecStages) * Lay::STAGE;
    const int my_s = s0 + (lane & (kTcTile - 1));
    const unsigned long long my_row =
        my_s < r.end ? (unsigned long long)slots.row(r.b, my_s) : 0ull;
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
    const uint32_t ks = ring_s + (t % kDecStages) * Lay::STAGE;
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


// Phase profile of the int8 body, compiled in only with
// -DRT_DECODE_PHASES (tools/decode_ab.py --phases builds such a library
// beside the real one): lane 0 of each warp adds the clock cycles it
// spent in each phase to g_decode_phases, with its tile count and 1;
// rt_decode_phases (decode_attn.cu) reads or zeroes them.  The compiler
// may move arithmetic across the clock reads, so a phase counts what the
// compiled code does between two of them.
#ifdef RT_DECODE_PHASES
// before the slot loop (the first copies issued, Q staged, tile 0 waited
// for, its S issued and V converted), a step's copies issued, its wait
// for tile t + 1, its softmax and P·V with tile t + 1's front, and after
// the loop (the merge)
constexpr int kDecPhases = 5;
namespace {
__device__ unsigned long long g_decode_phases[kDecPhases + 2];
}
#define RT_DPHASE(i)                                                     \
  do {                                                                   \
    const long long now_ = clock64();                                    \
    ph_cyc[i] += now_ - ph_t;                                            \
    ph_t = now_;                                                         \
  } while (0)
#else
#define RT_DPHASE(i) \
  do {               \
  } while (0)
#endif

// The f32 value of byte i of g, a word of int8 codes each xor 0x80 (so
// the byte is u = code + 128): u put in the low mantissa bits of 2^23
// (0x4B000000 | u is 2^23 + u, exact), less 2^23 + 128.  One byte
// permute and one add, exact for all 256 codes: no integer-to-float
// conversion, which issues at a quarter of the f32 rate.  i is a
// constant wherever it is called.
__device__ __forceinline__ float code_f32(uint32_t g, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(g, 0x4B000000u, 0x7540u | i)),
                   8388736.f);
}

// Two codes times their slots' scales, each rounded to f32 and then to
// bf16 (dequantize_kv's two roundings: f32(code * scale), then q's
// dtype), as one register of a B fragment, the first in the low half.
__device__ __forceinline__ uint32_t dequant2(uint32_t g0, int i0, float s0,
                                             uint32_t g1, int i1, float s1) {
  return sm90::pack_bf16(__fmul_rn(code_f32(g0, i0), s0),
                         __fmul_rn(code_f32(g1, i1), s1));
}

// Whether the int8 body converts a tile's V fragments a step ahead (or,
// one n8 block at a time, inside P·V): only where the registers beside
// the accumulators hold two tiles' fragments without spilling.
__host__ __device__ constexpr bool q8_v_ahead(int DH) { return DH <= 128; }

// The tensor-core body over an int8 cache: the same tiles, warp
// assignment, products, softmax and merge as the bf16 body, with each
// lane's mma B fragments built in registers from the code tiles (no bf16
// tile).  K's fragments are the bf16 body's ldmatrix fragments, element
// for element.  V's n8 block nb takes, in column c, not head dim 8 nb + c
// but dim (c + 8 (nb / U)) U + nb % U, so that a lane's codes are whole
// U-byte units of a row; each output element still sums the same
// products in the same order, so the bits are the bf16 body's over the
// dequantized cache.
template <int DH, int MT, typename Slots>
__device__ void decode_body(const DecodeArgs<__nv_bfloat16, int8_t>& a,
                            Slots slots) {
  using Lay = Q8Layout<DH>;
  constexpr int RB = Lay::RB, NS = Lay::STAGES, U = Lay::U;
  constexpr int KB = DH / 16, NB = DH / 8, VW = (NB + 3) / 4;
  constexpr bool VA = q8_v_ahead(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockRange r = block_range(a.pos, a.s_len, a.ring, a.L);
  if (block_is_empty(a, r, DH)) return;
#ifdef RT_DECODE_PHASES
  unsigned long long ph_cyc[kDecPhases] = {};
  long long ph_t = clock64();
#endif
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = lane >> 2, q = lane & 3;
  const int G = a.G;

  unsigned char* ring = smem_raw + 16 * MT * TcLayout<DH>::RB;
  const uint32_t qs_s = sm90::smem_addr(smem_raw);
  constexpr int QRB = TcLayout<DH>::RB;
  unsigned char* wring = ring + warp * Lay::WARP_RING;
  const uint32_t ring_s = sm90::smem_addr(wring);

  const int span = r.end - r.start;
  constexpr int STEP = kDecWarps * kTcTile;
  const int nt = span > warp * kTcTile
                     ? (span - warp * kTcTile + STEP - 1) / STEP : 0;
  const size_t hstride = (size_t)a.Hkv * DH;
  const int8_t* kbase = a.k + (size_t)r.kvh * DH;
  const int8_t* vbase = a.v + (size_t)r.kvh * DH;

  // K then V codes, 16-byte chunks of DH-byte rows; lanes 0-15 the K
  // scales of the tile's slots, lanes 16-31 the V scales.  A cache row
  // index fits 32 bits (2^32 rows of at least 64 code bytes would not
  // fit the card), so one shuffle hands it to the lanes that copy it; a
  // slot past the end takes row 0, whose copy is zero-filled unread.
  auto issue = [&](int t) {
    const int s0 = r.start + (warp + kDecWarps * t) * kTcTile;
    const uint32_t dst = ring_s + (t % NS) * Lay::STAGE;
    const int my_s = s0 + (lane & (kTcTile - 1));
    const uint32_t my_row =
        my_s < r.end ? (uint32_t)slots.row(r.b, my_s) : 0u;
    constexpr int C16 = DH / 16, PER = kTcTile * C16;
#pragma unroll
    for (int i = 0; i < 2 * PER / 32; ++i) {
      const int idx = lane + 32 * i;
      const int kv = idx / PER, rem = idx - kv * PER;
      const int j = rem / C16, c = rem - j * C16;
      const uint32_t row = __shfl_sync(0xffffffffu, my_row, j);
      sm90::cp_async16(dst + kv * Lay::CTILE + j * RB + c * 16,
                       (kv ? vbase : kbase) + (size_t)row * hstride + c * 16,
                       s0 + j < r.end);
    }
    const float* sbase = (lane < kTcTile ? a.k_scale : a.v_scale) + r.kvh;
    cp_async4(dst + 2 * Lay::CTILE + lane * 4,
              sbase + (size_t)my_row * a.Hkv, my_s < r.end);
  };
  auto stage = [&](int t) { return wring + (t % NS) * Lay::STAGE; };
  auto scales = [&](const unsigned char* st) {
    return reinterpret_cast<const float*>(st + 2 * Lay::CTILE);
  };

  // K's B fragments of k16 step kk, as ldmatrix gives them from a bf16
  // tile: slot rows n (f[0], f[1]) and n + 8 (f[2], f[3]), head dims
  // 16 kk + 2q + {0, 1} (f[0], f[2]) and + 8 (f[1], f[3]).  The lane
  // reads the two words that hold its four codes of a row and gathers
  // them with one byte permute.
  const uint32_t gsel = (q & 1) ? 0x7632u : 0x5410u;
  auto k_frag = [&](const unsigned char* st, int kk, float s0, float s1,
                    uint32_t (&f)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
                              st + (n + 8 * h) * RB + 16 * kk) + (q >> 1);
      const uint32_t g = __byte_perm(w[0], w[2], gsel) ^ 0x80808080u;
      const float s = h ? s1 : s0;
      f[2 * h] = dequant2(g, 0, s, g, 1, s);
      f[2 * h + 1] = dequant2(g, 2, s, g, 3, s);
    }
  };
  // the lane's V codes, each xor 0x80: slot rows 2q, 2q + 1, 2q + 8,
  // 2q + 9, and of each its units n, n + 8, ...: byte nb % 4 of word
  // nb / 4 is the code of n8 block nb's column n
  auto v_codes = [&](const unsigned char* st, uint32_t (&w)[4][VW]) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const unsigned char* p =
          st + Lay::CTILE + (2 * q + (rr & 1) + 8 * (rr >> 1)) * RB;
#pragma unroll
      for (int i = 0; i < VW; ++i) w[rr][i] = 0u;
#pragma unroll
      for (int i = 0; i < NB / U; ++i) {
        const unsigned char* u = p + (n + 8 * i) * U;
        if constexpr (U == 16) {
          const uint4 x = *reinterpret_cast<const uint4*>(u);
          w[rr][4 * i] = x.x;
          w[rr][4 * i + 1] = x.y;
          w[rr][4 * i + 2] = x.z;
          w[rr][4 * i + 3] = x.w;
        } else if constexpr (U == 8) {
          const uint2 x = *reinterpret_cast<const uint2*>(u);
          w[rr][2 * i] = x.x;
          w[rr][2 * i + 1] = x.y;
        } else {
          w[rr][i / 2] |= (uint32_t)*reinterpret_cast<const uint16_t*>(u)
                          << (16 * (i & 1));
        }
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) w[rr][i] ^= 0x80808080u;
    }
  };
  // V's B fragment of n8 block nb: slots 2q, 2q + 1 (f[0]) and 2q + 8,
  // 2q + 9 (f[1]) at column n's head dim
  auto v_frag = [&](const uint32_t (&w)[4][VW], const float (&s)[4], int nb,
                    uint32_t (&f)[2]) {
    const int wi = nb / 4, bi = nb % 4;
    f[0] = dequant2(w[0][wi], bi, s[0], w[1][wi], bi, s[1]);
    f[1] = dequant2(w[2][wi], bi, s[2], w[3][wi], bi, s[3]);
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

  // S = Q·Kᵀ of the tile at stage st (16 MT rows by its 16 slots, two
  // n8 blocks), each k16 step's K fragments converted just before its
  // products; and the tile's V codes and scales, and its V fragments
  // where they are converted ahead
  float s[MT][2][4];
  uint32_t vw[4][VW];
  float vsc[4];
  uint32_t vf[VA ? NB : 1][2];
  auto tile_front = [&](const unsigned char* st) {
    const float* sc = scales(st);
    const float k0 = sc[n], k1 = sc[n + 8];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][0][e] = s[mt][1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t kf[4];
      k_frag(st, kk, k0, k1, kf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qs_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   QRB + (kk * 2 + (lane >> 4)) * 16);
        mma_bf16(s[mt][0], qa, kf[0], kf[1]);
        mma_bf16(s[mt][1], qa, kf[2], kf[3]);
      }
    }
    v_codes(st, vw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      vsc[i] = sc[kTcTile + 2 * q + (i & 1) + 8 * (i >> 1)];
    if constexpr (VA) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) v_frag(vw, vsc, nb, vf[nb]);
    }
  };

  // the softmax and P·V of tile t, whose S and V fragments (or codes) its
  // front left
  auto tile_back = [&](int t) {
    uint32_t ph[MT][4], pl[MT][4];
    const int s0 = r.start + (warp + kDecWarps * t) * kTcTile;
    tile_softmax(s, m_r, l_r, o, ph, pl, s0, r.end, a.scale_log2, lane);
    // O += P·V, P as hi + lo
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t f[2];
      if constexpr (VA) {
        f[0] = vf[nb][0];
        f[1] = vf[nb][1];
      } else {
        v_frag(vw, vsc, nb, f);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][nb], ph[mt], f[0], f[1]);
        mma_bf16(o[mt][nb], pl[mt], f[0], f[1]);
      }
    }
  };

  // The ring runs NS - 1 tiles ahead.  Step t issues tile t + NS - 1,
  // waits for tile t + 1, then in one basic block runs tile t's back and
  // tile t + 1's front: the compiler interleaves the two tiles' dependent
  // chains of products with the softmax and the conversion.  Each output
  // element still takes its products in the bf16 body's order.
  stage_q_async<DH, MT>(qs_s,
                        a.q + ((size_t)r.b * a.H + (size_t)r.kvh * G) * DH,
                        G);                    // in tile 0's group
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nt) issue(t);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<NS - 2>();
  __syncthreads();
  if (nt > 0) tile_front(stage(0));
  RT_DPHASE(0);
  for (int t = 0; t + 1 < nt; ++t) {
    if (t + NS - 1 < nt) issue(t + NS - 1);
    sm90::cp_async_commit();
    RT_DPHASE(1);
    // tile t + 1 has landed, and every lane is done reading tile t's
    // stage, which step t + 1 refills
    sm90::cp_async_wait<NS - 2>();
    __syncwarp();
    RT_DPHASE(2);
    tile_back(t);
    tile_front(stage(t + 1));
    RT_DPHASE(3);
  }
  if (nt > 0) tile_back(nt - 1);
  finish_tc<DH, U>(ring, a, r, o, m_r, l_r);
#ifdef RT_DECODE_PHASES
  RT_DPHASE(4);
  if (lane == 0) {
    for (int i = 0; i < kDecPhases; ++i)
      atomicAdd(&g_decode_phases[i], ph_cyc[i]);
    atomicAdd(&g_decode_phases[kDecPhases], (unsigned long long)nt);
    atomicAdd(&g_decode_phases[kDecPhases + 1], 1ull);
  }
#endif
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
// 181 KB for its int8 ring, 94 KB for the f32 body at G = 16; at Dh 192
// 156 KB, 139 KB and 74 KB.  An int8 ring never takes more than the bf16
// ring of its head dim (Q8Layout), so the two run as many blocks an SM.
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
static_assert(tc_smem_bytes<128, true>(1, 16) <= kSmemTwoBlocks &&
                  tc_smem_bytes<192, true>(1, 16) <= kSmemTwoBlocks &&
                  tc_smem_bytes<256, true>(1, 16) <= kSmemTwoBlocks,
              "two int8 blocks no longer share an SM");

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
