// GQA flash-decode body shared by the contiguous and the paged decode
// kernels; they differ only in how a virtual slot maps to a cache row.
//
// Bound on the H100: the bytes of K and V read (every live slot of every
// kv head once per step, 3.35 TB/s); the FLOPs are tiny.  Design: one
// block of 128 threads per (kv head, batch row) streams the live slots in
// 32-slot tiles through shared memory, so each K/V element is read from
// device memory once and scored against all G query heads of its kv
// head (the GQA saving the Pallas kernels get by processing G heads per
// grid step).  A tile is read with 16-byte loads into registers, and the
// next tile's loads are issued before the current tile's math, so the
// loads of one tile are in flight together and overlap the math.  Warp w
// scores heads w, w+4, ... with one slot per lane, so the tile's max and
// sum are warp shuffles; the online softmax keeps m, l and the (G, Dh)
// accumulator in f32.  The loop stops at the last live slot (pos + 1, or
// the whole cache once a ring has wrapped).  What holds it back first: at
// B = 8 and Hkv = 8 the grid is only 64 blocks on 132 SMs, one block of
// four warps per SM; split-KV is the later fix.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kDecThreads = 128;
constexpr int kDecBS = 32;     // slots per shared-memory tile
constexpr int kDecMaxOut = 16;  // G * Dh <= 16 * 128

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

// q: (B, H, Dh); out: (B, H, Dh).  s_len is the request-level cache
// length: slot s is live iff s < s_len and (s <= pos or (ring and
// pos >= s_len)), i.e. iff s < n for the n computed below.
template <typename T, int DH, typename Slots>
__device__ void decode_block(const T* __restrict__ q, const T* __restrict__ kc,
                             const T* __restrict__ vc,
                             const int* __restrict__ pos, T* __restrict__ out,
                             int H, int Hkv, int G, int s_len, int ring,
                             float scale, Slots slots) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [G][DH]
  float* Ks = qs + G * DH;                   // [BS][DH + 1] (padded)
  float* Vs = Ks + kDecBS * (DH + 1);        // [BS][DH]
  float* Ps = Vs + kDecBS * DH;              // [G][BS]
  float* ms = Ps + G * kDecBS;               // [G]
  float* ls = ms + G;                        // [G]
  float* as = ls + G;                        // [G] rescale factors

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int GD = G * DH;

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * DH;
  for (int idx = tid; idx < GD; idx += kDecThreads) qs[idx] = to_f(qb[idx]);
  for (int g = tid; g < G; g += kDecThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  float acc[kDecMaxOut];
#pragma unroll
  for (int o = 0; o < kDecMaxOut; ++o) acc[o] = 0.f;

  const int p = pos[b];
  const int n = (ring && p >= s_len) ? s_len : min(s_len, p + 1);
  const size_t hstride = (size_t)Hkv * DH;

  // a tile is kDecBS rows of CPR 16-byte chunks; thread tid holds chunks
  // tid, tid + 128, ... of K and of V in registers
  constexpr int VEC = kVec<T>;
  constexpr int CPR = DH / VEC;
  constexpr int NCH = (kDecBS * CPR + kDecThreads - 1) / kDecThreads;
  static_assert(DH % VEC == 0, "rows must be whole 16-byte chunks");
  uint4 kreg[NCH], vreg[NCH];
  auto issue = [&](int s0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int idx = tid + i * kDecThreads;
      const int j = idx / CPR, c = idx - j * CPR;
      const int s = s0 + j;
      kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kDecBS * CPR && s < n) {
        const size_t off =
            slots.row(b, s) * hstride + (size_t)kvh * DH + c * VEC;
        kreg[i] = ld16(kc + off);
        vreg[i] = ld16(vc + off);
      }
    }
  };
  issue(0);

  for (int s0 = 0; s0 < n; s0 += kDecBS) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int idx = tid + i * kDecThreads;
      if (idx < kDecBS * CPR) {
        const int j = idx / CPR, c = idx - j * CPR;
        float kf[VEC], vf[VEC];
        unpack16(kreg[i], kf, T());
        unpack16(vreg[i], vf, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          Ks[j * (DH + 1) + c * VEC + e] = kf[e];
          Vs[j * DH + c * VEC + e] = vf[e];
        }
      }
    }
    __syncthreads();
    if (s0 + kDecBS < n) issue(s0 + kDecBS);   // in flight during the math

    for (int g = warp; g < G; g += kDecThreads / 32) {
      const float* qg = qs + g * DH;
      const float* kr = Ks + lane * (DH + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot += qg[d] * kr[d];
      const float sc = (s0 + lane < n) ? dot * scale : kNegInf;
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float pj = expf(sc - m_new);
      const float psum = warp_sum(pj);
      Ps[g * kDecBS + lane] = pj;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        as[g] = a;
        ls[g] = ls[g] * a + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int o = 0; o < kDecMaxOut; ++o) {
      const int idx = tid + o * kDecThreads;
      if (idx < GD) {
        const int g = idx / DH, d = idx - g * DH;
        const float* pg = Ps + g * kDecBS;
        float a = acc[o] * as[g];
#pragma unroll 8
        for (int j = 0; j < kDecBS; ++j) a += pg[j] * Vs[j * DH + d];
        acc[o] = a;
      }
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * DH;
#pragma unroll
  for (int o = 0; o < kDecMaxOut; ++o) {
    const int idx = tid + o * kDecThreads;
    if (idx < GD) ob[idx] = from_f<T>(acc[o] / fmaxf(ls[idx / DH], 1e-30f));
  }
}

inline size_t decode_smem_bytes(int G, int DH) {
  return sizeof(float) * ((size_t)G * DH + (size_t)kDecBS * (DH + 1) +
                          (size_t)kDecBS * DH + (size_t)G * kDecBS + 3 * G);
}

inline bool decode_shape_ok(int H, int Hkv, int DH) {
  return Hkv > 0 && H % Hkv == 0 && (H / Hkv) * DH <= kDecMaxOut * kDecThreads;
}

}  // namespace rt
