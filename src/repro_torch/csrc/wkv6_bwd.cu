// The gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu) on Hopper
// (sm_90a): the backward of `wkv6` under autograd (kernels/autograd.py).
//
// Replaces no Pallas kernel: the reference trains through `wkv_scan`
// (repro/models/rwkv.py:72), a lax.scan whose gradient XLA compiles as
// one reverse scan; this kernel is the port's counterpart of that
// gradient.  Per (batch row b, head h), with S_{t-1} the state before
// step t (S_0 = s0) and G_t = dL/dS_t (G_T = dsT, 0 when absent):
//   dr_t    = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//   dk_t    = G_t v_t + u * r_t (v_t . dy_t)
//   dv_t    = G_t^T k_t + dy_t (r_t . (u * k_t))
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   du      = sum_{b, t} r_t * k_t (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0
// kernels/ref.py:wkv6_bwd_ref is the plain version.  r, k, v (and dr, dk,
// dv) are f32 or bf16; w, u, s0, dy, dsT, dw, du and ds0 are f32.
//
// Bound on the H100: per state element a step the recompute of S (3
// flops), G's update (3), S dy, G v, G^T k and sum G S (2 each): 14 flops
// on the f32 CUDA cores, 9.6 GFLOP at the serving chunk (B = 8, T = 512,
// H = 40, hs = 64), 0.14 ms at 67 TFLOP/s, against 0.08 ms for its 262 MB
// of inputs and gradients: bound by operations (kernels/cost.py:wkv6_bwd).
//
// Design (a simple CUDA-core kernel; a chunked tensor-core form is later
// work).
// - dw_t needs S_{t-1} and G_t at the same step, and the two run in
//   opposite directions.  S_{t-1} is never rebuilt from S_t by dividing by
//   w_t: at the strong decay exp(-exp(3)) that is noise.  Instead a first
//   pass runs the recurrence from s0 and writes the state every kBwdChunk
//   steps into a workspace the wrapper allocates (B H ceil(T / kBwdChunk)
//   hs^2 f32); the reverse pass walks the chunks last to first, replays
//   each chunk's states from its checkpoint into shared memory, then walks
//   the chunk's steps backwards with G in registers.  Each state element's
//   update is local to it, so a thread replays and reads back only its own
//   elements (checkpoint and history need no barrier).
// - One block holds a whole head: a thread keeps a KR x VC tile of S and
//   of G.  The LPR lanes of a row group hold all the columns of its KR
//   rows, so dr, dk and dw (sums over a row) fold inside the warp; dv (a
//   sum over the rows) folds over the warp's row groups, then the warps'
//   partials meet in shared memory and are summed in warp order after the
//   chunk.  Folds exchange halves with __shfl_xor_sync in a fixed order, du
//   is summed per (b, h) in step order and then over b in a second small
//   kernel: no atomics, and two calls give the same bits.
// - The chunk's r, k, w, v and dy land in shared memory in f32; the next
//   chunk's (and its checkpoint) are loaded into registers while this one
//   computes.  The per-step rank-1 terms (v . dy, r . (u * k)) are computed
//   once a step; the gradients leave through a coalesced pass after the
//   chunk.
#include "common.cuh"

namespace {

// kernels/wkv6.py mirrors this constant.
constexpr int kBwdChunk = 8;           // BWD_CHUNK: steps between checkpoints
constexpr unsigned kFull = 0xffffffffu;

// The thread layout of a head size: KR rows by VC columns a thread, LPR
// lanes a row group (lane l holds the float4 column chunks (q LPR + l) * 4
// for q < VC / 4), RPW row groups a warp, NW warps a head.
template <int HS>
struct Lay {
  static constexpr int KR = 2;
  static constexpr int VC = HS >= 32 ? 8 : 4;
  static constexpr int LPR = HS / VC;
  static constexpr int RPW = 32 / LPR;
  static constexpr int NW = HS / (RPW * KR);
  static constexpr int NT = 32 * NW;
  static constexpr int E = KR * VC;     // state elements a thread
  static constexpr int E4 = E / 4;
  static constexpr int NQ = VC / 4;     // float4 column chunks a row
  static constexpr int PT = kBwdChunk * HS / NT;  // tile elements a thread
};

// Offsets (in floats) of a block's dynamic shared memory: u, the chunk's
// f32 r, k, w, v, dy (kBwdChunk x HS each), v . dy and r . (u * k) of each
// step, the replayed states (kBwdChunk x E x NT), the row totals (dr, dk,
// dw before their rank-1 terms) and the warps' dv partials.
struct BwdSmem {
  int u, r, k, w, v, dy, vd, cb, hist, rowtot, colpart, total;
};

__host__ __device__ constexpr BwdSmem bwd_smem(int hs, int nt, int nw,
                                               int e) {
  BwdSmem s{};
  const int tile = kBwdChunk * hs;
  s.u = 0;
  s.r = hs;
  s.k = s.r + tile;
  s.w = s.k + tile;
  s.v = s.w + tile;
  s.dy = s.v + tile;
  s.vd = s.dy + tile;
  s.cb = s.vd + kBwdChunk;
  s.hist = s.cb + kBwdChunk;            // a multiple of 8: float4-aligned
  s.rowtot = s.hist + kBwdChunk * e * nt;
  s.colpart = s.rowtot + kBwdChunk * 3 * hs;
  s.total = s.colpart + kBwdChunk * nw * hs;
  return s;
}

// Sums the first N values of a[] over the NL lanes (lane offsets STRIDE,
// 2 STRIDE, ...) of a group, halves first: at each level a lane keeps one
// half of its values and adds its partner's copy of the same half.  Lane
// lg of the group ends with the totals of values lg * N / NL + j,
// j < max(N / NL, 1) (with N < NL, the NL / N lanes from lg = q NL / N up
// hold value q).
template <int N, int NL, int STRIDE, int NV>
__device__ __forceinline__ void fold(float (&a)[NV], int lg) {
  if constexpr (NL > 1) {
    constexpr int hl = NL / 2;
    if constexpr (N > 1) {
      constexpr int hv = N / 2;
      const bool up = lg & hl;
#pragma unroll
      for (int i = 0; i < hv; ++i) {
        const float send = up ? a[i] : a[i + hv];
        const float keep = up ? a[i + hv] : a[i];
        a[i] = keep + __shfl_xor_sync(kFull, send, hl * STRIDE);
      }
      fold<hv, hl, STRIDE>(a, lg);
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], hl * STRIDE);
      fold<1, hl, STRIDE>(a, lg);
    }
  }
}

template <typename T, int HS>
__global__ void __launch_bounds__(Lay<HS>::NT, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt, int n_t,
                int H) {
  using Y = Lay<HS>;
  constexpr int C = kBwdChunk, NT = Y::NT, NW = Y::NW, KR = Y::KR,
                VC = Y::VC, LPR = Y::LPR, RPW = Y::RPW, E4 = Y::E4,
                NQ = Y::NQ, PT = Y::PT;
  constexpr BwdSmem L = bwd_smem(HS, NT, NW, Y::E);
  extern __shared__ __align__(16) float sm[];
  float* U = sm + L.u;
  float* R = sm + L.r;
  float* K = sm + L.k;
  float* W = sm + L.w;
  float* V = sm + L.v;
  float* DY = sm + L.dy;
  float* VD = sm + L.vd;
  float* CB = sm + L.cb;
  float4* hist = reinterpret_cast<float4*>(sm + L.hist);
  float* rowtot = sm + L.rowtot;
  float* colpart = sm + L.colpart;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int cgl = lane % LPR, rgw = lane / LPR;
  const int i0 = (wp * RPW + rgw) * KR;   // the thread's first row
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_chunks = (n_t + C - 1) / C;
  // element offset of (b, t, h, 0) in the (B, T, H, hs) operands
  auto row_off = [&](int t) {
    return (static_cast<size_t>(b) * n_t + t) * H * HS +
           static_cast<size_t>(h) * HS;
  };
  // the first column of the thread's float4 chunk q
  auto col = [&](int q) { return (q * LPR + cgl) * 4; };
  if (tid < HS) U[tid] = u[h * HS + tid];

  // The thread's tile of an (hs, hs) row-major state, and back.
  auto load_state = [&](const float* src, float (&X)[KR][VC]) {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 a =
            *reinterpret_cast<const float4*>(src + (i0 + i) * HS + col(q));
        X[i][4 * q] = a.x; X[i][4 * q + 1] = a.y;
        X[i][4 * q + 2] = a.z; X[i][4 * q + 3] = a.w;
      }
  };
  auto store_state = [&](float* dst, const float (&X)[KR][VC]) {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        *reinterpret_cast<float4*>(dst + (i0 + i) * HS + col(q)) =
            make_float4(X[i][4 * q], X[i][4 * q + 1], X[i][4 * q + 2],
                        X[i][4 * q + 3]);
  };
  // chunk c's checkpoint: float4 e4 of every thread, threads adjacent
  float4* ck = reinterpret_cast<float4*>(ckpt) +
               static_cast<size_t>(bh) * n_chunks * E4 * NT;
  auto ck_at = [&](int c, int e4) {
    return ck + (static_cast<size_t>(c) * E4 + e4) * NT + tid;
  };
  // the thread's elements of a float4 e4 = i NQ + q of the history
  auto to4 = [&](const float (&X)[KR][VC], int e4) {
    const int i = e4 / NQ, q = e4 % NQ;
    return make_float4(X[i][4 * q], X[i][4 * q + 1], X[i][4 * q + 2],
                       X[i][4 * q + 3]);
  };
  auto from4 = [&](float (&X)[KR][VC], int e4, float4 a) {
    const int i = e4 / NQ, q = e4 % NQ;
    X[i][4 * q] = a.x; X[i][4 * q + 1] = a.y;
    X[i][4 * q + 2] = a.z; X[i][4 * q + 3] = a.w;
  };

  // A chunk's operands: element m of the thread is idx = tid + m NT, step
  // idx / HS of the chunk, channel idx % HS, and lands at [idx] of each
  // (kBwdChunk, HS) tile.  Loaded into registers ahead (fetch), stored
  // after the barrier (put).
  float pr[PT] = {}, pk[PT] = {}, pw[PT] = {}, pv[PT] = {}, pdy[PT] = {};
  auto fetch = [&](int c, bool all) {
    const int t0 = c * C, n = min(C, n_t - t0);
#pragma unroll
    for (int m = 0; m < PT; ++m) {
      const int idx = tid + m * NT, tl = idx / HS;
      if (tl < n) {
        const size_t off = row_off(t0 + tl) + idx % HS;
        pk[m] = rt::to_f(k[off]);
        pw[m] = w[off];
        pv[m] = rt::to_f(v[off]);
        if (all) {
          pr[m] = rt::to_f(r[off]);
          pdy[m] = dy[off];
        }
      }
    }
  };
  auto put = [&](bool all) {
#pragma unroll
    for (int m = 0; m < PT; ++m) {
      const int idx = tid + m * NT;
      K[idx] = pk[m];
      W[idx] = pw[m];
      V[idx] = pv[m];
      if (all) {
        R[idx] = pr[m];
        DY[idx] = pdy[m];
      }
    }
  };
  // the step's k and w of the thread's rows, v of its columns
  auto rows2 = [&](const float* X, int tl, float (&o)[KR]) {
#pragma unroll
    for (int i = 0; i < KR; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(X + tl * HS + i0 + i);
      o[i] = a.x;
      o[i + 1] = a.y;
    }
  };
  auto cols4 = [&](const float* X, int tl, float (&o)[VC]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(X + tl * HS + col(q));
      o[4 * q] = a.x; o[4 * q + 1] = a.y;
      o[4 * q + 2] = a.z; o[4 * q + 3] = a.w;
    }
  };
  auto advance = [&](float (&X)[KR][VC], int tl) {   // X <- diag(w) X + k v^T
    float kk[KR], ww[KR], vv[VC];
    rows2(K, tl, kk);
    rows2(W, tl, ww);
    cols4(V, tl, vv);
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < VC; ++c) X[i][c] = fmaf(ww[i], X[i][c], kk[i] * vv[c]);
  };

  // Pass 1: the recurrence from s0, the state written before each chunk.
  float S[KR][VC];
  load_state(s0 + static_cast<size_t>(bh) * HS * HS, S);
  if (n_chunks > 1) fetch(0, false);
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int e4 = 0; e4 < E4; ++e4) *ck_at(c, e4) = to4(S, e4);
    if (c == n_chunks - 1) break;       // the last chunk's steps: pass 2
    __syncthreads();                    // the previous chunk's tile is read
    put(false);
    __syncthreads();
    if (c + 1 < n_chunks - 1) fetch(c + 1, false);
    for (int tl = 0; tl < C; ++tl) advance(S, tl);
  }

  // Pass 2: the chunks last to first, G carried backwards in registers.
  float G[KR][VC];
  if (dsT != nullptr) {
    load_state(dsT + static_cast<size_t>(bh) * HS * HS, G);
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < VC; ++c) G[i][c] = 0.f;
  }
  float du_acc = 0.f;
  float4 pck[E4];
  if (n_chunks > 0) {
    fetch(n_chunks - 1, true);
#pragma unroll
    for (int e4 = 0; e4 < E4; ++e4) pck[e4] = *ck_at(n_chunks - 1, e4);
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, n_t - t0);
    __syncthreads();     // the previous chunk's output pass is done
    put(true);
#pragma unroll
    for (int e4 = 0; e4 < E4; ++e4) from4(S, e4, pck[e4]);
    __syncthreads();     // the tile (and u) are in shared memory
    if (c > 0) {
      fetch(c - 1, true);
#pragma unroll
      for (int e4 = 0; e4 < E4; ++e4) pck[e4] = *ck_at(c - 1, e4);
    }
    // the steps' rank-1 terms: v . dy and r . (u * k), a warp a step
    for (int tl = wp; tl < n; tl += NW) {
      float a = 0.f, e = 0.f;
      for (int i = lane; i < HS; i += 32) {
        a = fmaf(V[tl * HS + i], DY[tl * HS + i], a);
        e = fmaf(R[tl * HS + i] * U[i], K[tl * HS + i], e);
      }
      a = rt::warp_sum(a);
      e = rt::warp_sum(e);
      if (lane == 0) {
        VD[tl] = a;
        CB[tl] = e;
      }
    }
    // the states before each of the chunk's steps, into the history
    for (int tl = 0; tl < n; ++tl) {
#pragma unroll
      for (int e4 = 0; e4 < E4; ++e4)
        hist[(tl * E4 + e4) * NT + tid] = to4(S, e4);
      if (tl + 1 < n) advance(S, tl);
    }
    // the steps backwards
    for (int tl = n - 1; tl >= 0; --tl) {
      float Sh[KR][VC];
#pragma unroll
      for (int e4 = 0; e4 < E4; ++e4)
        from4(Sh, e4, hist[(tl * E4 + e4) * NT + tid]);
      float rr[KR], kk[KR], ww[KR], vv[VC], dd[VC];
      rows2(R, tl, rr);
      rows2(K, tl, kk);
      rows2(W, tl, ww);
      cols4(V, tl, vv);
      cols4(DY, tl, dd);
      // row partials: S dy (rows 0..KR), G v (KR..2KR), sum G S (2KR..3KR)
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0.f;
      float d[VC];                      // column partials: G^T k
#pragma unroll
      for (int c = 0; c < VC; ++c) d[c] = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const float g = G[i][c], s = Sh[i][c];
          p[i] = fmaf(s, dd[c], p[i]);
          p[KR + i] = fmaf(g, vv[c], p[KR + i]);
          p[2 * KR + i] = fmaf(g, s, p[2 * KR + i]);
          d[c] = fmaf(g, kk[i], d[c]);
          G[i][c] = fmaf(ww[i], g, rr[i] * dd[c]);
        }
      fold<8, LPR, 1>(p, cgl);
#pragma unroll
      for (int j = 0; j < 8 / LPR; ++j) {
        const int q = cgl * (8 / LPR) + j;
        if (q < 3 * KR) rowtot[(tl * 3 + q / KR) * HS + i0 + q % KR] = p[j];
      }
      fold<VC, RPW, LPR>(d, rgw);
      if (VC >= RPW || rgw % (RPW / VC) == 0) {
#pragma unroll
        for (int j = 0; j < (VC >= RPW ? VC / RPW : 1); ++j) {
          const int cc = rgw * VC / RPW + j;  // the thread's column cc
          colpart[(tl * NW + wp) * HS + col(cc / 4) + cc % 4] = d[j];
        }
      }
    }
    __syncthreads();     // the chunk's totals are in shared memory
    for (int idx = tid; idx < n * HS; idx += NT) {
      const int tl = idx / HS, i = idx % HS;
      const size_t off = row_off(t0 + tl) + i;
      const float vd = VD[tl];
      dr[off] = rt::from_f<T>(rowtot[(tl * 3) * HS + i] + U[i] * K[idx] * vd);
      dk[off] =
          rt::from_f<T>(rowtot[(tl * 3 + 1) * HS + i] + U[i] * R[idx] * vd);
      dw[off] = rowtot[(tl * 3 + 2) * HS + i];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) s += colpart[(tl * NW + q) * HS + i];
      dv[off] = rt::from_f<T>(fmaf(DY[idx], CB[tl], s));
    }
    if (tid < HS)
      for (int tl = n - 1; tl >= 0; --tl)
        du_acc = fmaf(R[tl * HS + tid] * K[tl * HS + tid], VD[tl], du_acc);
  }
  store_state(ds0 + static_cast<size_t>(bh) * HS * HS, G);
  if (tid < HS) du_part[static_cast<size_t>(bh) * HS + tid] = du_acc;
}

// du[h, i] = sum over b, in order, of the (b, h) partials.
__global__ void wkv6_bwd_du(const float* __restrict__ part,
                            float* __restrict__ du, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[static_cast<size_t>(b) * n + i];
  du[i] = s;
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0, *dy, *dsT;
  void *dr, *dk, *dv, *dw, *du, *ds0, *ckpt, *du_part;
};

template <typename T, int HS>
int launch(const Args& a, int B, int n_t, int H, cudaStream_t s) {
  using Y = Lay<HS>;
  const size_t bytes = bwd_smem(HS, Y::NT, Y::NW, Y::E).total * sizeof(float);
  auto kern = wkv6_bwd_kernel<T, HS>;
  cudaError_t err = rt::allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * H, Y::NT, bytes, s>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<const float*>(a.dy), static_cast<const float*>(a.dsT),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.du_part),
      static_cast<float*>(a.ds0), static_cast<float*>(a.ckpt), n_t, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * HS;
  wkv6_bwd_du<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(a.du_part), static_cast<float*>(a.du), B, n);
  return cudaGetLastError();
}

template <typename T>
int by_hs(const Args& a, int B, int n_t, int H, int hs, cudaStream_t s) {
  switch (hs) {
    case 16: return launch<T, 16>(a, B, n_t, H, s);
    case 32: return launch<T, 32>(a, B, n_t, H, s);
    case 64: return launch<T, 64>(a, B, n_t, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dr, dk, dv: (B,T,H,hs) in `dtype`; w, dy, dw: (B,T,H,hs) f32;
// u, du: (H,hs) f32; s0, dsT (null: zero), ds0: (B,H,hs,hs) f32; ckpt:
// B H ceil(T / 8) hs^2 f32 and du_part: B H hs f32, the workspace.  All
// contiguous and 16-byte aligned.  hs must be 16, 32 or 64.  Returns a
// cudaError_t (cudaErrorInvalidValue, before any launch, for a shape the
// kernel does not take).
extern "C" int rt_wkv6_bwd(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           const void* dy, const void* dsT, void* dr,
                           void* dk, void* dv, void* dw, void* du, void* ds0,
                           void* ckpt, void* du_part, int B, int T, int H,
                           int hs, int dtype, void* stream) {
  if (B < 1 || H < 1 || T < 0 || (hs != 16 && hs != 32 && hs != 64) ||
      (dtype != rt::kFloat32 && dtype != rt::kBFloat16) ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt,
               du_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return by_hs<float>(a, B, T, H, hs, s);
  return by_hs<__nv_bfloat16>(a, B, T, H, hs, s);
}
