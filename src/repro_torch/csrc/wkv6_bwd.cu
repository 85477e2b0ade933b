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
// The kernel issues about 10 f32 instructions an element-step (2 in the
// forward pass, 2 in the replay, 6 in the backward step), so the card's
// f32 issue rate, not its memory, is the limit it can reach.
//
// Design.
// - S_{t-1} is never rebuilt from S_t by dividing by w_t: at the strong
//   decay exp(-exp(3)) that is noise.  A forward pass runs the recurrence
//   from s0 and writes the state before each chunk of kBwdChunk steps
//   into a workspace the wrapper allocates (B H ceil(T / kBwdChunk) hs^2
//   f32; chunk 0's is s0 and the last chunk's stays in registers); the
//   reverse pass walks the chunks last to first, replays each chunk's
//   states from its checkpoint into registers (the history, kBwdChunk x 8
//   a thread), then walks its steps backwards with G in registers.
// - A head's rows over a thread-block cluster of NC blocks (1, 2 or 4:
//   kernels/wkv6.py:bwd_plan, rt_wkv6_bwd_plan).  Rows are independent in
//   both recurrences (row i decays by w_t[i] and is updated by k[i] v and
//   r[i] dy), so each block holds hs / NC rows of S and G across all
//   columns, and its forward pass, checkpoints, replay and its rows' dr,
//   dk, dw and du are its own.  Only dv (a sum over rows) crosses blocks:
//   each warp pushes its partials of a chunk into the shared memory of the
//   block that owns those columns (st.async through distributed shared
//   memory, each store counted off the owner's mbarrier), and the owner
//   sums them in rank and warp order once its mbarrier's phase completes.
//   No device-memory round trip, no atomics, and no cluster barrier a
//   chunk: its release would be a full memory barrier (MEMBAR.ALL.GPU in
//   SASS, ~1,000 cycles a chunk on the H100).
// - A thread keeps a 2-row by 4-column tile of S and of G (8 elements):
//   hs / 4 lanes hold a row pair, so the block has hs^2 / (8 NC) threads
//   (128 at hs 64, NC 4).  Each chunk is kBwdChunk steps of compile-time
//   count: a ragged last chunk is padded with identity steps (k = r = v =
//   dy = 0, w = 1 leave S and G as they are; their outputs are not
//   written).  Unrolled, a chunk's steps overlap: only G's update (one FMA
//   an element) chains one step to the next.  Its partials fold a half
//   chunk at a time, one shuffle tree for all its steps (halves first):
//   S dy of every step after the replay, G v and sum G S of each row and
//   G^T k of each column after each half of the backward steps.
// - v . dy and r . (u * k) of each step (whole 64-wide vectors, read from
//   the block's full-width tiles) are computed at the start of the chunk;
//   the rank-1 terms and du are added in the output pass.
// - One block barrier a chunk.  Chunk c's rows leave after the barrier
//   that ends its iteration, its dv columns after the wait for its
//   partials in the next, so neither waits for work in flight.  The
//   partials rotate through kBwdRecv buffers: a block pushes chunk c - 3
//   into a buffer only after it has waited for chunk c - 1's partials,
//   which the owner pushes after reading chunk c + 1's from that buffer.
//   Operand tiles (f32 in shared memory, kBwdStages deep) and the totals
//   rotate too: the next chunk's operands, loaded into registers a chunk
//   ahead, are stored while this one computes; the checkpoint of the next
//   chunk is copied into shared memory (cp.async) a chunk ahead.  The
//   forward pass keeps two chunks' loads in flight.  Sums run in a fixed
//   order: two calls give the same bits.  du is summed per (b, h) in a
//   fixed order and then over b in a second small kernel.
// - Built with -DRT_WKV_BWD_PHASES (tools/wkv6_bwd_ab.py --phases), lane 0
//   of each warp adds the clock cycles it spent in each phase to
//   g_bwd_phases; rt_wkv6_bwd_phases reads or zeroes them.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// kernels/wkv6.py mirrors these constants.
constexpr int kBwdChunk = 8;           // BWD_CHUNK: steps between checkpoints
constexpr int kBwdRows = 2;            // BWD_ROWS: state rows a thread
constexpr int kBwdCols = 4;            // BWD_COLS: state columns a thread
constexpr int kBwdMaxThreads = 256;    // BWD_MAX_THREADS: threads a block
constexpr int kBwdTargetBlocks = 264;  // BWD_TARGET_BLOCKS: 2 blocks an SM
constexpr int kBwdPlanThreads = 128;   // BWD_PLAN_THREADS: planned, at most
constexpr int kBwdClusters[] = {1, 2, 4};  // BWD_CLUSTERS: the built NC
constexpr int kBwdStages = 3;          // operand tiles in shared memory
constexpr int kBwdRecv = 4;            // dv partial buffers (see the loop)
constexpr int kArrays = 5;             // r, k, w, v, dy
constexpr int kR = 0, kK = 1, kW = 2, kV = 3, kDY = 4;
constexpr unsigned kFull = 0xffffffffu;

// Threads a block at head size hs over a cluster of nc blocks.
__host__ __device__ constexpr int bwd_threads(int hs, int nc) {
  return hs * hs / (kBwdRows * kBwdCols * nc);
}

// Whether the kernel is built for (hs, nc): a built cluster size, whole
// warps, at most kBwdMaxThreads threads.
constexpr bool valid_nc(int hs, int nc) {
  bool built = false;
  for (int c : kBwdClusters) built = built || c == nc;
  return (hs == 16 || hs == 32 || hs == 64) && built &&
         bwd_threads(hs, nc) >= 32 && bwd_threads(hs, nc) <= kBwdMaxThreads;
}

// The cluster size rt_wkv6_bwd launches: of the built NC whose blocks
// have at most kBwdPlanThreads threads (three blocks an SM fit the
// register budget; a block of 256 runs alone), the least whose grid of
// B H NC blocks reaches kBwdTargetBlocks, else the largest.
int plan_nc(int B, int H, int hs) {
  int last = 0;
  for (int nc : kBwdClusters) {
    if (!valid_nc(hs, nc) || bwd_threads(hs, nc) > kBwdPlanThreads) continue;
    last = nc;
    if (static_cast<long long>(B) * H * nc >= kBwdTargetBlocks) break;
  }
  return last;
}

// The thread layout of (HS, NC): KR rows by VC columns a thread; LPR lanes
// a row group (lane l holds columns 4 l .. 4 l + 3), RPW row groups a
// warp, NW warps and R rows a block; TPS threads a step (CH channels
// each) for v . dy and r . (u * k).
template <int HS, int NC>
struct Lay {
  static constexpr int KR = kBwdRows;
  static constexpr int VC = kBwdCols;
  static constexpr int E = KR * VC;
  static constexpr int E4 = E / 4;
  static constexpr int LPR = HS / VC;
  static constexpr int RPW = 32 / LPR;
  static constexpr int R = HS / NC;
  static constexpr int NT = bwd_threads(HS, NC);
  static constexpr int NW = NT / 32;
  static constexpr int RC = HS / NC;     // dv columns the block writes
  static constexpr int TPS = HS / 4 < NT / kBwdChunk ? HS / 4
                                                     : NT / kBwdChunk;
  static constexpr int CH = HS / TPS;
  static_assert(CH % 4 == 0 && TPS <= 32, "rank-1 layout");
  // registers: at most 168 a thread (three blocks of 128 threads an SM;
  // eight of one warp, whose f32 operands would spill at 168)
  static constexpr int MINB = NT > 384 ? 1 : 384 / NT < 8 ? 384 / NT : 8;
  static_assert(NW * 32 == NT && R == NW * RPW * KR, "layout");
};

// Offsets (in floats) of a block's dynamic shared memory: u; kBwdStages
// operand tiles, each kArrays (kBwdChunk, HS) f32 arrays; two buffers of
// the row totals (dr, dk, dw before their rank-1 terms; (C, 3, R)),
// kBwdRecv of the dv partials the cluster's warps push into the block
// that owns their columns ((C, NC NW, RC): a chunk's are summed one chunk
// later), two of v . dy and r . (u * k) of each step; the threads' du
// partials; an mbarrier for each recv buffer.
struct BwdSmem {
  int u, tile, rowtot, recv, vd, cb, cks, du, mbar, total;
};

__host__ __device__ constexpr BwdSmem bwd_smem(int hs, int nc) {
  const int nt = bwd_threads(hs, nc), nw = nt / 32, rows = hs / nc;
  BwdSmem s{};
  s.u = 0;
  s.tile = hs;                          // a multiple of 16: float4-aligned
  s.rowtot = s.tile + kBwdStages * kArrays * kBwdChunk * hs;
  s.recv = s.rowtot + 2 * kBwdChunk * 3 * rows;
  s.vd = s.recv + kBwdRecv * kBwdChunk * nw * hs;   // NC NW RC = NW HS
  s.cb = s.vd + 2 * kBwdChunk;
  s.cks = s.cb + 2 * kBwdChunk;         // two checkpoints' share, 8 a thread
  s.du = s.cks + 2 * 8 * nt;
  s.mbar = s.du + nt;                   // kBwdRecv mbarriers, 8 bytes each
  s.total = s.mbar + 2 * kBwdRecv;
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

// The cluster barrier (release and acquire: a full memory barrier and an
// L1 invalidate in SASS), at the start and the end only.  A one-block
// launch is a cluster of one.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The dv partials move between blocks by st.async: each store lands in
// the owner's shared memory and counts its bytes off the owner's mbarrier
// of that buffer; the owner arms the mbarrier with the bytes a chunk
// brings and waits for its phase.  No thread-level fence: that is what a
// barrier.cluster release would cost each chunk.
__device__ __forceinline__ uint32_t mapa(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(m)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t m, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(m), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t m, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(m), "r"(parity) : "memory");
}
// the first N of (a, b, c, d) to shared::cluster address dst
template <int N>
__device__ __forceinline__ void st_async(uint32_t dst, uint32_t mbar, float a,
                                         float b, float c, float d) {
  if constexpr (N == 4)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst), "f"(a), "f"(b),
        "f"(c), "f"(d), "r"(mbar) : "memory");
  else if constexpr (N == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(dst), "f"(a), "f"(b), "r"(mbar)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
        "[%0], %1, [%2];\n" ::"r"(dst), "f"(a), "r"(mbar) : "memory");
}

#ifdef RT_WKV_BWD_PHASES
// the forward pass's advance, loads and stores, barrier; then a chunk's
// previous rows out with v . dy and r . (u * k), replay with its fold,
// next operands' store, backward steps, folds and pushes, wait for the
// previous chunk's dv partials, previous dv out, next loads, block
// barrier
constexpr int kBwdPhases = 12;
// the phases' cycle sums, then forward-pass chunks, reverse-pass chunks
// and warps
__device__ unsigned long long g_bwd_phases[kBwdPhases + 3];
#define RT_BPHASE(i)                                                     \
  do {                                                                   \
    const long long now_ = clock64();                                    \
    ph_cyc[i] += now_ - ph_t;                                            \
    ph_t = now_;                                                         \
  } while (0)
#else
#define RT_BPHASE(i) \
  do {               \
  } while (0)
#endif

// A chunk's operands in registers, 16 bytes a vector (VT elements of r,
// k, v, 4 of w, dy): vector m of an array is tile element (tid + m NT) VT.
template <typename T, int HS, int NC>
struct Regs {
  static constexpr int NT = bwd_threads(HS, NC), VT = 16 / sizeof(T);
  static constexpr int NVT = kBwdChunk * HS / VT, MT = (NVT + NT - 1) / NT;
  static constexpr int NVF = kBwdChunk * HS / 4, MF = (NVF + NT - 1) / NT;
  uint4 r[MT], k[MT], v[MT], w[MF], d[MF];
};

template <typename T, int HS, int NC>
__global__ void __launch_bounds__(Lay<HS, NC>::NT, Lay<HS, NC>::MINB)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt, int n_t,
                int H) {
  using Y = Lay<HS, NC>;
  using F = Regs<T, HS, NC>;
  constexpr int C = kBwdChunk, NT = Y::NT, NW = Y::NW, KR = Y::KR,
                VC = Y::VC, LPR = Y::LPR, RPW = Y::RPW, R = Y::R,
                RC = Y::RC, E4 = Y::E4, TPS = Y::TPS, CH = Y::CH;
  constexpr int VT = F::VT, NVT = F::NVT, MT = F::MT, NVF = F::NVF,
                MF = F::MF;
  constexpr BwdSmem L = bwd_smem(HS, NC);
  extern __shared__ __align__(16) float sm[];
  float* U = sm + L.u;
  float* rowtot = sm + L.rowtot;
  float* recv = sm + L.recv;
  float* VD = sm + L.vd;
  float* CB = sm + L.cb;
#ifdef RT_WKV_BWD_PHASES
  unsigned long long ph_cyc[kBwdPhases] = {};
  long long ph_t = clock64();
#endif

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int cgl = lane % LPR, rgw = lane / LPR;
  int rank = 0;
  if constexpr (NC > 1)
    rank = static_cast<int>(cg::this_cluster().block_rank());
  const int bh = blockIdx.x / NC, b = bh / H, h = bh % H;
  const int i0 = (wp * RPW + rgw) * KR;   // the thread's first row (block)
  const int gi0 = rank * R + i0;          // ... in the head
  const int c0 = cgl * VC;                // the thread's first column
  const int n_chunks = (n_t + C - 1) / C;
  // element offset of (b, t, h, 0) in the (B, T, H, hs) operands
  const size_t bh_off = (static_cast<size_t>(b) * n_t * H + h) * HS,
               t_str = static_cast<size_t>(H) * HS;
  auto row_off = [&](int t) {
    return bh_off + static_cast<size_t>(t) * t_str;
  };
  auto tile = [&](int slot, int a) {
    return sm + L.tile + (slot * kArrays + a) * C * HS;
  };
  for (int i = tid; i < HS; i += NT) U[i] = u[h * HS + i];

  // The thread's tile of an (hs, hs) row-major state, and back.
  auto load_state = [&](const float* src, float (&X)[KR][VC]) {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(src + (gi0 + i) * HS + c0);
      X[i][0] = a.x; X[i][1] = a.y; X[i][2] = a.z; X[i][3] = a.w;
    }
  };
  auto store_state = [&](float* dst, const float (&X)[KR][VC]) {
#pragma unroll
    for (int i = 0; i < KR; ++i)
      *reinterpret_cast<float4*>(dst + (gi0 + i) * HS + c0) =
          make_float4(X[i][0], X[i][1], X[i][2], X[i][3]);
  };
  // chunk c's checkpoint (1 <= c < n_chunks - 1): the block's share of the
  // state, float4 e4 (row e4) of every thread, threads adjacent
  float4* ck = reinterpret_cast<float4*>(ckpt) +
               (static_cast<size_t>(bh) * n_chunks * NC + rank) * E4 * NT;
  auto ck_at = [&](int c, int e4) {
    return ck + (static_cast<size_t>(c) * NC * E4 + e4) * NT + tid;
  };

  // A chunk's operands: loaded into registers ahead (fetch), converted to
  // f32 and stored into a tile (put); one step's row holds whole vectors.
  // Steps past T are identity steps: k = r = v = dy = 0, w = 1.
  auto fetch = [&](F& x, int c, bool all) {
    const int t0 = c * C;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int idx = tid + m * NT;
      if (NVT % NT == 0 || idx < NVT) {
        const int e = idx * VT, t = t0 + e / HS;
        x.k[m] = x.v[m] = x.r[m] = make_uint4(0, 0, 0, 0);
        if (t < n_t) {
          const size_t off = row_off(t) + e % HS;
          x.k[m] = rt::ld16(k + off);
          x.v[m] = rt::ld16(v + off);
          if (all) x.r[m] = rt::ld16(r + off);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      const int idx = tid + m * NT;
      if (NVF % NT == 0 || idx < NVF) {
        const int e = idx * 4, t = t0 + e / HS;
        const unsigned one = __float_as_uint(1.f);
        x.w[m] = make_uint4(one, one, one, one);
        x.d[m] = make_uint4(0, 0, 0, 0);
        if (t < n_t) {
          const size_t off = row_off(t) + e % HS;
          x.w[m] = rt::ld16(w + off);
          if (all) x.d[m] = rt::ld16(dy + off);
        }
      }
    }
  };
  auto put = [&](const F& x, int slot, bool all) {
    auto put_t = [&](const uint4& raw, int a, int idx) {
      float o[VT];
      rt::unpack16(raw, o, T());
#pragma unroll
      for (int q = 0; q < VT; q += 4)
        *reinterpret_cast<float4*>(tile(slot, a) + idx * VT + q) =
            make_float4(o[q], o[q + 1], o[q + 2], o[q + 3]);
    };
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int idx = tid + m * NT;
      if (NVT % NT == 0 || idx < NVT) {
        put_t(x.k[m], kK, idx);
        put_t(x.v[m], kV, idx);
        if (all) put_t(x.r[m], kR, idx);
      }
    }
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      const int idx = tid + m * NT;
      if (NVF % NT == 0 || idx < NVF) {
        *reinterpret_cast<uint4*>(tile(slot, kW) + idx * 4) = x.w[m];
        if (all) *reinterpret_cast<uint4*>(tile(slot, kDY) + idx * 4) = x.d[m];
      }
    }
  };
  // the step's values of the thread's rows and of its columns
  auto rows2 = [&](const float* X, int tl, float (&o)[KR]) {
    const float2 a = *reinterpret_cast<const float2*>(X + tl * HS + gi0);
    o[0] = a.x;
    o[1] = a.y;
  };
  auto cols4 = [&](const float* X, int tl, float (&o)[VC]) {
    const float4 a = *reinterpret_cast<const float4*>(X + tl * HS + c0);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  };
  auto advance = [&](float (&X)[KR][VC], int slot, int tl) {
    float kk[KR], ww[KR], vv[VC];   // X <- diag(w) X + k v^T
    rows2(tile(slot, kK), tl, kk);
    rows2(tile(slot, kW), tl, ww);
    cols4(tile(slot, kV), tl, vv);
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < VC; ++j)
        X[i][j] = fmaf(ww[i], X[i][j], kk[i] * vv[j]);
  };

  // Forward pass over the chunks but the last: the recurrence from s0,
  // the block's rows of the state written before each (chunk 0's is s0).
  // Two register sets (even and odd chunks) keep two chunks' loads in
  // flight; one block barrier a chunk.
  float S[KR][VC];
  load_state(s0 + static_cast<size_t>(bh) * HS * HS, S);
  const int nf = n_chunks - 1;
  if (nf > 0) {
    F ga, gb;
    fetch(ga, 0, false);
    put(ga, 0, false);
    if (nf > 1) fetch(gb, 1, false);
    if (nf > 2) fetch(ga, 2, false);
    __syncthreads();
    // chunk c; `nxt` holds chunk c + 1 and is refilled with c + 3
    auto step = [&](int c, F& nxt) {
      if (c > 0) {
#pragma unroll
        for (int i = 0; i < KR; ++i)
          *ck_at(c, i) = make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
      }
#pragma unroll
      for (int tl = 0; tl < C; ++tl) advance(S, c % kBwdStages, tl);
      RT_BPHASE(0);
      if (c + 1 < nf) {
        put(nxt, (c + 1) % kBwdStages, false);
        if (c + 3 < nf) fetch(nxt, c + 3, false);
      }
      RT_BPHASE(1);
      __syncthreads();
      RT_BPHASE(2);
    };
    for (int c = 0; c < nf; c += 2) {
      step(c, gb);
      if (c + 1 < nf) step(c + 1, ga);
    }
  }

  // Reverse pass: the chunks last to first, G carried backwards.  Chunk
  // c's rows leave at the start of iteration c - 1 (after the block
  // barrier that ends iteration c), its dv columns after the wait for
  // its partials in iteration c - 1.
  float G[KR][VC];
  if (dsT != nullptr) {
    load_state(dsT + static_cast<size_t>(bh) * HS * HS, G);
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < VC; ++j) G[i][j] = 0.f;
  }
  float du_acc = 0.f;
  // chunk c's dr, dk, dw (and du) of the block's rows
  auto rows_out = [&](int c) {
    const int slot = c % kBwdStages, b2 = c & 1, t0 = c * C,
              n = min(C, n_t - t0);
    const float* Kt = tile(slot, kK);
    const float* Rt = tile(slot, kR);
#pragma unroll
    for (int m = 0; m < (C * R + NT - 1) / NT; ++m) {
      const int idx = tid + m * NT;
      const int tl = idx / R, i = idx % R, gi = rank * R + i;
      if ((C * R % NT == 0 || idx < C * R) && tl < n) {
        const float vd = VD[b2 * C + tl], kk = Kt[tl * HS + gi],
                    rr = Rt[tl * HS + gi], uu = U[gi];
        const float* tot = rowtot + (b2 * C + tl) * 3 * R + i;
        const size_t off = row_off(t0 + tl) + gi;
        dr[off] = rt::from_f<T>(tot[0] + uu * kk * vd);
        dk[off] = rt::from_f<T>(tot[R] + uu * rr * vd);
        dw[off] = tot[2 * R];
        du_acc = fmaf(rr * kk, vd, du_acc);
      }
    }
  };
  // chunk c's dv of the block's RC columns: the partials of the cluster's
  // NC NW warps, in rank and warp order
  auto dv_out = [&](int c) {
    const int slot = c % kBwdStages, b2 = c & 1, t0 = c * C,
              n = min(C, n_t - t0);
    const float* DYt = tile(slot, kDY);
#pragma unroll
    for (int m = 0; m < (C * RC + NT - 1) / NT; ++m) {
      const int idx = tid + m * NT;
      const int tl = idx / RC, jj = idx % RC;
      if ((C * RC % NT == 0 || idx < C * RC) && tl < n) {
        const float* src =
            recv + (((c % kBwdRecv) * C + tl) * NC * NW) * RC + jj;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NC * NW; ++q) s += src[q * RC];
        const int j = rank * RC + jj;
        dv[row_off(t0 + tl) + j] =
            rt::from_f<T>(fmaf(DYt[tl * HS + j], CB[b2 * C + tl], s));
      }
    }
  };
  // the state before chunk c, copied ahead into cks[c & 1] (the thread's
  // own elements: no barrier) and read at chunk c's replay
  float4* cks = reinterpret_cast<float4*>(sm + L.cks) + tid;
  auto ck_issue = [&](int c) {
    float4* dst = cks + (c & 1) * E4 * NT;
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const void* src =
          c == 0 ? static_cast<const void*>(
                       s0 + static_cast<size_t>(bh) * HS * HS +
                       (gi0 + i) * HS + c0)
                 : static_cast<const void*>(ck_at(c, i));
      rt::sm90::cp_async16(rt::sm90::smem_addr(dst + i * NT), src, true);
    }
    rt::sm90::cp_async_commit();
  };
  F f;
  const int cl = n_chunks - 1;
  // recv buffer q's mbarrier; chunk c's partials land in buffer
  // c % kBwdRecv, the buffer's ((cl - c) / kBwdRecv)-th use: its parity
  const uint32_t mbar0 = rt::sm90::smem_addr(sm + L.mbar);
  constexpr int kRecvBytes = C * NW * HS * sizeof(float);
  auto dv_wait = [&](int c) {
    const uint32_t m = mbar0 + 8 * (c % kBwdRecv);
    if (tid == 0) mbar_expect(m, kRecvBytes);
    mbar_wait(m, ((cl - c) / kBwdRecv) & 1);
  };
  if (n_chunks > 0) {
    if (tid == 0) {
      for (int q = 0; q < kBwdRecv; ++q) mbar_init(mbar0 + 8 * q);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fetch(f, cl, true);
    put(f, cl % kBwdStages, true);
    if (cl > 0) fetch(f, cl - 1, true);
    // every block of the cluster runs, its mbarriers set, before any
    // pushes into it
    cluster_sync();
  }
  for (int c = cl; c >= 0; --c) {
    const int slot = c % kBwdStages, b2 = c & 1;
    const float* Rt = tile(slot, kR);
    const float* Kt = tile(slot, kK);
    const float* Wt = tile(slot, kW);
    const float* Vt = tile(slot, kV);
    const float* DYt = tile(slot, kDY);
    if (c > 0) ck_issue(c - 1);
    if (c < cl) rows_out(c + 1);
    // v . dy and r . (u * k) of the chunk's steps: TPS threads a step, CH
    // adjacent channels each
    if (tid < C * TPS) {
      const int tl = tid / TPS, l = tid % TPS;
      float a[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < CH; q += 4) {
        const int j = l * CH + q;
        const float4 vv = *reinterpret_cast<const float4*>(Vt + tl * HS + j);
        const float4 dd = *reinterpret_cast<const float4*>(DYt + tl * HS + j);
        const float4 rr = *reinterpret_cast<const float4*>(Rt + tl * HS + j);
        const float4 kk = *reinterpret_cast<const float4*>(Kt + tl * HS + j);
        const float4 uu = *reinterpret_cast<const float4*>(U + j);
        a[0] = fmaf(vv.x, dd.x, fmaf(vv.y, dd.y,
               fmaf(vv.z, dd.z, fmaf(vv.w, dd.w, a[0]))));
        a[1] = fmaf(rr.x * uu.x, kk.x, fmaf(rr.y * uu.y, kk.y,
               fmaf(rr.z * uu.z, kk.z, fmaf(rr.w * uu.w, kk.w, a[1]))));
      }
      fold<2, TPS, 1>(a, l);
      if (l == 0) VD[b2 * C + tl] = a[0];
      if (l == TPS / 2) CB[b2 * C + tl] = a[0];
    }
    RT_BPHASE(3);
    if (c < cl) {
      // chunk c's copy landed (chunk c - 1's, the newest, may still fly)
      if (c > 0)
        rt::sm90::cp_async_wait<1>();
      else
        rt::sm90::cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const float4 a = cks[((c & 1) * E4 + i) * NT];
        S[i][0] = a.x; S[i][1] = a.y; S[i][2] = a.z; S[i][3] = a.w;
      }
    }
    // the replay: the states before each step into the history, and the
    // row partials S dy ((tl, i)), folded over the row's LPR lanes
    float Sh[C][KR][VC];
    float pd[C * KR];
#pragma unroll
    for (int tl = 0; tl < C; ++tl) {
      float dd[VC];
      cols4(DYt, tl, dd);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < VC; ++j) {
          Sh[tl][i][j] = S[i][j];
          a = fmaf(S[i][j], dd[j], a);
        }
        pd[tl * KR + i] = a;
      }
      if (tl + 1 < C) advance(S, slot, tl);
    }
    fold<C * KR, LPR, 1>(pd, cgl);
    {
      constexpr int NV = C * KR / LPR;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int idx = cgl * NV + j, tl = idx / KR, i = idx % KR;
        rowtot[(b2 * C + tl) * 3 * R + i0 + i] = pd[j];
      }
    }
    RT_BPHASE(4);
    if (c > 0) put(f, (c - 1) % kBwdStages, true);
    RT_BPHASE(5);
    // the steps backwards in two halves of H2 steps: row partials G v and
    // sum G S ((tl, i, q)) and column partials G^T k ((tl, j)) of each
    // half folded, the rows into rowtot, the columns (over the warp's RPW
    // row groups) pushed into the block that owns them
    constexpr int H2 = C / 2;
    const uint32_t dst = mapa(
        rt::sm90::smem_addr(recv + ((c % kBwdRecv) * C * NC + rank) * NW * RC +
                            wp * RC + c0 % RC), c0 / RC);
    const uint32_t dst_mbar = mapa(mbar0 + 8 * (c % kBwdRecv), c0 / RC);
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      float p[H2 * KR * 2];
      float d[H2 * VC];
#pragma unroll
      for (int hl = H2 - 1; hl >= 0; --hl) {
        const int tl = half * H2 + hl;
        float rr[KR], kk[KR], ww[KR], vv[VC], dd[VC];
        rows2(Rt, tl, rr);
        rows2(Kt, tl, kk);
        rows2(Wt, tl, ww);
        cols4(Vt, tl, vv);
        cols4(DYt, tl, dd);
#pragma unroll
        for (int j = 0; j < VC; ++j) d[hl * VC + j] = 0.f;
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          float a = 0.f, e = 0.f;
#pragma unroll
          for (int j = 0; j < VC; ++j) {
            const float g = G[i][j];
            a = fmaf(g, vv[j], a);
            e = fmaf(g, Sh[tl][i][j], e);
            d[hl * VC + j] = fmaf(g, kk[i], d[hl * VC + j]);
            G[i][j] = fmaf(ww[i], g, rr[i] * dd[j]);
          }
          p[(hl * KR + i) * 2] = a;
          p[(hl * KR + i) * 2 + 1] = e;
        }
      }
      RT_BPHASE(6);
      fold<H2 * KR * 2, LPR, 1>(p, cgl);
      {
        constexpr int NV = H2 * KR * 2 / LPR;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int idx = cgl * NV + j, tl = half * H2 + idx / (2 * KR),
                    i = (idx / 2) % KR, q = 1 + idx % 2;
          rowtot[((b2 * C + tl) * 3 + q) * R + i0 + i] = p[j];
        }
      }
      fold<H2 * VC, RPW, LPR>(d, rgw);
      {
        constexpr int NV = H2 * VC / RPW;
        constexpr int PW = NV < 4 ? NV : 4;
#pragma unroll
        for (int j = 0; j < NV; j += PW) {
          const int idx = rgw * NV + j, tl = half * H2 + idx / VC;
          st_async<PW>(dst + 4 * (tl * NC * NW * RC + idx % VC), dst_mbar,
                       d[j], d[(j + 1) % NV], d[(j + 2) % NV],
                       d[(j + 3) % NV]);
        }
      }
      RT_BPHASE(7);
    }
    // Chunk c + 1's partials are in after the wait.  The next pushes into
    // its buffer (chunk c + 1 - kBwdRecv, iteration c - 3) follow each
    // pusher's wait for chunk c - 1, whose partials this block pushes
    // after these reads: so no barrier guards the buffers.
    if (c < cl) dv_wait(c + 1);
    RT_BPHASE(8);
    if (c < cl) dv_out(c + 1);
    RT_BPHASE(9);
    if (c > 1) fetch(f, c - 2, true);
    RT_BPHASE(10);
    __syncthreads();
    RT_BPHASE(11);
  }
  if (n_chunks > 0) {
    rows_out(0);
    dv_wait(0);
    dv_out(0);
  }
  store_state(ds0 + static_cast<size_t>(bh) * HS * HS, G);
  // du of the block's rows: thread tid holds row tid % R (NT is a
  // multiple of R); the last barrier also keeps this block's shared
  // memory alive until the cluster is done with it
  sm[L.du + tid] = du_acc;
  cluster_sync();
  if (tid < R) {
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < NT / R; ++m) s += sm[L.du + m * R + tid];
    du_part[static_cast<size_t>(bh) * HS + rank * R + tid] = s;
  }
#ifdef RT_WKV_BWD_PHASES
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kBwdPhases; ++i)
      atomicAdd(&g_bwd_phases[i], ph_cyc[i]);
    atomicAdd(&g_bwd_phases[kBwdPhases],
              static_cast<unsigned long long>(max(n_chunks - 1, 0)));
    atomicAdd(&g_bwd_phases[kBwdPhases + 1],
              static_cast<unsigned long long>(n_chunks));
    atomicAdd(&g_bwd_phases[kBwdPhases + 2], 1ull);
  }
#endif
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

// The launch configuration of (T, HS, NC) for `blocks` blocks: its
// dynamic shared memory allowed first.
template <typename T, int HS, int NC>
cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                   long long blocks, cudaStream_t s) {
  const size_t bytes = bwd_smem(HS, NC).total * sizeof(float);
  const cudaError_t err = rt::allow_smem(wkv6_bwd_kernel<T, HS, NC>, bytes);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(Lay<HS, NC>::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int HS, int NC>
int launch(const Args& a, int B, int n_t, int H, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      config<T, HS, NC>(cfg, attr, static_cast<long long>(B) * H * NC, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, wkv6_bwd_kernel<T, HS, NC>, static_cast<const T*>(a.r),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.s0), static_cast<const float*>(a.dy),
      static_cast<const float*>(a.dsT), static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.du_part),
      static_cast<float*>(a.ds0), static_cast<float*>(a.ckpt), n_t, H);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * HS;
  wkv6_bwd_du<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(a.du_part), static_cast<float*>(a.du), B, n);
  return cudaGetLastError();
}

// out[0..3]: threads a block, dynamic shared memory bytes, clusters of NC
// blocks the card holds at once (cudaOccupancyMaxActiveClusters),
// registers a thread.
template <typename T, int HS, int NC>
int occupancy(int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = config<T, HS, NC>(cfg, attr, static_cast<long long>(sms) * NC,
                            nullptr);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, wkv6_bwd_kernel<T, HS, NC>);
  if (err != cudaSuccess) return err;
  out[0] = Lay<HS, NC>::NT;
  out[1] = static_cast<int>(cfg.dynamicSmemBytes);
  out[3] = fa.numRegs;
  return cudaOccupancyMaxActiveClusters(&out[2], wkv6_bwd_kernel<T, HS, NC>,
                                        &cfg);
}

template <typename T, int HS>
int by_nc(const Args* a, int* occ, int B, int n_t, int H, int nc,
          cudaStream_t s) {
  if constexpr (valid_nc(HS, 1))
    if (nc == 1)
      return a ? launch<T, HS, 1>(*a, B, n_t, H, s) : occupancy<T, HS, 1>(occ);
  if constexpr (valid_nc(HS, 2))
    if (nc == 2)
      return a ? launch<T, HS, 2>(*a, B, n_t, H, s) : occupancy<T, HS, 2>(occ);
  if constexpr (valid_nc(HS, 4))
    if (nc == 4)
      return a ? launch<T, HS, 4>(*a, B, n_t, H, s) : occupancy<T, HS, 4>(occ);
  return cudaErrorInvalidValue;
}

// Launches (a given) or reads the occupancy of (occ given) the kernel of
// (dtype, hs, nc).
int dispatch(const Args* a, int* occ, int B, int T, int H, int hs,
             int dtype, int nc, cudaStream_t s) {
  if (!valid_nc(hs, nc) ||
      (dtype != rt::kFloat32 && dtype != rt::kBFloat16))
    return cudaErrorInvalidValue;
  if (dtype == rt::kFloat32) {
    switch (hs) {
      case 16: return by_nc<float, 16>(a, occ, B, T, H, nc, s);
      case 32: return by_nc<float, 32>(a, occ, B, T, H, nc, s);
      default: return by_nc<float, 64>(a, occ, B, T, H, nc, s);
    }
  }
  switch (hs) {
    case 16: return by_nc<__nv_bfloat16, 16>(a, occ, B, T, H, nc, s);
    case 32: return by_nc<__nv_bfloat16, 32>(a, occ, B, T, H, nc, s);
    default: return by_nc<__nv_bfloat16, 64>(a, occ, B, T, H, nc, s);
  }
}

int run(const Args& a, int B, int T, int H, int hs, int dtype, int nc,
        void* stream) {
  if (B < 1 || H < 1 || T < 0 ||
      static_cast<long long>(B) * H * 4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return dispatch(&a, nullptr, B, T, H, hs, dtype, nc,
                  static_cast<cudaStream_t>(stream));
}

}  // namespace

// r, k, v, dr, dk, dv: (B,T,H,hs) in `dtype`; w, dy, dw: (B,T,H,hs) f32;
// u, du: (H,hs) f32; s0, dsT (null: zero), ds0: (B,H,hs,hs) f32; ckpt:
// B H ceil(T / 8) hs^2 f32 and du_part: B H hs f32, the workspace.  All
// contiguous and 16-byte aligned.  hs must be 16, 32 or 64.  Launches the
// cluster size of rt_wkv6_bwd_plan.  Returns a cudaError_t
// (cudaErrorInvalidValue, before any launch, for a shape the kernel does
// not take).
extern "C" int rt_wkv6_bwd(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           const void* dy, const void* dsT, void* dr,
                           void* dk, void* dv, void* dw, void* du, void* ds0,
                           void* ckpt, void* du_part, int B, int T, int H,
                           int hs, int dtype, void* stream) {
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt,
               du_part};
  return run(a, B, T, H, hs, dtype, plan_nc(B, H, hs), stream);
}

// The same with a given cluster size nc (1, 2 or 4, where the head size
// allows it: kernels/wkv6.py:bwd_valid): for timing the plans around the
// rule's.  Any other nc is refused with cudaErrorInvalidValue.
extern "C" int rt_wkv6_bwd_nc(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dy, const void* dsT, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* ckpt, void* du_part, int B,
                              int T, int H, int hs, int dtype, int nc,
                              void* stream) {
  const Args a{r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt,
               du_part};
  return run(a, B, T, H, hs, dtype, nc, stream);
}

// The plan rt_wkv6_bwd launches for the shape, into out[0..1] = the
// cluster size NC and the threads a block.
extern "C" int rt_wkv6_bwd_plan(int B, int H, int hs, int T, int* out) {
  const int nc = B < 1 || H < 1 || T < 0 ? 0 : plan_nc(B, H, hs);
  if (nc == 0) return cudaErrorInvalidValue;
  out[0] = nc;
  out[1] = bwd_threads(hs, nc);
  return cudaSuccess;
}

// The kernel of (hs, dtype, nc) on this card, into out[0..3]: threads a
// block, dynamic shared memory bytes a block, clusters resident at once
// (cudaOccupancyMaxActiveClusters), registers a thread.
extern "C" int rt_wkv6_bwd_occupancy(int hs, int dtype, int nc, int* out) {
  return dispatch(nullptr, out, 1, 0, 1, hs, dtype, nc, nullptr);
}

#ifdef RT_WKV_BWD_PHASES
// counts: the kBwdPhases cycle sums, then forward-pass chunks,
// reverse-pass chunks and warps (each summed over warps); zeroes them if
// reset
extern "C" int rt_wkv6_bwd_phases(unsigned long long* counts, int reset) {
  if (reset) {
    const unsigned long long zero[kBwdPhases + 3] = {};
    return cudaMemcpyToSymbol(g_bwd_phases, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(counts, g_bwd_phases,
                              sizeof(unsigned long long) * (kBwdPhases + 3));
}
#endif
