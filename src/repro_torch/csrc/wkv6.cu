// RWKV6 WKV recurrence on Hopper (sm_90a).
//
// Replaces: repro/kernels/wkv6.py:wkv6 (Pallas TPU).  Per (batch row b,
// head h), with the (hs x hs) state S[k, v] and the bonus u:
//   y_t[v] = sum_k r_t[k] S[k, v] + c_t v_t[v],  c_t = sum_k r_t[k] u[k] k_t[k]
//   S[k, v] <- w_t[k] S[k, v] + k_t[k] v_t[v]
// r, k, v come in f32 or bf16, w (the decay in (0, 1)), u and s0 in f32;
// y and sT are f32.  Callers pad with k = 0, w = 1 (an identity update).
//
// Bound on the H100: the recurrence is sequential in time, but every
// state column S[:, v] is independent of the others: at the serving chunk
// (B = 8, H = 40, hs = 64, 512 steps) 20 480 columns, 1.31 M state
// elements, about 10 K an SM.  The chunk needs 3.4 GFLOP on the f32 CUDA
// cores, 5 flops a state element a step (r . S, k v, w S + kv: one FMUL
// and two FFMA), 0.051 ms at 67 TFLOP/s, and moves 157 MB (0.047 ms at
// 3.35 TB/s).  A decode step moves the 5.2 MB of state in and the same
// out (0.0032 ms): bound by bytes.
//
// Design.
// - The state is split over threads and blocks.  A thread keeps a KR x VC
//   register tile of one (b, h)'s state (rows rg*KR.., its column group's
//   VC columns), so each r/k/w value it reads from shared memory serves
//   VC columns and each v value KR rows.  The G = hs/KR threads of a
//   column group sit in adjacent lanes of one warp and fold their y
//   partials with __shfl_xor_sync, halves first, in a fixed order: no
//   atomics, and two calls give the same bits.  A thread holds its
//   columns in an order XORed by its lane's fold mask (col_mask), so at
//   every fold level a lane keeps one half and takes its partner's other
//   half without a select.  A block holds `cols` columns of one (b, h),
//   the column group fastest in the grid, so blocks that read the same
//   r/k/w tile run together and share it through L2.  `plan` (mirrored
//   by kernels/wkv6.py:plan) gives the serving shapes 4 x 8 tiles, one
//   block of 128 threads a head for a chunk (320 blocks) and two of 64
//   for a decode step; the tile sweep of chip_smoke.py times the tiles
//   around it.
// - Loads overlap the recurrence.  Tiles of kWkvTileT steps of r, k, w and
//   the block's v columns move through a kWkvStages-deep ring in shared
//   memory by 16-byte cp.async, two tiles ahead of the one computed, and
//   a thread reads the next step's operands while it computes this one.
//   f32 rows land with their 16-byte chunks permuted (perm) so that the
//   KR/4 float4 reads of a step hit distinct banks across the row
//   groups.  u and the state also arrive by cp.async, the state staged in
//   shared memory so that device memory sees whole 16-byte chunks of its
//   rows both ways, where the tiled layout's own loads would touch a few
//   bytes of many rows (the decode step is bound by those bytes).
// - The bonus is hoisted: once a tile lands, one pass over it converts
//   bf16 r/k/v to f32 (into the same permuted layout) and computes
//   c_t = sum_k (r_t[k] u[k]) k_t[k] of each step into shared memory.
//   The per-element loop is then y += r S_old, S = fma(w, S, k v): three
//   instructions, the bound's 5 flops; y_t[v] is the folded partials
//   plus c_t v_t[v].
// What holds it back (chip_smoke.py's tile sweep, PERF.md): with ~10 K
// state elements an SM there are ~10 warps an SM at 32 elements a thread,
// too few to issue the FMAs back to back, and a warp's step issues its
// operand reads, the fold's shuffles and the y store beside its 96
// FMUL/FFMA; smaller tiles spend more of the shared-memory pipe on r/k/w
// than they gain in warps, larger ones leave fewer warps still.
// s0 and sT may be the same buffer: each block reads its state columns
// before the loop and writes the same columns after it, and no other
// block touches them.  T = 0 writes sT = s0.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// kernels/wkv6.py mirrors these constants.
constexpr int kWkvTileT = 16;          // TILE_T: steps a shared-memory tile
constexpr int kWkvStages = 3;          // STAGES: cp.async ring depth
constexpr int kWkvMaxThreads = 256;    // MAX_THREADS: threads a block
constexpr int kWkvPlanRows = 4;        // PLAN_ROWS: KR of the plan
constexpr int kWkvPlanCols = 8;        // PLAN_COLS: VC of the plan, at most
constexpr int kWkvMinCols = 16;        // MIN_COLS: columns a block, at least
constexpr int kWkvTargetBlocks = 264;  // TARGET_BLOCKS: 2 blocks an SM
constexpr unsigned kFull = 0xffffffffu;

struct Tile {
  int kr, vc, cols;
};

// kernels/wkv6.py:TILES, the (KR, VC) register tiles the launch takes
__host__ bool known_tile(int kr, int vc) {
  return (kr == 4 && (vc == 8 || vc == 2)) ||
         (kr == 8 && (vc == 8 || vc == 4));
}

// kernels/wkv6.py:valid
__host__ bool valid_tile(int hs, Tile p, int esz) {
  if ((hs != 16 && hs != 32 && hs != 64) || !known_tile(p.kr, p.vc))
    return false;
  const int g = hs / p.kr;
  if (p.kr > hs || g < p.vc || p.cols < 1 || hs % p.cols ||
      p.cols % p.vc || (p.cols * esz) % 16)
    return false;
  const int threads = g * (p.cols / p.vc);
  return threads % 32 == 0 && threads <= kWkvMaxThreads;
}

// kernels/wkv6.py:plan
__host__ bool plan(int B, int H, int hs, int T, Tile* p) {
  if ((hs != 16 && hs != 32 && hs != 64) || T < 0) return false;
  const int kr = kWkvPlanRows, g = hs / kr;
  int vc = kWkvPlanCols;
  while (vc > 1 && (vc > g || g * hs / vc < 32)) vc /= 2;
  // a step shorter than a tile (decode) is bound by its state bytes:
  // twice the blocks keep more of them in flight
  const long long target =
      T >= kWkvTileT ? kWkvTargetBlocks : 2LL * kWkvTargetBlocks;
  int cols = hs;
  while (cols / 2 >= kWkvMinCols && g * (cols / 2) / vc >= 32 &&
         static_cast<long long>(B) * H * (hs / cols) < target)
    cols /= 2;
  *p = Tile{kr, vc, cols};
  return true;
}

// Byte offsets of a block's dynamic shared memory: u, the ring of raw
// tiles (r, k in the input dtype, w in f32, the block's v columns), the
// f32 copies of r, k and v that the pass makes of bf16 inputs, and c_t of
// each step.  f32 r/k/w rows have their 16-byte chunks permuted (perm).
// The state columns pass through the last ring stage and on, free
// before the first tile and after the last.
struct Smem {
  int u, stage, stage_bytes, r, k, w, v, rf, kf, vf, c, state, total;
};

__host__ __device__ inline Smem smem_layout(int hs, int cols, int rows,
                                            int esz) {
  Smem s;
  int off = 0;
  s.u = off;
  off += hs * 4;
  s.r = 0;  // inside a stage
  s.k = rows * hs * esz;
  s.w = 2 * rows * hs * esz;
  s.v = s.w + rows * hs * 4;
  s.stage_bytes = (s.v + rows * cols * esz + 15) / 16 * 16;
  s.stage = off;
  off += kWkvStages * s.stage_bytes;
  s.rf = s.kf = s.vf = off;
  if (esz == 2) {
    s.rf = off;
    off += rows * hs * 4;
    s.kf = off;
    off += rows * hs * 4;
    s.vf = off;
    off += rows * cols * 4;
  }
  s.c = off;
  off += rows * 4;
  s.state = s.stage + (kWkvStages - 1) * s.stage_bytes;
  s.total = off > s.state + hs * cols * 4 ? off : s.state + hs * cols * 4;
  return s;
}

// Threads a block of the tile has at most (a whole head of columns).
constexpr int max_threads(int hs, int kr, int vc) {
  return (hs / kr) * (hs / vc) < kWkvMaxThreads ? (hs / kr) * (hs / vc)
                                                : kWkvMaxThreads;
}

// Position of 16-byte f32 chunk q (elements 4q..4q+3) of a row: thread
// row group rg reads chunks rg*KR/4 + j, stored at j*G + rg.
template <int KR, int G>
__device__ __forceinline__ int perm(int q) {
  return (q % (KR / 4)) * G + q / (KR / 4);
}

// A thread's local column c is column c ^ col_mask of its column group:
// at fold level l (l = 1 first) the lanes whose row-group bit G >> l is
// set hold the two halves of their columns swapped (mask bit VC >> l).
// So at every level a lane keeps its lower half and takes its partner's
// upper half, which holds the same columns, with no select.
template <int G, int VC>
__device__ __forceinline__ int col_mask(int rg) {
  int m = 0;
#pragma unroll
  for (int l = 1; VC >> l; ++l)
    if (rg & (G >> l)) m |= VC >> l;
  return m;
}

// Folds the VC column partials of the G lanes of a column group, halves
// first (lane pairs rg, rg ^ G/2 first); the lane ends with the total of
// its local column 0, which is column col_mask of its group.
template <int G, int VC>
__device__ __forceinline__ float fold(float (&a)[VC]) {
  int o = G / 2;
#pragma unroll
  for (int half = VC / 2; half >= 1; half /= 2, o /= 2)
#pragma unroll
    for (int i = 0; i < half; ++i)
      a[i] += __shfl_xor_sync(kFull, a[i + half], o);
#pragma unroll
  for (; o >= 1; o /= 2) a[0] += __shfl_xor_sync(kFull, a[0], o);
  return a[0];
}

template <typename T, int HS, int KR, int VC>
__global__ void __launch_bounds__(max_threads(HS, KR, VC))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sT, int n_t, int H, int cols,
            int rows) {
  constexpr int G = HS / KR;            // threads that share a column
  constexpr int QPR = KR / 4;           // float4 reads of a thread's rows
  constexpr int ESZ = sizeof(T);
  constexpr bool kBf16 = ESZ == 2;
  extern __shared__ __align__(16) char smem[];
  const Smem L = smem_layout(HS, cols, rows, ESZ);
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int ncg = HS / cols;
  const int bh = blockIdx.x / ncg;      // b * H + h
  const int b = bh / H, h = bh % H;
  const int c0 = (blockIdx.x % ncg) * cols;
  const int rg = tid % G, cg = tid / G;
  const int col = c0 + cg * VC;         // the thread's first column
  const int m = col_mask<G, VC>(rg);
  const bool writer = rg % (G / VC) == 0;  // one lane of each column
  int voff[VC];                            // the thread's columns in v
#pragma unroll
  for (int c = 0; c < VC; ++c) voff[c] = cg * VC + (c ^ m);
  float* U = reinterpret_cast<float*>(smem + L.u);
  float* C = reinterpret_cast<float*>(smem + L.c);

  // u and the block's state columns arrive in shared memory by cp.async
  // (no load waits before the copies are issued), the state as whole
  // 16-byte chunks of its rows.
  for (int c = tid; c < HS / 4; c += NT)
    rt::sm90::cp_async16(rt::sm90::smem_addr(U + c * 4), u + h * HS + c * 4,
                         true);
  float* Ss = reinterpret_cast<float*>(smem + L.state);
  const size_t sbase = static_cast<size_t>(bh) * HS * HS + c0;
  const int q4 = cols / 4;
  for (int c = tid; c < HS * q4; c += NT) {
    const int row = c / q4, q = c % q4;
    rt::sm90::cp_async16(rt::sm90::smem_addr(Ss + row * cols + q * 4),
                         s0 + sbase + row * HS + q * 4, true);
  }
  rt::sm90::cp_async_commit();

  // element offset of (b, t, h, 0) in the (B, T, H, hs) inputs
  auto row_off = [&](int t) {
    return (static_cast<size_t>(b) * n_t + t) * H * HS +
           static_cast<size_t>(h) * HS;
  };

  // cp.async of tile `tile` into its ring stage, one commit group (empty
  // past the end); steps past the end are zero-filled.
  auto issue = [&](int tile) {
    const int t0 = tile * rows;
    if (t0 < n_t) {
      const int n = min(rows, n_t - t0);
      const uint32_t st = rt::sm90::smem_addr(
          smem + L.stage + (tile % kWkvStages) * L.stage_bytes);
      constexpr int qrk = HS * ESZ / 16;  // 16-byte chunks of an r/k row
      for (int c = tid; c < rows * qrk; c += NT) {
        const int t = c / qrk, q = c % qrk;
        const bool ok = t < n;
        const size_t off = row_off(t0 + (ok ? t : 0)) * ESZ + q * 16;
        const int dq = kBf16 ? q : perm<KR, G>(q);
        const uint32_t d = t * HS * ESZ + dq * 16;
        rt::sm90::cp_async16(st + L.r + d,
                             reinterpret_cast<const char*>(r) + off, ok);
        rt::sm90::cp_async16(st + L.k + d,
                             reinterpret_cast<const char*>(k) + off, ok);
      }
      constexpr int qw = HS / 4;
      for (int c = tid; c < rows * qw; c += NT) {
        const int t = c / qw, q = c % qw;
        const bool ok = t < n;
        rt::sm90::cp_async16(
            st + L.w + (t * HS + perm<KR, G>(q) * 4) * 4,
            w + row_off(t0 + (ok ? t : 0)) + q * 4, ok);
      }
      const int qv = cols * ESZ / 16;
      for (int c = tid; c < rows * qv; c += NT) {
        const int t = c / qv, q = c % qv;
        const bool ok = t < n;
        const size_t off = (row_off(t0 + (ok ? t : 0)) + c0) * ESZ + q * 16;
        rt::sm90::cp_async16(st + L.v + (t * cols) * ESZ + q * 16,
                             reinterpret_cast<const char*>(v) + off, ok);
      }
    }
    rt::sm90::cp_async_commit();
  };

  const int n_tiles = (n_t + rows - 1) / rows;
#pragma unroll
  for (int s = 0; s < kWkvStages - 1; ++s) issue(s);
  rt::sm90::cp_async_wait<kWkvStages - 1>();
  __syncthreads();  // the state has landed
  float S[KR][VC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < VC; ++c) S[i][c] = Ss[(rg * KR + i) * cols + voff[c]];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * rows, n = min(rows, n_t - t0);
    rt::sm90::cp_async_wait<kWkvStages - 2>();
    __syncthreads();  // the tile has landed; the previous one is computed
    issue(tile + kWkvStages - 1);
    const char* st = smem + L.stage + (tile % kWkvStages) * L.stage_bytes;
    const float* Rf = reinterpret_cast<const float*>(
        kBf16 ? smem + L.rf : st + L.r);
    const float* Kf = reinterpret_cast<const float*>(
        kBf16 ? smem + L.kf : st + L.k);
    const float* Wf = reinterpret_cast<const float*>(st + L.w);
    const float* Vf = reinterpret_cast<const float*>(
        kBf16 ? smem + L.vf : st + L.v);

    // The pass: item (t, g8) is elements 8 g8 .. 8 g8 + 7 of step t.  It
    // converts bf16 r/k to f32 and adds its part of c_t; the HS/8 items
    // of a step sit in adjacent lanes and fold c_t halves first.  Whole
    // warps iterate, so every lane joins the shuffles.
    constexpr int Q8 = HS / 8;
    for (int i0 = tid - lane; i0 < rows * Q8; i0 += NT) {
      const int i = i0 + lane;
      const bool ok = i < rows * Q8;
      const int t = ok ? i / Q8 : 0, g8 = i % Q8;
      const int p0 = t * HS + perm<KR, G>(2 * g8) * 4;
      const int p1 = t * HS + perm<KR, G>(2 * g8 + 1) * 4;
      float rr[8], kk[8];
      if constexpr (kBf16) {
        rt::unpack16(*reinterpret_cast<const uint4*>(
                         st + L.r + (t * HS + g8 * 8) * 2),
                     rr, __nv_bfloat16{});
        rt::unpack16(*reinterpret_cast<const uint4*>(
                         st + L.k + (t * HS + g8 * 8) * 2),
                     kk, __nv_bfloat16{});
        if (ok) {
          float* R = reinterpret_cast<float*>(smem + L.rf);
          float* K = reinterpret_cast<float*>(smem + L.kf);
          *reinterpret_cast<float4*>(R + p0) =
              make_float4(rr[0], rr[1], rr[2], rr[3]);
          *reinterpret_cast<float4*>(R + p1) =
              make_float4(rr[4], rr[5], rr[6], rr[7]);
          *reinterpret_cast<float4*>(K + p0) =
              make_float4(kk[0], kk[1], kk[2], kk[3]);
          *reinterpret_cast<float4*>(K + p1) =
              make_float4(kk[4], kk[5], kk[6], kk[7]);
        }
      } else {
        const float4 a = *reinterpret_cast<const float4*>(Rf + p0);
        const float4 a2 = *reinterpret_cast<const float4*>(Rf + p1);
        const float4 e = *reinterpret_cast<const float4*>(Kf + p0);
        const float4 e2 = *reinterpret_cast<const float4*>(Kf + p1);
        rr[0] = a.x; rr[1] = a.y; rr[2] = a.z; rr[3] = a.w;
        rr[4] = a2.x; rr[5] = a2.y; rr[6] = a2.z; rr[7] = a2.w;
        kk[0] = e.x; kk[1] = e.y; kk[2] = e.z; kk[3] = e.w;
        kk[4] = e2.x; kk[5] = e2.y; kk[6] = e2.z; kk[7] = e2.w;
      }
      float c = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) c = fmaf(rr[j] * U[g8 * 8 + j], kk[j], c);
#pragma unroll
      for (int o = Q8 / 2; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
      if (ok && g8 == 0) C[t] = c;
    }
    if constexpr (kBf16) {
      float* V = reinterpret_cast<float*>(smem + L.vf);
      const int q8 = cols / 8;
      for (int i = tid; i < rows * q8; i += NT) {
        const int t = i / q8, q = i % q8;
        float vv[8];
        rt::unpack16(*reinterpret_cast<const uint4*>(
                         st + L.v + (t * cols + q * 8) * 2),
                     vv, __nv_bfloat16{});
        float* d = V + t * cols + q * 8;
        *reinterpret_cast<float4*>(d) =
            make_float4(vv[0], vv[1], vv[2], vv[3]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(vv[4], vv[5], vv[6], vv[7]);
      }
    }
    __syncthreads();  // the f32 tile and c_t are in shared memory

    // The step's operands: r, k, w of the thread's rows (KR/4 float4
    // reads each) and v of its columns; the next step's are read while
    // this one computes.
    auto operands = [&](int t, float (&r_)[KR], float (&k_)[KR],
                        float (&w_)[KR], float (&v_)[VC]) {
#pragma unroll
      for (int j = 0; j < QPR; ++j) {
        const int p = t * HS + (j * G + rg) * 4;
        const float4 a = *reinterpret_cast<const float4*>(Rf + p);
        const float4 e = *reinterpret_cast<const float4*>(Kf + p);
        const float4 d = *reinterpret_cast<const float4*>(Wf + p);
        r_[4 * j] = a.x; r_[4 * j + 1] = a.y; r_[4 * j + 2] = a.z;
        r_[4 * j + 3] = a.w;
        k_[4 * j] = e.x; k_[4 * j + 1] = e.y; k_[4 * j + 2] = e.z;
        k_[4 * j + 3] = e.w;
        w_[4 * j] = d.x; w_[4 * j + 1] = d.y; w_[4 * j + 2] = d.z;
        w_[4 * j + 3] = d.w;
      }
#pragma unroll
      for (int c = 0; c < VC; ++c) v_[c] = Vf[t * cols + voff[c]];
    };
    float rr[KR], kk[KR], ww[KR], vv[VC];
    operands(0, rr, kk, ww, vv);
    float* yt = y + row_off(t0) + col + m;  // y_t of the lane's column
    const int ystep = H * HS;
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float nr[KR], nk[KR], nw[KR], nv[VC];
      operands(min(t + 1, rows - 1), nr, nk, nw, nv);
      float acc[VC];
#pragma unroll
      for (int c = 0; c < VC; ++c) acc[c] = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          acc[c] = fmaf(rr[i], S[i][c], acc[c]);
          S[i][c] = fmaf(ww[i], S[i][c], kk[i] * vv[c]);
        }
      }
      const float tot = fold<G, VC>(acc);
      if (writer) *yt = fmaf(C[t], vv[0], tot);
      yt += ystep;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        rr[i] = nr[i];
        kk[i] = nk[i];
        ww[i] = nw[i];
      }
#pragma unroll
      for (int c = 0; c < VC; ++c) vv[c] = nv[c];
    }
  }
  rt::sm90::cp_async_wait<0>();
  __syncthreads();  // every thread is done with the last tile
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < VC; ++c) Ss[(rg * KR + i) * cols + voff[c]] = S[i][c];
  __syncthreads();
  for (int c = tid; c < HS * q4; c += NT) {
    const int row = c / q4, q = c % q4;
    *reinterpret_cast<float4*>(sT + sbase + row * HS + q * 4) =
        *reinterpret_cast<const float4*>(Ss + row * cols + q * 4);
  }
}

template <typename T, int HS, int KR, int VC>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int n_t,
           int H, int cols, cudaStream_t stream) {
  const int rows = max(1, min(n_t, kWkvTileT));
  const Smem L = smem_layout(HS, cols, rows, sizeof(T));
  auto kern = wkv6_kernel<T, HS, KR, VC>;
  cudaError_t err = rt::allow_smem(kern, L.total);
  if (err != cudaSuccess) return err;
  const int threads = (HS / KR) * (cols / VC);
  const long long blocks = static_cast<long long>(B) * H * (HS / cols);
  kern<<<static_cast<unsigned>(blocks), threads, L.total, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), n_t, H, cols, rows);
  return cudaGetLastError();
}

template <typename T, int HS, int KR, int VC>
int if_tile(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* sT, int B, int n_t,
            int H, Tile p, cudaStream_t s) {
  if constexpr (HS / KR >= VC) {
    if (p.kr == KR && p.vc == VC)
      return launch<T, HS, KR, VC>(r, k, v, w, u, s0, y, sT, B, n_t, H,
                                   p.cols, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int HS>
int by_tile(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* sT, int B, int n_t,
            int H, Tile p, cudaStream_t s) {
  using F = int (*)(const void*, const void*, const void*, const void*,
                    const void*, const void*, void*, void*, int, int, int,
                    Tile, cudaStream_t);
  constexpr F tiles[] = {if_tile<T, HS, 4, 8>, if_tile<T, HS, 4, 2>,
                         if_tile<T, HS, 8, 8>, if_tile<T, HS, 8, 4>};
  for (F f : tiles) {
    const int err = f(r, k, v, w, u, s0, y, sT, B, n_t, H, p, s);
    if (err != cudaErrorInvalidValue) return err;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int by_hs(const void* r, const void* k, const void* v, const void* w,
          const void* u, const void* s0, void* y, void* sT, int B, int n_t,
          int H, int hs, Tile p, cudaStream_t s) {
  switch (hs) {
    case 16: return by_tile<T, 16>(r, k, v, w, u, s0, y, sT, B, n_t, H, p, s);
    case 32: return by_tile<T, 32>(r, k, v, w, u, s0, y, sT, B, n_t, H, p, s);
    case 64: return by_tile<T, 64>(r, k, v, w, u, s0, y, sT, B, n_t, H, p, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* r, const void* k, const void* v, const void* w,
        const void* u, const void* s0, void* y, void* sT, int B, int T,
        int H, int hs, int dtype, Tile p, void* stream) {
  const int esz = dtype == rt::kFloat32 ? 4 : dtype == rt::kBFloat16 ? 2 : 0;
  if (B < 1 || H < 1 || T < 0 || esz == 0 || !valid_tile(hs, p, esz) ||
      static_cast<long long>(B) * H * (hs / p.cols) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return by_hs<float>(r, k, v, w, u, s0, y, sT, B, T, H, hs, p, s);
  return by_hs<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T, H, hs, p, s);
}

}  // namespace

// r, k, v: (B,T,H,hs) in `dtype`; w: (B,T,H,hs) f32; u: (H,hs) f32;
// s0, sT: (B,H,hs,hs) f32 (may alias); y: (B,T,H,hs) f32.  All
// contiguous and 16-byte aligned.  hs must be 16, 32 or 64.  Runs the
// tile of `plan`.  Returns a cudaError_t.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* y,
                       void* sT, int B, int T, int H, int hs, int dtype,
                       void* stream) {
  Tile p;
  if (!plan(B, H, hs, T, &p)) return cudaErrorInvalidValue;
  return run(r, k, v, w, u, s0, y, sT, B, T, H, hs, dtype, p, stream);
}

// The same with a given tile (KR rows by VC columns a thread, `cols`
// columns a block): for timing the tiles around the plan's.  A tile
// outside kernels/wkv6.py:valid is refused with cudaErrorInvalidValue.
extern "C" int rt_wkv6_tile(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* sT, int B, int T, int H, int hs,
                            int dtype, int kr, int vc, int cols,
                            void* stream) {
  return run(r, k, v, w, u, s0, y, sT, B, T, H, hs, dtype,
             Tile{kr, vc, cols}, stream);
}

// The tile rt_wkv6 launches for the shape, into out[0..2] = KR, VC, cols.
extern "C" int rt_wkv6_plan(int B, int H, int hs, int T, int* out) {
  Tile p;
  if (B < 1 || H < 1 || !plan(B, H, hs, T, &p)) return cudaErrorInvalidValue;
  out[0] = p.kr;
  out[1] = p.vc;
  out[2] = p.cols;
  return cudaSuccess;
}
