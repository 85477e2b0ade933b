// GQA flash attention for prefill and chunked prefill on Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_prefill.py:flash_prefill (Pallas TPU),
// generalised to Tq != Tk with a query offset: Tq queries at absolute
// positions q_offset + i attend over Tk keys at positions 0..Tk-1, which
// is what chunked prefill runs (a chunk of Tc queries over the cache).
// q_offset is an int32 in device memory (null: 0) that every block reads
// first (the reference traces a chunk's `start`, so one executable serves
// every offset; here one captured CUDA graph does).
// Causal, sliding-window and non-causal masks, per-row key `lengths`,
// the reference's finite mask value (kNegInf) and its l >= 1e-30 clamp;
// f32 online softmax and accumulation, the output rounded once.
//
// Bound on the H100: at long T the 4 * live pairs * H * Dh FLOPs of the
// two products (operations: 989 TFLOP/s dense bf16 on the tensor cores);
// at short T the bytes of q, k, v and out (3.35 TB/s).
//
// Two bodies, chosen by dtype alone before the launch
// (rt_flash_prefill_body, mirrored by kernels/flash_prefill.py:body):
//
// * bf16, every Dh the kernel takes (64, 80, 128, 192, 256): the
//   tensor-core body.  A block is one or two warpgroups (128 threads
//   each), each owning 64 query rows of one query head; the grid is (H, q
//   tiles, B) with the head fastest, so the G query heads of a kv head run
//   together and reread its K/V from L2, and the q tiles are issued last
//   tile first (the causal tiles with the most keys start first).  Shared
//   memory holds a Q tile a warpgroup, two stages of 64-key K tiles and
//   three of V tiles, all in the 128-byte-swizzled layout of hopper.cuh
//   (64-column atoms), filled by 16-byte cp.async copies that zero-fill
//   rows past Tq and Tk.  At the top of each key tile the block waits for
//   that tile's copies (cp.async.wait_group and __syncthreads) and issues
//   the next tile's, one tile ahead.  S = Q·Kᵀ is Dh/16 wgmma m64n64k16
//   with K read K-major from shared memory, 32 f32 accumulators a thread.
//   Thread t of warp w holds rows w*16 + t/4 and +8 of S, columns 8j +
//   2(t%4) + {0,1}: the row max and sum are shuffles among the 4 lanes of
//   a row, the scores are scaled by scale * log2(e) for exp2, and masks
//   are applied only on tiles that cross the diagonal, the window edge,
//   the row's length or Tk (for the warpgroup's own rows).  P goes to the
//   tensor cores as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi): P
//   rounded to bf16 alone is off by up to 2^-9 relative a term, which at
//   rows with a few keys exceeds the main path's tolerance against the
//   f32 reference.  The accumulator fragment of two adjacent 8-column
//   blocks of S is the register A fragment of one k16 step, so O += P·V
//   is hi and lo for four k-steps, with V read MN-major (the transpose
//   bit) from the same swizzled tile; the split makes the tensor-core work
//   1.5 times the bound's.  S of tile t and P·V of tile t - 1 are issued
//   together.  No TMA, warp specialisation, clusters or persistent blocks
//   yet.  By head dim (tc::Layout):
//
//   Dh   tile    P·V's N        Q operand   warpgroups  shared memory a block
//   64   1 atom  64: n64        registers   1           49 KB, 4 blocks/SM
//   80   2 atoms 128: n128      registers   1           97 KB, 2 blocks/SM
//   128  2 atoms 128: n128      registers   1           97 KB, 2 blocks/SM
//   192  3 atoms 192: n128+n64  shared mem  2           169 KB, 1 block/SM
//   256  4 atoms 256: n128+n128 shared mem  2           225 KB, 1 block/SM
//
//   - Dh 80 is 1.25 atoms.  Its tiles take two, columns 80-127 never
//     written: S's fifth k-step reads columns 64-79 of atom 1, and P·V
//     runs at N = 128 over both atoms, storing the first 80 columns (the
//     columns past 80 see only their own unwritten V columns).  The
//     MN-major 128-byte-swizzled layout repeats over whole 64-column
//     atoms, so an N of 80 would end inside one; a second layout for the
//     tail (a 32-byte swizzle at N = 16) would need its own copy path.
//     The padding makes P·V 1.6 times its work at Dh 80 (all products 1.4
//     times) and leaves the Dh 128 code as it is.
//   - N past 128 is issued as an n128 over atoms 0-1 and an n64 (192) or
//     n128 (256) from atom 2, into O's accumulators from 64 on: each
//     issue's fragment is O's at its columns, so O is laid out as one
//     product (hopper.cuh's wgmma_m64n*k16 with an offset).
//   - Registers at Dh 192 and 256: O alone is 96 or 128 a thread, with S
//     32 and P's hi and lo 32 more; Q's register fragments (Dh/4) would
//     pass 255 at Dh 256 (and 208 before any address at 192).  There S
//     reads Q from its tile through a shared-memory A descriptor (the same
//     K-major swizzled bytes the register fragments are loaded from).
//   - Shared memory at Dh 192 and 256 allows one block an SM.  Two
//     warpgroups over 128 query rows share each K/V stage, so a K/V tile
//     copied into shared memory serves twice the rows and the SM holds 8
//     warps instead of 4; the block's key range covers both warpgroups'
//     rows (each masks its own edge tiles).
//
// * f32 (every Dh: 64, 80, 128, 192, 256): the CUDA-core body, in f32.
//   One block of 256 threads per (q tile, kv head, batch row).  The q
//   tile holds 256/TPR rows: BQ = rows/G query positions times the G
//   query heads of that kv head, so each K/V tile loaded into shared
//   memory is shared by all G heads.  Each row is owned by TPR
//   consecutive lanes, each holding Dh/TPR dims of q and of the f32
//   accumulator in registers; a score is a per-lane partial dot product
//   summed with TPR-lane shuffles, over 32-key tiles read with 16-byte
//   loads whose next tile is issued before the current tile's math.
//
// Both bodies loop over key tiles from the first the window reaches to
// the last live causal tile for q_offset + q_end (and the row's length).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per shared-memory tile

template <int DH, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ lengths,
                     float* __restrict__ out, int Tq, int Tk, int H, int Hkv,
                     int G, int BQ, int causal, int window,
                     const int* __restrict__ q_offset_ptr, float scale) {
  const int q_offset = q_offset_ptr ? *q_offset_ptr : 0;
  constexpr int NCH = DH / 4;     // float4 chunks per row
  constexpr int CPL = NCH / TPR;  // chunks per lane
  static_assert(NCH % TPR == 0, "Dh/4 must divide by lanes per row");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * DH;

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % TPR;
  const int r = tid / TPR;
  const int g = r % G;
  const int i = r / G;
  const int q0 = qt * BQ;
  const int qi = q0 + i;
  const bool row_ok = (i < BQ) && (qi < Tq);
  const int h = kvh * G + g;
  const int qpos = q_offset + qi;

  float qr[CPL * 4];
  float acc[CPL * 4];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + c * TPR;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c * 4 + e] =
          row_ok ? q[((size_t)(b * Tq + qi) * H + h) * DH + ch * 4 + e] : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = rt::kNegInf, l = 0.f;

  // block-uniform key range: [kstart, kend) covers every live key of
  // every row of this tile; per-row masks below handle the rest
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Tq) - 1;
  const int len = lengths ? lengths[b] : Tk;
  int kend = min(Tk, len);
  if (causal) kend = min(kend, q_hi + 1);
  const int kstart = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = kstart / kBK;
  const int t1 = (kend + kBK - 1) / kBK;

  const size_t row_stride = (size_t)Hkv * DH;
  const float* kbase = k + ((size_t)b * Tk * Hkv + kvh) * DH;
  const float* vbase = v + ((size_t)b * Tk * Hkv + kvh) * DH;

  // a K/V tile is kBK rows of CPR 16-byte chunks, held in registers by
  // the threads (chunks tid, tid + 256, ...) until stored to shared
  // memory; the next tile's loads are issued before this tile's math
  constexpr int VEC = rt::kVec<float>;
  constexpr int CPR = DH / VEC;
  constexpr int NLD = (kBK * CPR + kThreads - 1) / kThreads;
  static_assert(DH % VEC == 0, "rows must be whole 16-byte chunks");
  uint4 kreg[NLD], vreg[NLD];
  auto issue = [&](int kb) {
#pragma unroll
    for (int u = 0; u < NLD; ++u) {
      const int idx = tid + u * kThreads;
      const int j = idx / CPR, c = idx - j * CPR;
      kreg[u] = vreg[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kBK * CPR && kb + j < Tk) {
        const size_t off = (size_t)(kb + j) * row_stride + c * VEC;
        kreg[u] = rt::ld16(kbase + off);
        vreg[u] = rt::ld16(vbase + off);
      }
    }
  };
  if (t0 < t1) issue(t0 * kBK);

  for (int t = t0; t < t1; ++t) {
    const int kb = t * kBK;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NLD; ++u) {
      const int idx = tid + u * kThreads;
      if (idx < kBK * CPR) {
        const int j = idx / CPR, c = idx - j * CPR;
        rt::unpack16(kreg[u], Ks + j * DH + c * VEC, float());
        rt::unpack16(vreg[u], Vs + j * DH + c * VEC, float());
      }
    }
    __syncthreads();
    if (t + 1 < t1) issue(kb + kBK);   // in flight during the math

    float s[kBK];
    float mt = rt::kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * DH);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float4 kk = kr[lane + c * TPR];
        part += qr[c * 4 + 0] * kk.x + qr[c * 4 + 1] * kk.y +
                qr[c * 4 + 2] * kk.z + qr[c * 4 + 3] * kk.w;
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const int kp = kb + j;
      bool ok = kp < Tk && kp < len;
      if (causal) ok = ok && qpos >= kp;
      if (window > 0) ok = ok && (qpos - kp < window);
      s[j] = ok ? part * scale : rt::kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < CPL * 4; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * DH);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float4 vv = vr[lane + c * TPR];
        acc[c * 4 + 0] += s[j] * vv.x;
        acc[c * 4 + 1] += s[j] * vv.y;
        acc[c * 4 + 2] += s[j] * vv.z;
        acc[c * 4 + 3] += s[j] * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    float* orow = out + ((size_t)(b * Tq + qi) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + c * TPR;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[ch * 4 + e] = acc[c * 4 + e] / lc;
    }
  }
}

template <int DH, int TPR>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Tq, int Tk, int H, int Hkv, int causal,
           int window, const int* q_offset_ptr, cudaStream_t stream) {
  const int rows = kThreads / TPR;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > rows) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int BQ = rows / G;
  const size_t smem = 2u * kBK * DH * sizeof(float);
  auto kern = flash_prefill_kernel<DH, TPR>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), Tq, Tk, H, Hkv, G, BQ, causal, window,
      q_offset_ptr, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int B, int Tq, int Tk, int H, int Hkv, int Dh,
             int causal, int window, const int* q_offset_ptr,
             cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<64, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, causal,
                           window, q_offset_ptr, stream);
    case 80:
      return launch<80, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, causal,
                           window, q_offset_ptr, stream);
    case 128:
      return launch<128, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, causal,
                            window, q_offset_ptr, stream);
    case 192:  // 24 dims a lane, six 16-byte loads
      return launch<192, 8>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, causal,
                            window, q_offset_ptr, stream);
    case 256:
      return launch<256, 8>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, causal,
                            window, q_offset_ptr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ tensor-core body ---
namespace tc {

using bf16 = __nv_bfloat16;
namespace sm = rt::sm90;

constexpr int kRows = 64;      // query rows a warpgroup (the wgmma M)
constexpr int kKeys = 64;      // keys a tile
constexpr int kWarpgroup = 128;
constexpr int kAtom = kKeys * 128;  // bytes of one 64-column atom of a tile

constexpr int kKStages = 2;    // K tiles in shared memory
constexpr int kVStages = 3;    // V tiles: P·V of t - 1 reads one while t + 1
                               // lands in another

// The layout of one head dim (the source's header says why).  A tile of
// Q, K or V is 64 rows of whole 64-column atoms; P·V runs over all of
// them, kPV columns, of which the first DH are stored.  kGroups warpgroups
// a block each own 64 query rows and share every K/V stage; with
// kQShared, S = Q·Kᵀ reads Q from its shared-memory tile instead of from
// registers.  Shared memory: kGroups Q tiles and the stages, plus room to
// align them to 1024 bytes.
template <int DH>
struct Layout {
  static constexpr int kAtoms = (DH + 63) / 64;
  static constexpr int kTile = kAtoms * kAtom;
  static constexpr int kPV = kAtoms * 64;
  static constexpr int kGroups = DH > 128 ? 2 : 1;
  static constexpr bool kQShared = DH > 128;
  static constexpr int kThreads = kGroups * kWarpgroup;
  static constexpr int kBytes = (kGroups + kKStages + kVStages) * kTile + 1024;
  static_assert(DH % 16 == 0, "S = Q·Kᵀ takes whole k16 steps");
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

// Phase profile, compiled in only with -DRT_PREFILL_PHASES (chip_smoke.py
// builds such a library beside the real one): thread 0 of each block adds
// the clock cycles it spent in each phase of the key loop, its tile count
// and 1 to g_phase_counts; rt_prefill_phases reads or zeroes them.  The
// compiler may move arithmetic across the clock reads, so a phase counts
// what the compiled code does between two of them.
#ifdef RT_PREFILL_PHASES
constexpr int kPhases = 6;  // load wait, issue, S wait, softmax, P·V wait,
                            // rescale and split
__device__ unsigned long long g_phase_counts[kPhases + 2];
#define RT_PHASE(i)                                                      \
  do {                                                                   \
    const long long now_ = clock64();                                    \
    phase_cycles[i] += now_ - phase_t;                                   \
    phase_t = now_;                                                      \
  } while (0)
#else
#define RT_PHASE(i) \
  do {              \
  } while (0)
#endif

// cp.async of rows [row0, row0 + 64) of a bf16 array with `stride`
// elements a row into a swizzled tile, by NT threads; rows at or past
// `nrows` are zero-filled.  Columns DH.. of the tile's last atom are not
// written.  Where NT threads cover a whole number of rows, and that
// number is a multiple of 8, each thread copies one chunk column in rows
// STEP apart, whose swizzled chunk is the same in every row: one source
// pointer stepped by STEP rows and one shared-memory address are all it
// keeps (with an offset computed for each copy, the Dh 256 instance
// spilled 48 bytes).
template <int DH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t stride, int row0, int nrows,
                                          int tid) {
  constexpr int CPR = DH / 8;                  // 16-byte chunks a row
  constexpr int N = kKeys * CPR / NT;
  static_assert(kKeys * CPR % NT == 0, "whole chunks a thread");
  if constexpr (NT % CPR == 0 && (NT / CPR) % 8 == 0) {
    constexpr int STEP = NT / CPR;
    const int r = tid / CPR, c = tid % CPR;
    const bf16* p = src + (size_t)(row0 + r) * stride + c * 8;
    const uint32_t d = dst + sm::swizzled(r, c, kKeys);
    const int left = nrows - row0 - r;         // rows this thread may read
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool ok = u * STEP < left;
      sm::cp_async16(d + u * STEP * 128, ok ? p : src, ok);
      p += STEP * stride;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + u * NT;
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = row0 + r < nrows;
      const bf16* p = src + (ok ? (size_t)(row0 + r) * stride : 0) + c * 8;
      sm::cp_async16(dst + sm::swizzled(r, c, kKeys), p, ok);
    }
  }
}

// O += P·V over one k16 step: `a` (16 keys of P) from registers, V
// MN-major from `base` (the step's first key row in the tile), over NPV
// columns: one n64 or n128 wgmma, or at NPV 192 and 256 an n128 over
// atoms 0-1 and an n64 or n128 from atom 2 into o[64..].
template <int NPV>
__device__ __forceinline__ void pv_k16(float (&o)[NPV / 2],
                                       const uint32_t (&a)[4],
                                       uint32_t base) {
  static_assert(NPV % 64 == 0 && NPV <= 256, "P·V over whole atoms");
  if constexpr (NPV == 64) {
    sm::wgmma_m64n64k16<1>(o, a, sm::desc_sw128(base, kAtom, 1024), 1);
  } else {
    sm::wgmma_m64n128k16<1>(o, a, sm::desc_sw128(base, kAtom, 1024), 1);
    if constexpr (NPV == 192)
      sm::wgmma_m64n64k16<1, 64>(
          o, a, sm::desc_sw128(base + 2 * kAtom, kAtom, 1024), 1);
    if constexpr (NPV == 256)
      sm::wgmma_m64n128k16<1, 64>(
          o, a, sm::desc_sw128(base + 2 * kAtom, kAtom, 1024), 1);
  }
}

template <int DH>
__global__ void __launch_bounds__(Layout<DH>::kThreads)
flash_prefill_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int* __restrict__ lengths,
                           bf16* __restrict__ out, int Tq, int Tk, int H,
                           int Hkv, int causal, int window,
                           const int* __restrict__ q_offset_ptr,
                           float scale_log2) {
  using L = Layout<DH>;
  const int q_offset = q_offset_ptr ? *q_offset_ptr : 0;
  constexpr int NO = L::kPV / 2;   // O accumulators a thread
  constexpr int T = L::kTile;
  constexpr int BR = L::kGroups * kRows;   // query rows a block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (sm::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::kGroups * T, sv = sk + kKStages * T;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // last tile first
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid % 32;
  // a one-warpgroup block's warpgroup is 0 at compile time
  const int wg = L::kGroups > 1 ? tid / kWarpgroup : 0;
  const int wtid = L::kGroups > 1 ? tid % kWarpgroup : tid;
  const int qw = q0 + wg * kRows;              // this warpgroup's rows
  const uint32_t sqw = sq + wg * T;            // ... and their Q tile
  const int r0 = (wtid / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);               // columns 8j + c0 + {0, 1}
  const int qp0 = q_offset + qw + r0, qp1 = qp0 + 8;

  // block-uniform key range [kstart, kend); per-row masks on edge tiles
  const int len = lengths ? lengths[b] : Tk;
  const int kvalid = min(Tk, len);
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BR, Tq) - 1;
  int kend = kvalid;
  if (causal) kend = min(kend, q_hi + 1);
  const int kstart = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = kstart / kKeys;
  const int t1 = (kend + kKeys - 1) / kKeys;
  // the warpgroup's own positions decide which tiles it masks
  const int w_lo = q_offset + qw;
  const int w_hi = q_offset + min(qw + kRows, Tq) - 1;

  const size_t qs = (size_t)H * DH, ks = (size_t)Hkv * DH;
  const bf16* qb = q + ((size_t)b * Tq * H + h) * DH;
  const bf16* kbase = k + ((size_t)b * Tk * Hkv + kvh) * DH;
  const bf16* vbase = v + ((size_t)b * Tk * Hkv + kvh) * DH;

  // cp.async groups, oldest first: Q (each warpgroup its own rows); K and
  // V of tile t0; then one a tile t: K and V of t + 1, issued at the top
  // of t into the K stage S of t - 1 read and the V stage P·V of t - 2
  // read, both done before that top.
  load_tile<DH, kWarpgroup>(sqw, qb, qs, qw, Tq, wtid);
  sm::cp_async_commit();
  if (t0 < t1) {
    load_tile<DH, L::kThreads>(sk, kbase, ks, t0 * kKeys, Tk, tid);
    load_tile<DH, L::kThreads>(sv, vbase, ks, t0 * kKeys, Tk, tid);
  }
  sm::cp_async_commit();

  // Q as the register A fragments of S = Q·Kᵀ's Dh/16 k-steps; with
  // kQShared the k-steps read the tile itself, visible to wgmma after the
  // first tile's wait and fence
  uint32_t qa[L::kQShared ? 1 : DH / 16][4];
  if constexpr (!L::kQShared) {
    sm::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qa[kk][e] = sm::ld_shared32(
            sqw + sm::swizzled(r0 + 8 * (e & 1), 2 * kk + e / 2, kKeys) +
            2 * c0);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf, l0 = 0.f, l1 = 0.f;
  // P of the previous tile as two bf16 terms, hi + lo: S's fragment of
  // columns 16kk..16kk+15 is the register A fragment of k-step kk
  uint32_t ph[4][4] = {}, pl[4][4] = {};

  // O += P·V of the tile in V stage `stage`, V MN-major in shared memory
  auto pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t base = sv + stage * T + kk * 16 * 128;
      pv_k16<L::kPV>(o, ph[kk], base);
      pv_k16<L::kPV>(o, pl[kk], base);
    }
  };

#ifdef RT_PREFILL_PHASES
  unsigned long long phase_cycles[kPhases] = {};
  long long phase_t = clock64();
#endif

  // Tile t: S = Q·Kᵀ of t and P·V of t - 1 are issued together and run
  // back to back on the tensor cores.  The source waits for P·V only after
  // the softmax, but the compiler places that wait before it (the SASS has
  // the WARPGROUP.DEPBAR there), so the softmax does not overlap P·V yet.
  for (int t = t0, vs = 0; t < t1; ++t, vs = vs == kVStages - 1 ? 0 : vs + 1) {
    const int buf = (t - t0) & 1;      // K stage of t; V stage of t is vs
    const int kb = t * kKeys;
    sm::cp_async_wait<0>();      // K and V of t (and Q) landed
    sm::fence_async_shared();
    __syncthreads();             // ... for every thread, which are all past
                                 // S of t - 1 and P·V of t - 2
    RT_PHASE(0);
    if (t + 1 < t1) {
      load_tile<DH, L::kThreads>(sk + (buf ^ 1) * T, kbase, ks, kb + kKeys,
                                 Tk, tid);
      load_tile<DH, L::kThreads>(sv + (vs == kVStages - 1 ? 0 : vs + 1) * T,
                                 vbase, ks, kb + kKeys, Tk, tid);
    }
    sm::cp_async_commit();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm::fence_regs(s);
    sm::fence_regs(o);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      const uint64_t dk = sm::desc_sw128(sk + buf * T + off, 16, 1024);
      if constexpr (L::kQShared)
        sm::wgmma_m64n64k16_ss(s, sm::desc_sw128(sqw + off, 16, 1024), dk,
                               kk > 0);
      else
        sm::wgmma_m64n64k16<0>(s, qa[kk], dk, kk > 0);
    }
    sm::wgmma_commit();
    if (t > t0) {
      pv(vs == 0 ? kVStages - 1 : vs - 1);
      sm::wgmma_commit();
      RT_PHASE(1);
      sm::wgmma_wait<1>();       // S of t done; P·V of t - 1 may still run
    } else {
      RT_PHASE(1);
      sm::wgmma_wait<0>();
    }
    sm::fence_regs(s);
    RT_PHASE(2);

    // online softmax in the exp2 domain
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    const bool edge = kb + kKeys > kvalid ||
                      (causal && kb + kKeys - 1 > w_lo) ||
                      (window > 0 && w_hi - kb >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kb + (i / 4) * 8 + c0 + (i & 1);
        const int qp = (i & 2) ? qp1 : qp0;
        bool ok = kp < kvalid;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        if (!ok) s[i] = rt::kNegInf;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float a0 = sm::exp2_ftz(m0 - mx0), a1 = sm::exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = sm::exp2_ftz(s[i] - ((i & 2) ? m1 : m0));
      if (i & 2) ps1 += s[i];
      else ps0 += s[i];
    }
    l0 = l0 * a0 + ps0;     // this thread's share of the row sums
    l1 = l1 * a1 + ps1;

    RT_PHASE(3);
    sm::wgmma_wait<0>();         // P·V of t - 1 done: O and P are free
    sm::fence_regs(o);
    sm::fence_regs(ph);
    sm::fence_regs(pl);
    RT_PHASE(4);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a1 : a0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm::split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e],
                       pl[kk][e]);
    RT_PHASE(5);
  }
#ifdef RT_PREFILL_PHASES
  if (tid == 0) {
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&g_phase_counts[i], phase_cycles[i]);
    atomicAdd(&g_phase_counts[kPhases], (unsigned long long)(t1 - t0));
    atomicAdd(&g_phase_counts[kPhases + 1], 1ull);
  }
#endif
  if (t0 < t1) {                 // P·V of the last tile (landed at its top)
    sm::fence_regs(o);
    sm::wgmma_fence();
    pv((t1 - 1 - t0) % kVStages);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const int row0 = qw + r0, row1 = row0 + 8;
  bf16* o0 = out + ((size_t)(b * Tq + row0) * H + h) * DH + c0;
  bf16* o1 = out + ((size_t)(b * Tq + row1) * H + h) * DH + c0;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (row0 < Tq)
      *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
          sm::pack_bf16(o[4 * j] / lc0, o[4 * j + 1] / lc0);
    if (row1 < Tq)
      *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
          sm::pack_bf16(o[4 * j + 2] / lc1, o[4 * j + 3] / lc1);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Tq, int Tk, int H, int Hkv, int causal,
           int window, const int* q_offset_ptr, cudaStream_t stream) {
  using L = Layout<DH>;
  if (Hkv < 1 || H % Hkv != 0) return cudaErrorInvalidValue;
  constexpr int BR = L::kGroups * kRows;
  auto kern = flash_prefill_wgmma_kernel<DH>;
  cudaError_t err = rt::allow_smem(kern, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (Tq + BR - 1) / BR, B);
  kern<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), Tq, Tk, H, Hkv, causal, window, q_offset_ptr,
      1.4426950408889634f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int B, int Tq, int Tk, int H, int Hkv, int Dh,
             int causal, int window, const int* q_offset_ptr,
             cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return tc::launch<64>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                            causal, window, q_offset_ptr, stream);
    case 80:
      return tc::launch<80>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                            causal, window, q_offset_ptr, stream);
    case 128:
      return tc::launch<128>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                             causal, window, q_offset_ptr, stream);
    case 192:
      return tc::launch<192>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                             causal, window, q_offset_ptr, stream);
    case 256:
      return tc::launch<256>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                             causal, window, q_offset_ptr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

#ifdef RT_PREFILL_PHASES
// counts: kPhases cycle sums, then tiles and blocks; zeroes them if reset
extern "C" int rt_prefill_phases(unsigned long long* counts, int reset) {
  if (reset) {
    const unsigned long long zero[tc::kPhases + 2] = {};
    return cudaMemcpyToSymbol(tc::g_phase_counts, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(counts, tc::g_phase_counts,
                              sizeof(unsigned long long) * (tc::kPhases + 2));
}
#endif

// Which body takes a call: 1 for the tensor-core body (bf16, every Dh
// the kernel takes), 0 for the CUDA-core body (f32).
extern "C" int rt_flash_prefill_body(int dtype, int Dh) {
  (void)Dh;
  return dtype == rt::kBFloat16;
}

// q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh); lengths: (B,) int32 or null;
// out: (B,Tq,H,Dh).  All contiguous, one dtype.  The query offset is the
// int32 `q_offset_ptr` points to in device memory, read by every block,
// or 0 when it is null: a CUDA graph captured once then serves every
// chunk offset.  The grid depends on B, Tq and Tk only.
// Returns a cudaError_t.
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int Tq,
                                int Tk, int H, int Hkv, int Dh, int causal,
                                int window, const void* q_offset_ptr,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset_ptr);
  if (dtype == rt::kFloat32)
    return dispatch(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, Dh, causal,
                    window, qo, s);
  if (rt_flash_prefill_body(dtype, Dh))
    return tc::dispatch(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, Dh, causal,
                        window, qo, s);
  return cudaErrorInvalidValue;
}
