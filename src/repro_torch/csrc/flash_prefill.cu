// GQA flash attention for prefill and chunked prefill on Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_prefill.py:flash_prefill (Pallas TPU),
// generalised to Tq != Tk with a query offset: Tq queries at absolute
// positions q_offset + i attend over Tk keys at positions 0..Tk-1, which
// is what chunked prefill runs (a chunk of Tc queries over the cache).
// Causal, sliding-window and non-causal masks, per-row key `lengths`.
//
// Bound on the H100: at long T the work is the 4*T^2/2*H*Dh FLOPs of the
// two products (tensor-core bound at 989 TFLOP/s bf16); at short T the
// bytes of q, k, v and out.  This first version computes in f32 on the
// CUDA cores and so sits well above that bound; wgmma/TMA is later work.
//
// Design: one block of 256 threads per (q tile, kv head, batch row).  The
// q tile holds 256/TPR rows: BQ = rows/G query positions times the G
// query heads of that kv head, so each K/V tile loaded into shared memory
// is shared by all G heads (the GQA saving the Pallas kernel gets from
// its `h // G` index map).  Each row is owned by TPR consecutive lanes,
// each holding Dh/TPR dims of q and of the f32 accumulator in registers;
// a score is a per-lane partial dot product summed with TPR-lane
// shuffles.  The sequential kv-block grid axis of the Pallas kernel
// becomes a loop over 32-key tiles, which starts at the first tile the
// window reaches and stops at the last live causal tile for
// q_offset + q_end (and at the row's length).  Tiles are read with
// 16-byte loads into registers and the next tile's loads are issued
// before the current tile's math.  Online softmax keeps m, l
// and the accumulator in f32; l is clamped at 1e-30 as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per shared-memory tile

template <typename T, int DH, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int Tq, int Tk, int H, int Hkv,
                     int G, int BQ, int causal, int window, int q_offset,
                     float scale) {
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
          row_ok ? rt::to_f(q[((size_t)(b * Tq + qi) * H + h) * DH + ch * 4 + e])
                 : 0.f;
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
  const T* kbase = k + ((size_t)b * Tk * Hkv + kvh) * DH;
  const T* vbase = v + ((size_t)b * Tk * Hkv + kvh) * DH;

  // a K/V tile is kBK rows of CPR 16-byte chunks, held in registers by
  // the threads (chunks tid, tid + 256, ...) until stored to shared
  // memory; the next tile's loads are issued before this tile's math
  constexpr int VEC = rt::kVec<T>;
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
        rt::unpack16(kreg[u], Ks + j * DH + c * VEC, T());
        rt::unpack16(vreg[u], Vs + j * DH + c * VEC, T());
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
    T* orow = out + ((size_t)(b * Tq + qi) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + c * TPR;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[ch * 4 + e] = rt::from_f<T>(acc[c * 4 + e] / lc);
    }
  }
}

template <typename T, int DH, int TPR>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Tq, int Tk, int H, int Hkv, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int rows = kThreads / TPR;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > rows) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int BQ = rows / G;
  const size_t smem = 2u * kBK * DH * sizeof(float);
  auto kern = flash_prefill_kernel<T, DH, TPR>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Tq, Tk, H, Hkv, G, BQ, causal, window, q_offset,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int B, int Tq, int Tk, int H, int Hkv, int Dh,
             int causal, int window, int q_offset, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                              causal, window, q_offset, stream);
    case 80:
      return launch<T, 80, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                              causal, window, q_offset, stream);
    case 128:
      return launch<T, 128, 4>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                               causal, window, q_offset, stream);
    case 256:
      return launch<T, 256, 8>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                               causal, window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh); lengths: (B,) int32 or null;
// out: (B,Tq,H,Dh).  All contiguous, one dtype.  Returns a cudaError_t.
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int Tq,
                                int Tk, int H, int Hkv, int Dh, int causal,
                                int window, int q_offset, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch<float>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv, Dh,
                           causal, window, q_offset, s);
  if (dtype == rt::kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, Tq, Tk, H, Hkv,
                                   Dh, causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
