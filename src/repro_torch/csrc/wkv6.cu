// RWKV6 WKV recurrence on Hopper (sm_90a).
//
// Replaces: repro/kernels/wkv6.py:wkv6 (Pallas TPU).  Per (batch row b,
// head h), with the (hs x hs) state S[k, v] and the bonus u:
//   y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//   S[k, v] <- w_t[k] * S[k, v] + k_t[k] * v_t[v]
// r, k, v come in f32 or bf16, w (the decay in (0, 1)), u and s0 in f32;
// y and sT are f32.  Callers pad with k = 0, w = 1 (an identity update).
//
// Bound on the H100: the recurrence is sequential in time, and at the
// serving shapes (B*H = 320 (b, h) pairs of hs = 64, 512 steps a chunk)
// it is bound by the latency of that dependent chain, not by bytes: a
// 512-step chunk at B = 8 moves 157 MB (0.047 ms at 3.35 TB/s) and needs
// 3.4 GFLOP (0.051 ms on the f32 CUDA cores): 5 flops a state element a
// step (r . S, k^T v, w S + kv), the bonus term being rank 1,
// (sum_k r[k] u[k] k[k]) v_t[v], so O(hs) a step.  This kernel folds the
// bonus into the per-element chain (7 flops an element).  One decode step
// moves the 10.8 MB of state in and out (0.0032 ms).
//
// Design: one block per (b, h), one thread per value channel v (hs
// threads).  Thread v keeps its state column S[:, v] in registers, in f32,
// for the whole sequence: the residency the Pallas kernel gets from its
// VMEM scratch, and the loop over time inside the block takes the place of
// its sequential grid axis.  A tile of kTT steps of r, k, v, w is staged
// in shared memory with coalesced loads (thread v reads element v of each
// row); every thread then reads r_t, k_t, w_t and u as broadcasts and
// updates its own column, so no reduction crosses threads.  The y sum is
// split over four accumulators to shorten its dependent chain.  s0 and sT
// may be the same buffer: each thread reads its column of s0 before the
// loop and writes the same column of sT after it, and no other thread
// touches that column.
#include "common.cuh"

namespace {

constexpr int kTT = 32;  // time steps per shared-memory tile

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sT, int n_t, int H) {
  __shared__ __align__(16) float sr[kTT][HS];
  __shared__ __align__(16) float sk[kTT][HS];
  __shared__ __align__(16) float sw[kTT][HS];
  __shared__ __align__(16) float sv[kTT][HS];
  __shared__ __align__(16) float su[HS];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t state = (static_cast<size_t>(b) * H + h) * HS * HS;
  const size_t step = static_cast<size_t>(H) * HS;     // between t and t+1
  const size_t base = static_cast<size_t>(b) * n_t * step + h * HS + j;

  su[j] = u[h * HS + j];
  float S[HS];
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = s0[state + i * HS + j];

  for (int t0 = 0; t0 < n_t; t0 += kTT) {
    const int n = min(kTT, n_t - t0);
    __syncthreads();  // the previous tile has been read by every thread
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = base + (t0 + tt) * step;
      sr[tt][j] = rt::to_f(r[off]);
      sk[tt][j] = rt::to_f(k[off]);
      sv[tt][j] = rt::to_f(v[off]);
      sw[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float kv = sk[tt][i] * vj;
        acc[i & 3] = fmaf(sr[tt][i], fmaf(su[i], kv, S[i]), acc[i & 3]);
        S[i] = fmaf(sw[tt][i], S[i], kv);
      }
      y[base + (t0 + tt) * step] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < HS; ++i) sT[state + i * HS + j] = S[i];
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int n_t,
           int H, cudaStream_t stream) {
  wkv6_kernel<T, HS><<<dim3(H, B), HS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), n_t, H);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT, int B, int n_t,
             int H, int hs, cudaStream_t stream) {
  switch (hs) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, n_t, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, n_t, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sT, B, n_t, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B,T,H,hs) in `dtype`; w: (B,T,H,hs) f32; u: (H,hs) f32;
// s0, sT: (B,H,hs,hs) f32 (may alias); y: (B,T,H,hs) f32.  All
// contiguous.  hs must be 16, 32 or 64.  Returns a cudaError_t.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* y,
                       void* sT, int B, int T, int H, int hs, int dtype,
                       void* stream) {
  if (B < 1 || H < 1 || T < 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch<float>(r, k, v, w, u, s0, y, sT, B, T, H, hs, s);
  if (dtype == rt::kBFloat16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T, H, hs, s);
  return cudaErrorInvalidValue;
}
