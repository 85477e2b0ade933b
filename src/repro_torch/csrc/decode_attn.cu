// GQA flash-decode over a contiguous KV cache on Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attn.py:flash_decode (Pallas TPU): one
// query token per row against a (B, S, Hkv, Dh) cache, `pos` validity and
// ring (sliding-window) caches.  It carries the contiguous slot pool of
// the serving engine.  Bound, design and what holds it back: see
// decode_common.cuh; a slot s of row b is cache row b*S + s.
#include "decode_common.cuh"

namespace {

template <typename T, int DH>
__global__ void __launch_bounds__(rt::kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    T* __restrict__ out, int H, int Hkv, int G, int S,
                    int ring, float scale) {
  rt::decode_block<T, DH>(q, kc, vc, pos, out, H, Hkv, G, S, ring, scale,
                          rt::ContiguousSlots{S});
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* out, int B, int S, int H, int Hkv, int ring,
           cudaStream_t stream) {
  if (!rt::decode_shape_ok(H, Hkv, DH)) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem = rt::decode_smem_bytes(G, DH);
  auto kern = flash_decode_kernel<T, DH>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), rt::kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(out), H, Hkv, G, S, ring,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* pos,
             void* out, int B, int S, int H, int Hkv, int Dh, int ring,
             cudaStream_t stream) {
  switch (Dh) {
    case 64: return launch<T, 64>(q, kc, vc, pos, out, B, S, H, Hkv, ring, stream);
    case 80: return launch<T, 80>(q, kc, vc, pos, out, B, S, H, Hkv, ring, stream);
    case 128: return launch<T, 128>(q, kc, vc, pos, out, B, S, H, Hkv, ring, stream);
    case 256: return launch<T, 256>(q, kc, vc, pos, out, B, S, H, Hkv, ring, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,H,Dh); k, v: (B,S,Hkv,Dh); pos: (B,) int32; out: (B,H,Dh).
// All contiguous, one dtype.  Returns a cudaError_t.
extern "C" int rt_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* pos, void* out, int B, int S, int H,
                               int Hkv, int Dh, int ring, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch<float>(q, kc, vc, pos, out, B, S, H, Hkv, Dh, ring, s);
  if (dtype == rt::kBFloat16)
    return dispatch<__nv_bfloat16>(q, kc, vc, pos, out, B, S, H, Hkv, Dh, ring,
                                   s);
  return cudaErrorInvalidValue;
}
