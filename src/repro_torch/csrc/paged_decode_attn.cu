// GQA flash-decode over a paged KV pool on Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_decode_attn.py:paged_flash_decode (Pallas
// TPU): one query token per row against a shared (n_pages, page, Hkv, Dh)
// pool through per-row block tables; validity `slot <= pos or (ring and
// pos >= s_len)`, `slot < s_len`; table entries clipped into the pool.
// It runs on every decode step of the paged pool.  The Pallas kernel
// brings the block table in by scalar prefetch; here each block reads its
// own row's entries, clipped to [0, n_pages - 1], as it streams the
// slots.  Bound, design and what holds it back: see decode_common.cuh.
#include "decode_common.cuh"

namespace {

template <typename T, int DH>
__global__ void __launch_bounds__(rt::kDecThreads)
paged_flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ pos, T* __restrict__ out,
                          int H, int Hkv, int G, int s_len, int page, int n_p,
                          int n_pages, int ring, float scale) {
  rt::decode_block<T, DH>(q, kp, vp, pos, out, H, Hkv, G, s_len, ring, scale,
                          rt::PagedSlots{block_tables, n_p, page, n_pages});
}

template <typename T, int DH>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* pos, void* out, int B, int n_pages, int page, int n_p,
           int s_len, int H, int Hkv, int ring, cudaStream_t stream) {
  if (!rt::decode_shape_ok(H, Hkv, DH) || s_len > n_p * page)
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem = rt::decode_smem_bytes(G, DH);
  auto kern = paged_flash_decode_kernel<T, DH>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), rt::kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out), H, Hkv, G, s_len,
      page, n_p, n_pages, ring, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* bt,
             const void* pos, void* out, int B, int n_pages, int page,
             int n_p, int s_len, int H, int Hkv, int Dh, int ring,
             cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(q, kp, vp, bt, pos, out, B, n_pages, page, n_p,
                           s_len, H, Hkv, ring, stream);
    case 80:
      return launch<T, 80>(q, kp, vp, bt, pos, out, B, n_pages, page, n_p,
                           s_len, H, Hkv, ring, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, bt, pos, out, B, n_pages, page, n_p,
                            s_len, H, Hkv, ring, stream);
    case 256:
      return launch<T, 256>(q, kp, vp, bt, pos, out, B, n_pages, page, n_p,
                            s_len, H, Hkv, ring, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,H,Dh); k, v pools: (n_pages,page,Hkv,Dh); block_tables:
// (B,n_p) int32; pos: (B,) int32; out: (B,H,Dh).  All contiguous, one
// float dtype.  Returns a cudaError_t.
extern "C" int rt_paged_flash_decode(const void* q, const void* kp,
                                     const void* vp, const void* bt,
                                     const void* pos, void* out, int B,
                                     int n_pages, int page, int n_p,
                                     int s_len, int H, int Hkv, int Dh,
                                     int ring, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch<float>(q, kp, vp, bt, pos, out, B, n_pages, page, n_p,
                           s_len, H, Hkv, Dh, ring, s);
  if (dtype == rt::kBFloat16)
    return dispatch<__nv_bfloat16>(q, kp, vp, bt, pos, out, B, n_pages, page,
                                   n_p, s_len, H, Hkv, Dh, ring, s);
  return cudaErrorInvalidValue;
}
