// GQA flash-decode over a paged KV pool on Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_decode_attn.py:paged_flash_decode (Pallas
// TPU): one query token per row against a shared (n_pages, page, Hkv, Dh)
// pool through per-row block tables; validity `slot <= pos or (ring and
// pos >= s_len)`, `slot < s_len`; table entries clipped into the pool.
// It runs on every decode step of the paged pool.  The Pallas kernel
// brings the block table in by scalar prefetch; here the lanes that copy
// a slot's K/V row read its page from the table (clipped to
// [0, n_pages - 1]) as the tile is issued, so a tile may span pages.
//
// Everything else is the contiguous kernel's: the same split-KV body,
// split rule, pipeline, body rule and merge (decode_common.cuh).
//
// rt_paged_flash_decode_int8 runs the same body over an int8 pool (codes
// (n_pages, page, Hkv, Dh) and f32 scales (n_pages, page, Hkv) through
// the same tables), dequantizing in the kernel: it replaces the jnp
// gather-and-dequantize of the reference's repro/models/attention.py:
// self_attn_decode_paged (scope vmem_fused:paged_flash_decode_int8),
// which has no Pallas kernel.
#include "decode_common.cuh"

namespace {

template <typename T, typename KV, int DH, int MT>
__global__ void __launch_bounds__(rt::kDecThreads)
paged_flash_decode_kernel(rt::DecodeArgs<T, KV> a, rt::PagedSlots slots) {
  rt::decode_body<DH, MT>(a, slots);
}

struct Kernels {
  template <typename T, typename KV, int DH, int MT>
  static auto get() { return paged_flash_decode_kernel<T, KV, DH, MT>; }
};

template <typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* bt, const void* pos, void* out,
           void* part, void* arrivals, int B, int n_pages, int page, int n_p,
           int s_len, int H, int Hkv, int Dh, int ring, int L, int n_split,
           cudaStream_t stream) {
  if (Hkv <= 0 || H % Hkv || (long long)n_p * page < s_len)
    return cudaErrorInvalidValue;
  const auto a = rt::decode_args<T, KV>(q, kp, vp, ks, vs, pos, out, part,
                                        arrivals, H, Hkv, Dh, s_len, ring, L,
                                        n_split);
  return rt::launch_decode<T, KV, Kernels>(
      a, rt::PagedSlots{static_cast<const int*>(bt), n_p, page, n_pages}, B,
      Dh, stream);
}

}  // namespace

// q: (B,H,Dh); k, v pools: (n_pages,page,Hkv,Dh); block_tables:
// (B,n_p) int32; pos: (B,) int32; out: (B,H,Dh); part and arrivals as
// for rt_flash_decode.  All contiguous, one float dtype.  Returns a
// cudaError_t.
extern "C" int rt_paged_flash_decode(const void* q, const void* kp,
                                     const void* vp, const void* bt,
                                     const void* pos, void* out, void* part,
                                     void* arrivals, int B, int n_pages,
                                     int page, int n_p, int s_len, int H,
                                     int Hkv, int Dh, int ring, int L,
                                     int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float, float>(q, kp, vp, nullptr, nullptr, bt, pos, out,
                                part, arrivals, B, n_pages, page, n_p, s_len,
                                H, Hkv, Dh, ring, L, n_split, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, nullptr, nullptr, bt, pos, out, part, arrivals, B, n_pages,
        page, n_p, s_len, H, Hkv, Dh, ring, L, n_split, s);
  return cudaErrorInvalidValue;
}

// The same over an int8 pool: kp, vp (n_pages,page,Hkv,Dh) int8 codes;
// ks, vs (n_pages,page,Hkv) f32 scales; q and out in dtype (f32 or bf16).
extern "C" int rt_paged_flash_decode_int8(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* pos, void* out, void* part,
    void* arrivals, int B, int n_pages, int page, int n_p, int s_len, int H,
    int Hkv, int Dh, int ring, int L, int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float, int8_t>(q, kp, vp, ks, vs, bt, pos, out, part,
                                 arrivals, B, n_pages, page, n_p, s_len, H,
                                 Hkv, Dh, ring, L, n_split, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, bt, pos, out,
                                         part, arrivals, B, n_pages, page,
                                         n_p, s_len, H, Hkv, Dh, ring, L,
                                         n_split, s);
  return cudaErrorInvalidValue;
}
