// GQA flash-decode over a contiguous KV cache on Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attn.py:flash_decode (Pallas TPU): one
// query token per row against a (B, S, Hkv, Dh) cache, `pos` validity and
// ring (sliding-window) caches.  It carries the contiguous slot pool of
// the serving engine.  A slot s of row b is cache row b*S + s.
//
// Bound (the bytes of K and V), the split rule, the cp.async pipeline,
// the body rule (bf16 on the tensor cores, f32 on the CUDA cores), the
// one-launch merge and what still holds the kernel back: see
// decode_common.cuh.  The host picks the split (kernels/decode_attn.py:
// plan) and allocates the partials; this file only names the kernel.
//
// rt_flash_decode_int8 runs the same body over an int8 cache (codes
// (B, S, Hkv, Dh) and f32 scales (B, S, Hkv)), dequantizing in the
// kernel: it replaces the jnp dequantization of the reference's
// repro/models/attention.py:self_attn_decode (scope
// vmem_fused:flash_decode_int8), which has no Pallas kernel.
#include "decode_common.cuh"

namespace {

template <typename T, typename KV, int DH, int MT>
__global__ void __launch_bounds__(rt::kDecThreads)
flash_decode_kernel(rt::DecodeArgs<T, KV> a, rt::ContiguousSlots slots) {
  rt::decode_body<DH, MT>(a, slots);
}

struct Kernels {
  template <typename T, typename KV, int DH, int MT>
  static auto get() { return flash_decode_kernel<T, KV, DH, MT>; }
};

template <typename T, typename KV>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* pos, void* out, void* lse, void* part,
           void* arrivals, int B, int S, int H, int Hkv, int Dh, int ring,
           int L, int n_split, cudaStream_t stream) {
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  const auto a = rt::decode_args<T, KV>(q, kc, vc, ks, vs, pos, out, part,
                                        arrivals, H, Hkv, Dh, S, ring, L,
                                        n_split, lse);
  return rt::launch_decode<T, KV, Kernels>(a, rt::ContiguousSlots{S}, B, Dh,
                                           stream);
}

}  // namespace

// q: (B,H,Dh); k, v: (B,S,Hkv,Dh); pos: (B,) int32; out: (B,H,Dh); lse:
// (B,H) f32, each (row, head)'s log-sum-exp of its scaled scores (null:
// not written); part: (B,H,n_split,Dh+2) f32 scratch (may be null when
// n_split == 1); arrivals: >= B*Hkv int32, zero.  All contiguous, one
// dtype; L and n_split from kernels/decode_attn.py:plan.  Returns a
// cudaError_t.
extern "C" int rt_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* pos, void* out, void* lse,
                               void* part, void* arrivals, int B, int S,
                               int H, int Hkv, int Dh, int ring, int L,
                               int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float, float>(q, kc, vc, nullptr, nullptr, pos, out, lse,
                                part, arrivals, B, S, H, Hkv, Dh, ring, L,
                                n_split, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, nullptr, nullptr, pos, out, lse, part, arrivals, B, S, H,
        Hkv, Dh, ring, L, n_split, s);
  return cudaErrorInvalidValue;
}

// The same over an int8 cache: kc, vc (B,S,Hkv,Dh) int8 codes; ks, vs
// (B,S,Hkv) f32 scales; q and out in dtype (f32 or bf16); lse as above.
extern "C" int rt_flash_decode_int8(const void* q, const void* kc,
                                    const void* vc, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, void* lse, void* part,
                                    void* arrivals, int B, int S, int H,
                                    int Hkv, int Dh, int ring, int L,
                                    int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float, int8_t>(q, kc, vc, ks, vs, pos, out, lse, part,
                                 arrivals, B, S, H, Hkv, Dh, ring, L, n_split,
                                 s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16, int8_t>(q, kc, vc, ks, vs, pos, out, lse,
                                         part, arrivals, B, S, H, Hkv, Dh,
                                         ring, L, n_split, s);
  return cudaErrorInvalidValue;
}

#ifdef RT_DECODE_PHASES
// counts: the int8 body's kDecPhases cycle sums, then warp tiles and
// warps, of this source's kernels; zeroes them if reset
extern "C" int rt_decode_phases(unsigned long long* counts, int reset) {
  if (reset) {
    const unsigned long long zero[rt::kDecPhases + 2] = {};
    return cudaMemcpyToSymbol(rt::g_decode_phases, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(counts, rt::g_decode_phases,
                              sizeof(unsigned long long) *
                                  (rt::kDecPhases + 2));
}
#endif

// 1 when (dtype, Dh) runs the tensor-core body of both decode kernels
// (bf16, at every head dim they take), 0 for the CUDA-core body (f32):
// the dispatch of decode_common.cuh's decode_body overloads, which
// kernels/decode_attn.py:body repeats.
extern "C" int rt_decode_body(int dtype, int Dh) {
  (void)Dh;
  return dtype == rt::kBFloat16;
}
