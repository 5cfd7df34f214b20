// householder_gemm_batched_dw: the dW half of the backward of the bank
// GEMM y[b] = R_{ids[b]}(x[b]) · W, R_t the blockwise reflection
// I − 2ûûᵀ of tenant t of an adapter bank, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_batched_dw_pallas
// (src/repro/kernels/gemm_bwd.py:383, _gemm_dw_batched_kernel, pallas_call
// at :420): dW = Σ_b R_{ids[b]}(x_b)ᵀ · G_b, the shared frozen weight's
// cotangent.  It is a launch of its own, as the Pallas kernel is a
// pallas_call of its own, so that PEFT training through a bank (W frozen)
// never runs it: the autograd Function asks for it only when W requires
// grad.  x (B·S, K), G (B·S, N) bf16 or f32 alike; u_bank (A, n, db) f32
// raw hyperplanes, n·db = K; ids (B,) int32 or int64, mapped into [0, A)
// as the forward kernel maps them; dW (K, N) in x's dtype.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): a GEMM that reduces over the B·S token
// rows, 2·M·K·N operations; at M = 1024 and smollm-360m's 960×2560 it is
// 5.0 GFLOP, 5 µs on the bf16 tensor cores, against about 9 MB of bytes,
// 3 µs.  Operations bound, as the single-tenant reflect_gemm_dw.
//
// What the design does about that — a simple kernel that is right first:
//  * It is reflect_gemm_dw over a bank: the prologue (proj_kernel under
//    BANK) computes each token row's block projections x_t,i · û_i and
//    block norms with its own sequence's tenant's hyperplanes into an
//    (M, n) pair of scratches, and the shared GEMM of reflect_common.cuh
//    reflects Aᵀ = x along m while it stages its tiles, reading û at the
//    token's tenant (kReflectM under BANK).  The reflected x never
//    reaches device memory, and the GEMM's tiles span any sequences.
//  * The reduction over the tokens runs inside each block's K loop, so
//    every dW element is summed by one thread in a fixed order: no
//    atomics, the same bits every run.
//  * SIMT f32, no tensor cores, as every GEMM of the port so far.
//
// C interface, bound with ctypes: hh_gemm_batched_dw(...) launches both
// kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* u, const void* g, const Tenants& tn,
        void* p, void* unorm, void* dw, int M, int K, int N, int n, int db,
        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<T, false, true>(xt, pr, M, K, s, tn);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW (K×N) = R_t(x)ᵀ (K×M) · G (M×N): A(i, t) = x[t*K + i] reflected with
  // token t's tenant's û, B(t, c) = g[t*N + c]
  return static_cast<int>(
      launch_gemm<T, T, T, false, true, kReflectM, kFuseNone, true>(
          xt, K, static_cast<const T*>(g), N, static_cast<T*>(dw), K, N, M,
          pr, s, Side{}, tn));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, G and dW alike).  ids: B = M / seq
// ids, int64 when ids64, else int32; tenants = A.  p and unorm are (M, n)
// f32 scratch each, written before they are read.
extern "C" int hh_gemm_batched_dw(const void* x, const void* u, const void* g,
                                  const void* ids, int ids64, int seq,
                                  int tenants, void* p, void* unorm, void* dw,
                                  int M, int K, int N, int n, int db,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (dtype == 0)
    return run<float>(x, u, g, tn, p, unorm, dw, M, K, N, n, db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, u, g, tn, p, unorm, dw, M, K, N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
