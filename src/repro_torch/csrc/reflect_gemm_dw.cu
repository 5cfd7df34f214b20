// reflect_gemm_dw: the dW half of the backward of y = R(x) · W,
// R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel reflect_gemm_dw_pallas
// (src/repro/kernels/gemm_bwd.py:213, _gemm_dw_kernel at :178,
// pallas_call at :246): dW = R(x)ᵀ · G, the frozen-weight cotangent.  It
// is a launch of its own, as the Pallas kernel is a pallas_call of its
// own, so that PEFT training (W frozen) never runs it: the autograd
// Function asks for it only when W requires grad.
// x (M, K), G (M, N) bf16 or f32 alike; u (n, db) f32 raw hyperplanes,
// n·db = K; dW (K, N) in W's dtype (= x's dtype).  With v (the rank-2
// shim _dw_rank2_shim, gemm_bwd.py:204) R is ETHER+'s H⁺ = I − ûûᵀ + v̂v̂ᵀ:
// the prologue projects x on both directions in one read, and the staging
// applies x − (ûᵀx)û + (v̂ᵀx)v̂.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): a GEMM that reduces over the M token rows,
// 2·M·K·N operations; at M = 1024 and smollm-360m's 960×2560 it is 5.0
// GFLOP, 5 µs on the bf16 tensor cores, against 9 MB of bytes, 3 µs.
// Operations bound.
//
// What the design does about that — a simple kernel that is right first:
//  * The reflection is applied to x while the GEMM stages its A tile
//    (Aᵀ = R(x)), as the forward kernel does: the prologue of
//    reflect_common.cuh first computes the block projections p[t, i] =
//    x_t,i · û_i into an (M, n) f32 scratch, for any db and ragged edge.
//    The reflected x never reaches device memory.
//  * The reduction over M runs inside each block's K loop, so every dW
//    element is summed by one thread in a fixed order: no atomics, the
//    same bits every run.
//  * The GEMM is the register-tiled SIMT f32 kernel of reflect_common.cuh
//    (f32 math for both dtypes, no tensor cores): it runs at the f32 rate;
//    wgmma is later work (ROADMAP.md).
//
// C interface, bound with ctypes: reflect_gemm_dw(...) launches both
// kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T, bool RANK2>
int run(const void* x, const void* u, const void* v, const void* g,
        void* scratch, void* dw, int M, int K, int N, int n, int db,
        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr = carve(static_cast<const float*>(u),
                        static_cast<const float*>(v),
                        static_cast<float*>(scratch), M, n, db);
  cudaError_t err = launch_proj<T, RANK2>(xt, pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW (K×N) = R(x)ᵀ (K×M) · G (M×N): A(i, t) = x[t*K + i] reflected,
  // B(t, c) = g[t*N + c]
  return static_cast<int>(
      launch_gemm<T, T, T, false, true, RANK2 ? kRank2M : kReflectM>(
          xt, K, static_cast<const T*>(g), N, static_cast<T*>(dw), K, N, M,
          pr, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, G and dW alike).  v is null for the
// reflection, ETHER+'s second hyperplanes for H⁺.  scratch is f32 of
// (M + 1)·n floats (twice that with v), written before it is read.
extern "C" int reflect_gemm_dw(const void* x, const void* u, const void* v,
                               const void* g, void* scratch, void* dw, int M,
                               int K, int N, int n, int db, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !v)
    return run<float, false>(x, u, v, g, scratch, dw, M, K, N, n, db, s);
  if (dtype == 1 && !v)
    return run<__nv_bfloat16, false>(x, u, v, g, scratch, dw, M, K, N, n, db,
                                     s);
  if (dtype == 0)
    return run<float, true>(x, u, v, g, scratch, dw, M, K, N, n, db, s);
  if (dtype == 1)
    return run<__nv_bfloat16, true>(x, u, v, g, scratch, dw, M, K, N, n, db,
                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}
