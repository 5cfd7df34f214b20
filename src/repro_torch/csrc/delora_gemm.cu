// delora_gemm: y = x·W + ((x·a)·s)·b, the DeLoRA adapted linear, for
// sm_90a.
//
// Replaces the TPU kernel delora_gemm_pallas
// (src/repro/kernels/delora_gemm.py:66, _delora_kernel at :38,
// pallas_call at :82): the forward of every adapted linear under DeLoRA,
// in serving, in training and in its remat recompute, and the dx of its
// backward (src/repro/kernels/ops.py:482-512), which the JAX package runs
// on the same kernel with transposed operands:
//   dx = G·Wᵀ + ((G·bᵀ)·s)·aᵀ   W read transposed, la = bᵀ, lb = aᵀ.
// x: (M, K) bf16 or f32, W: (K, N) same dtype (or, read transposed, the
// (N, K) weight of the forward), a: (K, r) f32, b: (r, N) f32, both
// row-major, s: (r,) in x's dtype (the method layer's pre-normalised
// scale (λ/r)/(‖a_j‖‖b_j‖ + ε), rounded to the activation dtype as the JAX
// package rounds it); y: (M, N) in x's dtype.  Everything inside is f32
// and the low-rank term is added to the f32 sum before the one rounding,
// as in the Pallas kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the base GEMM, as for householder_gemm —
// bytes at decode (W read once), operations at prefill and in training.
// The rank-r term adds 2·M·r·(K + N) operations, r/N and r/K of the GEMM.
//
// What the design does about that — a simple kernel that is right first:
//  * The shared SIMT f32 GEMM of reflect_common.cuh in its kFuseLowRank
//    variant: beside the B tile each K step stages the a tile (BK × r) in
//    shared memory, and the block accumulates h = x·a (BM × r) in shared
//    memory in the same K loop, so x is read once for both products and
//    the (M, r) intermediate never reaches device memory.  The epilogue
//    adds (h·s)·b[:, col] to each f32 output.  Each h element belongs to
//    one thread for the whole loop: no atomics, a fixed order.
//  * Like the Pallas kernel, every column tile of a row block recomputes
//    its rows' h (r/BN more operations than the GEMM); r is held whole in
//    shared memory, up to kMaxRank = 512.  h in registers would cost TM·r
//    floats a thread (register spills, PERF.md run J); shared memory costs
//    (BM + BK)·r·4 bytes a block, 20 KB at r = 64.
//  * dx reads W where it lies, transposed (B_N_CONTIG = false): no copy of
//    W a call; aᵀ and bᵀ are KB-sized copies made by the caller.
//  * No tensor cores: it runs at the f32 rate, like every GEMM of the port
//    so far; wgmma with TMA-fed rings is later work (ROADMAP.md).
//
// C interface, bound with ctypes: delora_gemm(...) launches one kernel on
// the given stream, allocates nothing and returns cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* a, const void* b,
        const void* sv, void* y, int M, int K, int N, int r, int w_t,
        cudaStream_t s) {
  if (r < 1 || r > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  Side sd;
  sd.la = static_cast<const float*>(a);
  sd.lb = static_cast<const float*>(b);
  sd.ls = sv;
  sd.r = r;
  const Proj none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1};
  // y (M×N) = x (M×K) · W + ((x·a)·s)·b: B(k, n) = w[k*N + n], or
  // transposed from the (N, K) weight, B(k, n) = w[n*K + k]
  if (w_t)
    return static_cast<int>(
        launch_gemm<T, T, T, true, false, kReflectNone, kFuseLowRank>(
            xt, K, wt, K, static_cast<T*>(y), M, N, K, none, s, sd));
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectNone, kFuseLowRank>(
          xt, K, wt, N, static_cast<T*>(y), M, N, K, none, s, sd));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, s and y alike).  w_t = 1 reads W
// as the transpose of a row-major (N, K) matrix.
extern "C" int delora_gemm(const void* x, const void* w, const void* a,
                           const void* b, const void* sv, void* y, int M,
                           int K, int N, int r, int w_t, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w, a, b, sv, y, M, K, N, r, w_t, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, a, b, sv, y, M, K, N, r, w_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
