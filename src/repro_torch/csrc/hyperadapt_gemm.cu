// hyperadapt_gemm: y = ((x·r) · W) · c, the HyperAdapt adapted linear, for
// sm_90a.  diag(r) W diag(c) is applied without ever forming the scaled
// weight.
//
// Replaces the TPU kernel hyperadapt_gemm_pallas
// (src/repro/kernels/hyperadapt_gemm.py:51, _ha_kernel at :30,
// pallas_call at :66): the forward of every adapted linear under
// HyperAdapt, in serving, in training and in its remat recompute, and the
// two GEMMs of its backward (src/repro/kernels/ops.py:570-606), which the
// JAX package runs on the same kernel:
//   z  = (G·c) · Wᵀ   row scale c, W read transposed, no column scale;
//   y0 = (x·r) · W    the product before the column scale, recomputed.
// x: (M, K) bf16 or f32, W: (K, N) same dtype (or, read transposed, the
// (N, K) weight of the forward), r: (K,) f32, c: (N,) f32 or null;
// y: (M, N) in x's dtype.  Everything inside is f32 (x·r formed in f32 as
// the x tile is staged, f32 accumulation, the column scale on the f32 sum
// before the one rounding), as in the Pallas kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the GEMM, as for householder_gemm — bytes
// at decode (W read once: 960×2560 bf16 is 1.5 µs), operations at prefill
// and in training (1024×960×2560 is 5.0 GFLOP, 5 µs).  The scales add
// O(M·K + M·N) multiplies, nothing next to it.
//
// What the design does about that — a simple kernel that is right first:
//  * It is the shared SIMT f32 GEMM of reflect_common.cuh in its
//    kFuseScale variant: the row scale multiplies each x element as the A
//    tile is staged (where householder_gemm reflects it), the column scale
//    the f32 sum in the epilogue.  Nothing scaled reaches device memory.
//  * The backward's z reads W where it lies, transposed (B_N_CONTIG =
//    false): no copy of W a call.
//  * No tensor cores: it runs at the f32 rate, like every GEMM of the port
//    so far; wgmma with TMA-fed rings is later work (ROADMAP.md).
//
// C interface, bound with ctypes: hyperadapt_gemm(...) launches one kernel
// on the given stream, allocates nothing and returns cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* r, const void* c, void* y,
        int M, int K, int N, int w_t, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  Side sd;
  sd.rs = static_cast<const float*>(r);
  sd.cs = static_cast<const float*>(c);
  const Proj none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1};
  // y (M×N) = (x·r) (M×K) · W: B(k, n) = w[k*N + n], or transposed from the
  // (N, K) weight, B(k, n) = w[n*K + k]
  if (w_t)
    return static_cast<int>(
        launch_gemm<T, T, T, true, false, kReflectNone, kFuseScale>(
            xt, K, wt, K, static_cast<T*>(y), M, N, K, none, s, sd));
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectNone, kFuseScale>(
          xt, K, wt, N, static_cast<T*>(y), M, N, K, none, s, sd));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike).  w_t = 1 reads W
// as the transpose of a row-major (N, K) matrix.  c may be null (no column
// scale).
extern "C" int hyperadapt_gemm(const void* x, const void* w, const void* r,
                               const void* c, void* y, int M, int K, int N,
                               int w_t, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w, r, c, y, M, K, N, w_t, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, w, r, c, y, M, K, N, w_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
