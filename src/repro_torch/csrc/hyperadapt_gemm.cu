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
// y: (M, N) in x's dtype.  Everything inside is f32 (x·r formed in f32,
// f32 accumulation, the column scale on the f32 sum before the one
// rounding), as in the Pallas kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the GEMM, as for householder_gemm — bytes
// at decode (W read once: 960×2560 bf16 is 1.5 µs), operations at prefill
// and in training (2048×960×2560 is 10.1 GFLOP, 10 µs).  The scales add
// O(M·K + M·N) multiplies, nothing next to it.
//
// Routes, chosen on the host (kernels/hyperadapt_gemm.py, `route`) and
// counted by ops.routes("hyperadapt_gemm"):
//  * wgmma (bf16, d and f multiples of 8, x, W, r and c 16-byte aligned):
//    scaled_wgmma.cuh's core with one tenant (kOne), as the bank's
//    hyperadapt_gemm_batched runs it with many: a prologue writes x⊙r,
//    formed in f32, as a bf16 hi and lo plane (a (2, M, K) scratch); the
//    TMA-fed wgmma GEMM adds hi·W and lo·W in 64-deep K partials added in
//    order, and its epilogue multiplies the f32 accumulator by c[col] and
//    rounds once (kColScale; kPlain without c: the backward's z and y0).
//    Both kernels from this one C call, on one stream.
//  * simt (float32, and the shapes the rule refuses): the shared SIMT f32
//    GEMM of reflect_common.cuh in its kFuseScale variant: the row scale
//    multiplies each x element as the A tile is staged, the column scale
//    the f32 sum in the epilogue; nothing scaled reaches device memory.
// On either route the backward's z reads W where it lies, transposed: no
// copy of W a call.
//
// C interface, bound with ctypes: hyperadapt_gemm(...) launches the route
// it is given on the given stream, allocates nothing and returns a
// cudaError_t; ha_map_counts reads the wgmma route's tensor-map cache.

#include "reflect_common.cuh"
#include "scaled_wgmma.cuh"

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

int run_wgmma(const void* x, const void* w, const void* r, const void* c,
              void* xr, void* y, int M, int K, int N, int w_t,
              cudaStream_t s) {
  const void* ptrs[4] = {x, w, r, c};
  if (!sw::takes(K, N, ptrs, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  sw::scale_rows_kernel<<<sw::scale_blocks(M, K), 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(r),
      static_cast<bf16*>(xr), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sw::Args args{};
  args.y = static_cast<bf16*>(y);
  args.c = static_cast<const float*>(c);
  args.M = M, args.K = K, args.N = N;
  if (c == nullptr)
    return static_cast<int>(
        sw::launch<sw::kOne | sw::kPlain>(xr, w, w_t, args, s));
  return static_cast<int>(
      sw::launch<sw::kOne | sw::kColScale>(xr, w, w_t, args, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike); route: 0 = SIMT,
// 1 = wgmma (bf16 only).  w_t = 1 reads W as the transpose of a row-major
// (N, K) matrix.  c may be null (no column scale).  xr: the wgmma route's
// (2, M, K) bf16 scratch, written before it is read (unused by SIMT).
extern "C" int hyperadapt_gemm(const void* x, const void* w, const void* r,
                               const void* c, void* xr, void* y, int M,
                               int K, int N, int w_t, int dtype, int route,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1)
    return run_wgmma(x, w, r, c, xr, y, M, K, N, w_t, s);
  if (route == 0 && dtype == 0)
    return run<float>(x, w, r, c, y, M, K, N, w_t, s);
  if (route == 0 && dtype == 1)
    return run<__nv_bfloat16>(x, w, r, c, y, M, K, N, w_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route's tensor-map cache: lookups and encodes (its misses)
// since the library was loaded, into counts[0] and counts[1].
extern "C" int ha_map_counts(long long* counts) {
  sw::map_cache().counts(counts);
  return 0;
}
