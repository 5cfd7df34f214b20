// hyperadapt_gemm_batched: y[b] = ((x[b]·r_t) · W) · c_t with t = ids[b]
// for every sequence b of a batch, HyperAdapt's adapted linear in
// multi-tenant bank serving, for sm_90a.
//
// Replaces the TPU kernel hyperadapt_gemm_batched_pallas
// (src/repro/kernels/hyperadapt_gemm.py:105, pallas_call at :141): the
// HyperAdapt forward of every adapted linear under `serve --tenants N`
// (src/repro/core/methods.py:574-577).
// x: (B·S, K) bf16 or f32, W: (K, N) same dtype, r_bank: (A, K) f32,
// c_bank: (A, N) f32, ids: (B,) int32 or int64 (mapped into [0, A));
// y: (B·S, N) in x's dtype.  The column scale multiplies the f32 sum
// before the one rounding, as in the Pallas kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the GEMM, as for hyperadapt_gemm — bytes
// at decode (W read once, plus B·(K + N) floats of gathered scales),
// operations at prefill.
//
// Routes, chosen on the host (kernels/batched.py, `hyperadapt_route`)
// and counted by ops.routes("hyperadapt_gemm_batched"):
//  * wgmma (bf16, d and f multiples of 8, x, W and both banks 16-byte
//    aligned): scaled_wgmma.cuh's core.  A prologue writes x⊙r_t, formed
//    in f32 at each row's tenant (read on the device), as a bf16 hi and lo
//    plane (a (2, M, K) scratch); the TMA-fed wgmma GEMM adds hi·W and
//    lo·W and its epilogue multiplies the f32 accumulator by c_t[col] at
//    each row's tenant and rounds once (kColScale; kPlain without c).  A
//    row tile spans rows of any sequences, so W is read once a call.  Both
//    kernels from this one C call, on one stream.
//  * simt (float32, and the shapes the rule refuses): the shared SIMT f32
//    GEMM of reflect_common.cuh in its kFuseScale variant under BANK: the
//    row scale multiplies each x element in f32 as the A tile is staged,
//    read at the row's tenant, and the column scale multiplies the f32 sum at the
//    output row's tenant.  A tile spans rows of several tenants and W is
//    read once for the whole batch, where the Pallas grid (B, S/Ts, F/Tf,
//    K/Tk) reads it once per sequence.
// Training through a bank (src/repro/kernels/ops.py:609) runs it twice
// more per linear for z = (G·c_t)·Wᵀ (row scale c, W read transposed in
// place: w_t) and y0 = (x·r_t)·W, each without its column scale (c null),
// on either route.
//
// C interface, bound with ctypes: hyperadapt_gemm_batched(...) launches
// the route it is given on the given stream, allocates nothing and returns
// a cudaError_t; hg_map_counts reads the wgmma route's tensor-map cache.

#include "reflect_common.cuh"
#include "scaled_wgmma.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* r, const void* c,
        const Tenants& tn, void* y, int M, int K, int N, int w_t,
        cudaStream_t s) {
  Side sd;
  sd.rs = static_cast<const float*>(r);
  sd.cs = static_cast<const float*>(c);
  const Proj none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1};
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  // B(k, n) = w[k*N + n], or transposed from the (N, K) weight, w[n*K + k]
  if (w_t)
    return static_cast<int>(
        launch_gemm<T, T, T, true, false, kReflectNone, kFuseScale, true>(
            xt, K, wt, K, static_cast<T*>(y), M, N, K, none, s, sd, tn));
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectNone, kFuseScale, true>(
          xt, K, wt, N, static_cast<T*>(y), M, N, K, none, s, sd, tn));
}

int run_wgmma(const void* x, const void* w, const void* r, const void* c,
              const Tenants& tn, void* xr, void* y, int M, int K, int N,
              int w_t, cudaStream_t s) {
  const void* ptrs[4] = {x, w, r, c};
  if (!sw::takes(K, N, ptrs, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  sw::scale_rows_kernel<<<sw::scale_blocks(M, K), 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(r),
      static_cast<bf16*>(xr), tn, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sw::Args args{};
  args.y = static_cast<bf16*>(y);
  args.c = static_cast<const float*>(c);
  args.tn = tn;
  args.M = M, args.K = K, args.N = N;
  if (c == nullptr)
    return static_cast<int>(sw::launch<sw::kPlain>(xr, w, w_t, args, s));
  return static_cast<int>(sw::launch<sw::kColScale>(xr, w, w_t, args, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike); route: 0 = SIMT,
// 1 = wgmma (bf16 only).  ids: B = M / seq ids, int64 when ids64, else
// int32; tenants = A.  w_t = 1 reads W as the transpose of a row-major
// (N, K) matrix.  c may be null (no column scale).  xr: the wgmma route's
// (2, M, K) bf16 scratch, written before it is read (unused by SIMT).
extern "C" int hyperadapt_gemm_batched(const void* x, const void* w,
                                       const void* r, const void* c,
                                       const void* ids, int ids64, int seq,
                                       int tenants, void* xr, void* y, int M,
                                       int K, int N, int w_t, int dtype,
                                       int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq || !r)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (route == 1 && dtype == 1)
    return run_wgmma(x, w, r, c, tn, xr, y, M, K, N, w_t, s);
  if (route == 0 && dtype == 0)
    return run<float>(x, w, r, c, tn, y, M, K, N, w_t, s);
  if (route == 0 && dtype == 1)
    return run<__nv_bfloat16>(x, w, r, c, tn, y, M, K, N, w_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route's tensor-map cache: lookups and encodes (its misses)
// since the library was loaded, into counts[0] and counts[1].
extern "C" int hg_map_counts(long long* counts) {
  sw::map_cache().counts(counts);
  return 0;
}
