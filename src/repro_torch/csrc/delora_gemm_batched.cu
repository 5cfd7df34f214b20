// delora_gemm_batched: y[b] = x[b]·W + ((x[b]·a_t)·s_t)·b_t with t =
// ids[b] for every sequence b of a batch, DeLoRA's adapted linear in
// multi-tenant bank serving, for sm_90a.
//
// Replaces the TPU kernel delora_gemm_batched_pallas
// (src/repro/kernels/delora_gemm.py:129, _delora_batched_kernel at :100,
// pallas_call at :169): the DeLoRA forward of every adapted linear under
// `serve --tenants N` (src/repro/core/methods.py:527-531).
// x: (B·S, K) bf16 or f32, W: (K, N) same dtype, a_bank: (A, K, r) f32,
// b_bank: (A, r, N) f32, s_bank: (A, r) in x's dtype (the method layer's
// scale of every tenant, rounded to the activation dtype as the JAX
// package rounds it), ids: (B,) int32 or int64 (mapped into [0, A));
// y: (B·S, N) in x's dtype.  Everything inside is f32 and the low-rank
// term is added to the f32 sum before the one rounding, as in the Pallas
// kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the base GEMM, as for delora_gemm — bytes
// at decode (W read once, plus the gathered a_t, b_t: 4·r·(K + N) bytes a
// distinct tenant), operations at prefill.  The rank-r term adds
// 2·M·r·(K + N) operations.
//
// What the design does about that — a simple kernel that is right first:
//  * The single-tenant kernel stages one a tile per K step for all rows of
//    a tile (kFuseLowRank), which cannot serve rows of different tenants.
//    Rather than keep each tile inside one sequence (the Pallas grid
//    (B, S/Ts, F/Tf, K/Tk), which reads W once per sequence: four times
//    at B = 4 decode), the work is split in two launches:
//    1. h_kernel, one warp per (row m, rank j): h[m, j] = x_m · a_t[:, j]
//       in f32 into an (M, r) scratch (M·r·4 bytes);
//    2. the shared GEMM of reflect_common.cuh in its kFuseRowLowRank
//       variant under BANK: x·W, and the epilogue adds
//       Σ_j (h[m, j]·s_t[j])·b_t[j, col] at the output row's tenant before
//       the one rounding.
//    So W is read once for the whole batch, and h is computed once a row
//    rather than once per column tile as the fused single-tenant kernel
//    does.
//  * The (M, r) h reaches device memory (KBs at decode), the one byte
//    stream the Pallas kernel keeps on chip; a x·a pass reads x once more.
//  * Training through a bank (src/repro/kernels/ops.py:515) runs it once
//    more per linear for dx = G·Wᵀ + ((G·b_tᵀ)·s_t)·a_tᵀ: W read
//    transposed in place (w_t), the banks' transposes (small copies) in
//    place of a and b.
//  * No tensor cores, as every GEMM of the port so far.
//
// C interface, bound with ctypes: delora_gemm_batched(...) launches both
// kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

// One warp per (row m, rank j): h[m*r + j] = Σ_k x[m, k]·a_t[k, j] in f32,
// t the row's tenant.  a_t's column j is strided by r; a tenant's a is
// K·r·4 bytes (31 KB at K = 960, r = 8), read from L2 by its rows.
template <typename T>
__global__ void h_kernel(const T* __restrict__ x, const float* __restrict__ a,
                         float* __restrict__ h, int M, int K, int r,
                         Tenants tn) {
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * r) return;  // whole warps exit
  const int m = static_cast<int>(pair / r), j = static_cast<int>(pair % r);
  const float* at = a + static_cast<long long>(row_tenant(tn, m)) * K * r + j;
  const T* xm = x + static_cast<long long>(m) * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32)
    acc = fmaf(to_f32(xm[k]), __ldg(at + static_cast<long long>(k) * r), acc);
  acc = warp_sum(acc);
  if (lane == 0) h[pair] = acc;
}

template <typename T>
int run(const void* x, const void* w, const void* a, const void* b,
        const void* sv, const Tenants& tn, void* h, void* y, int M, int K,
        int N, int r, int w_t, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * r;
  h_kernel<T><<<static_cast<unsigned>((pairs + kThreads / 32 - 1) /
                                      (kThreads / 32)),
                kThreads, 0, s>>>(xt, static_cast<const float*>(a),
                                  static_cast<float*>(h), M, K, r, tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Side sd;
  sd.lb = static_cast<const float*>(b);
  sd.ls = sv;
  sd.h = static_cast<const float*>(h);
  sd.r = r;
  const Proj none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1};
  // y (M×N) = x (M×K) · W (K×N) + ((h·s_t)·b_t) per row; B(k, n) =
  // w[k*N + n], or transposed from the (N, K) weight, w[n*K + k]
  const T* wt = static_cast<const T*>(w);
  if (w_t)
    return static_cast<int>(
        launch_gemm<T, T, T, true, false, kReflectNone, kFuseRowLowRank,
                    true>(xt, K, wt, K, static_cast<T*>(y), M, N, K, none, s,
                          sd, tn));
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectNone, kFuseRowLowRank, true>(
          xt, K, wt, N, static_cast<T*>(y), M, N, K, none, s, sd, tn));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, s and y alike).  ids: B = M /
// seq ids, int64 when ids64, else int32; tenants = A.  h is (M, r) f32
// scratch, written before it is read.  w_t = 1 reads W as the transpose of
// a row-major (N, K) matrix.
extern "C" int delora_gemm_batched(const void* x, const void* w,
                                   const void* a, const void* b,
                                   const void* sv, const void* ids, int ids64,
                                   int seq, int tenants, void* h, void* y,
                                   int M, int K, int N, int r, int w_t,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (dtype == 0)
    return run<float>(x, w, a, b, sv, tn, h, y, M, K, N, r, w_t, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, a, b, sv, tn, h, y, M, K, N, r, w_t,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}
