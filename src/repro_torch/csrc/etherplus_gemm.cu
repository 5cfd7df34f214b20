// etherplus_gemm: y = (H⁺x) · W [· H̃⁺], the ETHER+ adapted linear, for
// sm_90a.  H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of the input (u1, v1), H̃⁺ the same
// on the output blocks (u2, v2) when the adapter is two-sided.
//
// Replaces the TPU kernel etherplus_gemm_pallas
// (src/repro/kernels/etherplus_gemm.py:92, _ep_gemm_kernel at :66,
// _ep_gemm_kernel_2s at :75, pallas_call at :148): the forward of every
// adapted linear under ETHER+, in serving, in training and in its remat
// recompute, and the y0 recompute of the two-sided backward.
// x: (M, K) bf16 or f32, W: (K, N) same dtype, u1/v1: (n, db) f32 raw with
// n·db = K, u2/v2: (n_out, db_out) f32 raw with n_out·db_out = N; y: (M, N)
// in x's dtype.  Both projections read the original x (a true rank-2
// update, not two reflections).  Everything inside is f32, and the H̃⁺
// epilogue acts on the f32 product before the one rounding, as in the
// Pallas kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): as for householder_gemm, the GEMM — bytes
// at decode (W read once: 960×2560 bf16 is 1.5 µs), operations at prefill
// and in training (1024×960×2560 is 5.0 GFLOP, 5 µs).  The rank-2 update
// adds O(M·K + M·N) work, nothing next to the GEMM.
//
// What the design does about that — a simple kernel that is right first:
//  * The input side reuses householder_gemm's design: a prologue reads x
//    once and writes both block projections (ûᵀx, v̂ᵀx) and both norms,
//    and the shared GEMM of reflect_common.cuh applies x − p·û + q·v̂ to
//    each x element as it stages the A tile (kRank2K), for any db.
//  * The Pallas kernel reflects its f32 accumulator tile on the output
//    blocks, which needs each F tile to hold whole blocks (Tf % db_out ==
//    0).  At smollm-360m's widths db_out is 40, 120 or 320 (n = 8) and 10,
//    30 or 80 (n = 32), which no Hopper tile holds.  So, as reflect_gemm_dx
//    does, the two-sided GEMM writes its f32 result to an (M, N) scratch,
//    and rank2_rows_kernel (one warp per (row, output block)) applies H̃⁺
//    and rounds once.  The one-sided kernel writes y straight from the
//    GEMM.  Fusing the epilogue into the GEMM is later work (ROADMAP.md).
//  * The GEMM is SIMT f32 (no tensor cores); wgmma is the next step.
//
// C interface, bound with ctypes: etherplus_gemm(...) launches the
// prologue, the GEMM and (two-sided) the epilogue on the given stream,
// allocates nothing and returns cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* u1, const void* v1,
        const void* u2, const void* v2, void* scratch, void* yacc, void* y,
        int M, int K, int N, int n, int db, int n_out, int db_out,
        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const Proj pr = carve(static_cast<const float*>(u1),
                        static_cast<const float*>(v1),
                        static_cast<float*>(scratch), M, n, db);
  cudaError_t err = launch_proj<T, true>(xt, pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // y0 (M×N) = H⁺(x) (M×K) · W (K×N): A(t, k) = x[t*K + k] updated along k
  if (!u2)
    return static_cast<int>(launch_gemm<T, T, T, true, true, kRank2K>(
        xt, K, wt, N, static_cast<T*>(y), M, N, K, pr, s));
  float* acc = static_cast<float*>(yacc);
  err = launch_gemm<T, T, float, true, true, kRank2K>(xt, K, wt, N, acc, M, N,
                                                      K, pr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_rank2_rows<float, T>(
      acc, static_cast<const float*>(u2), static_cast<const float*>(v2),
      static_cast<T*>(y), M, n_out, db_out, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike).  u2 and v2 are
// null one-sided.  scratch is f32 of 2·(M + 1)·n floats, yacc (M, N) f32
// (two-sided only, else null), both written before they are read.
extern "C" int etherplus_gemm(const void* x, const void* w, const void* u1,
                              const void* v1, const void* u2, const void* v2,
                              void* scratch, void* yacc, void* y, int M, int K,
                              int N, int n, int db, int n_out, int db_out,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N, n, db,
                      n_out, db_out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N,
                              n, db, n_out, db_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
