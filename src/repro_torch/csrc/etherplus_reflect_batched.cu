// etherplus_reflect_batched: out[b] = H⁺_t x[b] with t = ids[b] for every
// sequence b of a batch, H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of tenant t of an
// ETHER+ adapter bank, for sm_90a.
//
// Replaces the TPU kernel etherplus_reflect_batched_pallas
// (src/repro/kernels/etherplus_reflect_batched.py:44, pallas_call at :70):
// ETHER+ bank serving (`serve --tenants N`, src/repro/core/methods.py:
// 258-270) runs it twice per adapted linear, on x before the shared
// frozen GEMM (u1/v1 over d) and, two-sided, on its output (u2/v2 over
// f); the GEMM between them is a plain product, as the JAX package leaves
// it to XLA.
// x: (B·S, d) bf16 or f32, u_bank/v_bank: (A, n, db) f32 raw with
// n·db = d, ids: (B,) int32 or int64 (mapped into [0, A)); out: (B·S, d)
// in x's dtype.  Both projections read the original x (a true rank-2
// update); everything inside is f32 with one rounding, as in the Pallas
// kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, the data sheet's rate at
// 700 W): bytes.  It reads x and writes out once (4·B·S·d bytes in bf16)
// and does ~10 operations an element.
//
// What the design does about that — a simple kernel that is right first:
//  * It is the per-row rank-2 kernel of reflect_common.cuh
//    (rank2_rows_kernel, which the two-sided etherplus_gemm epilogue and
//    the right ETHER+ merge run) under BANK: one warp per (row, block),
//    the row's tenant ids[m / S] (mapped into [0, A)) picking its
//    hyperplanes, so rows of any sequences share a launch.  The Pallas
//    grid is (B, S/Ts), one sequence a step.
//  * Each warp recomputes its block's two norms from the bank (2·db
//    floats, from L2): nothing is precomputed on the host per call.
//
// C interface, bound with ctypes: etherplus_reflect_batched(...) launches
// one kernel on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).  ids: B = M / seq
// ids, int64 when ids64, else int32; tenants = A.  out must not alias x.
extern "C" int etherplus_reflect_batched(const void* x, const void* u,
                                         const void* v, const void* ids,
                                         int ids64, int seq, int tenants,
                                         void* out, int M, int n, int db,
                                         int dtype, void* stream) {
  using namespace reflect;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  if (dtype == 0)
    return static_cast<int>(launch_rank2_rows<float, float, true>(
        static_cast<const float*>(x), uf, vf, static_cast<float*>(out), M, n,
        db, s, tn));
  if (dtype == 1)
    return static_cast<int>(
        launch_rank2_rows<__nv_bfloat16, __nv_bfloat16, true>(
            static_cast<const __nv_bfloat16*>(x), uf, vf,
            static_cast<__nv_bfloat16*>(out), M, n, db, s, tn));
  return static_cast<int>(cudaErrorInvalidValue);
}
