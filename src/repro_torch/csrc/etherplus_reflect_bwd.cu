// etherplus_reflect_bwd: the backward of ETHER+'s output-side rank-2 update
// y = H⁺x, H⁺ = I − ûûᵀ + v̂v̂ᵀ per block, for sm_90a.
//
// Replaces the TPU kernel etherplus_reflect_bwd_pallas
// (src/repro/kernels/reflect_bwd.py:150, _r2_bwd_kernel at :89,
// pallas_call at :161).  The two-sided ETHER+ backward runs it on the
// recomputed pre-epilogue product y0 = (H⁺x)·W (rounded to the activation
// dtype, as the JAX package's ops.etherplus_gemm_bwd does) under the
// layer's cotangent G, so x here is y0.  For x, G (M, K) bf16 or f32
// alike and u, v (n, db) f32 raw with n·db = K:
//   dx = G − (ûᵀG) û + (v̂ᵀG) v̂                         (M, K) in x's dtype
//   ĝ_u = −Σ_t [(ûᵀx_t) G_t + (ûᵀG_t) x_t],  ĝ_v the same with v̂ and +
//   du, dv = norm_chain(u, ĝ_u), norm_chain(v, ĝ_v)     (n, db) f32
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  It reads x
// and G and writes dx, ~12 flops per element.  At the train step of
// smollm-360m (M = 1024) gate_proj's output (K = 2560) is 3 × 5.2 MB in
// bf16, about 4.7 µs.
//
// What the design does about that: it is the same work as the epilogue of
// reflect_gemm_dx with G in place of dXr, so it runs reflect_common.cuh's
// reflect_bwd_kernel (one warp per (32-row tile, block): warp sums for
// the four projections, dx written, the tile's ĝ_u and ĝ_v partials kept
// in shared memory) and du_kernel for both directions in one launch,
// which sums the partials in a fixed order and applies the norm chain.
// No float atomics, so a train step gives the same bits every run.
//
// C interface, bound with ctypes: etherplus_reflect_bwd(...) launches the
// two kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

using namespace reflect;

// Rows of ĝ partials the caller's `part` scratch must hold per direction,
// times n·db.
extern "C" int etherplus_reflect_bwd_row_tiles(int M) { return row_tiles(M); }

// dtype: 0 = float32, 1 = bfloat16 (x, G and dx alike).  part is f32
// scratch of 2·etherplus_reflect_bwd_row_tiles(M)·n·db floats, written
// before it is read; du, dv (n, db) f32.
extern "C" int etherplus_reflect_bwd(const void* x, const void* u,
                                     const void* v, const void* g, void* part,
                                     void* dx, void* du, void* dv, int M,
                                     int K, int n, int db, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_u = static_cast<float*>(part);
  float* part_v = part_u + static_cast<long long>(row_tiles(M)) * K;
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  float* duf = static_cast<float*>(du);
  float* dvf = static_cast<float*>(dv);
  if (dtype == 0)
    return static_cast<int>(launch_reflect_bwd<float, float, true>(
        static_cast<const float*>(x), static_cast<const float*>(g), uf, vf,
        static_cast<float*>(dx), part_u, part_v, duf, dvf, M, K, n, db, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_reflect_bwd<__nv_bfloat16, __nv_bfloat16, true>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), uf, vf,
            static_cast<__nv_bfloat16*>(dx), part_u, part_v, duf, dvf, M, K,
            n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
