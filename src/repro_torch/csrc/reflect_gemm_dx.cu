// reflect_gemm_dx: the (dx, du) half of the backward of y = R(x) · W,
// R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel reflect_gemm_dx_pallas
// (src/repro/kernels/gemm_bwd.py:118, _gemm_dx_kernel at :60, pallas_call
// at :151): the gradient of every adapted linear in training.  Under the
// cotangent G (M, N):
//   dXr = G · Wᵀ                         (M, K), f32
//   dx  = R(dXr) = dXr − 2 (ûᵀdXr) û     (M, K) in x's dtype
//   ĝ   = −2 Σ_t [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t]   per block, f32
//   du  = norm_chain(u, ĝ) = ĝ/s − (u·ĝ) u / (r s²),  r = ‖u‖, s = r + ε
// (src/repro/kernels/reflect_bwd.py:37, XLA's AD of û = u/(‖u‖+ε)).
// x, W, G bf16 or f32 alike; u (n, db) f32 raw hyperplanes, n·db = K.
// With v (the rank-2 shim _rank2_kernel_shim, gemm_bwd.py:108: the
// backward of ETHER+'s y = H⁺(x)·W) the reflection is H⁺ = I − ûûᵀ + v̂v̂ᵀ:
// dx = H⁺(dXr), ĝ_u takes the coefficient −1 in place of −2, and a ĝ_v
// with +1 gives dv beside du.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the dXr GEMM, 2·M·N·K operations.  At the
// train step of smollm-360m (M = B·S = 1024) down_proj's 1024×960×2560 is
// 5.0 GFLOP, 5 µs on the bf16 tensor cores, and the bytes it must move
// (x, W, G, dx) 11 MB, 3 µs.  Operations bound, like the forward.
//
// What the design does about that — a simple kernel that is right first:
//  * The Pallas kernel keeps the dL/dû sum in VMEM scratch across its
//    sequential grid.  Hopper runs blocks in parallel and in no order, so
//    here each tile of kRowsPerTile rows writes its own partial ĝ
//    (⌈M/kRowsPerTile⌉, n, db; a second one for ĝ_v) and a last small
//    kernel sums the partials in a fixed order and applies norm_chain.
//    No floating-point atomics: the same inputs give the same bits every
//    run, which the trainer's bitwise resume check needs.
//  * The Pallas kernel needs each K tile to hold whole reflection blocks;
//    smollm-360m's db = 30 or 80 (n = 32) fits no Hopper tile.  So the
//    GEMM writes dXr in f32 to an (M, K) scratch, and an epilogue kernel
//    runs one warp per (row tile, block): it computes ûᵀx_t and ûᵀdXr_t
//    by warp sums, writes dx and accumulates its ĝ partial in shared
//    memory, for any db and any ragged M.  Fusing the epilogue into the
//    GEMM (and so never writing dXr) is later work.
//  * The GEMM is the register-tiled SIMT f32 kernel of reflect_common.cuh:
//    exact f32 math for both dtypes, no tensor cores, so it runs at the
//    f32 rate (67 TFLOP/s), far from the bf16 bound.  wgmma with TMA-fed
//    shared-memory rings is the next step (ROADMAP.md).
//
// The epilogue and the ĝ sum are reflect_common.cuh's reflect_bwd_kernel
// and du_kernel, which etherplus_reflect_bwd runs too.
//
// C interface, bound with ctypes: reflect_gemm_dx(...) launches the three
// kernels (four with v) on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T, bool RANK2>
int run(const void* x, const void* w, const void* u, const void* v,
        const void* g, void* dxr, void* part, void* dx, void* du, void* dv,
        int M, int K, int N, int n, int db, cudaStream_t s) {
  float* dxr_f = static_cast<float*>(dxr);
  float* part_u = static_cast<float*>(part);
  // dXr (M×K) = G (M×N) · Wᵀ: A(m, k) = g[m*N + k], B(k, c) = w[c*N + k]
  cudaError_t err = launch_gemm<T, T, float, true, false, kReflectNone>(
      static_cast<const T*>(g), N, static_cast<const T*>(w), N, dxr_f, M, K, N,
      Proj{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, db}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reflect_bwd<T, float, RANK2>(
      static_cast<const T*>(x), dxr_f, static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<T*>(dx), part_u,
      part_u + static_cast<long long>(row_tiles(M)) * K,
      static_cast<float*>(du), static_cast<float*>(dv), M, K, n, db, s));
}

}  // namespace

// Rows of ĝ partials the caller's `part` scratch must hold per direction,
// times n·db.
extern "C" int reflect_gemm_dx_row_tiles(int M) { return row_tiles(M); }

// dtype: 0 = float32, 1 = bfloat16 (x, W, G and dx alike).  v is null for
// the reflection, ETHER+'s second hyperplanes for H⁺ (dv is then written).
// dxr is (M, K) f32 scratch, part (reflect_gemm_dx_row_tiles(M), n, db)
// f32 scratch per direction (twice that with v), both written before they
// are read; du, dv (n, db) f32.
extern "C" int reflect_gemm_dx(const void* x, const void* w, const void* u,
                               const void* v, const void* g, void* dxr,
                               void* part, void* dx, void* du, void* dv, int M,
                               int K, int N, int n, int db, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !v)
    return run<float, false>(x, w, u, v, g, dxr, part, dx, du, dv, M, K, N, n,
                             db, s);
  if (dtype == 1 && !v)
    return run<__nv_bfloat16, false>(x, w, u, v, g, dxr, part, dx, du, dv, M,
                                     K, N, n, db, s);
  if (dtype == 0)
    return run<float, true>(x, w, u, v, g, dxr, part, dx, du, dv, M, K, N, n,
                            db, s);
  if (dtype == 1)
    return run<__nv_bfloat16, true>(x, w, u, v, g, dxr, part, dx, du, dv, M, K,
                                    N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
