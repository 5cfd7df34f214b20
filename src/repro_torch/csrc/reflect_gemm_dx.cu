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
// Routes, chosen on the host (kernels/reflect_gemm_dx.py, `route`) and
// counted by ops.routes("reflect_gemm_dx"):
//  * wgmma (bf16, K and N multiples of 8, x, W, G, u and v 16-byte
//    aligned): dxr_wgmma.cuh -- TMA-fed wgmma on 128-row tiles.  Where a
//    reflection block fits a tile (db ≤ 160: smollm-360m's 30 and 80 at
//    n = 32, 120 at n = 8, Llama-2-7B's 128) the reflection backward runs
//    in the GEMM's epilogue on the f32 accumulators, column tiles holding
//    whole blocks, and dXr never reaches device memory; du_kernel then
//    sums the row tiles' ĝ partials in order.  Wider blocks (db 320 at
//    n = 8 on d = 2560, 344 on Llama-2-7B's down_proj) take the same GEMM
//    into an (M, K) f32 scratch and the epilogue below.
//  * simt (float32, whose TOL of 1e-4 TF32 would miss; widths that are
//    not multiples of 8; a misaligned view): the register-tiled SIMT f32
//    GEMM of reflect_common.cuh writes dXr in f32 to the (M, K) scratch,
//    exact f32 math for both dtypes, no tensor cores.
//  * The SIMT route's and the scratch epilogue's reflection backward is
//    reflect_common.cuh's reflect_bwd_kernel: one warp per (32-row tile,
//    block) computes ûᵀx_t and ûᵀdXr_t by warp sums, writes dx and its ĝ
//    partial, for any db and any ragged M; du_kernel sums the partials in
//    a fixed order and applies norm_chain.  The Pallas kernel keeps the
//    dL/dû sum in VMEM across its sequential grid; Hopper runs blocks in
//    parallel and in no order, so every route writes per-tile partials
//    and sums them afterwards.  No float atomics on any route: the same
//    inputs give the same bits every run, which the trainer's bitwise
//    resume check needs.
//
// C interface, bound with ctypes: reflect_gemm_dx(...) launches the route
// it is given on the given stream, allocates nothing and returns a
// cudaError_t.

#include "dxr_wgmma.cuh"
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

// The wgmma route: the fused epilogue when nb > 0, else dXr to scratch
// and the SIMT route's epilogue.
template <bool RANK2>
int run_wgmma(const void* x, const void* w, const void* u, const void* v,
              const void* g, void* dxr, void* part, void* dx, void* du,
              void* dv, int M, int K, int N, int n, int db, int nb,
              cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  float* part_u = static_cast<float*>(part);
  float* part_v =
      part_u + static_cast<long long>(dxr::part_rows(M, M, nb > 0)) * K;
  const dxr::Args a{static_cast<const bf16*>(x),
                    static_cast<const float*>(u),
                    static_cast<const float*>(v),
                    static_cast<bf16*>(dx),
                    static_cast<float*>(dxr),
                    part_u,
                    part_v,
                    M, K, N, n, db, nb, M,
                    (M + dxr::kRows - 1) / dxr::kRows,
                    Tenants{}};
  cudaError_t err = dxr::launch<RANK2, false>(g, w, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0)
    return static_cast<int>(launch_reflect_bwd<bf16, float, RANK2>(
        a.x, a.dxr, a.u, a.v, a.dx, part_u, part_v,
        static_cast<float*>(du), static_cast<float*>(dv), M, K, n, db, s));
  return static_cast<int>(launch_du<RANK2>(
      part_u, a.u, static_cast<float*>(du), part_v, a.v,
      static_cast<float*>(dv), n, db, a.seq_tiles, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, G and dx alike); route: 0 =
// simt, 1 = wgmma (bf16, K and N multiples of 8, x, W, u, v and G 16-byte
// aligned), whose column tiles hold nb whole blocks (nb·db ≤ 160), or
// nb = 0 for the scratch epilogue.  v is null for the reflection,
// ETHER+'s second hyperplanes for H⁺ (dv is then written).  dxr is (M, K)
// f32 scratch (unread by the fused epilogue, which may pass null), part
// (dxr::part_rows(M, M, nb > 0), K) f32 scratch per direction (twice that
// with v; kernels/reflect_gemm_dx.py, part_rows), both written before they
// are read; du, dv (n, db) f32.
extern "C" int reflect_gemm_dx(const void* x, const void* w, const void* u,
                               const void* v, const void* g, void* dxr,
                               void* part, void* dx, void* du, void* dv, int M,
                               int K, int N, int n, int db, int dtype,
                               int route, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const void* ptrs[5] = {x, w, u, g, v};
    if (!dxr::takes(dtype, K, N, n, db, nb, ptrs, v ? 5 : 4) ||
        (nb == 0 && dxr == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return v ? run_wgmma<true>(x, w, u, v, g, dxr, part, dx, du, dv, M, K,
                               N, n, db, nb, s)
             : run_wgmma<false>(x, w, u, v, g, dxr, part, dx, du, dv, M, K,
                                N, n, db, nb, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
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
