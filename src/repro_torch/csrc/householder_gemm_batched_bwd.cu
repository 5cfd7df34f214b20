// householder_gemm_batched_bwd: the (dx, du_bank) backward of the bank
// GEMM y[b] = R_{ids[b]}(x[b]) · W, R_t the blockwise reflection
// I − 2ûûᵀ of tenant t of an adapter bank, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_batched_bwd_pallas
// (src/repro/kernels/gemm_bwd.py:303, _gemm_dx_batched_kernel, pallas_call
// at :347): the ETHER backward of every adapted linear when a model trains
// through an AdapterBank (the JAX package's
// jax.value_and_grad(train_loss(params, bank.request(ids), ...)) over the
// bank, src/repro/kernels/ops.py:412).  Under the cotangent G (B·S, N):
//   dXr = G · Wᵀ                                 (B·S, K), f32
//   dx  = R_t(dXr) per sequence                  (B·S, K) in x's dtype
//   ĝ_seq[b] = −2 Σ_{t∈b} [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t]   (B, n, db) f32
//   du_bank  = norm_chain(u_bank, Σ_{b: ids[b] = a} ĝ_seq[b])  (A, n, db)
// ĝ_seq is the Pallas kernel's second output; du_bank is what the JAX
// op's _bank_grad makes of it (scatter-add over the ids, then the ε-norm
// chain per bank row).  x, W, G bf16 or f32 alike; u_bank f32 raw
// hyperplanes, n·db = K; ids (B,) int32 or int64, an id outside [0, A)
// mapped into it as the forward kernel maps it (row_tenant), so the
// gradient of each sequence lands on the tenant that served it.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the dXr GEMM, 2·M·N·K operations, as the
// single-tenant reflect_gemm_dx.  At the train step of smollm-360m (M =
// B·S = 1024) down_proj's 1024×960×2560 is 5.0 GFLOP, 5 µs on the bf16
// tensor cores; the bytes it must move (x, W, G, dx, the bank rows of
// the tenants named) about 11 MB, 3 µs.  Operations bound.
//
// dXr does not depend on the tenant, so the two routes are
// reflect_gemm_dx's (kernels/batched.py, `route`; counted by
// ops.routes("householder_gemm_batched_bwd")):
//  * wgmma (bf16, K and N multiples of 8, x, W, G and the bank 16-byte
//    aligned): dxr_wgmma.cuh's TMA-fed wgmma GEMM.  Where a block fits a
//    tile (db ≤ 160) the reflection backward runs in its epilogue: each
//    sequence has ⌈S/128⌉ row tiles of its own (the last ragged: S = 1,
//    100 and 128 alike), a tile's hyperplanes are its sequence's
//    tenant's, read on the device, and each tile writes one ĝ partial a
//    column.  Wider blocks take the same GEMM into an (M, K) f32 scratch
//    and the epilogue below.
//  * simt (float32, other widths, a misaligned view): the shared SIMT f32
//    GEMM of reflect_common.cuh into the scratch, W read transposed in
//    place.
//  * The scratch epilogue is reflect_bwd_kernel under BANK: one warp per
//    (32-row tile, block), each tile inside one sequence, its hyperplanes
//    the sequence's tenant's; each tile writes its own ĝ partial.
//  * On every route seq_ghat_kernel sums each sequence's partials in order
//    (ĝ_seq), and bank_chain_kernel sums, per (tenant, block), the ĝ_seq
//    of the sequences its id names in order b = 0, 1, ... and applies the
//    norm chain; a tenant no id names gets an exact zero.  No float
//    atomics: the same inputs give the same bits every run, which the
//    bitwise restore of a train run needs.  The ids are read on the
//    device only.
//
// C interface, bound with ctypes: hh_gemm_batched_bwd(...) launches the
// route it is given on the given stream, allocates nothing and returns a
// cudaError_t.

#include "dxr_wgmma.cuh"
#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* u, const void* g,
        const Tenants& tn, void* dxr, void* part, void* ghat, void* dx,
        void* du, int M, int K, int N, int n, int db, cudaStream_t s) {
  float* dxr_f = static_cast<float*>(dxr);
  // dXr (M×K) = G (M×N) · Wᵀ: A(m, k) = g[m*N + k], B(k, c) = w[c*N + k]
  cudaError_t err = launch_gemm<T, T, float, true, false, kReflectNone>(
      static_cast<const T*>(g), N, static_cast<const T*>(w), N, dxr_f, M, K, N,
      Proj{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, db}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reflect_bwd_bank<T, float, false>(
      static_cast<const T*>(x), dxr_f, static_cast<const float*>(u), nullptr,
      static_cast<T*>(dx), static_cast<float*>(part),
      static_cast<float*>(ghat), static_cast<float*>(du), nullptr, M, K, n,
      db, tn, s));
}

// The wgmma route: the fused epilogue when nb > 0, else dXr to scratch
// and reflect_bwd_kernel under BANK.
int run_wgmma(const void* x, const void* w, const void* u, const void* g,
              const Tenants& tn, void* dxr, void* part, void* ghat, void* dx,
              void* du, int M, int K, int N, int n, int db, int nb,
              cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (nb == 0) {
    const dxr::Args a{static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
                      static_cast<float*>(dxr), nullptr, nullptr, M, K, N, n,
                      db, 0, M, (M + dxr::kRows - 1) / dxr::kRows, Tenants{}};
    cudaError_t err = dxr::launch_tiles<false, false, false, 128>(g, w, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_reflect_bwd_bank<bf16, float, false>(
        a.x, a.dxr, static_cast<const float*>(u), nullptr,
        static_cast<bf16*>(dx), static_cast<float*>(part),
        static_cast<float*>(ghat), static_cast<float*>(du), nullptr, M, K, n,
        db, tn, s));
  }
  const int seq_tiles = (tn.seq + dxr::kRows - 1) / dxr::kRows;
  const dxr::Args a{static_cast<const bf16*>(x),
                    static_cast<const float*>(u),
                    nullptr,
                    static_cast<bf16*>(dx),
                    nullptr,
                    static_cast<float*>(part),
                    nullptr,
                    M, K, N, n, db, nb, tn.seq, seq_tiles, tn};
  cudaError_t err = dxr::launch<false, true>(g, w, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_bank_sums(
      a.part_u, static_cast<float*>(ghat), a.u, nullptr,
      static_cast<float*>(du), nullptr, M / tn.seq, n, db, seq_tiles, 1, tn,
      s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, G and dx alike); route: 0 =
// simt, 1 = wgmma (bf16, K and N multiples of 8, x, W, u and G 16-byte
// aligned), whose column tiles hold nb whole blocks (nb·db ≤ 160), or
// nb = 0 for the scratch epilogue.  ids: B = M / seq ids, int64 when
// ids64, else int32; tenants = A.  dxr is (M, K) f32 scratch (unread by
// the fused epilogue, which may pass null), part
// (dxr::part_rows(M, seq, nb > 0), K) f32 scratch, both
// written before they are read; ghat (B, n, db) f32 and du (A, n, db) f32
// are outputs.
extern "C" int hh_gemm_batched_bwd(const void* x, const void* w,
                                   const void* u, const void* g,
                                   const void* ids, int ids64, int seq,
                                   int tenants, void* dxr, void* part,
                                   void* ghat, void* dx, void* du, int M,
                                   int K, int N, int n, int db, int dtype,
                                   int route, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (route == 1) {
    const void* ptrs[4] = {x, w, u, g};
    if (!dxr::takes(dtype, K, N, n, db, nb, ptrs, 4) ||
        (nb == 0 && dxr == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return run_wgmma(x, w, u, g, tn, dxr, part, ghat, dx, du, M, K, N, n, db,
                     nb, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(x, w, u, g, tn, dxr, part, ghat, dx, du, M, K, N, n,
                      db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u, g, tn, dxr, part, ghat, dx, du, M, K,
                              N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
