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
// What the design does about that — a simple kernel that is right first:
//  * dXr does not depend on the tenant, so it runs on the shared SIMT GEMM
//    of reflect_common.cuh with W read transposed in place, W read once
//    for the whole batch, into an (M, K) f32 scratch.
//  * The reflection epilogue is reflect_bwd_kernel under BANK: one warp
//    per (row tile, block), each tile inside one sequence (⌈S/32⌉ tiles a
//    sequence, the last ragged: S = 1, 16, 100 alike), its hyperplanes
//    the sequence's tenant's.  Each tile writes its own ĝ partial.
//  * seq_ghat_kernel sums each sequence's partials in order (ĝ_seq), and
//    bank_chain_kernel sums, per (tenant, block), the ĝ_seq of the
//    sequences its id names in order b = 0, 1, ... and applies the norm
//    chain; a tenant no id names gets an exact zero.  No float atomics:
//    the same inputs give the same bits every run, which the bitwise
//    restore of a train run needs.  The ids are read on the device only.
//  * SIMT f32, no tensor cores, as every GEMM of the port so far.
//
// C interface, bound with ctypes: hh_gemm_batched_bwd(...) launches the
// four kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

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

}  // namespace

// Row tiles of one sequence of `seq` rows: `part` holds B times this many
// (n, db) partials.
extern "C" int hh_gemm_batched_bwd_row_tiles(int seq) {
  return row_tiles(seq);
}

// dtype: 0 = float32, 1 = bfloat16 (x, W, G and dx alike).  ids: B = M /
// seq ids, int64 when ids64, else int32; tenants = A.  dxr is (M, K) f32
// scratch, part (B·hh_gemm_batched_bwd_row_tiles(seq), n, db) f32
// scratch, both written before they are read; ghat (B, n, db) f32 and du
// (A, n, db) f32 are outputs.
extern "C" int hh_gemm_batched_bwd(const void* x, const void* w,
                                   const void* u, const void* g,
                                   const void* ids, int ids64, int seq,
                                   int tenants, void* dxr, void* part,
                                   void* ghat, void* dx, void* du, int M,
                                   int K, int N, int n, int db, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (dtype == 0)
    return run<float>(x, w, u, g, tn, dxr, part, ghat, dx, du, M, K, N, n,
                      db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u, g, tn, dxr, part, ghat, dx, du, M, K,
                              N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
