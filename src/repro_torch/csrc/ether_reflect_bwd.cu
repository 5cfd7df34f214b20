// ether_reflect_bwd and ether_reflect_batched_bwd: the backwards of the
// standalone reflection out = H_B x and of its bank form out[b] = H_t x[b],
// t = ids[b], H = I − 2ûûᵀ per block, for sm_90a.
//
// Replace the TPU kernels ether_reflect_bwd_pallas
// (src/repro/kernels/reflect_bwd.py:117, _r1_bwd_kernel at :67,
// pallas_call at :128) and ether_reflect_batched_bwd_pallas
// (src/repro/kernels/reflect_bwd_batched.py:82, _r1b_bwd_kernel at :32,
// pallas_call at :108), whose per-sequence ĝ the JAX op finishes with
// _bank_grad (src/repro/kernels/ops.py:279): the registry's
// ether_reflect_bwd and ether_reflect_batched_bwd, which the backward of
// execute.dispatch("ether_reflect" / "ether_reflect_batched") runs.  For
// x, G (M, d) bf16 or f32 alike (G in the activation dtype: it is the
// cotangent of the op's own output) and u (n, db) f32 raw, n·db = d:
//   dx = G − 2(ûᵀG) û                                  (M, d) in x's dtype
//   ĝ  = −2 Σ_t [(ûᵀx_t) G_t + (ûᵀG_t) x_t]            per block, f32
//   du = norm_chain(u, ĝ)                              (n, db) f32
// and over a bank (A, n, db) with ids (B,) int32 or int64 (mapped into
// [0, A) as the forward maps them), ĝ_seq per sequence (B, n, db) and
// du_bank[a] = norm_chain(u_bank[a], Σ_{b: ids[b] ↦ a} ĝ_seq[b]), an exact
// zero for a tenant that no id names.  An id ≥ A trains tenant A − 1, the
// tenant its forward served (the JAX op's scatter drops it).
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  It reads x
// and G and writes dx (6·M·d bytes in bf16), ~10 operations an element;
// one smollm-360m train layer (M = 1024, d = 960 six times, 2560 once) is
// 51 MB, about 0.015 ms.
//
// What the design does about that: these are the rank-1 (RANK2 = false)
// instances, with G in the activation dtype, of reflect_common.cuh's
// reflection backward, which etherplus_reflect_bwd (rank 2) and the
// epilogues of reflect_gemm_dx and householder_gemm_batched_bwd (f32 G)
// run: reflect_bwd_kernel, one warp per (32-row tile, block), G read as
// bf16 and widened in registers (never rounded again), the tile's ĝ kept
// in shared memory (4 warps · db floats a CUDA block: 22 KB at db 1376)
// and written as a partial; then du_kernel sums the partials in a fixed
// order and applies the norm chain, or, over a bank, seq_ghat_kernel and
// bank_chain_kernel.  A bank tile never straddles two sequences.  No
// float atomics: the same inputs give the same bits every run.
//
// C interface, bound with ctypes: each function launches its kernels on
// the given stream, allocates nothing and returns cudaGetLastError().

#include "reflect_common.cuh"

using namespace reflect;

// Row tiles of `rows` rows: ether_reflect_bwd's `part` holds this many
// (n, db) partials for M rows; ether_reflect_batched_bwd's B times this
// many for one sequence of `seq` rows.
extern "C" int ether_reflect_bwd_row_tiles(int rows) { return row_tiles(rows); }

// dtype: 0 = float32, 1 = bfloat16 (x, G and dx alike).  part is f32
// scratch of ether_reflect_bwd_row_tiles(M)·n·db floats, written before it
// is read; du (n, db) f32.
extern "C" int ether_reflect_bwd(const void* x, const void* u, const void* g,
                                 void* part, void* dx, void* du, int M, int n,
                                 int db, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = n * db;
  const float* uf = static_cast<const float*>(u);
  float* pf = static_cast<float*>(part);
  float* duf = static_cast<float*>(du);
  if (dtype == 0)
    return static_cast<int>(launch_reflect_bwd<float, float, false>(
        static_cast<const float*>(x), static_cast<const float*>(g), uf,
        nullptr, static_cast<float*>(dx), pf, nullptr, duf, nullptr, M, K, n,
        db, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_reflect_bwd<__nv_bfloat16, __nv_bfloat16, false>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), uf, nullptr,
            static_cast<__nv_bfloat16*>(dx), pf, nullptr, duf, nullptr, M, K,
            n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bank form.  ids: B = M / seq ids, int64 when ids64, else int32;
// tenants = A.  part is f32 scratch of B·ether_reflect_bwd_row_tiles(seq)·
// n·db floats, written before it is read; ghat (B, n, db) f32 (ĝ_seq) and
// du (A, n, db) f32 are outputs.
extern "C" int ether_reflect_batched_bwd(const void* x, const void* u,
                                         const void* g, const void* ids,
                                         int ids64, int seq, int tenants,
                                         void* part, void* ghat, void* dx,
                                         void* du, int M, int n, int db,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  const int K = n * db;
  const float* uf = static_cast<const float*>(u);
  float* pf = static_cast<float*>(part);
  float* gf = static_cast<float*>(ghat);
  float* duf = static_cast<float*>(du);
  if (dtype == 0)
    return static_cast<int>(launch_reflect_bwd_bank<float, float, false>(
        static_cast<const float*>(x), static_cast<const float*>(g), uf,
        nullptr, static_cast<float*>(dx), pf, gf, duf, nullptr, M, K, n, db,
        tn, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_reflect_bwd_bank<__nv_bfloat16, __nv_bfloat16, false>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), uf, nullptr,
            static_cast<__nv_bfloat16*>(dx), pf, gf, duf, nullptr, M, K, n,
            db, tn, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
