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
// Routes, chosen on the host (kernels/etherplus_gemm.py, `route`) and
// counted by ops.routes("etherplus_gemm").  Every call first runs the
// projection prologue of reflect_common.cuh: it reads x once and writes
// both block projections (P = ûᵀx, Q = v̂ᵀx per block) and both norms.
//  * wgmma (bf16, n ≤ 32, K and N multiples of 8, x, W, u1 and v1 16-byte
//    aligned): hh_wgmma.cuh's core at rank 2, H⁺(x)·W = x·W − P·U + Q·V
//    by TMA-fed wgmma, U = ÛᵀW and V = V̂ᵀW summed together by the U
//    warpgroups from the W tiles in shared memory, every order of
//    summation set by K alone.  One-sided (and the backward's y0
//    recompute): 128×128 tiles, y rounded once.  Two-sided, the epilogue
//    the host picks (`epilogue`):
//    - fused, where the whole output blocks of a 128-column tile fill at
//      least 3/4 of it (smollm-360m's db_out 30 and 10 at n = 32, 120 and
//      40 at n = 8: 120 columns): column tiles holding whole output blocks
//      (kernels/etherplus_gemm.py, column_tiles: each tile starting on a
//      multiple of 8 columns, since a TMA box must start on 16 bytes: a
//      tile at column 119 made the card raise an illegal instruction) and
//      H̃⁺ on the f32 accumulators in the GEMM's epilogue: y0 never
//      reaches device memory.
//    - scratch, the rest (db_out 80 at n = 32, 320 at n = 8, both on
//      f = 2560): the GEMM writes y0 in f32 to an (M, N) scratch and
//      rank2_rows_kernel (one warp a (row, output block)) applies H̃⁺ and
//      rounds once.  At db_out 80 a fused 128-column tile holds one
//      block, 5/8 of it, and ran slower on the card than this epilogue;
//      so did 160-column tiles of two blocks (hh_wgmma.cuh: too few
//      registers).
//  * simt (float32, whose tolerance TF32 would miss; n > 32; widths not
//    multiples of 8; a misaligned view): the shared GEMM of
//    reflect_common.cuh applies x − p·û + q·v̂ to each x element as it
//    stages the A tile (kRank2K), for any db; two-sided it writes y0 to
//    the f32 scratch for rank2_rows_kernel.  No tensor cores.
//
// C interface, bound with ctypes: etherplus_gemm(...) launches the
// prologue, the GEMM and (two-sided, scratch) the epilogue on the given
// stream, allocates nothing and returns a cudaError_t.

#include "hh_wgmma.cuh"
#include "reflect_common.cuh"

namespace {

using namespace reflect;
using bf16 = __nv_bfloat16;

template <typename T>
int run_simt(const void* x, const void* w, const void* u1, const void* v1,
             const void* u2, const void* v2, void* scratch, void* yacc,
             void* y, int M, int K, int N, int n, int db, int n_out,
             int db_out, cudaStream_t s) {
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

// The wgmma route: nb > 0 takes the fused epilogue on 128-column tiles of
// nb whole output blocks (each tile's first column a multiple of 8 unless
// one tile holds every block), nb = 0 two-sided the scratch one.
int run_wgmma(const void* x, const void* w, const void* u1, const void* v1,
              const void* u2, const void* v2, void* scratch, void* yacc,
              void* y, int M, int K, int N, int n, int db, int n_out,
              int db_out, int nb, cudaStream_t s) {
  const void* ptrs[4] = {x, w, u1, v1};
  if (!hhw::takes(K, N, n, ptrs, 4) || nb < 0 || nb > hhw::kMaxOut ||
      (nb && (!u2 || nb > n_out ||
              static_cast<long long>(nb) * db_out > 128 ||
              (nb < n_out && nb * db_out % 8))) ||
      (u2 && !nb && !yacc))
    return static_cast<int>(cudaErrorInvalidValue);
  const Proj pr = carve(static_cast<const float*>(u1),
                        static_cast<const float*>(v1),
                        static_cast<float*>(scratch), M, n, db);
  cudaError_t err = launch_proj<bf16, true>(static_cast<const bf16*>(x), pr,
                                            M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hhw::Args a{};
  a.u = pr.u, a.v = pr.v, a.p = pr.p, a.q = pr.q;
  a.unorm = pr.unorm, a.vnorm = pr.vnorm;
  a.u2 = static_cast<const float*>(u2);
  a.v2 = static_cast<const float*>(v2);
  a.y = static_cast<bf16*>(y);
  a.yacc = static_cast<float*>(yacc);
  a.M = M, a.K = K, a.N = N, a.n = n, a.db = db;
  a.nb = nb, a.db_out = db_out, a.n_out = n_out;
  if (!u2) return static_cast<int>(hhw::launch<128, 2, false, hhw::kNone>(
               x, w, a, s));
  if (nb == 0) {
    err = hhw::launch<128, 2, false, hhw::kScratch>(x, w, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_rank2_rows<float, bf16>(
        a.yacc, a.u2, a.v2, a.y, M, n_out, db_out, s));
  }
  return static_cast<int>(hhw::launch<128, 2, false, hhw::kFused>(x, w, a,
                                                                  s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike); route: 0 = SIMT,
// 1 = wgmma (bf16 only).  u2 and v2 are null one-sided.  nb: the wgmma route's
// whole output blocks a column tile (its fused epilogue), 0 for the
// scratch one.  scratch is f32 of 2·(M + 1)·n floats, yacc (M, N) f32
// (two-sided SIMT and the scratch epilogue, else null), both written
// before they are read.
extern "C" int etherplus_gemm(const void* x, const void* w, const void* u1,
                              const void* v1, const void* u2, const void* v2,
                              void* scratch, void* yacc, void* y, int M, int K,
                              int N, int n, int db, int n_out, int db_out,
                              int dtype, int route, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1)
    return run_wgmma(x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N, n, db,
                     n_out, db_out, nb, s);
  if (route == 0 && dtype == 0)
    return run_simt<float>(x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N,
                           n, db, n_out, db_out, s);
  if (route == 0 && dtype == 1)
    return run_simt<bf16>(x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N, n,
                          db, n_out, db_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-map cache's lookups and encodes (its misses) since the
// library was loaded, into counts[0] and counts[1].
extern "C" int ep_map_counts(long long* counts) {
  hhw::map_cache().counts(counts);
  return 0;
}
