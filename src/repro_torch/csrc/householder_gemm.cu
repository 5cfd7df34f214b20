// householder_gemm: y = R(x) · W with R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_pallas
// (src/repro/kernels/householder_gemm.py:51, pallas_call at :73): the
// ETHER forward of every adapted linear in activation mode.
// x: (M, K) bf16 or f32, W: (K, N) same dtype, u: (n, db) f32 raw
// hyperplanes with n·db = K; y: (M, N) in x's dtype.
// û = u / (‖u‖ + 1e-8) with ε outside the square root.  Like the TPU
// kernel it never writes the reflected x or a reflected W to device
// memory, and it rounds y once, from f32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W):
//  * decode (M = batch, 2 or 4) reads W once: qwen2.5-32b's gate/up,
//    5120×27648 bf16 = 283 MB, is 0.085 ms of memory time; smollm-360m's
//    gate, 960×2560 = 4.9 MB, 1.5 µs.  Bytes bound.
//  * prefill: qwen2.5-32b's gate/up at M = 4,096 (B 2 × P 2,048) is 1.16
//    TFLOP, 1.17 ms on the bf16 tensor cores.  Operations bound.
//
// Routes, chosen on the host (kernels/householder_gemm.py, `route`) from
// the dtype, M, the widths, n and the alignment.  Every call makes two
// launches: the projection prologue of reflect_common.cuh (P[t, i] =
// x_t,i · û_i into an (M, n) f32 scratch, and the block norms), then the
// GEMM.  Only the GEMM reads W, once.
//
// 1. wgmma (bf16, n ≤ 32, K and N multiples of 8, x, W and u 16-byte
//    aligned): hh_wgmma.cuh's core at rank 1, y = x·W − 2·P·U by
//    TMA-fed wgmma with U = ÛᵀW summed by two U warpgroups from the W
//    tiles in shared memory (its design note says how, and why every
//    order of summation is set by K alone).
//    a. `wgmma` (M > 16, prefill and training): 128×128 tiles.
//    b. `wgmma_decode` (M ≤ 16, decode): 64-column tiles, four K tiles a
//       stage, the same sums.
// 2. SIMT (f32, n > 32, widths not multiples of 8, a misaligned view of
//    x, W or u): the prologue's projections turn each loaded x element
//    into x − 2·p[t, k/db]·û[k] while the register-tiled SIMT f32 FMA
//    kernel of reflect_common.cuh stages its A tile, for any db and any
//    ragged edge.
//    TF32 tensor cores would miss float32's tolerance.
//
// Next steps: persistent blocks that overlap one tile's epilogue with the
// next tile's loads; 256-wide tiles; the same core for the shared GEMM's
// other users (rows 10-13, 19 and 21 of PERF.md's kernel table).
//
// C interface, bound with ctypes: hh_gemm(...) launches the route it is
// given on the given stream, allocates nothing and returns a cudaError_t.

#include <cuda.h>
#include <stdint.h>

#include "hh_wgmma.cuh"
#include "reflect_common.cuh"

namespace {

using namespace reflect;
using bf16 = __nv_bfloat16;

template <typename T>
int run_simt(const void* x, const void* w, const void* u, void* p,
             void* unorm, void* y, int M, int K, int N, int n, int db,
             cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<T, false>(xt, pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // y (M×N) = R(x) (M×K) · W (K×N): A(t, k) = x[t*K + k] reflected along k
  return static_cast<int>(launch_gemm<T, T, T, true, true, kReflectK>(
      xt, K, static_cast<const T*>(w), N, static_cast<T*>(y), M, N, K, pr, s));
}

template <int TILE>
int run_wgmma(const void* x, const void* w, const void* u, void* p,
              void* unorm, void* y, int M, int K, int N, int n, int db,
              cudaStream_t s) {
  const void* ptrs[3] = {x, w, u};
  if (!hhw::takes(K, N, n, ptrs, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  hhw::Args a{};
  a.u = static_cast<const float*>(u);
  a.p = static_cast<const float*>(p);
  a.unorm = static_cast<const float*>(unorm);
  a.y = static_cast<bf16*>(y);
  a.M = M, a.K = K, a.N = N, a.n = n, a.db = db;
  const Proj pr{a.u, nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err =
      launch_proj<bf16, false>(static_cast<const bf16*>(x), pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      hhw::launch<TILE, 1, false, hhw::kNone>(x, w, a, s));
}

}  // namespace

// route: 0 = SIMT float32, 1 = SIMT bfloat16 (x, W and y alike), 2 =
// wgmma (bf16), 3 = wgmma_decode (bf16); the wgmma routes take n ≤ 32, K
// and N multiples of 8, x, W and u 16-byte aligned.  p is (M, n) f32
// scratch, unorm (n,) f32 scratch, both written before they are read.
extern "C" int hh_gemm(const void* x, const void* w, const void* u, void* p,
                       void* unorm, void* y, int M, int K, int N, int n,
                       int db, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return run_simt<float>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 1:
      return run_simt<bf16>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 2:
      return run_wgmma<128>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 3:
      return run_wgmma<64>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-map cache's lookups and encodes (its misses) since the
// library was loaded, into counts[0] and counts[1].
extern "C" int hh_map_counts(long long* counts) {
  hhw::map_cache().counts(counts);
  return 0;
}
