// householder_gemm: y = R(x) · W with R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_pallas
// (src/repro/kernels/householder_gemm.py:51, pallas_call at :73): the
// ETHER forward of every adapted linear in activation mode.
// x: (M, K) bf16 or f32, W: (K, N) same dtype, u: (n, db) f32 raw
// hyperplanes with n·db = K; y: (M, N) in x's dtype.  Everything inside
// is f32 (x, W and û converted on load, f32 accumulation), as in the
// Pallas kernel; û = u / (‖u‖ + 1e-8) with ε outside the square root.
// Like the TPU kernel it never writes the reflected x or a reflected W to
// device memory.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W):
//  * decode (M = batch = 4) reads W once: gate_proj of smollm-360m,
//    960×2560 bf16 = 4.9 MB, is about 1.5 µs of memory time.  Bytes bound.
//  * prefill at Llama-2-7B's 4096×11008 with M = 2048 is 185 GFLOP, about
//    0.19 ms on the bf16 tensor cores.  Operations bound.
//
// What the design does about that — a simple kernel that is right first:
//  * The TPU kernel needs each K tile to hold whole reflection blocks.
//    At smollm-360m's widths db is 120 or 320 (n = 8), which no Hopper K
//    tile holds.  So a prologue kernel first computes the per-row block
//    projections p[t, i] = x_t,i · û_i into a (M, n) f32 scratch (M·n·4
//    bytes, tiny) and the block norms ‖u_i‖ + ε into an (n,) scratch; the
//    GEMM then turns each loaded x element into x − 2·p[t, k/db]·û[k]
//    while staging the A tile, for any db, any ragged M, N and K edge.
//  * The GEMM is the register-tiled SIMT f32 FMA kernel of
//    reflect_common.cuh, which the two backward kernels share: exact f32
//    math for both dtypes, no tensor cores.  Prefill is therefore held to
//    the f32 rate (67 TFLOP/s), far from the bf16 bound; wgmma with
//    TMA-fed shared-memory rings is the next step (ROADMAP.md).
//  * Skinny M (decode, M ≤ 8) takes an 8×32 tile so that more blocks
//    stream W at once; larger M takes 64×64 tiles with 4×4 per thread,
//    or 32×32 tiles with 2×2 per thread where 64×64 tiles would leave
//    SMs without a block.  (Prefetching the next K tile into registers
//    was tried: it took the 64×64 tile from 64 to 91 registers a thread
//    and made it slower; PERF.md.)
//
// C interface, bound with ctypes: hh_gemm(...) launches both kernels on
// the given stream, allocates nothing and returns cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* u, void* p, void* unorm,
        void* y, int M, int K, int N, int n, int db, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<T, false>(xt, pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // y (M×N) = R(x) (M×K) · W (K×N): A(t, k) = x[t*K + k] reflected along k
  return static_cast<int>(launch_gemm<T, T, T, true, true, kReflectK>(
      xt, K, static_cast<const T*>(w), N, static_cast<T*>(y), M, N, K, pr, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike).  p is (M, n) f32
// scratch, unorm (n,) f32 scratch, both written before they are read.
extern "C" int hh_gemm(const void* x, const void* w, const void* u, void* p,
                       void* unorm, void* y, int M, int K, int N, int n,
                       int db, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w, u, p, unorm, y, M, K, N, n, db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u, p, unorm, y, M, K, N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
