// householder_gemm_batched: y[b] = R_{ids[b]}(x[b]) · W for every sequence
// b of a batch, R_t the blockwise reflection I − 2ûûᵀ of tenant t of an
// adapter bank, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_batched_pallas
// (src/repro/kernels/householder_gemm_batched.py:58, pallas_call at :96):
// the ETHER forward of every adapted linear in multi-tenant bank serving
// (`serve --tenants N`, src/repro/core/methods.py:183-190).
// x: (B·S, K) bf16 or f32 (B sequences of S rows), W: (K, N) same dtype,
// u_bank: (A, n, db) f32 raw hyperplanes with n·db = K, ids: (B,) int32 or
// int64; y: (B·S, N) in x's dtype.  An id outside [0, A) is mapped into
// it as the JAX package's gather maps an index (row_tenant in
// reflect_common.cuh).  Everything inside is f32, as in the Pallas
// kernel and the single-tenant householder_gemm.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): as householder_gemm — bytes at decode (W
// read once: one smollm-360m layer's seven weights, 19.7 MB, are 5.9 µs;
// the B gathered rows of the bank add 4·K bytes each), operations at
// prefill.
//
// Routes, chosen on the host (kernels/batched.py, `gemm_route`) and
// counted by ops.routes("householder_gemm_batched").  Both start with the
// bank prologue (proj_kernel under BANK): each row's block projections
// and block norms from its own tenant's hyperplanes into an (M, n) pair
// of scratches, in the order the single-tenant prologue sums them.
//  * wgmma (bf16, n ≤ 32, K and N multiples of 8, x, W and the bank
//    16-byte aligned, any S: at S = 1, 32 and 33, where a tile holds 1 to
//    33 rows, it still ran faster than simt on the card at smollm-360m's
//    linears, B = 4, PERF.md §6): hh_wgmma.cuh's
//    core at rank 1 with the grid of the Pallas kernel, (B, S/Ts, F/Tf,
//    K/Tk): each sequence has row tiles of its own, a tile's tenant is
//    row_tenant of its first row, read on the device, and its U is
//    formed from that tenant's u.  With every id naming one tenant it
//    gives the single-tenant wgmma route's bits.  W is read once a
//    sequence's row tile, as the Pallas kernel reads it.
//  * simt (float32; n > 32; widths not multiples of 8; a misaligned
//    view): a tile spans rows of any sequences, and the shared GEMM of
//    reflect_common.cuh reads û at each row's tenant while it stages the A
//    tile, so W is read once for the whole batch.
// The row's tenant is ids[m / S], mapped into [0, A), read on the device:
// the wrapper never synchronises to look at the ids.
//
// C interface, bound with ctypes: hh_gemm_batched(...) launches both
// kernels on the given stream, allocates nothing and returns a
// cudaError_t.

#include "hh_wgmma.cuh"
#include "reflect_common.cuh"

namespace {

using namespace reflect;
using bf16 = __nv_bfloat16;

template <typename T>
int run_simt(const void* x, const void* w, const void* u, const Tenants& tn,
             void* p, void* unorm, void* y, int M, int K, int N, int n,
             int db, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<T, false, true>(xt, pr, M, K, s, tn);
  if (err != cudaSuccess) return static_cast<int>(err);
  // y (M×N) = R_t(x) (M×K) · W (K×N): A(m, k) = x[m*K + k] reflected along
  // k with row m's tenant's û
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectK, kFuseNone, true>(
          xt, K, static_cast<const T*>(w), N, static_cast<T*>(y), M, N, K, pr,
          s, Side{}, tn));
}

int run_wgmma(const void* x, const void* w, const void* u, const Tenants& tn,
              void* p, void* unorm, void* y, int M, int K, int N, int n,
              int db, cudaStream_t s) {
  const void* ptrs[3] = {x, w, u};
  if (!hhw::takes(K, N, n, ptrs, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<bf16, false, true>(
      static_cast<const bf16*>(x), pr, M, K, s, tn);
  if (err != cudaSuccess) return static_cast<int>(err);
  hhw::Args a{};
  a.u = pr.u, a.p = pr.p, a.unorm = pr.unorm;
  a.y = static_cast<bf16*>(y);
  a.M = M, a.K = K, a.N = N, a.n = n, a.db = db;
  a.seq = tn.seq;
  a.seq_tiles = (tn.seq + 127) / 128;
  a.tn = tn;
  return static_cast<int>(hhw::launch<128, 1, true, hhw::kNone>(x, w, a, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike); route: 0 = SIMT,
// 1 = wgmma (bf16 only).  ids: B = M / seq ids, int64 when ids64, else int32;
// tenants = A.  p and unorm are (M, n) f32 scratch each, written before
// they are read.
extern "C" int hh_gemm_batched(const void* x, const void* w, const void* u,
                               const void* ids, int ids64, int seq,
                               int tenants, void* p, void* unorm, void* y,
                               int M, int K, int N, int n, int db, int dtype,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (route == 1 && dtype == 1)
    return run_wgmma(x, w, u, tn, p, unorm, y, M, K, N, n, db, s);
  if (route == 0 && dtype == 0)
    return run_simt<float>(x, w, u, tn, p, unorm, y, M, K, N, n, db, s);
  if (route == 0 && dtype == 1)
    return run_simt<bf16>(x, w, u, tn, p, unorm, y, M, K, N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
