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
// What the design does about that — a simple kernel that is right first:
//  * The Pallas grid is (B, S/Ts, F/Tf, K/Tk) with the tenant id fetched
//    ahead per sequence, so a tile never spans two sequences and W is
//    read once per sequence (B times at decode).  Here a tile spans rows
//    of any sequences: the prologue (proj_kernel under BANK) computes each
//    row's block projections and block norms from its own tenant's
//    hyperplanes into an (M, n) pair of scratches, and the shared GEMM of
//    reflect_common.cuh reads û at the row's tenant while it stages the A
//    tile.  W is read once for the whole batch, as the single-tenant
//    kernel reads it, and the tile choice is the single-tenant kernel's at
//    the same M.
//  * The row's tenant is ids[m / S], mapped into [0, A), read on the
//    device: the wrapper never synchronises to look at the ids.
//  * SIMT f32, no tensor cores, as every GEMM of the port so far.
//
// C interface, bound with ctypes: hh_gemm_batched(...) launches both
// kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

template <typename T>
int run(const void* x, const void* w, const void* u, const Tenants& tn,
        void* p, void* unorm, void* y, int M, int K, int N, int n, int db,
        cudaStream_t s) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W and y alike).  ids: B = M / seq
// ids, int64 when ids64, else int32; tenants = A.  p and unorm are (M, n)
// f32 scratch each, written before they are read.
extern "C" int hh_gemm_batched(const void* x, const void* w, const void* u,
                               const void* ids, int ids64, int seq,
                               int tenants, void* p, void* unorm, void* y,
                               int M, int K, int N, int n, int db, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  if (dtype == 0)
    return run<float>(x, w, u, tn, p, unorm, y, M, K, N, n, db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u, tn, p, unorm, y, M, K, N, n, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
