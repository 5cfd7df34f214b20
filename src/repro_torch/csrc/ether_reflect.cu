// ether_reflect and ether_reflect_batched: the standalone blockwise
// Householder reflection out = H_B x, H_B = I − 2ûûᵀ per block of db, and
// its multi-tenant form out[b] = H_t x[b] with t = ids[b], for sm_90a.
//
// Replace the TPU kernels ether_reflect_pallas
// (src/repro/kernels/ether_reflect.py:35, _reflect_kernel at :22,
// pallas_call at :53) and ether_reflect_batched_pallas
// (src/repro/kernels/ether_reflect_batched.py:44, _reflect_batched_kernel
// at :29, pallas_call at :71): the registry's ops ether_reflect and
// ether_reflect_batched (src/repro/core/execute.py:338-350, :383-395),
// which no model calls; execute.dispatch runs them, forward and backward.
// x: (M, d) bf16 or f32 (M = B·S rows for the bank), u: (n, db) f32 raw
// with n·db = d, or a bank (A, n, db) with ids (B,) int32 or int64 mapped
// into [0, A) on the device; out: (M, d) in x's dtype, written once.  û =
// u / (‖u‖ + 1e-8) and the projection in f32, one rounding, as in the
// Pallas kernels.
//
// What bounds it on an H100 SXM (3.35 TB/s, the data sheet's rate at
// 700 W): bytes.  It reads x and writes out once (4·M·d bytes in bf16)
// and does ~6 operations an element.  At one smollm-360m train layer
// (M = 1024, the seven linears' inputs, d = 960 six times and 2560 once)
// that is 34 MB, about 0.010 ms.
//
// What the design does about that — a simple kernel that is right first:
//  * rank1_rows_kernel, the rank-1 counterpart of reflect_common.cuh's
//    rank2_rows_kernel: one warp per (row, block).  The warp recomputes
//    its block's norm from u (db floats, from L1/L2), takes the block's
//    projection as a warp sum, and reads its db elements of x a second
//    time (from L1) to write the output.  Any M, any db (30, 1376 or odd
//    test widths): lanes past db idle.
//  * Under BANK each row picks its tenant with row_tenant, so the rows of
//    every sequence share one launch; the Pallas grid is (B, S/Ts), one
//    sequence a step, and falls back to jnp for S % 128 ≠ 0.
//
// C interface, bound with ctypes: ether_reflect(...) and
// ether_reflect_batched(...) launch one kernel on the given stream,
// allocate nothing and return cudaGetLastError().

#include "reflect_common.cuh"

namespace reflect {

// One warp per (row t, block j) of a row-major (M, n·db) x: out = x −
// 2(x·û_j) û_j on the row's block j.  Under BANK, u is an (A, n, db) bank
// and row t takes its tenant's hyperplanes (`tn`).  out must not alias x.
template <typename T, bool BANK>
__global__ void rank1_rows_kernel(const T* __restrict__ x,
                                  const float* __restrict__ u,
                                  T* __restrict__ out, int M, int n, int db,
                                  Tenants tn) {
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * n) return;  // whole warps exit
  const int j = static_cast<int>(pair % n);
  const long long off = pair * db;  // (t·n + j)·db = t·(n·db) + j·db
  const int t = static_cast<int>(pair / n);
  const long long hj =
      (BANK ? static_cast<long long>(row_tenant(tn, t)) * n : 0) + j;
  const float* uj = u + hj * db;
  float su = 0.f;
  for (int c = lane; c < db; c += 32) su = fmaf(uj[c], uj[c], su);
  const float nu = sqrtf(warp_sum(su)) + kEps;
  float p = 0.f;
  for (int c = lane; c < db; c += 32) p = fmaf(to_f32(x[off + c]), uj[c] / nu, p);
  p = warp_sum(p);
  for (int c = lane; c < db; c += 32)
    out[off + c] = from_f32<T>(to_f32(x[off + c]) - 2.f * p * (uj[c] / nu));
}

template <bool BANK>
cudaError_t launch_rank1_rows(const void* x, const float* u, void* out, int M,
                              int n, int db, int dtype, const Tenants& tn,
                              cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * n;
  const unsigned grid =
      static_cast<unsigned>((pairs + kThreads / 32 - 1) / (kThreads / 32));
  if (dtype == 0)
    rank1_rows_kernel<float, BANK><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), u, static_cast<float*>(out), M, n, db,
        tn);
  else if (dtype == 1)
    rank1_rows_kernel<__nv_bfloat16, BANK><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), u,
        static_cast<__nv_bfloat16*>(out), M, n, db, tn);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace reflect

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).  out must not alias
// x.
extern "C" int ether_reflect(const void* x, const void* u, void* out, int M,
                             int n, int db, int dtype, void* stream) {
  return static_cast<int>(reflect::launch_rank1_rows<false>(
      x, static_cast<const float*>(u), out, M, n, db, dtype,
      reflect::Tenants{}, static_cast<cudaStream_t>(stream)));
}

// As ether_reflect over an (A, n, db) bank: ids holds B = M / seq ids,
// int64 when ids64, else int32; tenants = A.
extern "C" int ether_reflect_batched(const void* x, const void* u,
                                     const void* ids, int ids64, int seq,
                                     int tenants, void* out, int M, int n,
                                     int db, int dtype, void* stream) {
  if (seq < 1 || tenants < 1 || M % seq)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(reflect::launch_rank1_rows<true>(
      x, static_cast<const float*>(u), out, M, n, db, dtype,
      reflect::Tenants{ids, ids64, seq, tenants},
      static_cast<cudaStream_t>(stream)));
}
