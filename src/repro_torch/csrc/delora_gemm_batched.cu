// delora_gemm_batched: y[b] = x[b]·W + ((x[b]·a_t)·s_t)·b_t with t =
// ids[b] for every sequence b of a batch, DeLoRA's adapted linear in
// multi-tenant bank serving and training, for sm_90a.
//
// Replaces the TPU kernel delora_gemm_batched_pallas
// (src/repro/kernels/delora_gemm.py:129, _delora_batched_kernel at :100,
// pallas_call at :169): the DeLoRA forward of every adapted linear under
// `serve --tenants N` (src/repro/core/methods.py:527-531) and through a
// bank in training, and its backward's dx (src/repro/kernels/ops.py:
// 515-545), which the JAX package runs on the same kernel.
// x: (B·S, K) bf16 or f32, W: (K, N) same dtype, a_bank: (A, K, r) f32,
// b_bank: (A, r, N) f32, s_bank: (A, r) in x's dtype (the method layer's
// scale of every tenant, rounded to the activation dtype as the JAX
// package rounds it), ids: (B,) int32 or int64 (mapped into [0, A));
// y: (B·S, N) in x's dtype.  Everything inside is f32 (h summed in f64 on
// the wgmma route) and the low-rank term is added to the f32 sum before
// the one rounding, as in the Pallas kernel.  With w_t's bit 1 the call
// is the backward's dx = G·Wᵀ + ((G·b_tᵀ)·s_t)·a_tᵀ: x = G (B·S, K = f),
// W the (N = d, K) weight read transposed in place (bit 0), and both
// banks read where they lie, b_t along its rows and a_t down its columns
// (no transposed copy of either; the same values in the same order as
// the copies gave).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the base GEMM, as for delora_gemm — bytes
// at decode (W read once, plus the gathered a_t, b_t: 4·r·(K + N) bytes a
// distinct tenant), operations at prefill and in training.  The rank-r
// term adds 2·M·r·(K + N) operations.
//
// Routes, chosen on the host (kernels/batched.py, `delora_route`) and
// counted by ops.routes("delora_gemm_batched"):
//  * wgmma (bf16, d and f multiples of 8, x, W and both banks 16-byte
//    aligned, r ≤ sw::kMaxRank): scaled_wgmma.cuh's core under kLowRank.  A prologue
//    (lowrank_h_kernel) writes hs = fl32(x·a_t in f64)·s_t, t each row's
//    tenant, to an (M, r) f32 scratch; the TMA-fed wgmma GEMM multiplies
//    x itself (one plane) by W in 64-deep K partials added in order, and
//    its epilogue adds Σ_j hs[m, j]·b_t[j, col] in j order before the one
//    rounding, b_t's tile staged in shared memory where the tile's rows
//    name one tenant.  A row tile spans rows of any sequences, so W is
//    read once a call.  Both kernels from this one C call, on one stream.
//  * simt (float32, and the shapes the rule refuses): h_kernel, one warp
//    per (row m, rank j), h[m, j] = x_m · a_t[:, j] in f32 into the (M, r)
//    scratch, then the shared SIMT GEMM of reflect_common.cuh in its
//    kFuseRowLowRank variant under BANK: x·W, and the epilogue adds
//    Σ_j (h[m, j]·s_t[j])·b_t[j, col] at the output row's tenant before
//    the one rounding.
//
// C interface, bound with ctypes: delora_gemm_batched(...) launches the
// route it is given on the given stream, allocates nothing and returns a
// cudaError_t; dg_map_counts reads the wgmma route's tensor-map cache.

#include "reflect_common.cuh"
#include "scaled_wgmma.cuh"

namespace {

using namespace reflect;

// Where the prologue's p_t[k, j] and the epilogue's q_t[j, col] lie: the
// forward reads p = a (A, K, r) and q = b (A, r, N); dx reads p = b
// (A, r, K) along its rows and q = a (A, N, r) down its columns.
struct Banks {
  const float* p;
  long long p_ten;
  int p_k, p_j;
  const float* q;
  long long q_ten;
  int q_j, q_c;
};

Banks banks(const void* a, const void* b, int K, int N, int r, bool dx) {
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const long long kr = static_cast<long long>(K) * r;
  const long long nr = static_cast<long long>(N) * r;
  if (dx) return Banks{bf, kr, 1, K, af, nr, 1, r};
  return Banks{af, kr, r, 1, bf, nr, N, 1};
}

// One warp per (row m, rank j): h[m*r + j] = Σ_k x[m, k]·p_t[k, j] in f32,
// t the row's tenant, lanes strided over k, then a warp sum.  A tenant's
// p is K·r·4 bytes (31 KB at K = 960, r = 8), read from L2 by its rows.
template <typename T>
__global__ void h_kernel(const T* __restrict__ x, const float* __restrict__ p,
                         long long p_ten, int p_k, int p_j,
                         float* __restrict__ h, int M, int K, int r,
                         Tenants tn) {
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * r) return;  // whole warps exit
  const int m = static_cast<int>(pair / r), j = static_cast<int>(pair % r);
  const float* pt = p + row_tenant(tn, m) * p_ten +
                    static_cast<long long>(j) * p_j;
  const T* xm = x + static_cast<long long>(m) * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32)
    acc = fmaf(to_f32(xm[k]), __ldg(pt + static_cast<long long>(k) * p_k),
               acc);
  acc = warp_sum(acc);
  if (lane == 0) h[pair] = acc;
}

template <typename T>
int run(const void* x, const void* w, const Banks& bk, const void* sv,
        const Tenants& tn, void* h, void* y, int M, int K, int N, int r,
        int w_t, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * r;
  h_kernel<T><<<static_cast<unsigned>((pairs + kThreads / 32 - 1) /
                                      (kThreads / 32)),
                kThreads, 0, s>>>(xt, bk.p, bk.p_ten, bk.p_k, bk.p_j,
                                  static_cast<float*>(h), M, K, r, tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Side sd;
  sd.lb = bk.q;
  sd.lb_ten = bk.q_ten;
  sd.lb_q = bk.q_j;
  sd.lb_c = bk.q_c;
  sd.ls = sv;
  sd.h = static_cast<const float*>(h);
  sd.r = r;
  const Proj none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1};
  // y (M×N) = x (M×K) · W (K×N) + ((h·s_t)·q_t) per row; B(k, n) =
  // w[k*N + n], or transposed from the (N, K) weight, w[n*K + k]
  const T* wt = static_cast<const T*>(w);
  if (w_t)
    return static_cast<int>(
        launch_gemm<T, T, T, true, false, kReflectNone, kFuseRowLowRank,
                    true>(xt, K, wt, K, static_cast<T*>(y), M, N, K, none, s,
                          sd, tn));
  return static_cast<int>(
      launch_gemm<T, T, T, true, true, kReflectNone, kFuseRowLowRank, true>(
          xt, K, wt, N, static_cast<T*>(y), M, N, K, none, s, sd, tn));
}

int run_wgmma(const void* x, const void* w, const Banks& bk, bool dx,
              const void* sv, const Tenants& tn, void* hs, void* y, int M,
              int K, int N, int r, int w_t, int stage, int* staged,
              cudaStream_t s) {
  const void* ptrs[4] = {x, w, bk.p, bk.q};
  if (!sw::takes(K, N, ptrs, 4) || r > sw::kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  // dx reads b along its rows (k-major), the forward a across its rows
  auto h = dx ? sw::lowrank_h_kernel<true> : sw::lowrank_h_kernel<false>;
  h<<<sw::lowrank_h_blocks(M, r), sw::kHThreads, 0, s>>>(
      static_cast<const bf16*>(x), bk.p, bk.p_ten, bk.p_k, bk.p_j,
      static_cast<const bf16*>(sv), static_cast<float*>(hs), tn, M, K, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sw::Args args{};
  args.y = static_cast<bf16*>(y);
  args.tn = tn;
  args.M = M, args.K = K, args.N = N;
  args.hs = static_cast<const float*>(hs);
  args.q = bk.q;
  args.q_ten = bk.q_ten;
  args.q_j = bk.q_j, args.q_c = bk.q_c;
  args.r = r;
  args.stage = stage;
  args.staged = staged;
  return static_cast<int>(sw::launch<sw::kLowRank>(x, w, w_t, args, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, s and y alike); route: 0 = SIMT,
// 1 = wgmma (bf16 only).  ids: B = M / seq ids, int64 when ids64, else
// int32; tenants = A.  h is the (M, r) f32 scratch, written before it is
// read.  w_t, bit 0: W read as the transpose of a row-major (N, K)
// matrix; bit 1: the backward's dx, b (A, r, K) and a (A, N, r) read as
// they lie (without it a (A, K, r) and b (A, r, N), as the forward and the
// transposed copies of the banks give them).  stage (wgmma): 1 stages the
// epilogue's bank tile in shared memory where a tile's rows name one
// tenant, 0 reads it with __ldg at every tile (the same bits); staged
// (wgmma, may be null): two ints on the device to which the epilogue adds
// the row tiles that staged and every row tile.
extern "C" int delora_gemm_batched(const void* x, const void* w,
                                   const void* a, const void* b,
                                   const void* sv, const void* ids, int ids64,
                                   int seq, int tenants, void* h, void* y,
                                   int M, int K, int N, int r, int w_t,
                                   int dtype, int route, int stage,
                                   void* staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || tenants < 1 || M % seq || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tenants tn{ids, ids64, seq, tenants};
  const bool dx = (w_t & 2) != 0;
  const Banks bk = banks(a, b, K, N, r, dx);
  const int wt = w_t & 1;
  if (route == 1 && dtype == 1)
    return run_wgmma(x, w, bk, dx, sv, tn, h, y, M, K, N, r, wt, stage,
                     static_cast<int*>(staged), s);
  if (route == 0 && dtype == 0)
    return run<float>(x, w, bk, sv, tn, h, y, M, K, N, r, wt, s);
  if (route == 0 && dtype == 1)
    return run<__nv_bfloat16>(x, w, bk, sv, tn, h, y, M, K, N, r, wt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route's tensor-map cache: lookups and encodes (its misses)
// since the library was loaded, into counts[0] and counts[1].
extern "C" int dg_map_counts(long long* counts) {
  sw::map_cache().counts(counts);
  return 0;
}
