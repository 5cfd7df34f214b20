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
//  * The GEMM is a register-tiled SIMT f32 FMA kernel: exact f32 math for
//    both dtypes, no tensor cores.  Prefill is therefore held to the f32
//    rate (67 TFLOP/s), far from the bf16 bound; wgmma with TMA-fed
//    shared-memory rings is the next step (ROADMAP.md).
//  * Skinny M (decode, M ≤ 8) takes an 8×32 tile so that more blocks
//    stream W at once; larger M takes 64×64 tiles with 4×4 per thread,
//    or 32×32 tiles with 2×2 per thread where 64×64 tiles would leave
//    SMs without a block.  (Prefetching the next K tile into registers
//    was tried: it took the 64×64 tile from 64 to 91 registers a thread
//    and made it slower; PERF.md.)
//
// C interface, bound with ctypes: hh_gemm(...) launches both kernels on
// the given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-8f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per (row t, block i): p[t*n + i] = Σ_j x[t, i*db + j] u[i, j]
// / (‖u_i‖ + ε).  Row 0's warps also write unorm[i] = ‖u_i‖ + ε.
template <typename T>
__global__ void hh_proj_kernel(const T* __restrict__ x,
                               const float* __restrict__ u,
                               float* __restrict__ p,
                               float* __restrict__ unorm, int M, int K, int n,
                               int db) {
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * n) return;  // whole warps exit
  const long long t = pair / n;
  const int i = static_cast<int>(pair % n);
  const float* ui = u + static_cast<long long>(i) * db;
  const T* xt = x + t * K + static_cast<long long>(i) * db;
  float ss = 0.f, xu = 0.f;
  for (int j = lane; j < db; j += 32) {
    const float uv = ui[j];
    ss = fmaf(uv, uv, ss);
    xu = fmaf(to_f32(xt[j]), uv, xu);
  }
  ss = warp_sum(ss);
  xu = warp_sum(xu);
  if (lane == 0) {
    const float nrm = sqrtf(ss) + kEps;
    p[pair] = xu / nrm;
    if (t == 0) unorm[i] = nrm;
  }
}

// Register-tiled GEMM over the reflected x.  Block tile BM×BN, K step
// BK, each thread TM×TN outputs at rows ty + i·(BM/TM), columns
// tx + j·(BN/TN) (strided, so a warp's shared reads and global stores
// touch consecutive words).
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    hh_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ unorm,
                   const float* __restrict__ p, T* __restrict__ y, int M,
                   int K, int N, int n, int db) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];  // reflected x, k-major
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const long long m = m0 + r;
      const int k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        const int blk = k / db;
        v = to_f32(x[m * K + k]) - 2.f * p[m * n + blk] * (u[k] / unorm[blk]);
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk;
      const long long col = n0 + c;
      Bs[kk][c] = (k < K && col < N)
                      ? to_f32(w[static_cast<long long>(k) * N + col])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long col = n0 + tx + j * TX;
      if (col < N) y[m * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_gemm(const T* x, const T* w, const float* u, const float* unorm,
                 const float* p, T* y, int M, int K, int N, int n, int db,
                 cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  hh_gemm_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(x, w, u, unorm, p, y, M, K, N,
                                               n, db);
}

int sm_count() {
  static int sms = 0;  // one card per process
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;  // an H100 SXM; only the tile choice depends on it
  }
  return sms;
}

template <typename T>
int run(const void* x, const void* w, const void* u, void* p, void* unorm,
        void* y, int M, int K, int N, int n, int db, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* uf = static_cast<const float*>(u);
  float* pf = static_cast<float*>(p);
  float* nf = static_cast<float*>(unorm);
  constexpr int kProjThreads = 256;
  const long long pairs = static_cast<long long>(M) * n;
  const unsigned proj_blocks =
      static_cast<unsigned>((pairs + kProjThreads / 32 - 1) / (kProjThreads / 32));
  hh_proj_kernel<T><<<proj_blocks, kProjThreads, 0, s>>>(xt, uf, pf, nf, M, K,
                                                         n, db);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest tile that still gives every SM a block
  const long long big = static_cast<long long>((M + 63) / 64) * ((N + 63) / 64);
  T* yt = static_cast<T*>(y);
  if (M <= 8)
    launch_gemm<T, 8, 32, 32, 1, 1>(xt, wt, uf, nf, pf, yt, M, K, N, n, db, s);
  else if (big < sm_count())
    launch_gemm<T, 32, 32, 16, 2, 2>(xt, wt, uf, nf, pf, yt, M, K, N, n, db, s);
  else
    launch_gemm<T, 64, 64, 16, 4, 4>(xt, wt, uf, nf, pf, yt, M, K, N, n, db, s);
  return static_cast<int>(cudaGetLastError());
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
