// Device code shared by the port's reflect-GEMM kernels (householder_gemm,
// reflect_gemm_dx, reflect_gemm_dw): dtype conversions, a warp sum, the
// block-projection prologue and the one register-tiled f32 SIMT GEMM that
// all three products run on.
//
// R is the blockwise Householder reflection I − 2ûûᵀ over n blocks of db
// elements, û = u / (‖u‖ + 1e-8) with ε outside the square root, as in
// the JAX package (src/repro/kernels/reflect_bwd.py:48, unit_rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace reflect {

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
__global__ void proj_kernel(const T* __restrict__ x,
                            const float* __restrict__ u,
                            float* __restrict__ p, float* __restrict__ unorm,
                            int M, int K, int n, int db) {
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

template <typename T>
cudaError_t launch_proj(const T* x, const float* u, float* p, float* unorm,
                        int M, int K, int n, int db, cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * n;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kThreads / 32 - 1) / (kThreads / 32));
  proj_kernel<T><<<blocks, kThreads, 0, s>>>(x, u, p, unorm, M, K, n, db);
  return cudaGetLastError();
}

// Which index of A the GEMM reflects while staging its A tile.
enum Reflect {
  kReflectNone,  // A as it is (dXr = G · Wᵀ)
  kReflectK,     // A(m, k) − 2·p[m*n + k/db]·û[k]: row m of x (forward)
  kReflectM,     // A(m, k) − 2·p[k*n + m/db]·û[m]: column k of Aᵀ = x (dW)
};

// C (M×N) = A (M×K) · B (K×N), f32 accumulation, any ragged edge.
// Each operand is row-major in one of its two orientations, so one kernel
// covers the forward and the transposed products of the backward:
//   A(m, k) = A_K_CONTIG ? a[m*lda + k] : a[k*lda + m],
//   B(k, n) = B_N_CONTIG ? b[k*ldb + n] : b[n*ldb + k].
// The contiguous index varies fastest across threads while staging, so
// global reads coalesce.  REFLECT applies the blockwise reflection of x
// to A as it is staged (p: the prologue's block projections, unorm:
// ‖u_i‖ + ε), so the reflected x never reaches device memory.  Block tile
// BM×BN, K step BK; each thread owns TM×TN outputs at rows
// ty + i·(BM/TM), columns tx + j·(BN/TN) (strided, so a warp's shared
// reads and global stores touch consecutive words).  C is written at
// c[m*N + col] in TC.  Indices stay 32-bit (every dimension is an int);
// only addresses are 64-bit.  The launch bounds ask for one resident block
// a SM: with the thread count alone, ptxas squeezed the dXr instantiation
// to 32 registers with spills, 1.2-1.3x slower at the train step's
// 960-wide shapes on the H100 (PERF.md, run J).
template <typename TA, typename TB, typename TC, int BM, int BN, int BK,
          int TM, int TN, bool A_K_CONTIG, bool B_N_CONTIG, Reflect REFLECT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 1)
    gemm_kernel(const TA* __restrict__ a, int lda, const TB* __restrict__ b,
                int ldb, TC* __restrict__ c, int M, int N, int K,
                const float* __restrict__ u, const float* __restrict__ unorm,
                const float* __restrict__ p, int n, int db) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];  // k-major
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = A_K_CONTIG ? e / BK : e % BM;
      const int kk = A_K_CONTIG ? e % BK : e / BM;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = to_f32(A_K_CONTIG ? a[static_cast<long long>(m) * lda + k]
                              : a[static_cast<long long>(k) * lda + m]);
        if (REFLECT != kReflectNone) {
          const int j = REFLECT == kReflectK ? k : m;  // index of û
          const int t = REFLECT == kReflectK ? m : k;  // token row
          const int blk = j / db;
          v -= 2.f * p[static_cast<long long>(t) * n + blk] * (u[j] / unorm[blk]);
        }
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int cc = B_N_CONTIG ? e % BN : e / BK;
      const int kk = B_N_CONTIG ? e / BN : e % BK;
      const int k = k0 + kk, col = n0 + cc;
      Bs[kk][cc] = (k < K && col < N)
                       ? to_f32(B_N_CONTIG
                                    ? b[static_cast<long long>(k) * ldb + col]
                                    : b[static_cast<long long>(col) * ldb + k])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col < N)
        c[static_cast<long long>(m) * N + col] = from_f32<TC>(acc[i][j]);
    }
  }
}

inline int sm_count() {
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

template <typename TA, typename TB, typename TC, int BM, int BN, int BK,
          int TM, int TN, bool A_K_CONTIG, bool B_N_CONTIG, Reflect REFLECT>
void launch_tile(const TA* a, int lda, const TB* b, int ldb, TC* c, int M,
                 int N, int K, const float* u, const float* unorm,
                 const float* p, int n, int db, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TA, TB, TC, BM, BN, BK, TM, TN, A_K_CONTIG, B_N_CONTIG, REFLECT>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(a, lda, b, ldb, c, M, N, K, u,
                                               unorm, p, n, db);
}

// Skinny M (decode, M ≤ 8) takes an 8×32 tile, so that more blocks stream
// B at once; larger M the largest tile that still gives every SM a block:
// 64×64 (4×4 a thread), else 32×32 (2×2 a thread).
template <typename TA, typename TB, typename TC, bool A_K_CONTIG,
          bool B_N_CONTIG, Reflect REFLECT>
cudaError_t launch_gemm(const TA* a, int lda, const TB* b, int ldb, TC* c,
                        int M, int N, int K, const float* u,
                        const float* unorm, const float* p, int n, int db,
                        cudaStream_t s) {
  const long long big = static_cast<long long>((M + 63) / 64) * ((N + 63) / 64);
  if (M <= 8)
    launch_tile<TA, TB, TC, 8, 32, 32, 1, 1, A_K_CONTIG, B_N_CONTIG, REFLECT>(
        a, lda, b, ldb, c, M, N, K, u, unorm, p, n, db, s);
  else if (big < sm_count())
    launch_tile<TA, TB, TC, 32, 32, 16, 2, 2, A_K_CONTIG, B_N_CONTIG, REFLECT>(
        a, lda, b, ldb, c, M, N, K, u, unorm, p, n, db, s);
  else
    launch_tile<TA, TB, TC, 64, 64, 16, 4, 4, A_K_CONTIG, B_N_CONTIG, REFLECT>(
        a, lda, b, ldb, c, M, N, K, u, unorm, p, n, db, s);
  return cudaGetLastError();
}

}  // namespace reflect
