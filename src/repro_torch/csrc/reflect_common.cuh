// Device code shared by the port's GEMM kernels (householder_gemm,
// reflect_gemm_dx, reflect_gemm_dw, etherplus_gemm, delora_gemm,
// hyperadapt_gemm and the bank variants householder_gemm_batched,
// delora_gemm_batched, hyperadapt_gemm_batched) and its row kernels
// (etherplus_merge, etherplus_reflect_bwd, etherplus_reflect_batched,
// method_merge): dtype conversions, a warp sum, the per-row tenant of a
// multi-tenant bank, the block-projection prologue, the one
// register-tiled f32 SIMT GEMM that every product runs on (with DeLoRA's
// and HyperAdapt's fused variants), the per-row rank-2 update and the
// reflection backward with its fixed-order dL/dû sum.
//
// R is the blockwise Householder reflection I − 2ûûᵀ over n blocks of db
// elements, û = u / (‖u‖ + 1e-8) with ε outside the square root, as in
// the JAX package (src/repro/kernels/reflect_bwd.py:48, unit_rows).
// ETHER+ replaces it by the rank-2 H⁺ = I − ûûᵀ + v̂v̂ᵀ, both projections
// read off the original x (src/repro/kernels/etherplus_gemm.py:38).
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

// Multi-tenant bank serving: row m of the (B·S, ·) operand belongs to
// sequence m / seq, which is served by tenant ids[m / seq] of a bank of
// `count` tenants (ids int32, or int64 under is64).  An id outside
// [0, count) is mapped into it as the JAX package's gather maps an index
// (src/repro/core/peft.py:266-270): a negative id counts from the end,
// then the id is clamped.  So the kernel never reads past the bank, and
// the wrappers never read ids on the host.  The default (one tenant, no
// ids) is what every single-tenant kernel is launched with.
struct Tenants {
  const void* ids = nullptr;
  int is64 = 0;
  int seq = 1;
  int count = 1;
};

__device__ __forceinline__ int row_tenant(const Tenants& tn, int m) {
  const int b = m / tn.seq;
  const long long id =
      tn.is64 ? __ldg(static_cast<const long long*>(tn.ids) + b)
              : static_cast<long long>(
                    __ldg(static_cast<const int*>(tn.ids) + b));
  const long long wrapped = id < 0 ? id + tn.count : id;
  return wrapped < 0 ? 0
                     : wrapped >= tn.count ? tn.count - 1
                                           : static_cast<int>(wrapped);
}

// The hyperplanes of one reflection (raw (n, db) rows; v only for ETHER+'s
// rank 2) and what the projection prologue writes for them: the per-row
// block projections p[t*n + i] = x_t,i · û_i (q likewise for v̂) and the
// block norms unorm[i] = ‖u_i‖ + ε (vnorm for v).
struct Proj {
  const float* u;
  const float* v;
  float* p;
  float* unorm;
  float* q;
  float* vnorm;
  int n, db;
};

// Proj over one f32 scratch of (M + 1)·n floats (rank 1) or twice that
// (rank 2): p (M, n), unorm (n) [, q (M, n), vnorm (n)].
inline Proj carve(const float* u, const float* v, float* scratch, int M,
                  int n, int db) {
  float* p = scratch;
  float* unorm = p + static_cast<long long>(M) * n;
  float* q = v ? unorm + n : nullptr;
  float* vnorm = v ? q + static_cast<long long>(M) * n : nullptr;
  return Proj{u, v, p, unorm, q, vnorm, n, db};
}

// One warp per (row t, block i): p[t*n + i] = Σ_j x[t, i*db + j] u[i, j]
// / (‖u_i‖ + ε), and under RANK2 q likewise for v.  Row 0's warps also
// write the norms.  x is read once for both directions.  Under BANK, u is
// an (A, n, db) bank, row t reads its tenant's hyperplanes (`tn`) and
// every warp writes its own norm, unorm[t*n + i] (an (M, n) scratch).
template <typename T, bool RANK2, bool BANK = false>
__global__ void proj_kernel(const T* __restrict__ x, Proj pr, int M, int K,
                            Tenants tn) {
  static_assert(!(BANK && RANK2), "the bank prologue is rank 1");
  const int n = pr.n, db = pr.db;
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * n) return;  // whole warps exit
  const long long t = pair / n;
  const int i = static_cast<int>(pair % n);
  const long long bank =
      BANK ? static_cast<long long>(row_tenant(tn, static_cast<int>(t))) * K
           : 0;
  const float* ui = pr.u + bank + static_cast<long long>(i) * db;
  const float* vi = RANK2 ? pr.v + static_cast<long long>(i) * db : nullptr;
  const T* xt = x + t * K + static_cast<long long>(i) * db;
  float ss = 0.f, xu = 0.f, sv = 0.f, xv = 0.f;
  for (int j = lane; j < db; j += 32) {
    const float uv = ui[j];
    ss = fmaf(uv, uv, ss);
    xu = fmaf(to_f32(xt[j]), uv, xu);
    if constexpr (RANK2) {
      const float vv = vi[j];
      sv = fmaf(vv, vv, sv);
      xv = fmaf(to_f32(xt[j]), vv, xv);
    }
  }
  ss = warp_sum(ss);
  xu = warp_sum(xu);
  if constexpr (RANK2) {
    sv = warp_sum(sv);
    xv = warp_sum(xv);
  }
  if (lane == 0) {
    const float nrm = sqrtf(ss) + kEps;
    pr.p[pair] = xu / nrm;
    if (BANK)
      pr.unorm[pair] = nrm;
    else if (t == 0)
      pr.unorm[i] = nrm;
    if constexpr (RANK2) {
      const float vn = sqrtf(sv) + kEps;
      pr.q[pair] = xv / vn;
      if (t == 0) pr.vnorm[i] = vn;
    }
  }
}

template <typename T, bool RANK2, bool BANK = false>
cudaError_t launch_proj(const T* x, const Proj& pr, int M, int K,
                        cudaStream_t s, const Tenants& tn = Tenants{}) {
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * pr.n;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kThreads / 32 - 1) / (kThreads / 32));
  proj_kernel<T, RANK2, BANK><<<blocks, kThreads, 0, s>>>(x, pr, M, K, tn);
  return cudaGetLastError();
}

// Which index of A the GEMM reflects while staging its A tile, and how.
enum Reflect {
  kReflectNone,  // A as it is (dXr = G · Wᵀ)
  kReflectK,     // A(m, k) − 2·p[m*n + k/db]·û[k]: row m of x (forward)
  kReflectM,     // A(m, k) − 2·p[k*n + m/db]·û[m]: column k of Aᵀ = x (dW)
  kRank2K,       // A(m, k) − p·û[k] + q·v̂[k] at [m*n + k/db]: ETHER+ forward
  kRank2M,       // A(m, k) − p·û[m] + q·v̂[m] at [k*n + m/db]: ETHER+ dW
};

// What the GEMM fuses besides the product, for the methods whose update is
// not a reflection (src/repro/kernels/hyperadapt_gemm.py:31 and
// delora_gemm.py:39).  kFuseNone compiles to the plain product, as the
// reflect-GEMM instantiations always did.
enum Fuse {
  kFuseNone,
  // C = ((A·diag(rs)) · B) · diag(cs): rs[k] scales A(m, k) as it is
  // staged, cs[col] (when not null) the f32 sum before the one rounding
  // (HyperAdapt: rs = r, cs = c; its backward runs z = (G·c)·Wᵀ with cs
  // null).
  kFuseScale,
  // C = A·B + ((A·la) · diag(ls)) · lb: a second accumulator h = A·la
  // (BM × r, in shared memory) is filled in the same K loop from an la
  // tile staged beside the B tile, and the epilogue adds (h·ls)·lb[:, col]
  // to the f32 sum before the one rounding (DeLoRA: la = a, ls = s,
  // lb = b; its dx runs G·Wᵀ + ((G·bᵀ)·s)·aᵀ with la = bᵀ, lb = aᵀ).
  kFuseLowRank,
  // C = A·B + ((h · diag(ls_t)) · lb_t) with h = A·a_t (M × r, f32) given
  // by a pass before the GEMM and ls, lb at each row's tenant t (BANK
  // only: delora_gemm_batched).  The epilogue adds it to the f32 sum
  // before the one rounding.
  kFuseRowLowRank,
};

// The operands of a Fuse variant: rs (K,), cs (N,) f32 for kFuseScale; la
// (K, r), lb (r, N) f32 row-major and ls (r,) in A's dtype for
// kFuseLowRank.  Under BANK each is a bank with the tenant axis first
// (rs (A, K), cs (A, N); ls (A, r), lb by its strides and h (M, r) f32
// for kFuseRowLowRank), read at each row's tenant.
struct Side {
  const float* rs = nullptr;
  const float* cs = nullptr;
  const float* la = nullptr;
  const float* lb = nullptr;
  const void* ls = nullptr;
  const float* h = nullptr;
  int r = 0;
  // kFuseRowLowRank: lb_t[q, col] = lb[t·lb_ten + q·lb_q + col·lb_c], the
  // bank read where it lies (b (A, r, N): r·N, N, 1; DeLoRA's dx reads
  // a (A, N, r) down its columns: N·r, 1, r)
  long long lb_ten = 0;
  int lb_q = 0, lb_c = 1;
};

// The largest r the kFuseLowRank GEMM takes: h (BM × r) and the la tile
// (BK × r) of its largest tile fit in the shared memory a block can have.
constexpr int kMaxRank = 512;

// C (M×N) = A (M×K) · B (K×N), f32 accumulation, any ragged edge.
// Each operand is row-major in one of its two orientations, so one kernel
// covers the forward and the transposed products of the backward:
//   A(m, k) = A_K_CONTIG ? a[m*lda + k] : a[k*lda + m],
//   B(k, n) = B_N_CONTIG ? b[k*ldb + n] : b[n*ldb + k].
// The contiguous index varies fastest across threads while staging, so
// global reads coalesce.  REFLECT applies the blockwise reflection (or
// ETHER+'s rank-2 update) of x to A as it is staged, from the prologue's
// projections and norms in `pr`, so the updated x never reaches device
// memory.  FUSE adds DeLoRA's or HyperAdapt's update (see Fuse) from `sd`;
// it is never combined with REFLECT.  Block tile BM×BN, K step BK; each
// thread owns TM×TN outputs at rows ty + i·(BM/TM), columns tx + j·(BN/TN)
// (strided, so a warp's shared reads and global stores touch consecutive
// words).  C is written at c[m*N + col] in TC.  Indices stay 32-bit
// (every dimension is an int); only addresses are 64-bit.  BANK (bank
// serving, rows of several tenants in one tile) reads û and its per-row
// norm (kReflectK), rs and cs (kFuseScale) or ls and lb (kFuseRowLowRank)
// at each row's tenant (`tn`), so W is read once for all tenants; under
// kReflectM (the bank's dW, where the token rows of x are the columns k
// of Aᵀ) it reads û at token k's tenant, the bank's rows M = d wide.  The
// launch bounds ask for one resident block
// a SM: with the thread count alone, ptxas squeezed the dXr instantiation
// to 32 registers with spills, 1.2-1.3x slower at the train step's
// 960-wide shapes on the H100 (PERF.md, run J).
template <typename TA, typename TB, typename TC, int BM, int BN, int BK,
          int TM, int TN, bool A_K_CONTIG, bool B_N_CONTIG, Reflect REFLECT,
          Fuse FUSE = kFuseNone, bool BANK = false>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 1)
    gemm_kernel(const TA* __restrict__ a, int lda, const TB* __restrict__ b,
                int ldb, TC* __restrict__ c, int M, int N, int K, Proj pr,
                Side sd, Tenants tn) {
  static_assert(FUSE == kFuseNone || REFLECT == kReflectNone,
                "a fused update replaces the reflection");
  static_assert(!BANK || (A_K_CONTIG && (REFLECT == kReflectK ||
                                         (REFLECT == kReflectNone &&
                                          FUSE != kFuseLowRank))) ||
                    (!A_K_CONTIG && REFLECT == kReflectM),
                "a bank reads rows of x: the forward along k, or dW's "
                "columns of Aᵀ = x along m");
  static_assert(BANK || FUSE != kFuseRowLowRank,
                "kFuseRowLowRank reads its operands at the rows' tenants");
  constexpr bool kAlongK = REFLECT == kReflectK || REFLECT == kRank2K;
  constexpr bool kRank2 = REFLECT == kRank2K || REFLECT == kRank2M;
  constexpr bool kLowRank = FUSE == kFuseLowRank;
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];  // k-major
  __shared__ float Bs[BK][BN + 1];
  // kFuseLowRank: h (BM × r) row-major, then the la tile (BK × r); each
  // h element is owned by thread (index mod NT) for the whole K loop
  extern __shared__ float lr_sh[];
  float* h = lr_sh;
  float* at = lr_sh + BM * sd.r;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (kLowRank)
    for (int e = tid; e < BM * sd.r; e += NT) h[e] = 0.f;

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
      float val = 0.f;
      if (m < M && k < K) {
        val = to_f32(A_K_CONTIG ? a[static_cast<long long>(m) * lda + k]
                                : a[static_cast<long long>(k) * lda + m]);
        if (REFLECT != kReflectNone) {
          const int j = kAlongK ? k : m;  // index of û
          const int t = kAlongK ? m : k;  // token row
          const int blk = j / pr.db;
          const long long tb = static_cast<long long>(t) * pr.n + blk;
          // read-only loads (ld.global.nc): the struct's pointers carry
          // no __restrict__
          float uh;
          if constexpr (BANK)  // the row's tenant's û, the row's own norm
            uh = __ldg(pr.u +
                       static_cast<long long>(row_tenant(tn, t)) *
                           (kAlongK ? K : M) +
                       j) /
                 __ldg(pr.unorm + tb);
          else
            uh = __ldg(pr.u + j) / __ldg(pr.unorm + blk);
          if (kRank2)
            val = val - __ldg(pr.p + tb) * uh +
                  __ldg(pr.q + tb) * (__ldg(pr.v + j) / __ldg(pr.vnorm + blk));
          else
            val -= 2.f * __ldg(pr.p + tb) * uh;
        }
        if constexpr (FUSE == kFuseScale)
          val *= __ldg(sd.rs + (BANK ? static_cast<long long>(
                                           row_tenant(tn, m)) * K
                                     : 0) + k);
      }
      As[kk][r] = val;
    }
    if constexpr (kLowRank) {
      // la rows k0..k0+BK−1 are contiguous: at[kk*r + q] = la[(k0+kk)*r + q]
      const long long base = static_cast<long long>(k0) * sd.r;
      const long long end = static_cast<long long>(K) * sd.r;
      for (int e = tid; e < BK * sd.r; e += NT)
        at[e] = base + e < end ? __ldg(sd.la + base + e) : 0.f;
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
    if constexpr (kLowRank) {
      for (int e = tid; e < BM * sd.r; e += NT) {
        const int row = e / sd.r, q = e % sd.r;
        float hv = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          hv = fmaf(As[kk][row], at[kk * sd.r + q], hv);
        h[e] += hv;
      }
    }
    __syncthreads();
  }

  float lr[TM][TN];
  if constexpr (kLowRank) {
    // h·s in place (each thread its own elements), then (h·s)·lb[:, col]
    const TA* ls = static_cast<const TA*>(sd.ls);
    for (int e = tid; e < BM * sd.r; e += NT) h[e] *= to_f32(ls[e % sd.r]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) lr[i][j] = 0.f;
    for (int q = 0; q < sd.r; ++q) {
      float hv[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) hv[i] = h[(ty + i * TY) * sd.r + q];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + j * TX;
        bv[j] = col < N ? __ldg(sd.lb + static_cast<long long>(q) * N + col)
                        : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) lr[i][j] = fmaf(hv[i], bv[j], lr[i][j]);
    }
  }
  if constexpr (FUSE == kFuseRowLowRank) {
    // each row's own h and tenant: lr = Σ_q (h[m, q]·ls_t[q])·lb_t[q, col]
    const TA* ls = static_cast<const TA*>(sd.ls);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) lr[i][j] = 0.f;
      const int m = m0 + ty + i * TY;
      if (m >= M) continue;
      const long long ten = row_tenant(tn, m);
      const float* hm = sd.h + static_cast<long long>(m) * sd.r;
      const TA* lst = ls + ten * sd.r;
      const float* lbt = sd.lb + ten * sd.lb_ten;
      for (int q = 0; q < sd.r; ++q) {
        const float hv = __ldg(hm + q) * to_f32(lst[q]);
        const float* lbq = lbt + static_cast<long long>(q) * sd.lb_q;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx + j * TX;
          if (col < N)
            lr[i][j] = fmaf(hv, __ldg(lbq + static_cast<long long>(col) *
                                                sd.lb_c),
                            lr[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col < N) {
        float v = acc[i][j];
        if constexpr (FUSE == kFuseScale)
          if (sd.cs)
            v *= __ldg(sd.cs + (BANK ? static_cast<long long>(
                                           row_tenant(tn, m)) * N
                                     : 0) + col);
        if constexpr (kLowRank || FUSE == kFuseRowLowRank) v += lr[i][j];
        c[static_cast<long long>(m) * N + col] = from_f32<TC>(v);
      }
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
          int TM, int TN, bool A_K_CONTIG, bool B_N_CONTIG, Reflect REFLECT,
          Fuse FUSE, bool BANK>
cudaError_t launch_tile(const TA* a, int lda, const TB* b, int ldb, TC* c,
                        int M, int N, int K, const Proj& pr, const Side& sd,
                        const Tenants& tn, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto kernel = gemm_kernel<TA, TB, TC, BM, BN, BK, TM, TN, A_K_CONTIG,
                            B_N_CONTIG, REFLECT, FUSE, BANK>;
  // kFuseLowRank's h and la tile; beyond 48 KB with the static tiles the
  // block must ask for the shared memory
  const size_t dyn =
      FUSE == kFuseLowRank ? static_cast<size_t>(BM + BK) * sd.r * 4 : 0;
  constexpr size_t kStatic = sizeof(float) * BK * (BM + 1 + BN + 1);
  if (dyn + kStatic > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, (BM / TM) * (BN / TN), dyn, s>>>(a, lda, b, ldb, c, M, N, K,
                                                  pr, sd, tn);
  return cudaSuccess;
}

// Skinny M (decode, M ≤ 8) takes an 8×32 tile, so that more blocks stream
// B at once; larger M the largest tile that still gives every SM a block:
// 64×64 (4×4 a thread), else 32×32 (2×2 a thread).  The tile depends on M
// alone, so a bank GEMM over B·S rows takes the tile its single-tenant
// counterpart takes at the same rows.
template <typename TA, typename TB, typename TC, bool A_K_CONTIG,
          bool B_N_CONTIG, Reflect REFLECT, Fuse FUSE = kFuseNone,
          bool BANK = false>
cudaError_t launch_gemm(const TA* a, int lda, const TB* b, int ldb, TC* c,
                        int M, int N, int K, const Proj& pr, cudaStream_t s,
                        const Side& sd = Side{},
                        const Tenants& tn = Tenants{}) {
  const long long big = static_cast<long long>((M + 63) / 64) * ((N + 63) / 64);
  cudaError_t err;
  if (M <= 8)
    err = launch_tile<TA, TB, TC, 8, 32, 32, 1, 1, A_K_CONTIG, B_N_CONTIG,
                      REFLECT, FUSE, BANK>(a, lda, b, ldb, c, M, N, K, pr, sd,
                                           tn, s);
  else if (big < sm_count())
    err = launch_tile<TA, TB, TC, 32, 32, 16, 2, 2, A_K_CONTIG, B_N_CONTIG,
                      REFLECT, FUSE, BANK>(a, lda, b, ldb, c, M, N, K, pr, sd,
                                           tn, s);
  else
    err = launch_tile<TA, TB, TC, 64, 64, 16, 4, 4, A_K_CONTIG, B_N_CONTIG,
                      REFLECT, FUSE, BANK>(a, lda, b, ldb, c, M, N, K, pr, sd,
                                           tn, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One warp per (row t, block j) of a row-major (M, n·db) matrix Y: row t's
// block j takes ETHER+'s rank-2 update on the output side,
//   out = Y − (Y·û_j) û_j + (Y·v̂_j) v̂_j,
// in f32 from Y in TI, written once in TO (out must not alias Y).  The
// two-sided etherplus_gemm epilogue (Y the GEMM's f32 result) and the
// right ETHER+ merge (Y = W) run on it.  The warp reads its db elements
// of Y twice, the second time from L1.  Under BANK u and v are (A, n, db)
// banks and row t takes its tenant's (`tn`): etherplus_reflect_batched.
template <typename TI, typename TO, bool BANK = false>
__global__ void rank2_rows_kernel(const TI* __restrict__ y,
                                  const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  TO* __restrict__ out, int M, int n, int db,
                                  Tenants tn) {
  const int warps = blockDim.x / 32;
  const long long pair =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(M) * n) return;  // whole warps exit
  const int j = static_cast<int>(pair % n);
  const long long off = pair * db;  // (t·n + j)·db = t·(n·db) + j·db
  // block j of the hyperplanes (under BANK, of row t's tenant)
  const int t = static_cast<int>(pair / n);
  const long long hj =
      (BANK ? static_cast<long long>(row_tenant(tn, t)) * n : 0) + j;
  const float* uj = u + hj * db;
  const float* vj = v + hj * db;
  float su = 0.f, sv = 0.f;
  for (int c = lane; c < db; c += 32) {
    su = fmaf(uj[c], uj[c], su);
    sv = fmaf(vj[c], vj[c], sv);
  }
  const float nu = sqrtf(warp_sum(su)) + kEps;
  const float nv = sqrtf(warp_sum(sv)) + kEps;
  float pu = 0.f, pv = 0.f;
  for (int c = lane; c < db; c += 32) {
    const float yv = to_f32(y[off + c]);
    pu = fmaf(yv, uj[c] / nu, pu);
    pv = fmaf(yv, vj[c] / nv, pv);
  }
  pu = warp_sum(pu);
  pv = warp_sum(pv);
  for (int c = lane; c < db; c += 32)
    out[off + c] = from_f32<TO>(to_f32(y[off + c]) - pu * (uj[c] / nu) +
                                pv * (vj[c] / nv));
}

template <typename TI, typename TO, bool BANK = false>
cudaError_t launch_rank2_rows(const TI* y, const float* u, const float* v,
                              TO* out, int M, int n, int db, cudaStream_t s,
                              const Tenants& tn = Tenants{}) {
  constexpr int kThreads = 256;
  const long long pairs = static_cast<long long>(M) * n;
  rank2_rows_kernel<TI, TO, BANK>
      <<<static_cast<unsigned>((pairs + kThreads / 32 - 1) / (kThreads / 32)),
         kThreads, 0, s>>>(y, u, v, out, M, n, db, tn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward of the blockwise update y = x + c_u û(ûᵀx) [+ c_v v̂(v̂ᵀx)]
// (c_u = −2: the reflection; c_u = −1, c_v = +1: ETHER+'s H⁺) under a
// cotangent G, for any db and any ragged M (src/repro/kernels/
// reflect_bwd.py:60, reflect_bwd_tile):
//   dx  = G + c_u (ûᵀG) û [+ c_v (v̂ᵀG) v̂]                (M, K) in TX
//   ĝ_u = c_u Σ_t [(ûᵀx_t) G_t + (ûᵀG_t) x_t]            per block, f32
//   du  = norm_chain(u, ĝ_u) = ĝ/s − (u·ĝ) u / (r s²),  r = ‖u‖, s = r + ε
// (likewise ĝ_v, dv).  The Pallas kernels keep ĝ in VMEM across their
// sequential grid; Hopper runs blocks in any order, so each tile of
// kRowsPerTile rows writes its own partial (⌈M/kRowsPerTile⌉, n, db) and
// du_kernel sums the partials in a fixed order.  No float atomics: the
// same inputs give the same bits every run.
//
// A multi-tenant bank (BANK; src/repro/kernels/reflect_bwd_batched.py)
// reflects sequence b of B = M / S with tenant ids[b]'s hyperplanes.  Its
// row tiles never straddle two sequences: each sequence has
// ⌈S/kRowsPerTile⌉ tiles of its own (the last one ragged), so a partial
// belongs to one sequence and one tenant.  seq_ghat_kernel sums each
// sequence's partials into its ĝ_seq (B, n, db), the Pallas kernels'
// second output, and bank_chain_kernel sums, per tenant a, the ĝ_seq of
// the sequences whose id maps to a, in order b = 0, 1, ..., then applies
// norm_chain with u_bank[a]: the JAX package's scatter-add over the ids
// and _bank_grad (src/repro/kernels/ops.py:279), without atomics.
// ---------------------------------------------------------------------------

constexpr int kRowsPerTile = 32;

inline int row_tiles(int M) { return (M + kRowsPerTile - 1) / kRowsPerTile; }

// One warp per unit = (row tile r, block i), `warps` units per CUDA block.
// Shared memory holds each warp's ĝ partials for its block (db floats per
// direction); every lane touches only its own elements j ≡ lane (mod 32),
// so the warp needs no barrier beyond its shuffles.  Under BANK, tile r is
// tile r % seq_tiles of sequence r / seq_tiles (rows of that sequence
// only), and u, v are (A, n, db) banks read at the sequence's tenant.
template <typename TX, typename TG, bool RANK2, bool BANK = false>
__global__ void reflect_bwd_kernel(const TX* __restrict__ x,
                                   const TG* __restrict__ g,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   TX* __restrict__ dx,
                                   float* __restrict__ part_u,
                                   float* __restrict__ part_v, int M, int K,
                                   int n, int db, int n_tiles, int seq_tiles,
                                   Tenants tn) {
  extern __shared__ float ghat_sh[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = static_cast<long long>(blockIdx.x) * warps + w;
  if (unit >= static_cast<long long>(n_tiles) * n) return;  // whole warps
  const int r = static_cast<int>(unit / n), i = static_cast<int>(unit % n);
  float* acc = ghat_sh + static_cast<long long>(w) * db * (RANK2 ? 2 : 1);
  float* acc_v = acc + db;  // RANK2 only
  long long t_beg, t_end, bank = 0;
  if constexpr (BANK) {
    const long long seq_beg = static_cast<long long>(r / seq_tiles) * tn.seq;
    t_beg = seq_beg + static_cast<long long>(r % seq_tiles) * kRowsPerTile;
    t_end = t_beg + kRowsPerTile < seq_beg + tn.seq ? t_beg + kRowsPerTile
                                                    : seq_beg + tn.seq;
    bank = static_cast<long long>(row_tenant(tn, static_cast<int>(t_beg))) *
           K;
  } else {
    t_beg = static_cast<long long>(r) * kRowsPerTile;
    t_end = t_beg + kRowsPerTile < M ? t_beg + kRowsPerTile : M;
  }
  const float* ui = u + bank + static_cast<long long>(i) * db;
  const float* vi = RANK2 ? v + bank + static_cast<long long>(i) * db : nullptr;

  float ss = 0.f, sv = 0.f;
  for (int j = lane; j < db; j += 32) {
    ss = fmaf(ui[j], ui[j], ss);
    acc[j] = 0.f;
    if constexpr (RANK2) {
      sv = fmaf(vi[j], vi[j], sv);
      acc_v[j] = 0.f;
    }
  }
  const float nrm = sqrtf(warp_sum(ss)) + kEps;
  float nrm_v = 1.f;
  if constexpr (RANK2) nrm_v = sqrtf(warp_sum(sv)) + kEps;

  for (long long t = t_beg; t < t_end; ++t) {
    const long long off = t * K + static_cast<long long>(i) * db;
    float px = 0.f, pg = 0.f, qx = 0.f, qg = 0.f;
    for (int j = lane; j < db; j += 32) {
      const float uh = ui[j] / nrm;
      px = fmaf(to_f32(x[off + j]), uh, px);
      pg = fmaf(to_f32(g[off + j]), uh, pg);
      if constexpr (RANK2) {
        const float vh = vi[j] / nrm_v;
        qx = fmaf(to_f32(x[off + j]), vh, qx);
        qg = fmaf(to_f32(g[off + j]), vh, qg);
      }
    }
    px = warp_sum(px);
    pg = warp_sum(pg);
    if constexpr (RANK2) {
      qx = warp_sum(qx);
      qg = warp_sum(qg);
    }
    for (int j = lane; j < db; j += 32) {
      const float uh = ui[j] / nrm;
      const float gv = to_f32(g[off + j]);
      if constexpr (RANK2) {
        const float vh = vi[j] / nrm_v;
        const float xv = to_f32(x[off + j]);
        dx[off + j] = from_f32<TX>(gv - pg * uh + qg * vh);
        acc[j] += px * gv + pg * xv;
        acc_v[j] += qx * gv + qg * xv;
      } else {
        dx[off + j] = from_f32<TX>(gv - 2.f * pg * uh);
        acc[j] += px * gv + pg * to_f32(x[off + j]);
      }
    }
  }
  const long long out = (static_cast<long long>(r) * n + i) * db;
  for (int j = lane; j < db; j += 32) {
    if constexpr (RANK2) {
      part_u[out + j] = -acc[j];
      part_v[out + j] = acc_v[j];
    } else {
      part_u[out + j] = -2.f * acc[j];
    }
  }
}

// reflect_bwd_kernel's launch: `warps` units a CUDA block, the ĝ partials
// of each in dynamic shared memory (asked for past 48 KB).
template <typename TX, typename TG, bool RANK2, bool BANK = false>
cudaError_t launch_reflect_bwd_tiles(const TX* x, const TG* g, const float* u,
                                     const float* v, TX* dx, float* part_u,
                                     float* part_v, int M, int K, int n,
                                     int db, int n_tiles, int seq_tiles,
                                     const Tenants& tn, cudaStream_t s) {
  const int warps = db <= 3072 ? 4 : 1;
  const size_t shared =
      static_cast<size_t>(warps) * db * sizeof(float) * (RANK2 ? 2 : 1);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reflect_bwd_kernel<TX, TG, RANK2, BANK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const long long units = static_cast<long long>(n_tiles) * n;
  reflect_bwd_kernel<TX, TG, RANK2, BANK>
      <<<static_cast<unsigned>((units + warps - 1) / warps), warps * 32,
         shared, s>>>(x, g, u, v, dx, part_u, part_v, M, K, n, db, n_tiles,
                      seq_tiles, tn);
  return cudaGetLastError();
}

// One warp per block i of each direction (blockIdx.y: 0 for u, 1 for v,
// so that both directions of ETHER+'s H⁺ take one launch): ĝ = Σ_r
// part[r, i] in order r = 0, 1, ..., then du = norm_chain(u_i, ĝ).
__global__ void du_kernel(const float* __restrict__ part_u,
                          const float* __restrict__ u, float* __restrict__ du,
                          const float* __restrict__ part_v,
                          const float* __restrict__ v, float* __restrict__ dv,
                          int n, int db, int n_tiles) {
  const int warps = blockDim.x / 32;
  const int i = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;
  const bool second = blockIdx.y == 1;
  const float* part = second ? part_v : part_u;
  const float* ui = (second ? v : u) + static_cast<long long>(i) * db;
  float* di = (second ? dv : du) + static_cast<long long>(i) * db;
  const long long stride = static_cast<long long>(n) * db;
  float ss = 0.f, dot = 0.f;
  for (int j = lane; j < db; j += 32) {
    const float* pj = part + static_cast<long long>(i) * db + j;
    float g = 0.f;
    for (int r = 0; r < n_tiles; ++r) g += pj[r * stride];
    di[j] = g;
    ss = fmaf(ui[j], ui[j], ss);
    dot = fmaf(ui[j], g, dot);
  }
  const float rn = sqrtf(warp_sum(ss));
  dot = warp_sum(dot);
  const float s = rn + kEps;
  for (int j = lane; j < db; j += 32) di[j] = di[j] / s - dot * ui[j] / (rn * s * s);
}

// du (and with RANK2 dv) from part_u (part_v), n_tiles partials each:
// du_kernel, one launch.
template <bool RANK2>
cudaError_t launch_du(const float* part_u, const float* u, float* du,
                      const float* part_v, const float* v, float* dv, int n,
                      int db, int n_tiles, cudaStream_t s) {
  du_kernel<<<dim3((n + 3) / 4, RANK2 ? 2 : 1), 128, 0, s>>>(
      part_u, u, du, part_v, v, dv, n, db, n_tiles);
  return cudaGetLastError();
}

// dx, and du (dv) from the partials: reflect_bwd_kernel, then launch_du.
// part_u (part_v) hold row_tiles(M)·n·db floats.
template <typename TX, typename TG, bool RANK2>
cudaError_t launch_reflect_bwd(const TX* x, const TG* g, const float* u,
                               const float* v, TX* dx, float* part_u,
                               float* part_v, float* du, float* dv, int M,
                               int K, int n, int db, cudaStream_t s) {
  const int n_tiles = row_tiles(M);
  cudaError_t err = launch_reflect_bwd_tiles<TX, TG, RANK2>(
      x, g, u, v, dx, part_u, part_v, M, K, n, db, n_tiles, n_tiles,
      Tenants{}, s);
  if (err != cudaSuccess) return err;
  return launch_du<RANK2>(part_u, u, du, part_v, v, dv, n, db, n_tiles, s);
}

// The bank's ĝ per sequence: one warp per (direction, sequence b, block
// i), ĝ_seq[b, i] = Σ_j part[b·seq_tiles + j, i] in order j = 0, 1, ....
// part holds `dirs` directions of (B·seq_tiles, n, db) one after the
// other, ghat `dirs` of (B, n, db).
__global__ void seq_ghat_kernel(const float* __restrict__ part,
                                float* __restrict__ ghat, int B, int n,
                                int db, int seq_tiles, int dirs) {
  const int warps = blockDim.x / 32;
  const long long unit =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long per_dir = static_cast<long long>(B) * n;
  if (unit >= per_dir * dirs) return;
  const long long dir = unit / per_dir, bi = unit % per_dir;
  const long long b = bi / n, i = bi % n;
  const long long stride = static_cast<long long>(n) * db;
  const float* p = part + dir * per_dir * seq_tiles * db +
                   (b * seq_tiles * n + i) * db;
  float* out = ghat + (dir * per_dir + bi) * db;
  for (int j = lane; j < db; j += 32) {
    float acc = 0.f;
    for (int r = 0; r < seq_tiles; ++r) acc += p[r * stride + j];
    out[j] = acc;
  }
}

// The bank's du (dv): one warp per (direction, tenant a, block i).  ĝ =
// Σ ĝ_seq[b, i] over the sequences b whose id maps to a (row_tenant), in
// order b = 0, 1, ..., then norm_chain with u_bank[a, i]; a tenant that no
// id names gets an exact zero.  The ids are read on the device.
__global__ void bank_chain_kernel(const float* __restrict__ ghat,
                                  const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  float* __restrict__ du,
                                  float* __restrict__ dv, int B, int n,
                                  int db, int dirs, Tenants tn) {
  const int warps = blockDim.x / 32;
  const long long unit =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long per_dir = static_cast<long long>(tn.count) * n;
  if (unit >= per_dir * dirs) return;
  const long long dir = unit / per_dir, ai = unit % per_dir;
  const int a = static_cast<int>(ai / n);
  const long long i = ai % n;
  const float* ui = (dir ? v : u) + ai * db;
  float* di = (dir ? dv : du) + ai * db;
  const float* gh = ghat + dir * B * static_cast<long long>(n) * db + i * db;
  const long long stride = static_cast<long long>(n) * db;
  int hits = 0;
  for (int b = 0; b < B; ++b) hits += row_tenant(tn, b * tn.seq) == a;
  if (hits == 0) {
    for (int j = lane; j < db; j += 32) di[j] = 0.f;
    return;
  }
  float ss = 0.f, dot = 0.f;
  for (int j = lane; j < db; j += 32) {
    float g = 0.f;
    for (int b = 0; b < B; ++b)
      if (row_tenant(tn, b * tn.seq) == a) g += gh[b * stride + j];
    di[j] = g;
    ss = fmaf(ui[j], ui[j], ss);
    dot = fmaf(ui[j], g, dot);
  }
  const float rn = sqrtf(warp_sum(ss));
  dot = warp_sum(dot);
  const float s = rn + kEps;
  for (int j = lane; j < db; j += 32) di[j] = di[j] / s - dot * ui[j] / (rn * s * s);
}

// The bank's sums after the row tiles' ĝ partials (`seq_tiles` a
// sequence): seq_ghat_kernel (ĝ_seq, each direction), then
// bank_chain_kernel (du_bank [, dv_bank]).  part holds `dirs` directions
// of (B·seq_tiles, n, db), ghat `dirs` of (B, n, db).
inline cudaError_t launch_bank_sums(const float* part, float* ghat,
                                    const float* u, const float* v,
                                    float* du, float* dv, int B, int n,
                                    int db, int seq_tiles, int dirs,
                                    const Tenants& tn, cudaStream_t s) {
  constexpr int kThreads = 256, kWarps = kThreads / 32;
  const long long seq_units = static_cast<long long>(dirs) * B * n;
  seq_ghat_kernel<<<static_cast<unsigned>((seq_units + kWarps - 1) / kWarps),
                    kThreads, 0, s>>>(part, ghat, B, n, db, seq_tiles, dirs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bank_units = static_cast<long long>(dirs) * tn.count * n;
  bank_chain_kernel<<<static_cast<unsigned>((bank_units + kWarps - 1) /
                                            kWarps),
                      kThreads, 0, s>>>(ghat, u, v, du, dv, B, n, db, dirs,
                                        tn);
  return cudaGetLastError();
}

// The bank backward from x and G (M = B·S rows): reflect_bwd_kernel under
// BANK (dx and the tiles' partials), then launch_bank_sums.  part holds
// (RANK2 ? 2 : 1)·B·row_tiles(S)·n·db floats, ghat (RANK2 ? 2 : 1)·B·n·db;
// du, dv are (A, n, db) like the banks.
template <typename TX, typename TG, bool RANK2>
cudaError_t launch_reflect_bwd_bank(const TX* x, const TG* g, const float* u,
                                    const float* v, TX* dx, float* part,
                                    float* ghat, float* du, float* dv, int M,
                                    int K, int n, int db, const Tenants& tn,
                                    cudaStream_t s) {
  const int B = M / tn.seq, seq_tiles = row_tiles(tn.seq);
  const int n_tiles = B * seq_tiles;
  cudaError_t err = launch_reflect_bwd_tiles<TX, TG, RANK2, true>(
      x, g, u, v, dx, part,
      RANK2 ? part + static_cast<long long>(n_tiles) * K : nullptr, M, K, n,
      db, n_tiles, seq_tiles, tn, s);
  if (err != cudaSuccess) return err;
  return launch_bank_sums(part, ghat, u, v, du, dv, B, n, db, seq_tiles,
                          RANK2 ? 2 : 1, tn, s);
}

}  // namespace reflect
