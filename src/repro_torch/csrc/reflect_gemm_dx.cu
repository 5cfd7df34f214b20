// reflect_gemm_dx: the (dx, du) half of the backward of y = R(x) · W,
// R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel reflect_gemm_dx_pallas
// (src/repro/kernels/gemm_bwd.py:118, _gemm_dx_kernel at :60, pallas_call
// at :151): the gradient of every adapted linear in training.  Under the
// cotangent G (M, N):
//   dXr = G · Wᵀ                         (M, K), f32
//   dx  = R(dXr) = dXr − 2 (ûᵀdXr) û     (M, K) in x's dtype
//   ĝ   = −2 Σ_t [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t]   per block, f32
//   du  = norm_chain(u, ĝ) = ĝ/s − (u·ĝ) u / (r s²),  r = ‖u‖, s = r + ε
// (src/repro/kernels/reflect_bwd.py:37, XLA's AD of û = u/(‖u‖+ε)).
// x, W, G bf16 or f32 alike; u (n, db) f32 raw hyperplanes, n·db = K.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W): the dXr GEMM, 2·M·N·K operations.  At the
// train step of smollm-360m (M = B·S = 1024) down_proj's 1024×960×2560 is
// 5.0 GFLOP, 5 µs on the bf16 tensor cores, and the bytes it must move
// (x, W, G, dx) 11 MB, 3 µs.  Operations bound, like the forward.
//
// What the design does about that — a simple kernel that is right first:
//  * The Pallas kernel keeps the dL/dû sum in VMEM scratch across its
//    sequential grid.  Hopper runs blocks in parallel and in no order, so
//    here each tile of kRowsPerTile rows writes its own partial ĝ
//    (⌈M/kRowsPerTile⌉, n, db) and a last small kernel sums the partials
//    in a fixed order and applies norm_chain.  No floating-point atomics:
//    the same inputs give the same bits every run, which the trainer's
//    bitwise resume check needs.
//  * The Pallas kernel needs each K tile to hold whole reflection blocks;
//    smollm-360m's db = 30 or 80 (n = 32) fits no Hopper tile.  So the
//    GEMM writes dXr in f32 to an (M, K) scratch, and an epilogue kernel
//    runs one warp per (row tile, block): it computes ûᵀx_t and ûᵀdXr_t
//    by warp sums, writes dx and accumulates its ĝ partial in shared
//    memory, for any db and any ragged M.  Fusing the epilogue into the
//    GEMM (and so never writing dXr) is later work.
//  * The GEMM is the register-tiled SIMT f32 kernel of reflect_common.cuh:
//    exact f32 math for both dtypes, no tensor cores, so it runs at the
//    f32 rate (67 TFLOP/s), far from the bf16 bound.  wgmma with TMA-fed
//    shared-memory rings is the next step (ROADMAP.md).
//
// C interface, bound with ctypes: reflect_gemm_dx(...) launches the three
// kernels on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

constexpr int kRowsPerTile = 32;

// One warp per unit = (row tile r, block i), `warps` units per CUDA block.
// Shared memory holds each warp's ĝ partial for its block (db floats);
// every lane touches only its own elements j ≡ lane (mod 32), so the
// warp needs no barrier beyond its shuffles.
template <typename T>
__global__ void dx_epilogue_kernel(const T* __restrict__ x,
                                   const float* __restrict__ dxr,
                                   const float* __restrict__ u,
                                   T* __restrict__ dx,
                                   float* __restrict__ part, int M, int K,
                                   int n, int db, int n_tiles) {
  extern __shared__ float ghat_sh[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = static_cast<long long>(blockIdx.x) * warps + w;
  if (unit >= static_cast<long long>(n_tiles) * n) return;  // whole warps
  const int r = static_cast<int>(unit / n), i = static_cast<int>(unit % n);
  float* acc = ghat_sh + static_cast<long long>(w) * db;
  const float* ui = u + static_cast<long long>(i) * db;

  float ss = 0.f;
  for (int j = lane; j < db; j += 32) {
    ss = fmaf(ui[j], ui[j], ss);
    acc[j] = 0.f;
  }
  const float nrm = sqrtf(warp_sum(ss)) + kEps;

  const long long t_beg = static_cast<long long>(r) * kRowsPerTile;
  const long long t_end = t_beg + kRowsPerTile < M ? t_beg + kRowsPerTile : M;
  for (long long t = t_beg; t < t_end; ++t) {
    const long long off = t * K + static_cast<long long>(i) * db;
    float px = 0.f, pg = 0.f;
    for (int j = lane; j < db; j += 32) {
      const float uh = ui[j] / nrm;
      px = fmaf(to_f32(x[off + j]), uh, px);
      pg = fmaf(dxr[off + j], uh, pg);
    }
    px = warp_sum(px);
    pg = warp_sum(pg);
    for (int j = lane; j < db; j += 32) {
      const float uh = ui[j] / nrm;
      const float gv = dxr[off + j];
      dx[off + j] = from_f32<T>(gv - 2.f * pg * uh);
      acc[j] += px * gv + pg * to_f32(x[off + j]);
    }
  }
  float* out = part + (static_cast<long long>(r) * n + i) * db;
  for (int j = lane; j < db; j += 32) out[j] = -2.f * acc[j];
}

// One warp per block i: ĝ = Σ_r part[r, i] in order r = 0, 1, ..., then
// du = norm_chain(u_i, ĝ).
__global__ void du_kernel(const float* __restrict__ part,
                          const float* __restrict__ u, float* __restrict__ du,
                          int n, int db, int n_tiles) {
  const int warps = blockDim.x / 32;
  const int i = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;
  const float* ui = u + static_cast<long long>(i) * db;
  float* di = du + static_cast<long long>(i) * db;
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

template <typename T>
int run(const void* x, const void* w, const void* u, const void* g,
        void* dxr, void* part, void* dx, void* du, int M, int K, int N,
        int n, int db, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* uf = static_cast<const float*>(u);
  float* dxr_f = static_cast<float*>(dxr);
  float* part_f = static_cast<float*>(part);
  // dXr (M×K) = G (M×N) · Wᵀ: A(m, k) = g[m*N + k], B(k, c) = w[c*N + k]
  cudaError_t err = launch_gemm<T, T, float, true, false, kReflectNone>(
      static_cast<const T*>(g), N, static_cast<const T*>(w), N, dxr_f, M, K, N,
      nullptr, nullptr, nullptr, n, db, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (M + kRowsPerTile - 1) / kRowsPerTile;
  const int warps = db <= 3072 ? 4 : 1;
  const size_t shared = static_cast<size_t>(warps) * db * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(dx_epilogue_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long units = static_cast<long long>(n_tiles) * n;
  dx_epilogue_kernel<T><<<static_cast<unsigned>((units + warps - 1) / warps),
                          warps * 32, shared, s>>>(
      xt, dxr_f, uf, static_cast<T*>(dx), part_f, M, K, n, db, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  du_kernel<<<(n + 3) / 4, 128, 0, s>>>(part_f, uf, static_cast<float*>(du),
                                        n, db, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of ĝ partials the caller's `part` scratch must hold, times n·db.
extern "C" int reflect_gemm_dx_row_tiles(int M) {
  return (M + kRowsPerTile - 1) / kRowsPerTile;
}

// dtype: 0 = float32, 1 = bfloat16 (x, W, G and dx alike).  dxr is (M, K)
// f32 scratch, part (reflect_gemm_dx_row_tiles(M), n, db) f32 scratch, both
// written before they are read; du (n, db) f32.
extern "C" int reflect_gemm_dx(const void* x, const void* w, const void* u,
                               const void* g, void* dxr, void* part, void* dx,
                               void* du, int M, int K, int N, int n, int db,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w, u, g, dxr, part, dx, du, M, K, N, n, db, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, u, g, dxr, part, dx, du, M, K, N, n, db,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}
