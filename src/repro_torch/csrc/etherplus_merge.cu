// etherplus_merge: W' = H⁺_L · W, then W' · H̃⁺_R, an ETHER+ adapter
// absorbed into its frozen weight (the paper's zero-latency deployment),
// for sm_90a.  H⁺ = I − ûûᵀ + v̂v̂ᵀ per block.
//
// Replaces the TPU kernels etherplus_merge_left_pallas
// (src/repro/kernels/etherplus_merge.py:46, pallas_call at :64) and
// etherplus_merge_right_pallas (:79, pallas_call at :90).
// W: (d, f) bf16 or f32; u1/v1: (n, db) f32 raw with n·db = d (left, on the
// input dim); u2/v2: (n_out, db_out) f32 raw with n_out·db_out = f (right,
// on the output dim).  Each pass computes in f32 and rounds once to W's
// dtype; the caller runs left, then right on the rounded left result, as
// the JAX package's ops.etherplus_merge does.
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  Each pass
// must read d·f and write d·f elements and does ~8 flops per element, far
// below the ~295 flops per byte at which the tensor cores would be the
// limit.  smollm-360m's gate_proj (960×2560 bf16) moves 9.8 MB a pass,
// about 2.9 µs.
//
// What the design does about that — a simple kernel that is right first:
//  * Left: one CUDA block per (reflection block i, strip of 32 columns).
//    Its eight warps take every eighth row of the block's db rows, a warp
//    reading 32 neighbouring columns of a row (coalesced), and keep what
//    they read in shared memory while they sum their share of ûᵀW and
//    v̂ᵀW; the eight partials are added in a fixed order, and the update
//    is written from shared memory.  W is read from device memory once
//    (ether_merge's one-thread-per-column walk reads it twice).  Where the
//    db × 32 strip does not fit in shared memory (db above 1,600 in f32,
//    3,200 in bf16) the write pass reads W again instead.
//  * Right: the per-row rank-2 update of reflect_common.cuh
//    (rank2_rows_kernel, one warp per (row, output block)), which the
//    two-sided etherplus_gemm epilogue runs too: the warp reads its db_out
//    contiguous elements, then again from L1 to write them.
//
// C interface, bound with ctypes: etherplus_merge_left(...) and
// etherplus_merge_right(...) each launch one kernel on the given stream,
// allocate nothing and return cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

constexpr int kCols = 32;  // one warp's columns
constexpr int kWarps = 8;
constexpr int kThreads = kCols * kWarps;
constexpr size_t kMaxStrip = 200 * 1024;  // of the SM's 227 KB

// grid (⌈f / kCols⌉, n); STAGED keeps the db × kCols strip in dynamic
// shared memory.  Each thread re-reads only the strip elements it wrote
// itself, so the write pass needs no barrier of its own.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    merge_left_kernel(const T* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ v, T* __restrict__ out, int f,
                      int db) {
  extern __shared__ __align__(16) unsigned char strip_raw[];
  T* strip = reinterpret_cast<T*>(strip_raw);
  __shared__ float red_u[kWarps][kCols], red_v[kWarps][kCols];
  __shared__ float s_norm[2];
  const int i = blockIdx.y;
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const float* ui = u + static_cast<long long>(i) * db;
  const float* vi = v + static_cast<long long>(i) * db;
  if (wp < 2) {  // warp 0: ‖u_i‖ + ε, warp 1: ‖v_i‖ + ε
    const float* a = wp == 0 ? ui : vi;
    float ss = 0.f;
    for (int r = lane; r < db; r += 32) ss = fmaf(a[r], a[r], ss);
    ss = warp_sum(ss);
    if (lane == 0) s_norm[wp] = sqrtf(ss) + kEps;
  }
  __syncthreads();
  const float nu = s_norm[0], nv = s_norm[1];
  const long long c = static_cast<long long>(blockIdx.x) * kCols + lane;
  const bool ok = c < f;
  const long long base = static_cast<long long>(i) * db * f + c;

  float pu = 0.f, pv = 0.f;
#pragma unroll 4
  for (int r = wp; r < db; r += kWarps) {
    float wv = 0.f;
    if (ok) {
      const T raw = w[base + static_cast<long long>(r) * f];
      if (STAGED) strip[r * kCols + lane] = raw;
      wv = to_f32(raw);
    }
    pu = fmaf(ui[r] / nu, wv, pu);
    pv = fmaf(vi[r] / nv, wv, pv);
  }
  red_u[wp][lane] = pu;
  red_v[wp][lane] = pv;
  __syncthreads();
  float su = 0.f, sv = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    su += red_u[k][lane];
    sv += red_v[k][lane];
  }
  if (!ok) return;
#pragma unroll 4
  for (int r = wp; r < db; r += kWarps) {
    const long long o = base + static_cast<long long>(r) * f;
    const float wv = to_f32(STAGED ? strip[r * kCols + lane] : w[o]);
    out[o] = from_f32<T>(wv - (ui[r] / nu) * su + (vi[r] / nv) * sv);
  }
}

template <typename T>
cudaError_t launch_left(const T* w, const float* u, const float* v, T* out,
                        int f, int n, int db, cudaStream_t s) {
  const dim3 grid((f + kCols - 1) / kCols, n);
  const size_t strip = static_cast<size_t>(db) * kCols * sizeof(T);
  if (strip > kMaxStrip) {
    merge_left_kernel<T, false><<<grid, kThreads, 0, s>>>(w, u, v, out, f, db);
    return cudaGetLastError();
  }
  if (strip > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_left_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(strip));
    if (err != cudaSuccess) return err;
  }
  merge_left_kernel<T, true><<<grid, kThreads, strip, s>>>(w, u, v, out, f, db);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w and out alike); w is (n·db, f).
extern "C" int etherplus_merge_left(const void* w, const void* u,
                                    const void* v, void* out, int f, int n,
                                    int db, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  if (dtype == 0)
    return static_cast<int>(launch_left<float>(static_cast<const float*>(w),
                                               uf, vf, static_cast<float*>(out),
                                               f, n, db, s));
  if (dtype == 1)
    return static_cast<int>(launch_left<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(w), uf, vf,
        static_cast<__nv_bfloat16*>(out), f, n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above; w is (d, n·db), u and v (n, db) on its output dim.
extern "C" int etherplus_merge_right(const void* w, const void* u,
                                     const void* v, void* out, int d, int n,
                                     int db, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  if (dtype == 0)
    return static_cast<int>(launch_rank2_rows<float, float>(
        static_cast<const float*>(w), uf, vf, static_cast<float*>(out), d, n,
        db, s));
  if (dtype == 1)
    return static_cast<int>(launch_rank2_rows<__nv_bfloat16, __nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(w), uf, vf,
        static_cast<__nv_bfloat16*>(out), d, n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
