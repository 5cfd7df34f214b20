// ether_merge: W' = H_B · W for sm_90a, the ETHER adapter absorbed into
// its frozen weight (the paper's zero-latency deployment, §3.1).
//
// Replaces the TPU kernel ether_merge_pallas
// (src/repro/kernels/ether_merge.py:29, pallas_call at :42).
// W: (d, f) bf16 or f32, u: (n, db) f32 raw hyperplanes with n·db = d;
// W' has W's dtype.  Block i's rows W_i (db × f) become
// W_i − 2 û_i (û_iᵀ W_i), û_i = u_i / (‖u_i‖ + 1e-8), all in f32 inside:
// O(d·f) work whatever n is.
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  It must
// read d·f and write d·f elements and does 4 flops per element, far below
// the ~295 flops per byte at which the tensor cores would be the limit.
// smollm-360m's gate_proj (960×2560 bf16) moves 9.8 MB, about 2.9 µs.
//
// What the design does about that: one thread per column of one block.
// Each block of threads first reduces ‖u_i‖ in shared memory, then walks
// the block's db rows twice with coalesced reads (neighbouring threads on
// neighbouring columns): once for the projection û_iᵀW_i of its column,
// held in a register, and once to write the updated column.  The second
// read hits L2 when the block's db × 256 strip fits there, else it costs
// a third pass over device memory — keeping the strip in registers or
// shared memory is the next step (ROADMAP.md).  Stacked (L, d, f)
// kernels are merged one layer slice per call, as the JAX package vmaps
// merge_weight over the layer axis.
//
// C interface, bound with ctypes: ether_merge(...) launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kThreads = 256;

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
  return __float2bfloat16(v);
}

// grid (ceil(f / kThreads), n): block (bx, i) owns columns
// [bx·kThreads, (bx+1)·kThreads) of reflection block i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ether_merge_kernel(const T* __restrict__ w, const float* __restrict__ u,
                       T* __restrict__ out, int f, int db) {
  __shared__ float partial[kThreads / 32];
  __shared__ float s_norm;
  const int i = blockIdx.y;
  const float* ui = u + static_cast<long long>(i) * db;

  float ss = 0.f;
  for (int j = threadIdx.x; j < db; j += kThreads) ss = fmaf(ui[j], ui[j], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) tot += partial[k];
    s_norm = sqrtf(tot) + kEps;
  }
  __syncthreads();
  const float nrm = s_norm;

  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= f) return;
  const long long base = static_cast<long long>(i) * db * f + c;
  const T* wi = w + base;
  T* oi = out + base;

  float proj = 0.f;
#pragma unroll 8
  for (int r = 0; r < db; ++r)
    proj = fmaf(ui[r] / nrm, to_f32(wi[static_cast<long long>(r) * f]), proj);
  const float two_p = 2.f * proj;
#pragma unroll 8
  for (int r = 0; r < db; ++r) {
    const long long o = static_cast<long long>(r) * f;
    oi[o] = from_f32<T>(to_f32(wi[o]) - two_p * (ui[r] / nrm));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w and out alike); w is (n·db, f).
extern "C" int ether_merge(const void* w, const void* u, void* out, int f,
                           int n, int db, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((f + kThreads - 1) / kThreads, n);
  const float* uf = static_cast<const float*>(u);
  if (dtype == 0)
    ether_merge_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(w), uf, static_cast<float*>(out), f, db);
  else if (dtype == 1)
    ether_merge_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), uf,
        static_cast<__nv_bfloat16*>(out), f, db);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
