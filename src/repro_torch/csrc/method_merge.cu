// method_merge: the DeLoRA and HyperAdapt adapters absorbed into their
// frozen weights (the zero-latency deployment), for sm_90a:
//   delora_merge:     W' = W + (a·s)·b
//   hyperadapt_merge: W' = diag(r)·W·diag(c)
//
// Replaces the TPU kernels delora_merge_pallas
// (src/repro/kernels/method_merge.py:36, _delora_merge_kernel at :25,
// pallas_call at :57) and hyperadapt_merge_pallas (:81, _ha_merge_kernel
// at :72, pallas_call at :97).  hyperadapt_merge also gives the weight's
// cotangent of the HyperAdapt merge (src/repro/kernels/ops.py:643-656).
// W: (d, f) bf16 or f32; a: (d, r) f32, b: (r, f) f32, s: (r,) in W's
// dtype (rounded there by the method layer, as the JAX package does);
// r: (d,) f32, c: (f,) f32.  Each computes in f32 and rounds once to W's
// dtype, as the Pallas kernels do.
//
// What bounds them on an H100 SXM (3.35 TB/s at 700 W): bytes.  Each reads
// and writes d·f elements once; DeLoRA does 2·r flops per element (16 at
// r = 8, far below the ~295 flops per byte at which the tensor cores would
// be the limit), HyperAdapt two.  smollm-360m's gate_proj (960×2560 bf16)
// moves 9.8 MB, about 2.9 µs.
//
// What the design does about that — a simple kernel that is right first:
//  * delora_merge: one block per tile of kRows rows × kCols columns; each
//    thread owns one column and kRows / (kThreads / kCols) rows.  The
//    rank is walked in chunks of kChunk: the chunk of a·s for the tile's
//    rows and of b for its columns is staged in shared memory (f32), and
//    each thread adds its share of (a·s)·b in registers, the rank summed
//    in order 0, 1, ..., r − 1 (no atomics).  W is read once, coalesced,
//    and written once; any r, any d and f.
//  * hyperadapt_merge: elementwise, a thread per column walking rows.
//
// C interface, bound with ctypes: delora_merge(...) and
// hyperadapt_merge(...) each launch one kernel on the given stream,
// allocate nothing and return cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

constexpr int kCols = 128;
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kCols;  // 2
constexpr int kPer = kRows / kRowStep;      // rows a thread owns: 16
constexpr int kChunk = 32;

// grid (⌈f / kCols⌉, ⌈d / kRows⌉)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delora_merge_kernel(const T* __restrict__ w, const float* __restrict__ a,
                        const float* __restrict__ b, const T* __restrict__ sv,
                        T* __restrict__ out, int d, int f, int r) {
  __shared__ float as_sh[kRows][kChunk + 1];
  __shared__ float b_sh[kChunk][kCols];
  const int tid = threadIdx.x, cl = tid % kCols, rl = tid / kCols;
  const int row0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + cl;
  float dw[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dw[i] = 0.f;
  for (int q0 = 0; q0 < r; q0 += kChunk) {
    const int nq = r - q0 < kChunk ? r - q0 : kChunk;
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int i = e / kChunk, q = e % kChunk, row = row0 + i;
      as_sh[i][q] = row < d && q < nq
                        ? a[static_cast<long long>(row) * r + q0 + q] *
                              to_f32(sv[q0 + q])
                        : 0.f;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int q = e / kCols, c = blockIdx.x * kCols + e % kCols;
      b_sh[q][e % kCols] = q < nq && c < f
                               ? b[static_cast<long long>(q0 + q) * f + c]
                               : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const float bv = b_sh[q][cl];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        dw[i] = fmaf(as_sh[rl + i * kRowStep][q], bv, dw[i]);
    }
    __syncthreads();
  }
  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = row0 + rl + i * kRowStep;
    if (row < d) {
      const long long off = static_cast<long long>(row) * f + col;
      out[off] = from_f32<T>(to_f32(w[off]) + dw[i]);
    }
  }
}

// grid (⌈f / kThreads⌉, min(d, 65535)), rows strided by gridDim.y:
// out[i, j] = (w[i, j]·r[i])·c[j]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hyperadapt_merge_kernel(const T* __restrict__ w,
                            const float* __restrict__ rv,
                            const float* __restrict__ cv, T* __restrict__ out,
                            int d, int f) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= f) return;
  const float cc = cv[col];
  for (int row = blockIdx.y; row < d; row += gridDim.y) {
    const long long off = static_cast<long long>(row) * f + col;
    out[off] = from_f32<T>(to_f32(w[off]) * rv[row] * cc);
  }
}

template <typename T>
int run_delora(const void* w, const void* a, const void* b, const void* sv,
               void* out, int d, int f, int r, cudaStream_t s) {
  const dim3 grid((f + kCols - 1) / kCols, (d + kRows - 1) / kRows);
  delora_merge_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const T*>(sv),
      static_cast<T*>(out), d, f, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_hyperadapt(const void* w, const void* rv, const void* cv, void* out,
                   int d, int f, cudaStream_t s) {
  const dim3 grid((f + kThreads - 1) / kThreads, d < 65535 ? d : 65535);
  hyperadapt_merge_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(w), static_cast<const float*>(rv),
      static_cast<const float*>(cv), static_cast<T*>(out), d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (W, s and the result alike).
extern "C" int delora_merge(const void* w, const void* a, const void* b,
                            const void* sv, void* out, int d, int f, int r,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_delora<float>(w, a, b, sv, out, d, f, r, s);
  if (dtype == 1)
    return run_delora<__nv_bfloat16>(w, a, b, sv, out, d, f, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (W and the result alike).
extern "C" int hyperadapt_merge(const void* w, const void* rv, const void* cv,
                                void* out, int d, int f, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_hyperadapt<float>(w, rv, cv, out, d, f, s);
  if (dtype == 1)
    return run_hyperadapt<__nv_bfloat16>(w, rv, cv, out, d, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
