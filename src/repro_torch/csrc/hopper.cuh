// Device and host helpers shared by the port's Hopper kernels
// (householder_gemm.cu's wgmma routes, flash_attention.cu's wgmma route
// and dxr_wgmma.cuh's dXr GEMM): shared-memory addresses, mbarriers, TMA tensor loads and 1-D
// bulk copies, wgmma shared-memory descriptors under the 128-byte swizzle,
// the wgmma products (both operands from shared memory, or A from
// registers) with their fence, commit and wait, and the host side of TMA:
// the CUDA driver's tensor-map encoder and a cache of encoded maps.
//
// Every library that includes this header compiles on its own into its
// own shared object (kernels/build.py), so each keeps its own map cache
// and counters: a MapCache is an object of the including source.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of `map` at (c0 innermost, c1) into shared memory at `dst`,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A 3-D box of `map` at (c0 innermost, c1, c2), likewise.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global `src` into shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
// K-major operands (rows of 128 bytes, 8-row groups `sbo` = 1024 apart)
// ignore `lbo`; MN-major ones (transpose bit set) find their next
// 64-element chunk of M or N `lbo` bytes on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64×N f32, the warpgroup's fragment: register 4j + h (h < 2) at row
// r0 = 16·(warp % 4) + lane / 4, 4j + 2 + h at row r0 + 8, column
// 8j + 2·(lane % 4) + h) = A (64×16) · B (16×N) + (scale_d ? d : 0).
// WgmmaSS: A from shared memory, K-major; B from shared memory, K-major
// (TransB 0) or N-major (TransB 1, which bf16 allows).  WgmmaRS: A from
// four registers a thread, bf16 pairs in the fragment's layout (a[0]
// row r0, columns 2·(lane % 4) + {0, 1}; a[1] row r0 + 8; a[2], a[3]
// the same rows eight columns on): the layout of the f32 fragment's
// columns 16k .. 16k + 15 rounded to bf16, so a product's result feeds
// the next product without shared memory.
template <int N, int TransB>
struct WgmmaSS;
template <int N, int TransB>
struct WgmmaRS;

template <int TransB>
struct WgmmaSS<32, TransB> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
        "%17, p, 1, 1, 0, %19; \n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

template <int TransB>
struct WgmmaSS<64, TransB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, %32, %33, p, 1, 1, 0, %35; \n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

template <int TransB>
struct WgmmaSS<128, TransB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
        "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
        "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
        "0, %67; \n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

template <int TransB>
struct WgmmaRS<64, TransB> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38; \n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(TransB));
  }
};

template <int TransB>
struct WgmmaRS<128, TransB> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
        "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
        "%55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1, %70; \n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(TransB));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host side: shared memory, tensor maps
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Beyond 48 KB a block must ask for its dynamic shared memory: once a
// device for each kernel (`sized`, a static of the kernel's launcher),
// since a runtime call on every launch would add one to every call of a
// host-bound decode step.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, int bytes,
                         bool (&sized)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  return cudaSuccess;
}

// cuTensorMapEncodeTiled is a driver call: taken through the runtime's
// entry-point query, so a library links against the runtime alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A contiguous row-major bf16 tensor of `rank` (2 or 3) dimensions,
// dims[0] innermost, as a TMA map with box `box` (box[0] · 2 ≤ 128
// bytes), 128-byte swizzle, zeros past its edges: along each dimension on
// its own, so a 3-D map over (D, rows, heads) zero-fills a box at its own
// head's last row and never reads the next head's.
inline bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                   int rank, const uint64_t* dims, const uint32_t* box) {
  cuuint64_t gdims[3], strides[2];
  cuuint32_t gbox[3], step[3];
  uint64_t stride = 2;  // bytes of one bf16
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    step[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), gdims,
             strides, gbox, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode's map through a cache of the maps made last, keyed by address,
// rank, shape and box: a map holds nothing else (no contents), so an
// entry never goes stale.  Weights, and from PyTorch's caching allocator
// most activations, come back at the same addresses call after call, so
// a steady loop encodes few maps: kWays-way sets, so that keys that share
// a set do not evict each other every step (a direct-mapped table
// re-encoded maps on every decode step).
class MapCache {
 public:
  bool get(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rank,
           const uint64_t* dims, const uint32_t* box) {
    Key key{ptr, rank, {0, 0, 0}, {0, 0, 0}};
    for (int i = 0; i < rank; ++i) {
      key.dims[i] = dims[i];
      key.box[i] = box[i];
    }
    const uint64_t h =
        ((reinterpret_cast<uintptr_t>(ptr) >> 8) * 0x9E3779B97F4A7C15ull) ^
        ((key.dims[0] << 20 | key.dims[1] | key.dims[2] << 40) *
         0xC2B2AE3D27D4EB4Full) ^
        (key.box[1] | static_cast<uint64_t>(key.box[2]) << 16);
    const int set = static_cast<int>(h >> (64 - kSetsLog2));
    std::lock_guard<std::mutex> hold(lock_);
    ++lookups_;
    for (Slot& slot : slots_[set]) {
      if (slot.key == key) {
        *map = slot.map;
        return true;
      }
    }
    Slot& slot = slots_[set][next_[set]];
    next_[set] = (next_[set] + 1) % kWays;
    ++encodes_;
    if (!encode(enc, &slot.map, ptr, rank, dims, box)) {
      slot.key = Key{};
      return false;
    }
    slot.key = key;
    *map = slot.map;
    return true;
  }

  // lookups since the library was loaded, and encodes (the misses)
  void counts(long long* out) {
    std::lock_guard<std::mutex> hold(lock_);
    out[0] = lookups_;
    out[1] = encodes_;
  }

 private:
  struct Key {
    const void* ptr = nullptr;
    int rank = 0;
    uint64_t dims[3] = {0, 0, 0};
    uint32_t box[3] = {0, 0, 0};
    bool operator==(const Key& o) const {
      return ptr == o.ptr && rank == o.rank && dims[0] == o.dims[0] &&
             dims[1] == o.dims[1] && dims[2] == o.dims[2] &&
             box[0] == o.box[0] && box[1] == o.box[1] && box[2] == o.box[2];
    }
  };
  struct Slot {
    CUtensorMap map;
    Key key;
  };
  static constexpr int kSetsLog2 = 10, kWays = 4;
  Slot slots_[1 << kSetsLog2][kWays];
  int next_[1 << kSetsLog2] = {};  // the way a miss in the set refills
  std::mutex lock_;
  long long lookups_ = 0, encodes_ = 0;
};

}  // namespace hopper
