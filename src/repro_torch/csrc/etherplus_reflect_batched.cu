// etherplus_reflect_batched: out[b] = H⁺_t x[b] with t = ids[b] for every
// sequence b of a batch, H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of tenant t of an
// ETHER+ adapter bank, for sm_90a.
//
// Replaces the TPU kernel etherplus_reflect_batched_pallas
// (src/repro/kernels/etherplus_reflect_batched.py:44, pallas_call at :70):
// ETHER+ bank serving (`serve --tenants N`) and training through a bank
// (src/repro/core/methods.py:258-270) run it twice per adapted linear, on
// x before the shared frozen GEMM (u1/v1 over d) and, two-sided, on its
// output (u2/v2 over f); the GEMM between them is a plain product, as the
// JAX package leaves it to XLA.
// x: (B·S, d) bf16 or f32, u_bank/v_bank: (A, n, db) f32 raw with
// n·db = d, ids: (B,) int32 or int64 (mapped into [0, A)); out: (B·S, d)
// in x's dtype.  Both projections read the original x (a true rank-2
// update); everything inside is f32 with one rounding, as in the Pallas
// kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s, the data sheet's rate at
// 700 W): bytes.  It reads x and writes out once (4·B·S·d bytes in bf16)
// and does ~10 operations an element, far below the tensor cores' 295 a
// byte, so it uses none.
//
// The design is rank2_tiles.cuh's rank2_tile_kernel: one CTA per tile of
// rows of one sequence (and column chunk), the tenant's û and v̂ formed
// once in shared memory, the tile in with 16-byte cp.async and out with
// 16-byte stores, a warp per (row, block) pair.  The header's note
// states every sum's order.
//
// C interface, bound with ctypes: etherplus_reflect_batched(...) launches
// one kernel on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "rank2_tiles.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).  ids: B = M / seq
// ids, int64 when ids64, else int32; tenants = A.  rows, bpc, vec and
// staged: the launch geometry (kernels/batched.py, rank2_geometry), which
// this checks.  out must not alias x.
extern "C" int etherplus_reflect_batched(const void* x, const void* u,
                                         const void* v, const void* ids,
                                         int ids64, int seq, int tenants,
                                         void* out, int M, int n, int db,
                                         int dtype, int rows, int bpc, int vec,
                                         int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == 1 ? 2 : 4;
  const int tiles = seq > 0 && rows > 0 ? (seq + rows - 1) / rows : 0;
  const int chunks = bpc > 0 ? (n + bpc - 1) / bpc : 0;
  const r2t::Geometry g{M,     n,   db,     seq, rows,
                        tiles, bpc, chunks, vec,  staged};
  if (tenants < 1 || (dtype != 0 && dtype != 1) ||
      !r2t::check_geometry(g, es, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const reflect::Tenants tn{ids, ids64, seq, tenants};
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  if (dtype == 0)
    return static_cast<int>(r2t::launch_forward<float>(
        static_cast<const float*>(x), uf, vf, static_cast<float*>(out), g, tn,
        s));
  return static_cast<int>(r2t::launch_forward<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), uf, vf,
      static_cast<__nv_bfloat16*>(out), g, tn, s));
}
