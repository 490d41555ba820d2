// Hopper (sm_90a) building blocks shared by the port's warp-specialised
// kernels: wgmma descriptors and products, mbarriers, TMA tile loads and
// register reallocation. PTX semantics as in the PTX ISA 8.x chapters on
// wgmma.mma_async, mbarrier and cp.async.bulk.tensor.
//
// Shared-memory tiles are written by TMA with CU_TENSOR_MAP_SWIZZLE_128B:
// a box of `rows` x 64 bf16 (128 bytes a row) whose 8-row groups (1024
// bytes) are the swizzle atoms, so every tile starts 1024-byte aligned. A
// head dim of 128 is two such boxes, `rows` x 128 bytes apart.
//
// Descriptors (desc_*): a tile read K-major (K contiguous in each 128-byte
// row) advances 32 bytes a k16 step inside a box and jumps to the next box
// after 64 elements; SBO is the 1024-byte stride of 8-row groups, LBO is
// unused. A tile read MN-major (N contiguous, the transpose-B bit set)
// advances 16 rows (2048 bytes) a k16 step; SBO is again 1024 bytes (8
// K rows) and LBO the stride between 64-wide N atoms, i.e. between boxes.
//
// Accumulator layout of m64nNk16 (thread t of the warpgroup, warp w = t/32,
// lane l): d[4*j + 2*h + e] is row 16*w + l/4 + 8*h, column 8*j + 2*(l%4)
// + e. The register-A fragment of a k16 step kk is that layout's columns
// 16*kk .. 16*kk+15 packed as bf16 pairs, so an f32 accumulator turns into
// the A operand of the next product in place (frag_from_acc).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives and announces `bytes` of TMA traffic the phase must also wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// One box of a 4-d tensor map into shared memory; completion is reported
// to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ------------------------------------------------------------ setmaxnreg
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- named barriers
// Barrier `id` (1..15; 0 is __syncthreads) completes when `n` threads of
// the block have reached it by bar_sync (which waits) or bar_arrive (which
// does not).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------- descriptors
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

// K-major operand: rows of 128 bytes; step kk (16 elements) of a tile
// whose boxes are `box_bytes` apart.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk,
                                                uint32_t box_bytes) {
  const uint32_t a =
      smem_addr(tile) + (kk >> 2) * box_bytes + (kk & 3) * 32;
  return make_desc(a, 16, 1024);
}

// MN-major operand (transpose-B): step kk covers rows 16*kk .. 16*kk+15;
// N atoms of 64 elements are `box_bytes` apart.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk,
                                                 uint32_t box_bytes) {
  return make_desc(smem_addr(tile) + kk * 2048, box_bytes, 1024);
}

// ------------------------------------------------------------ ordering
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of these registers across the
// asynchronous products that read or write them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -------------------------------------------------------------- products
#define SM90_F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_F32 SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24)
#define SM90_F64 SM90_F32, SM90_F8(32), SM90_F8(40), SM90_F8(48), SM90_F8(56)
#define SM90_L16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_L32                                                          \
  SM90_L16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
           "%28, %29, %30, %31"
#define SM90_L64                                                          \
  SM90_L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
           "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
           "%56, %57, %58, %59, %60, %61, %62, %63"

// D (+)= A.B with A and B in shared memory (m64 N k16, bf16 in, f32
// accumulate); scale_d = 0 overwrites D. TA / TB set the transpose bits.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_L32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SM90_F32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_L64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SM90_F64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D += A.B with A from registers (a[4]: one k16 step, bf16 pairs) and B in
// shared memory.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_L32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_L64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SM90_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

#undef SM90_F8
#undef SM90_F32
#undef SM90_F64
#undef SM90_L16
#undef SM90_L32
#undef SM90_L64

// 2^x on the special-function unit (ex2.approx: a relative error of about
// 2^-22, flushing subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register-A fragments of an m64nNk16 accumulator's columns, one k16
// step (16 columns) each: f[kk] holds columns 16*kk .. 16*kk+15.
template <int R>
__device__ __forceinline__ void frag_from_acc(const float (&d)[R],
                                              uint32_t (&f)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    f[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    f[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// ------------------------------------------------------ host: tensor maps
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda. nullptr when the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 [B, S, H, D] tensor read through element strides (sb, ss, sh; D
// contiguous) as a 4-d map over (D, H, S, B), whose box is `rows` rows of
// S by 64 elements of D (128 bytes, 128-byte swizzle). Elements past D or
// S are zero-filled. -> false when the driver refuses it.
inline bool encode_bshd(CUtensorMap* map, const void* base, long long B,
                        long long S, long long H, long long D, long long sb,
                        long long ss, long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  // a dimension of extent 1 takes the stride a packed layout would give
  // it, so the strides grow with the dimension as the driver expects
  if (H == 1) sh = D;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
