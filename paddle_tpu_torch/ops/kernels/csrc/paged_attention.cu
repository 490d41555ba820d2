// Paged decode attention (one query token per row), for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:175 (paged_attention,
// body _kernel at :122, call at :211). Same function: each row b has one
// query token q[b] of H heads that attends over the first context_lens[b]
// keys of the row's pages; query heads are grouped G = H / KVH over the KV
// heads of the pools; the softmax is f32 online; a masked key contributes
// exactly 0; a row with context 0 writes exact zeros.
//
// Layouts (the JAX package's, kept at the wrapper):
//   q            [B, H, D]                      f32 or bf16
//   k/v_cache    [num_pages, page_size, KVH, D] same type as q
//   block_tables [B, max_pages] int32 (ids clamped to [0, num_pages))
//   context_lens [B] int32
//   out          [B, H, D]                      same type as q
//
// Design. The Pallas grid (B, max_pages) streams a row's pages in order on
// one core and computes all H heads per page. Here one thread block takes
// one (row, KV head) pair with the G query heads of that KV head, so each
// page of K/V is read from device memory once per group, not once per
// query head; a loop inside the block walks the row's pages with the
// context mask (attend_pages in paged_attend.cuh; the ragged kernel has
// its own tiled page walk since its Hopper redesign). The grid is B x KVH
// blocks: 256 at the serving engine's 16 slots of gpt_1p3b (KVH 16), about
// two per SM.
//
// Bound: bytes. A decode token does ~2 flops per byte of KV it reads, far
// below the H100's ~295 flop/byte ridge, so the floor is the KV pages the
// contexts need, read once, over 3.35 TB/s. This first kernel stages each
// page through shared memory in f32 with the loads and the math in turn;
// a later version keeps pages in flight with cp.async/TMA and splits long
// contexts over several blocks per row.
#include "paged_attend.cuh"

namespace {

using paged_kv::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int H, int KVH,
    int D, int num_pages, int page_size, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const size_t base = ((size_t)b * H + (size_t)kvh * G) * D;
  paged_kv::attend_pages<T>(q + base, k_cache, v_cache,
                            block_tables + (size_t)b * max_pages,
                            context_lens[b], kvh, KVH, G, D, num_pages,
                            page_size, max_pages, scale, out + base, smem);
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* block_tables, const int* context_lens, void* out, int B,
           int H, int KVH, int D, int num_pages, int page_size, int max_pages,
           float scale, cudaStream_t stream) {
  const size_t smem =
      paged_kv::smem_floats(H / KVH, D, page_size) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)B, (unsigned)KVH);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), block_tables, context_lens,
      static_cast<T*>(out), H, KVH, D, num_pages, page_size, max_pages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape the kernel
// does not take.
extern "C" int paged_attention(const void* q, const void* k_cache,
                               const void* v_cache, const void* block_tables,
                               const void* context_lens, void* out, int B,
                               int H, int KVH, int D, int num_pages,
                               int page_size, int max_pages, float scale,
                               int dtype, void* stream) {
  if ((D != 64 && D != 128) || KVH <= 0 || H % KVH != 0 || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, bt, cl, out, B, H, KVH, D,
                         num_pages, page_size, max_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, bt, cl, out, B, H, KVH,
                                 D, num_pages, page_size, max_pages, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
