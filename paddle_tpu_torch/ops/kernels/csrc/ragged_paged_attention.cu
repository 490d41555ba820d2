// Ragged paged attention over a flat token stream, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/ragged_attention.py:108
// (ragged_paged_attention, whose _ragged_body runs the paged decode body
// paged_attention.py:122 once per flat token). Same function: token t of
// row r sits at absolute position kv_lens[r] - row_lens[r] + offset and
// attends causally (context pos + 1) over its row's pages; query heads are
// grouped G = H / KVH over the KV heads of the pools; pad tokens and
// unused rows (context 0) come out as zeros, never NaN.
//
// Layouts (the JAX package's, kept at the wrapper):
//   q            [T, H, D]                     f32 or bf16
//   k/v_cache    [num_pages, page_size, KVH, D] same type as q
//   row_starts   [R] int32, nondecreasing; unused rows carry T
//   row_lens     [R] int32   query tokens of each row in this launch
//   kv_lens      [R] int32   KV tokens of each row after this launch's writes
//   block_tables [R, max_pages] int32 (ids clamped to [0, num_pages))
//   out          [T, H, D]                     same type as q
//
// Design. The Pallas grid (T, max_pages) walks pages in order on one core;
// here one thread block takes one (flat token, KV head) pair. Thread 0
// finds the token's row by a binary search of row_starts (the
// searchsorted(side="right") of ragged_row_index) and its context; the
// page loop is attend_pages in paged_attend.cuh, shared with the paged
// decode kernel (paged_attention.cu).
//
// Bound: bytes. A decode token does ~2 flops per byte of KV it reads,
// far below the H100's ~295 flop/byte ridge, so the floor is the KV pages
// read over 3.35 TB/s. This first kernel re-reads a row's pages once per
// query token of the row; a later version tiles several query tokens of
// one row per block so a prefill segment reads each page once, and moves
// the page loads to cp.async/TMA so they overlap the math.
#include "paged_attend.cuh"

namespace {

using paged_kv::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ row_starts,
    const int* __restrict__ row_lens, const int* __restrict__ kv_lens,
    const int* __restrict__ block_tables, T* __restrict__ out, int num_rows,
    int H, int KVH, int D, int num_pages, int page_size, int max_pages,
    float scale) {
  extern __shared__ float smem[];
  __shared__ int row_sh, ctx_sh;
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  if (threadIdx.x == 0) {
    // first row whose start is > t, minus one, clipped to [0, R)
    int lo = 0, hi = num_rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row_starts[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const int rid = min(max(lo - 1, 0), num_rows - 1);
    const int off = t - row_starts[rid];
    const int rl = row_lens[rid];
    row_sh = rid;
    ctx_sh = (off >= 0 && off < rl) ? kv_lens[rid] - rl + off + 1 : 0;
  }
  __syncthreads();
  const size_t q_base = ((size_t)t * H + (size_t)kvh * G) * D;
  paged_kv::attend_pages<T>(q + q_base, k_cache, v_cache,
                            block_tables + (size_t)row_sh * max_pages, ctx_sh,
                            kvh, KVH, G, D, num_pages, page_size, max_pages,
                            scale, out + q_base, smem);
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* row_starts, const int* row_lens, const int* kv_lens,
           const int* block_tables, void* out, int T_tokens, int H, int KVH,
           int D, int num_pages, int page_size, int num_rows, int max_pages,
           float scale, cudaStream_t stream) {
  const size_t smem =
      paged_kv::smem_floats(H / KVH, D, page_size) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)T_tokens, (unsigned)KVH);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), row_starts, row_lens, kv_lens,
      block_tables, static_cast<T*>(out), num_rows, H, KVH, D, num_pages,
      page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape the kernel
// does not take.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* row_starts, const void* row_lens, const void* kv_lens,
    const void* block_tables, void* out, int T_tokens, int H, int KVH, int D,
    int num_pages, int page_size, int num_rows, int max_pages, float scale,
    int dtype, void* stream) {
  if ((D != 64 && D != 128) || KVH <= 0 || H % KVH != 0 || num_rows <= 0 ||
      num_pages <= 0 || page_size <= 0 || max_pages <= 0 || T_tokens < 0)
    return (int)cudaErrorInvalidValue;
  if (T_tokens == 0) return 0;
  const int* rs = static_cast<const int*>(row_starts);
  const int* rl = static_cast<const int*>(row_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* bt = static_cast<const int*>(block_tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, rs, rl, kl, bt, out, T_tokens,
                         H, KVH, D, num_pages, page_size, num_rows, max_pages,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, rs, rl, kl, bt, out,
                                 T_tokens, H, KVH, D, num_pages, page_size,
                                 num_rows, max_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
