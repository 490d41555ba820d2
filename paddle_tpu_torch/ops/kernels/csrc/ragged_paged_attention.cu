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
// here one thread block takes one (flat token, KV head) pair and a loop
// inside the block takes the place of the sequential page axis. Thread 0
// finds the token's row by a binary search of row_starts (the
// searchsorted(side="right") of ragged_row_index). Per page, the block
// stages the K and V rows of its KV head in shared memory (f32), one warp
// per (query head, key) pair computes a score, one thread per query head
// runs the online-softmax update in f32 with an explicit context mask (a
// masked key contributes exactly 0 -- see paged_attention.py:154-158),
// and every thread rescales and accumulates its own slice of the
// [G, D] output in shared memory. Only the pages the context needs are
// visited.
//
// Bound: bytes. A decode token does ~2 flops per byte of KV it reads,
// far below the H100's ~295 flop/byte ridge, so the floor is the KV pages
// read over 3.35 TB/s. This first kernel re-reads a row's pages once per
// query token of the row; a later version tiles several query tokens of
// one row per block so a prefill segment reads each page once, and moves
// the page loads to cp.async/TMA so they overlap the math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
  float* q_s = smem;                     // [G, D] scaled query
  float* acc_s = q_s + G * D;            // [G, D] unnormalized output
  float* k_s = acc_s + G * D;            // [page_size, D]
  float* v_s = k_s + page_size * D;      // [page_size, D]
  float* p_s = v_s + page_size * D;      // [G, page_size] scores, then probs
  float* m_s = p_s + G * page_size;      // [G] running max
  float* l_s = m_s + G;                  // [G] running sum
  float* corr_s = l_s + G;               // [G] this page's rescale

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
  const size_t q_base = ((size_t)t * H + (size_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(q[q_base + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int rid = row_sh;
  const int ctx = ctx_sh;
  const int n_pages = min((ctx + page_size - 1) / page_size, max_pages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int pg = 0; pg < n_pages; ++pg) {
    int page = block_tables[(size_t)rid * max_pages + pg];
    page = min(max(page, 0), num_pages - 1);
    for (int i = threadIdx.x; i < page_size * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const size_t src =
          ((size_t)((size_t)page * page_size + j) * KVH + kvh) * D + d;
      k_s[i] = to_f32(k_cache[src]);
      v_s[i] = to_f32(v_cache[src]);
    }
    __syncthreads();
    const int key0 = pg * page_size;
    for (int pr = warp; pr < G * page_size; pr += n_warps) {
      const int g = pr / page_size;
      const int j = pr - g * page_size;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += q_s[g * D + d] * k_s[j * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) p_s[pr] = (key0 + j < ctx) ? s : kNegInf;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float* pg_row = p_s + g * page_size;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int j = 0; j < page_size; ++j) m_new = fmaxf(m_new, pg_row[j]);
      float sum = 0.f;
      for (int j = 0; j < page_size; ++j) {
        // explicit mask: a masked key adds exactly nothing
        const float p = (key0 + j < ctx) ? expf(pg_row[j] - m_new) : 0.f;
        pg_row[j] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[g] = corr * l_s[g] + sum;
      m_s[g] = m_new;
      corr_s[g] = corr;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg_row = p_s + g * page_size;
      float a = corr_s[g] * acc_s[i];
      for (int j = 0; j < page_size; ++j) a += pg_row[j] * v_s[j * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const float l = fmaxf(l_s[i / D], 1e-30f);
    store_val(&out[q_base + i], acc_s[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* row_starts, const int* row_lens, const int* kv_lens,
           const int* block_tables, void* out, int T_tokens, int H, int KVH,
           int D, int num_pages, int page_size, int num_rows, int max_pages,
           float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      (size_t)(2 * G * D + 2 * page_size * D + G * page_size + 3 * G) *
      sizeof(float);
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
