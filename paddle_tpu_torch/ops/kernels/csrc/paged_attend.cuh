// One query token's grouped attention over a row's KV pages: the page loop
// of paged_attention.cu (one decode token per row), and of that kernel
// alone: ragged_paged_attention.cu tiles several tokens of a row per block
// and streams pages through its own cp.async ring.
//
// The Pallas kernel it stands for (paged_attention.py:122 _kernel) walks a
// row's pages as the sequential axis of its grid and carries m, l and the
// accumulator in VMEM scratch. Here one thread block takes
// one (row, KV head) pair and this loop takes the place of that axis:
// per page the block stages the K and V rows of its KV head in shared
// memory (f32), one warp per (query head, key) pair computes a score, one
// thread per query head runs the online-softmax update in f32 with an
// explicit context mask (a masked key contributes exactly 0 -- see
// paged_attention.py:154-158), and every thread rescales and accumulates
// its own slice of the [G, D] output in shared memory. Only the pages the
// context needs are visited, so a context of 0 writes exact zeros
// (acc / max(l, 1e-30) = 0 / 1e-30). Block-table ids are clamped to
// [0, num_pages), as paged_attention.py:187-191 clamps them, so a sentinel
// -1 cannot fault.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged_kv {

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

// Floats of dynamic shared memory attend_pages needs.
inline size_t smem_floats(int G, int D, int page_size) {
  return (size_t)(2 * G * D + 2 * page_size * D + G * page_size + 3 * G);
}

// q and out point at the G query heads of KV head kvh ([G, D], contiguous);
// bt_row at the row's max_pages block-table ids; ctx is the row's context
// length (keys 0..ctx-1 are visible). Every thread of the block calls it.
template <typename T>
__device__ void attend_pages(const T* __restrict__ q,
                             const T* __restrict__ k_cache,
                             const T* __restrict__ v_cache,
                             const int* __restrict__ bt_row, int ctx, int kvh,
                             int KVH, int G, int D, int num_pages,
                             int page_size, int max_pages, float scale,
                             T* __restrict__ out, float* smem) {
  float* q_s = smem;                     // [G, D] scaled query
  float* acc_s = q_s + G * D;            // [G, D] unnormalized output
  float* k_s = acc_s + G * D;            // [page_size, D]
  float* v_s = k_s + page_size * D;      // [page_size, D]
  float* p_s = v_s + page_size * D;      // [G, page_size] scores, then probs
  float* m_s = p_s + G * page_size;      // [G] running max
  float* l_s = m_s + G;                  // [G] running sum
  float* corr_s = l_s + G;               // [G] this page's rescale

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(q[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int n_pages = min((ctx + page_size - 1) / page_size, max_pages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int pg = 0; pg < n_pages; ++pg) {
    int page = bt_row[pg];
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
    store_val(&out[i], acc_s[i] / l);
  }
}

}  // namespace paged_kv
