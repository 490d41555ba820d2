// Paged decode attention (one query token per row), for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:175 (paged_attention,
// body _kernel at :122, call at :211). Same function: each row b has one
// query token q[b] of H heads that attends over the first context_lens[b]
// keys of the row's pages; query heads are grouped G = H / KVH over the KV
// heads of the pools; the softmax is f32 online; a masked key contributes
// exactly 0; a row with context 0 writes exact zeros; block-table ids are
// clamped to [0, num_pages), so a sentinel -1 cannot fault.
//
// Layouts (the JAX package's, kept at the wrapper):
//   q            [B, H, D]                      f32 or bf16
//   k/v_cache    [num_pages, page_size, KVH, D] same type as q
//   block_tables [B, max_pages] int32
//   context_lens [B] int32
//   out          [B, H, D]                      same type as q
//
// Bound: bytes. A decode token does ~2 flops per byte of KV it reads (at
// most ~16 with 8 query heads a KV head), far below the H100's ~295
// flop/byte ridge, so the floor is the KV pages the contexts need, read
// once, over 3.35 TB/s. At the serving engine's decode step (16 rows of
// gpt_1p3b, KVH 16, contexts of a few hundred keys) that is a few MB in a
// few microseconds: the whole game is bytes in flight on every SM. What
// this design does about it:
//   * Split-K over the row's own keys, flash-decoding style. A block takes
//     one (row, KV head, head group, split): grid B x (KVH * head groups) x
//     n_split, n_split from the wrapper's launch_plan (host integers only:
//     B, KVH, max_pages, page size, SM count; context_lens is never read on
//     the host). Each block reads its row's context itself, cuts the row's
//     ceil(context / 16) key tiles into min(n_split, tiles) contiguous
//     ranges of floor or ceil(tiles / splits) tiles, and takes its own; so
//     no split of a row with at least n_split tiles is idle, and only the
//     splits a short row cannot use exit at once.
//   * A cp.async ring of 16-key tiles (one page at the engine's page size)
//     in the input type (bf16 stays bf16), 4 stages: three tiles of K and
//     V are in flight while one computes. Every thread copies 16-byte
//     chunks, and a thread computes on exactly the chunks it copied itself
//     (thread t owns chunk t % C of keys t / C + 128 / C * r of a tile, C
//     the chunks of a key row), so the loop waits on its own copies and
//     has no barrier at all. A warp's copy covers whole contiguous key rows
//     (two rows of 256 bytes for bf16 at D 128). The block loads the page
//     ids of its key range into shared memory once, before the ring.
//   * Math on the CUDA cores in f32. Up to 8 query heads per KV head a
//     bf16 KV byte needs at most ~16 flops, which the f32 CUDA cores keep
//     up with at the memory rate, so tensor cores would buy nothing (with
//     G = 1 an mma tile would be 1/16 used) and P is never rounded to bf16.
//     q (pre-scaled by scale * log2 e) sits in registers; a key's score is
//     a dot over its C lanes (a half-warp for bf16 at D 128) and a
//     shuffle reduction. Each group of C lanes (a key group) runs its own
//     online softmax over its keys in registers and owns a [G, 16-byte
//     chunk] slice of the accumulator; the block's key groups, then the
//     row's splits, are merged in the log2 domain at the end.
//   * Heads a block: the G query heads of a KV head in groups of up to 8
//     (1, 2, 4 or 8 a block by template); G > 8 takes several head groups,
//     each of which reads the KV head's pages (on no serving path).
//   * The splits merge in the same launch: each writes its (acc, m, l) in
//     f32 to scratch and takes an atomic ticket; the last split of a (row,
//     KV head, head group) merges them and resets the ticket to zero for
//     the next call. One split writes the output directly. Scratch is
//     B * H * n_split * (D + 2) f32 of partials and B * KVH * head groups
//     int32 tickets, owned by the wrapper per device and grown only when a
//     bigger plan comes; at a fixed decode shape (B, H, KVH, max_pages,
//     page size) the plan, and so the scratch and its pointers, never
//     change after the first call, so a captured CUDA graph stays valid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int KT = 16;        // keys a ring stage
constexpr int kStages = 4;    // ring stages
constexpr int kMaxHeads = 8;  // query heads a block
constexpr int kMaxSplit = 1024;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  void* out;
  const int* block_tables;
  const int* context_lens;
  float* part;   // [B, H, n_split, D + 2]: acc (unnormalised), m, l (log2)
  int* tickets;  // [B, KVH * n_hg] splits finished; the merger resets
  int H, KVH, G, n_hg, num_pages, page_size, max_pages, n_split;
  int split_pages;   // page ids a split's key range can span
  float scale_log2;  // scale * log2(e)
};

// ---------------------------------------------------------------- memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy into shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T (from shared or global memory) as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(float (&f)[4], const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(float (&f)[8], const bf16* p) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Geometry of one instantiation: C 16-byte chunks a key row, NKG key
// groups of C threads, KPT keys of a tile per key group.
template <typename T, int D>
struct Geo {
  static constexpr int V = Vec<T>::N;        // elements a chunk
  static constexpr int C = D / V;            // chunks a key row
  static constexpr int NKG = kThreads / C;   // key groups
  static constexpr int KPT = KT / NKG;       // keys a thread a tile
  static_assert(C <= 32 && 32 % C == 0 && KPT >= 1 && KT % NKG == 0,
                "key rows must map onto whole lane groups of a warp");
  static constexpr size_t ring_bytes = (size_t)kStages * 2 * KT * D * sizeof(T);
  template <int GB>
  __host__ __device__ static constexpr size_t merge_bytes() {
    return (size_t)NKG * GB * (D + 2) * sizeof(float);
  }
  template <int GB>
  __host__ __device__ static constexpr size_t pages_offset() {
    return ((ring_bytes > merge_bytes<GB>() ? ring_bytes : merge_bytes<GB>()) +
            15) / 16 * 16;
  }
};

// ----------------------------------------------------------------- kernel
template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  using GM = Geo<T, D>;
  constexpr int V = GM::V, C = GM::C, NKG = GM::NKG, KPT = GM::KPT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // stages of [KT, D] K, then V
  int* pages_s = reinterpret_cast<int*>(smem + GM::template pages_offset<GB>());
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int c = tid % C, kg = tid / C;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y / a.n_hg, hg = blockIdx.y % a.n_hg;
  const int split = blockIdx.z;
  const int h0 = kvh * a.G + hg * GB;
  const int gcount = min(GB, a.G - hg * GB);

  // the row's key tiles, cut into ns contiguous ranges; this block's range
  const int max_keys = a.max_pages * a.page_size;
  const int ctx = min(max(a.context_lens[b], 0), max_keys);
  const int n_tiles = (ctx + KT - 1) / KT;
  const int ns = max(1, min(a.n_split, n_tiles));
  if (split >= ns) return;
  const int t_lo = (int)((long long)split * n_tiles / ns);
  const int t_hi = (int)((long long)(split + 1) * n_tiles / ns);
  const int n_t = t_hi - t_lo;
  const int k_lo = t_lo * KT;
  const int k_hi = min(t_hi * KT, ctx);
  const int p_first = k_lo / a.page_size;
  if (n_t > 0) {
    const int n_pg = (k_hi - 1) / a.page_size - p_first + 1;
    const int* bt_row = a.block_tables + (size_t)b * a.max_pages + p_first;
    for (int i = tid; i < n_pg; i += kThreads)
      pages_s[i] = min(max(bt_row[i], 0), a.num_pages - 1);
  }

  // q of this thread's chunk for the block's heads, scaled, in registers
  float qf[GB][V];
  {
    const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + h0) * D +
                 c * V;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gcount) {
        Vec<T>::load(qf[g], q + (size_t)g * D);
#pragma unroll
        for (int e = 0; e < V; ++e) qf[g][e] *= a.scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) qf[g][e] = 0.f;
      }
    }
  }
  __syncthreads();  // the page ids are in

  const T* kc = static_cast<const T*>(a.k_cache);
  const T* vc = static_cast<const T*>(a.v_cache);
  const size_t key_stride = (size_t)a.KVH * D;  // elements between keys
  // tile it of the split into stage st: this thread's chunks only; keys
  // past the split's end are zero-filled
  auto load_tile = [&](int it, int st) {
    T* ks = ring + (size_t)st * 2 * KT * D;
    T* vs = ks + KT * D;
    const int k0 = k_lo + it * KT;
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int j = kg + r * NKG, key = k0 + j;
      size_t off = 0;
      int bytes = 0;
      if (key < k_hi) {
        const int pi = key / a.page_size;
        const int page = pages_s[pi - p_first];
        off = ((size_t)page * a.page_size + (key - pi * a.page_size)) *
                  key_stride + (size_t)kvh * D + c * V;
        bytes = 16;
      }
      cp_async16(ks + (j * C + c) * V, kc + off, bytes);
      cp_async16(vs + (j * C + c) * V, vc + off, bytes);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_t) load_tile(st, st);
    cp_async_commit();
  }

  // this key group's online softmax (identical in its C lanes)
  float m[GB], l[GB], acc[GB][V];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < n_t; ++it) {
    if (it + kStages - 1 < n_t)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile it landed
    const T* ks = ring + (size_t)(it % kStages) * 2 * KT * D;
    const T* vs = ks + KT * D;
    const int k0 = k_lo + it * KT;
    float s[KPT][GB];
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      float kf[V];
      Vec<T>::load(kf, ks + ((kg + r * NKG) * C + c) * V);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) x = fmaf(qf[g][e], kf[e], x);
        s[r][g] = x;
      }
    }
    // the C lanes of a key row sum their parts
#pragma unroll
    for (int o = C / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < KPT; ++r)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], o);
    bool ok[KPT];
#pragma unroll
    for (int r = 0; r < KPT; ++r) ok[r] = k0 + kg + r * NKG < k_hi;
    float p[KPT][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < KPT; ++r)
        if (ok[r]) mx = fmaxf(mx, s[r][g]);
      const float corr = exp2f(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        // explicit mask: a key past the context adds exactly nothing
        p[r][g] = ok[r] ? exp2f(s[r][g] - mx) : 0.f;
        sum += p[r][g];
      }
      l[g] = fmaf(l[g], corr, sum);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      float vf[V];
      Vec<T>::load(vf, vs + ((kg + r * NKG) * C + c) * V);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p[r][g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the key groups' merge reuses it

  // merge the block's key groups: [NKG, GB, D] acc, then [NKG, GB, 2] m, l
  float* macc = reinterpret_cast<float*>(smem);
  float* mml = macc + NKG * GB * D;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      macc[(kg * GB + g) * D + c * V + e] = acc[g][e];
    if (c == 0) {
      mml[(kg * GB + g) * 2] = m[g];
      mml[(kg * GB + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + h0) * D;
  const size_t pstride = (size_t)a.n_split * (D + 2);  // a head's partials
  for (int i = tid; i < gcount * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < NKG; ++k) mm = fmaxf(mm, mml[(k * GB + g) * 2]);
    float ll = 0.f, x = 0.f;
#pragma unroll
    for (int k = 0; k < NKG; ++k) {
      const float w = exp2f(mml[(k * GB + g) * 2] - mm);
      ll = fmaf(mml[(k * GB + g) * 2 + 1], w, ll);
      x = fmaf(macc[(k * GB + g) * D + d], w, x);
    }
    if (ns == 1) {
      store_val(out + (size_t)g * D + d, x / fmaxf(ll, 1e-30f));
    } else {
      float* dst = a.part + ((size_t)b * a.H + h0 + g) * pstride +
                   (size_t)split * (D + 2);
      dst[d] = x;
      if (d == 0) {
        dst[D] = mm;
        dst[D + 1] = ll;
      }
    }
  }
  if (ns == 1) return;

  // split-K: the last split of (row, KV head, head group) merges
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)b * a.KVH * a.n_hg + blockIdx.y;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == ns - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* p0 = a.part + ((size_t)b * a.H + h0) * pstride;
  for (int i = tid; i < gcount * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* ph = p0 + (size_t)g * pstride;
    float mm = kNegInf;
    for (int sp = 0; sp < ns; ++sp)
      mm = fmaxf(mm, __ldcg(ph + (size_t)sp * (D + 2) + D));
    float ll = 0.f, x = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float* pp = ph + (size_t)sp * (D + 2);
      const float w = exp2f(__ldcg(pp + D) - mm);
      ll = fmaf(__ldcg(pp + D + 1), w, ll);
      x = fmaf(__ldcg(pp + d), w, x);
    }
    store_val(out + (size_t)g * D + d, x / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

// query heads a block: the smallest of 1, 2, 4, 8 that holds G, at most 8
int heads_per_block(int G) {
  int gb = 1;
  while (gb < G && gb < kMaxHeads) gb *= 2;
  return gb;
}

// page ids a split's key range can span: its tiles (at most
// ceil(ceil(max_keys / KT) / n_split), one when a short row uses fewer
// splits) cover that many keys from any start
int split_pages(int max_pages, int page_size, int n_split) {
  const long long max_tiles = ((long long)max_pages * page_size + KT - 1) / KT;
  const long long tiles = (max_tiles + n_split - 1) / n_split;
  const long long pages = (tiles * KT + page_size - 1) / page_size + 1;
  return (int)(pages < max_pages ? pages : max_pages);
}

template <typename T, int D, int GB>
size_t smem_bytes(int pages) {
  return Geo<T, D>::template pages_offset<GB>() + (size_t)pages * sizeof(int);
}

template <typename T, int D>
size_t smem_for(int GB, int pages) {
  switch (GB) {
    case 1: return smem_bytes<T, D, 1>(pages);
    case 2: return smem_bytes<T, D, 2>(pages);
    case 4: return smem_bytes<T, D, 4>(pages);
    default: return smem_bytes<T, D, 8>(pages);
  }
}

size_t smem_for(int dtype, int D, int GB, int pages) {
  if (dtype == 0) return D == 64 ? smem_for<float, 64>(GB, pages)
                                 : smem_for<float, 128>(GB, pages);
  return D == 64 ? smem_for<bf16, 64>(GB, pages) : smem_for<bf16, 128>(GB, pages);
}

template <typename T, int D, int GB>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, D, GB>;
  const size_t smem = smem_bytes<T, D, GB>(a.split_pages);
  if (smem > 48 * 1024) {  // past the default only (f32 at D 128)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)B, (unsigned)(a.KVH * a.n_hg),
                  (unsigned)a.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_gb(const Args& a, int B, int GB, cudaStream_t s) {
  switch (GB) {
    case 1: return launch<T, D, 1>(a, B, s);
    case 2: return launch<T, D, 2>(a, B, s);
    case 4: return launch<T, D, 4>(a, B, s);
    default: return launch<T, D, 8>(a, B, s);
  }
}

bool valid_shape(int B, int H, int KVH, int D, int num_pages, int page_size,
                 int max_pages, int n_split, int dtype) {
  return (D == 64 || D == 128) && (dtype == 0 || dtype == 1) && KVH > 0 &&
         H > 0 && H % KVH == 0 && num_pages > 0 && page_size > 0 &&
         max_pages > 0 && B >= 0 && n_split >= 1 && n_split <= kMaxSplit &&
         (long long)max_pages * page_size < (1LL << 30);
}

}  // namespace

// Dynamic shared memory a block of this shape and plan launches with, or
// -1 for a shape the kernel does not take.
extern "C" long long paged_attention_smem_bytes(int H, int KVH, int D,
                                                int max_pages, int page_size,
                                                int n_split, int dtype) {
  if (!valid_shape(1, H, KVH, D, 1, page_size, max_pages, n_split, dtype))
    return -1;
  return (long long)smem_for(dtype, D, heads_per_block(H / KVH),
                             split_pages(max_pages, page_size, n_split));
}

// dtype: 0 = float32, 1 = bfloat16. n_split is the wrapper's plan
// (paged_attention.launch_plan). With n_split > 1, part (B * H * n_split *
// (D + 2) f32) and tickets (B * KVH * ceil(G / 8) int32, zero before the
// first call; each call leaves them zero) are the wrapper's scratch.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int paged_attention(const void* q, const void* k_cache,
                               const void* v_cache, const void* block_tables,
                               const void* context_lens, void* out,
                               void* part, void* tickets, int B, int H,
                               int KVH, int D, int num_pages, int page_size,
                               int max_pages, int n_split, float scale,
                               int dtype, void* stream) {
  if (!valid_shape(B, H, KVH, D, num_pages, page_size, max_pages, n_split,
                   dtype) ||
      (n_split > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = H / KVH;
  const int GB = heads_per_block(G);
  Args a;
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.out = out;
  a.block_tables = static_cast<const int*>(block_tables);
  a.context_lens = static_cast<const int*>(context_lens);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.H = H;
  a.KVH = KVH;
  a.G = G;
  a.n_hg = (G + GB - 1) / GB;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.n_split = n_split;
  a.split_pages = split_pages(max_pages, page_size, n_split);
  a.scale_log2 = scale * kLog2e;
  if ((long long)KVH * a.n_hg > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch_gb<float, 64>(a, B, GB, s)
                   : launch_gb<float, 128>(a, B, GB, s);
  return D == 64 ? launch_gb<bf16, 64>(a, B, GB, s)
                 : launch_gb<bf16, 128>(a, B, GB, s);
}
