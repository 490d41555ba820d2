// Ragged paged attention over a flat token stream, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/ragged_attention.py:108
// (ragged_paged_attention, whose _ragged_body runs the paged decode body
// paged_attention.py:122 once per flat token). Same function: token t of
// row r sits at absolute position kv_lens[r] - row_lens[r] + offset and
// attends causally (context pos + 1, at most max_pages * page_size keys)
// over its row's pages; query heads are grouped G = H / KVH over the KV
// heads of the pools; block-table ids are clamped to [0, num_pages); pad
// tokens, unused rows (row_starts = T) and context-0 rows come out as
// exact zeros, never NaN. A token belongs to the last row whose start is
// <= t (the searchsorted of ragged_row_index), and counts when its offset
// there is below the row's length.
//
// Layouts (the JAX package's, kept at the wrapper):
//   q            [T, H, D]                     f32 or bf16
//   k/v_cache    [num_pages, page_size, KVH, D] same type as q
//   row_starts   [R] int32, nondecreasing, >= 0; unused rows carry T
//   row_lens     [R] int32   query tokens of each row in this launch
//   kv_lens      [R] int32   KV tokens of each row after this launch's writes
//   block_tables [R, max_pages] int32
//   out          [T, H, D]                     same type as q
//
// Bound: bytes. Attention over a paged cache does ~2 flops per byte of KV
// for a decode token and at most 2 * tokens-per-tile for a prefill tile,
// below the H100's ~295 flop/byte ridge, so the floor is the KV pages read
// (and q and out) over 3.35 TB/s. What this design does about it:
//   * A block takes a tile of up to 64 / G consecutive tokens of ONE row
//     (never straddling rows; a decode row is a tile of one) times the G
//     query heads of one KV head: 64 (token, head) query rows, 4 warps of
//     16. So a prefill segment reads each page once per tile, not once
//     per token.
//   * The row's keys stream in 64-key tiles through a cp.async ring
//     (16-byte vectors, kept in the input type in shared memory, XOR-
//     swizzled 16-byte chunks; 3 stages for bf16, 2 for f32), with the
//     next tiles in flight while the current one computes.
//   * bf16: S = Q.K^T and O += P.V on the tensor cores (mma.sync
//     m16n8k16, ldmatrix). P, the S accumulator in registers, enters P.V
//     as three bf16 terms (hi, mid, lo), so the output keeps the f32
//     accuracy of the plain version; a warp whose rows all lie past the
//     tile's tokens skips the products. f32: the same tiling and fragment
//     layout on the CUDA cores in full f32. The online softmax runs in
//     registers in f32 with an explicit mask (causal within the tile,
//     past the context): a masked key adds exactly 0.
//   * Split-K, flash-decoding style, to fill 132 SMs on decode rounds: a
//     tile's keys are cut into splits of a fixed number of keys (grid z);
//     each split writes its (max, sum, acc) in f32 to scratch and takes a
//     ticket; the last split of a (tile, KV head) merges them in the same
//     launch and resets the ticket for the next call. One split writes the
//     output directly.
//   * The grid is sized from host integers only (T, R, KVH, max_pages):
//     x = ceil(T / tile) + R tile slots, which bound the (row, tile) pairs
//     of any layout, plus ceil(T / 64) blocks that zero the tokens no row
//     owns. The first warp maps its slot to (row, tile) by a prefix sum
//     over row_lens; slots and splits past the data exit at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps of 16 query rows
constexpr int kRows = 64;      // (token, head) query rows a block
constexpr int BK = 64;         // keys a tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Ring {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
};

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  void* out;
  const int* row_starts;
  const int* row_lens;
  const int* kv_lens;
  const int* block_tables;
  float* part_acc;  // [T, H, n_split, D] partial outputs (unnormalised)
  float* part_ml;   // [T, H, n_split, 2] partial (max, sum), log2 domain
  int* tickets;     // [n_slots, KVH] splits finished; the merger resets
  int T, H, KVH, G, R, num_pages, page_size, max_pages;
  int bq;       // tokens a tile: kRows / G
  int n_slots;  // tile slots; blocks past them zero unowned tokens
  int n_split, split_keys;
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

// A [rows, D] tile in shared memory: 16-byte chunk c of row r sits at
// chunk r * C + (c ^ (r & 7)), so the 8 rows an ldmatrix reads at one
// column fall in 8 different bank groups.
template <typename T, int D>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // elements a chunk
  static constexpr int C = D / V;           // chunks a row (>= 8)
  __device__ static int chunk(int r, int c) { return r * C + (c ^ (r & 7)); }
  __device__ static int at(int r, int d) { return chunk(r, d / V) * V + d % V; }
};

// ---------------------------------------------------------- tensor cores
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a.b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) as the sum of three bf16 pairs h + m + l, each the rounding of
// what the previous ones leave (the remainders are exact in f32), so a
// product with exact bf16 operands carries f32 accuracy (~2^-24)
__device__ __forceinline__ void split3(float x, float y, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hv);
  x -= hf.x;
  y -= hf.y;
  const __nv_bfloat162 mv = __floats2bfloat162_rn(x, y);
  const float2 mf = __bfloat1622float2(mv);
  h = *reinterpret_cast<const uint32_t*>(&hv);
  m = *reinterpret_cast<const uint32_t*>(&mv);
  l = pack_bf16(x - mf.x, y - mf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ---------------------------------------------------------------- zeroing
// Zeroes tokens [t0, t0 + 64) that no row owns (pad tokens): the owner of
// t is the last row whose start is <= t, and t counts when its offset
// there is below that row's length.
template <typename T, int D>
__device__ void zero_unowned(const Args& a, int t0) {
  __shared__ int owned[64];
  if (threadIdx.x < 64) {
    const int t = t0 + threadIdx.x;
    int lo = 0, hi = a.R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.row_starts[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const int rid = min(max(lo - 1, 0), a.R - 1);
    const int off = t - a.row_starts[rid];
    owned[threadIdx.x] = t >= a.T || (off >= 0 && off < a.row_lens[rid]);
  }
  __syncthreads();
  const int per = a.H * D * (int)sizeof(T) / 16;  // 16-byte chunks a token
  uint4* out = static_cast<uint4*>(a.out) + (size_t)t0 * per;
  for (int i = threadIdx.x; i < 64 * per; i += kThreads)
    if (!owned[i / per]) out[i] = make_uint4(0u, 0u, 0u, 0u);
}

// --------------------------------------------------------------- products
// S (16 rows x 64 keys, m16n8 accumulator layout) = Q.K^T of the warp's
// rows. bf16: ldmatrix + mma.sync from the Q fragments qa.
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[D / 16][4],
                                       const bf16* q_s, const bf16* ks,
                                       int warp, int lane) {
  using TL = Tile<bf16, D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ks + TL::chunk(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 2 + ((lane >> 3) & 1)) * 8);
      mma16816(s[2 * np], qa[kk], b[0], b[1]);
      mma16816(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
}
// f32: the same elements, dot products over D on the CUDA cores, a
// 16-byte chunk of D at a time
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&)[D / 16][4],
                                       const float* q_s, const float* ks,
                                       int warp, int lane) {
  using TL = Tile<float, D>;
  const int r0 = warp * 16 + (lane >> 2), j0 = 2 * (lane & 3);
#pragma unroll 1
  for (int c = 0; c < TL::C; ++c) {
    const float4 x0 =
        *reinterpret_cast<const float4*>(q_s + TL::chunk(r0, c) * 4);
    const float4 x1 =
        *reinterpret_cast<const float4*>(q_s + TL::chunk(r0 + 8, c) * 4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = *reinterpret_cast<const float4*>(
            ks + TL::chunk(nt * 8 + j0 + e, c) * 4);
        s[nt][e] = dot4(x0, y, s[nt][e]);
        s[nt][2 + e] = dot4(x1, y, s[nt][2 + e]);
      }
  }
}

// O (16 rows x D) += P.V, P the probabilities in the S layout. bf16: P is
// split into three bf16 terms in registers (split3), each the A operand of
// one tensor-core product with the same V fragments (V read transposed by
// ldmatrix), so P.V keeps the f32 accuracy of the plain version; rounding
// P to bf16 once would move the outputs by ~2^-9 relative.
template <int D>
__device__ __forceinline__ void accumulate(float (&o)[D / 8][4],
                                           const float (&p)[8][4],
                                           const bf16* vs, float*, int,
                                           int lane) {
  using TL = Tile<bf16, D>;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ph[4], pm[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* pi = &p[2 * j + i / 2][2 * (i & 1)];
      split3(pi[0], pi[1], ph[i], pm[i], pl[i]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + TL::chunk(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  dp * 2 + (lane >> 4)) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma16816(o[2 * dp + h], pl, b[2 * h], b[2 * h + 1]);
        mma16816(o[2 * dp + h], pm, b[2 * h], b[2 * h + 1]);
        mma16816(o[2 * dp + h], ph, b[2 * h], b[2 * h + 1]);
      }
    }
  }
}
// f32: P goes through the warp's rows of p_s ([64, BK + 4] f32), then each
// thread sums its O elements over the tile's keys
template <int D>
__device__ __forceinline__ void accumulate(float (&o)[D / 8][4],
                                           const float (&p)[8][4],
                                           const float* vs, float* p_s,
                                           int warp, int lane) {
  using TL = Tile<float, D>;
  constexpr int LD = BK + 4;
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p_s[(r0 + 8 * (e >> 1)) * LD + nt * 8 + 2 * (lane & 3) + (e & 1)] =
          p[nt][e];
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * (lane & 3);
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(vs + TL::at(j, d));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float pj = p_s[(r0 + 8 * hh) * LD + j];
        o[dt][2 * hh] = fmaf(pj, v.x, o[dt][2 * hh]);
        o[dt][2 * hh + 1] = fmaf(pj, v.y, o[dt][2 * hh + 1]);
      }
    }
  }
  __syncwarp();
}

// ----------------------------------------------------------------- kernel
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    Args a) {
  using TL = Tile<T, D>;
  constexpr int kStages = Ring<T>::kStages;
  constexpr int kTileElems = BK * D;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                    // [kRows, D]
  T* ring = q_s + kRows * D;                              // stages of K, V
  float* p_s = reinterpret_cast<float*>(ring + kStages * 2 * kTileElems);
  __shared__ int info[8];

  if ((int)blockIdx.x >= a.n_slots) {
    if (blockIdx.y == 0 && blockIdx.z == 0)
      zero_unowned<T, D>(a, (blockIdx.x - a.n_slots) * 64);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y, split = blockIdx.z;
  if (warp == 0) {
    // slot -> (row, tile): the rows' tiles back to back, in row order, by
    // a prefix sum over 32 rows at a time (one round of loads). A row's
    // length is cut where the next row starts and at T, so the slots of
    // any layout fit in ceil(T / bq) + R.
    int row = -1, tile = 0, len = 0, base = 0;
    for (int c0 = 0; c0 < a.R && row < 0; c0 += 32) {
      const int r = c0 + lane;
      int n = 0;
      if (r < a.R) {
        const int next = r + 1 < a.R ? a.row_starts[r + 1] : INT_MAX;
        n = max(0, min(a.row_lens[r], min(next, a.T) - a.row_starts[r]));
      }
      const int nt = (n + a.bq - 1) / a.bq;
      int inc = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const int first = base + inc - nt;  // the row's first slot
      const unsigned hit = __ballot_sync(
          0xffffffffu,
          (int)blockIdx.x >= first && (int)blockIdx.x < first + nt);
      if (hit) {
        const int src = __ffs(hit) - 1;
        row = c0 + src;
        tile = blockIdx.x - __shfl_sync(0xffffffffu, first, src);
        len = __shfl_sync(0xffffffffu, n, src);
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) {
      info[0] = row;
      if (row >= 0) {
        const int tok0 = tile * a.bq;
        const int ntok = min(a.bq, len - tok0);
        const int pos0 = a.kv_lens[row] - a.row_lens[row] + tok0;
        // keys the tile needs: its last token's context, at most the
        // table's
        const int kmax = min(pos0 + ntok, a.max_pages * a.page_size);
        info[1] = a.row_starts[row] + tok0;
        info[2] = ntok;
        info[3] = pos0;
        info[4] = kmax;
        info[5] = max(1, (kmax + a.split_keys - 1) / a.split_keys);
      }
    }
  }
  __syncthreads();
  const int row = info[0];
  if (row < 0 || split >= info[5]) return;
  const int t0 = info[1], ntok = info[2], pos0 = info[3], kmax = info[4];
  const int nsplit = info[5];
  const int nrows = ntok * a.G;
  const int k_lo = split * a.split_keys;
  const int k_hi = min(k_lo + a.split_keys, kmax);
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int* bt_row = a.block_tables + (size_t)row * a.max_pages;
  const T* kc = static_cast<const T*>(a.k_cache);
  const T* vc = static_cast<const T*>(a.v_cache);

  // the block's query rows: (token, head) = (r / G, kvh * G + r % G)
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < kRows * TL::C; i += kThreads) {
    const int r = i / TL::C, c = i % TL::C;
    const T* src = q;
    int bytes = 0;
    if (r < nrows) {
      src = q + ((size_t)(t0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D +
            c * TL::V;
      bytes = 16;
    }
    cp_async16(q_s + TL::chunk(r, c) * TL::V, src, bytes);
  }
  // key tile it of the split into ring stage st; keys past the split's
  // end are zero-filled
  auto load_kv = [&](int it, int st) {
    T* ks = ring + st * 2 * kTileElems;
    T* vs = ks + kTileElems;
    const int k0 = k_lo + it * BK;
    for (int i = tid; i < BK * TL::C; i += kThreads) {
      const int j = i / TL::C, c = i % TL::C, key = k0 + j;
      size_t off = 0;
      int bytes = 0;
      if (key < k_hi) {
        const int page =
            min(max(bt_row[key / a.page_size], 0), a.num_pages - 1);
        off = (((size_t)page * a.page_size + key % a.page_size) * a.KVH +
               kvh) * D + c * TL::V;
        bytes = 16;
      }
      cp_async16(ks + TL::chunk(j, c) * TL::V, kc + off, bytes);
      cp_async16(vs + TL::chunk(j, c) * TL::V, vc + off, bytes);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load_kv(st, st);
    cp_async_commit();  // group st (group 0 also holds Q)
  }

  // thread state: rows r0 and r0 + 8 of the warp, the m16n8 layout
  const int r0 = warp * 16 + (lane >> 2);
  bool rvalid[2];
  int rpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    rvalid[hh] = r < nrows;
    rpos[hh] = pos0 + r / a.G;  // keys <= rpos count
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  uint32_t qa[D / 16][4];

  for (int it = 0; it < n_kt; ++it) {
    if (it + kStages - 1 < n_kt)
      load_kv(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // groups <= it have landed
    __syncthreads();
    const T* ks = ring + (it % kStages) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    if (sizeof(T) == 2 && it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], q_s + TL::chunk(warp * 16 + (lane & 15),
                                        kk * 2 + (lane >> 4)) * TL::V);
    }
    if (warp * 16 >= nrows) {  // no query row of this warp counts
      __syncthreads();
      continue;
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    scores<D>(s, qa, q_s, ks, warp, lane);
    // mask (causal, past the split), then the online softmax in log2 units
    const int k0 = k_lo + it * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = rvalid[hh] && key < k_hi && key <= rpos[hh];
        s[nt][e] = ok ? s[nt][e] * a.scale_log2 : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[nt][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mnew = fmaxf(m[hh], quad_max(mx[hh]));
      corr[hh] = exp2f(m[hh] - mnew);
      m[hh] = mnew;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);  // masked: exactly 0
        rs[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + rs[hh];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];
    accumulate<D>(o, s, vs, p_s, warp, lane);
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);

  T* out = static_cast<T*>(a.out);
  if (nsplit == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!rvalid[hh]) continue;
      const int r = r0 + 8 * hh;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      T* dst = out + ((size_t)(t0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        store2(dst + dt * 8 + 2 * (lane & 3), o[dt][2 * hh] * inv,
               o[dt][2 * hh + 1] * inv);
    }
    return;
  }
  // split-K: this split's partials, then the last split merges
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!rvalid[hh]) continue;
    const int r = r0 + 8 * hh;
    const size_t pidx =
        ((size_t)(t0 + r / a.G) * a.H + kvh * a.G + r % a.G) * a.n_split +
        split;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(a.part_acc + pidx * D + dt * 8 + 2 * (lane & 3), o[dt][2 * hh],
             o[dt][2 * hh + 1]);
    if ((lane & 3) == 0) store2(a.part_ml + pidx * 2, m[hh], l[hh]);
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)blockIdx.x * a.KVH + kvh;
  if (tid == 0) info[6] = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!info[6]) return;
  __threadfence();
  for (int i = tid; i < nrows * (D / 2); i += kThreads) {
    const int r = i / (D / 2), d = (i % (D / 2)) * 2;
    const size_t base =
        ((size_t)(t0 + r / a.G) * a.H + kvh * a.G + r % a.G) * a.n_split;
    float mm = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp)
      mm = fmaxf(mm, __ldcg(a.part_ml + (base + sp) * 2));
    float ll = 0.f, x = 0.f, y = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(a.part_ml + (base + sp) * 2));
      const float2 v = __ldcg(
          reinterpret_cast<const float2*>(a.part_acc + (base + sp) * D + d));
      const float w = exp2f(ml.x - mm);
      ll = fmaf(ml.y, w, ll);
      x = fmaf(v.x, w, x);
      y = fmaf(v.y, w, y);
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    store2(out + ((size_t)(t0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D + d,
           x * inv, y * inv);
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

template <typename T, int D>
size_t smem_bytes() {
  return (size_t)(kRows * D + Ring<T>::kStages * 2 * BK * D) * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)kRows * (BK + 4) * 4 : 0);
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_slots + (a.T + 63) / 64), (unsigned)a.KVH,
                  (unsigned)a.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_split and split_keys are the
// wrapper's plan (ragged_attention.launch_plan): splits of split_keys keys
// (a multiple of 64) that together cover max_pages * page_size keys. With
// n_split > 1, part_acc (T * H * n_split * D f32), part_ml (T * H *
// n_split * 2 f32) and tickets ((ceil(T / (64 / G)) + R) * KVH int32,
// zero before the first call; each call leaves them zero) are the
// wrapper's scratch. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape or plan the kernel does
// not take.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* row_starts, const void* row_lens, const void* kv_lens,
    const void* block_tables, void* out, void* part_acc, void* part_ml,
    void* tickets, int T_tokens, int H, int KVH, int D, int num_pages,
    int page_size, int num_rows, int max_pages, int n_split, int split_keys,
    float scale, int dtype, void* stream) {
  if ((D != 64 && D != 128) || KVH <= 0 || H % KVH != 0 || H / KVH > kRows ||
      num_rows <= 0 || num_pages <= 0 || page_size <= 0 || max_pages <= 0 ||
      T_tokens < 0 || n_split <= 0 || split_keys <= 0 || split_keys % BK ||
      (long long)n_split * split_keys < (long long)max_pages * page_size ||
      (n_split > 1 && (!part_acc || !part_ml || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (T_tokens == 0) return 0;
  Args a;
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.out = out;
  a.row_starts = static_cast<const int*>(row_starts);
  a.row_lens = static_cast<const int*>(row_lens);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.block_tables = static_cast<const int*>(block_tables);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.T = T_tokens;
  a.H = H;
  a.KVH = KVH;
  a.G = H / KVH;
  a.R = num_rows;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.bq = kRows / a.G;
  a.n_slots = (T_tokens + a.bq - 1) / a.bq + num_rows;
  a.n_split = n_split;
  a.split_keys = split_keys;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch<float, 64>(a, s) : launch<float, 128>(a, s);
  if (dtype == 1)
    return D == 64 ? launch<bf16, 64>(a, s) : launch<bf16, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}
