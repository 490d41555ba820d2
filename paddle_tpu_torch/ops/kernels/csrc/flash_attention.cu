// Flash attention forward and backward (FlashAttention-2) in float32, for
// Hopper (sm_90a). The bf16 forward, dQ and dK/dV are
// flash_attention_sm90.cu's.
//
// Replaces, for float32 inputs, three Pallas kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   * paddle_tpu/ops/pallas/flash_attention.py:106 (_flash_fwd, body
//     _fwd_kernel :51): O and the per-row logsumexp, online softmax over key
//     tiles;
//   * paddle_tpu/ops/pallas/flash_attention.py:262 (the dQ call of
//     _flash_bwd, body _bwd_dq_kernel :143): P recomputed from lse,
//     dS = P*(dP - delta)*scale, dQ = sum dS K;
//   * paddle_tpu/ops/pallas/flash_attention.py:285 (the dK/dV call of
//     _flash_bwd, body _bwd_dkv_kernel :193): dV = sum P^T dO,
//     dK = sum dS^T Q per key tile.
// Same function: s = (q . k) * scale; a key counts for a query row when
// kpos < Sk and, if causal, kpos <= qpos (both absolute, no offset); a
// masked key contributes exactly 0 (explicit mask, as the JAX kernel's
// -1e30 fill gives for every row that has a valid key); l is floored at
// 1e-30 so a row with no valid key writes O = 0 and lse ~ -1e30
// (flash_attention.py:101-103). Delta = rowsum(dO*O) is computed by the
// caller (flash_attention.py:256).
//
// Layouts. q, k, v and dO are [B, S, H, D] read through strides (batch,
// seq, head; D contiguous), so the GPT's q/k/v views of its fused QKV
// projection need no copy and no transpose. O, dQ, dK, dV are written
// contiguous [B, S, H, D]; lse and delta are f32 [B, H, Sq]. The S tail is
// masked in the kernel (rows past Sq / Sk are zero-filled in shared memory
// and never stored), where the JAX wrapper pads S to the block.
//
// Design. The Pallas grids run their key axis (forward, dQ) or query axis
// (dK/dV) in order on one core and carry m, l and the accumulators in
// VMEM scratch across grid steps. Blocks on Hopper run in no order, so that
// axis becomes a loop inside one thread block: the forward and dQ kernels
// take one block per (b*h, query tile) and loop over key tiles, skipping
// the tiles that lie wholly above the diagonal (flash_attention.py:91-95);
// the dK/dV kernel takes one block per (b*h, key tile), loops over the
// query tiles on or below the diagonal (:236-240) and owns its tile's dK
// and dV, so no atomics are needed. Every product C (+)= A.B runs on tiles
// staged in shared memory in scalar f32 FMAs with an f32 result in shared
// memory (full f32, no TF32: these kernels are the tight check of the
// masks, the causal skip and the S tail). Tiles are 64 query x 32 key
// rows, so the check also covers a causal skip boundary with
// block_q != block_k.
//
// Bound: operations for the two backward kernels, bytes (just) for the
// forward, on the tensor cores the bf16 kernels use (see
// flash_attention_sm90.cu). These f32 kernels run on the CUDA cores at a
// small fraction of either bound: they serve f32 callers and the checks,
// not the bf16 training step.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // elements added to every shared-memory row

template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int BQ = 64, BK = 32;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int B, H, Sq, Sk, D;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Carves 128-byte-aligned regions out of dynamic shared memory.
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(int count) {
    U* out = reinterpret_cast<U*>(p);
    p += ((size_t)count * sizeof(U) + 127) / 128 * 128;
    return out;
  }
};
__host__ __device__ constexpr size_t carve(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Stage rows [0, rows_valid) of a [nrows, D] tile (row stride `stride`
// elements, D contiguous) into shared memory with row stride `ld`; the rows
// past rows_valid are zero-filled. 16-byte vector loads (the wrapper
// guarantees 16-byte-aligned rows).
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long stride,
                          int rows_valid, int nrows, int D) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = D / V;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// C[M, N] (f32, shared, row stride ldc) = or += A[M, K] . B[K, N], the whole
// block cooperating. A is row-major a[m*lda + k], or with AT a[k*lda + m];
// B is row-major b[k*ldb + n], or with BT b[n*ldb + k].
template <bool AT, bool BT>
__device__ void block_mma(float* c, int ldc, const float* a, int lda,
                          const float* b, int ldb, int M, int N, int K,
                          bool accumulate) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N;
    const int n = i - m * N;
    float s = accumulate ? c[m * ldc + n] : 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float av = AT ? a[kk * lda + m] : a[m * lda + kk];
      const float bv = BT ? b[n * ldb + kk] : b[kk * ldb + n];
      s = fmaf(av, bv, s);
    }
    c[m * ldc + n] = s;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool key_valid(const Params& p, int qpos,
                                          int kpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos);
}

// Number of key tiles a query tile starting at q0 visits: with causal, the
// tiles whose first key is <= the tile's last query row.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int BQ,
                                         int BK) {
  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  return nk;
}

template <typename T>
size_t fwd_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  return carve((size_t)BQ * ldt * sizeof(T)) +
         2 * carve((size_t)BK * ldt * sizeof(T)) +
         carve((size_t)BQ * lds * 4) + carve((size_t)BQ * ldp * sizeof(T)) +
         carve((size_t)BQ * lda * 4) + 2 * carve((size_t)BQ * 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int D = p.D;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* q_s = cv.take<T>(BQ * ldt);
  T* k_s = cv.take<T>(BK * ldt);
  T* v_s = cv.take<T>(BK * ldt);
  float* s_s = cv.take<float>(BQ * lds);
  T* p_s = cv.take<T>(BQ * ldp);
  float* acc_s = cv.take<float>(BQ * lda);
  float* m_s = cv.take<float>(BQ);
  float* l_s = cv.take<float>(BQ);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                (long long)q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile(q_s, ldt, qg, p.q_ss, min(BQ, p.Sq - q0), BQ, D);
  for (int i = threadIdx.x; i < BQ * lda; i += kThreads) acc_s[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int nk = key_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(k_s, ldt, kg + (long long)k0 * p.k_ss, p.k_ss,
              min(BK, p.Sk - k0), BK, D);
    load_tile(v_s, ldt, vg + (long long)k0 * p.v_ss, p.v_ss,
              min(BK, p.Sk - k0), BK, D);
    __syncthreads();
    block_mma<false, true>(s_s, lds, q_s, ldt, k_s, ldt, BQ, BK, D, false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q0 + r;
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32)
        if (key_valid(p, qpos, k0 + c))
          mx = fmaxf(mx, s_s[r * lds + c] * p.scale);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float e = key_valid(p, qpos, k0 + c)
                            ? expf(s_s[r * lds + c] * p.scale - m_new)
                            : 0.f;
        p_s[r * ldp + c] = from_f32<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) acc_s[r * lda + d] *= corr;
      if (lane == 0) {
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    block_mma<false, false>(acc_s, lda, p_s, ldp, v_s, ldt, BQ, D, BK, true);
  }
  __syncthreads();
  T* og = static_cast<T*>(p.o);
  const long long o_ss = (long long)p.H * D;
  for (int r = warp; r < BQ; r += kWarps) {
    const int qpos = q0 + r;
    if (qpos >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const float inv = 1.f / l;
    T* orow = og + (long long)b * p.Sq * o_ss + qpos * o_ss + (long long)h * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = from_f32<T>(acc_s[r * lda + d] * inv);
    if (lane == 0) p.lse[(long long)bh * p.Sq + qpos] = m_s[r] + logf(l);
  }
}

template <typename T>
size_t dq_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  return 2 * carve((size_t)BQ * ldt * sizeof(T)) +
         2 * carve((size_t)BK * ldt * sizeof(T)) +
         2 * carve((size_t)BQ * lds * 4) +
         carve((size_t)BQ * ldp * sizeof(T)) + carve((size_t)BQ * lda * 4) +
         2 * carve((size_t)BQ * 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int D = p.D;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* q_s = cv.take<T>(BQ * ldt);
  T* do_s = cv.take<T>(BQ * ldt);
  T* k_s = cv.take<T>(BK * ldt);
  T* v_s = cv.take<T>(BK * ldt);
  float* s_s = cv.take<float>(BQ * lds);
  float* dp_s = cv.take<float>(BQ * lds);
  T* ds_s = cv.take<T>(BQ * ldp);
  float* dq_s = cv.take<float>(BQ * lda);
  float* lse_s = cv.take<float>(BQ);
  float* dl_s = cv.take<float>(BQ);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, p.Sq - q0);
  load_tile(q_s, ldt,
            static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                (long long)q0 * p.q_ss,
            p.q_ss, rows, BQ, D);
  load_tile(do_s, ldt,
            static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
                (long long)q0 * p.do_ss,
            p.do_ss, rows, BQ, D);
  for (int i = threadIdx.x; i < BQ * lda; i += kThreads) dq_s[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const long long row = (long long)bh * p.Sq + q0 + r;
    lse_s[r] = r < rows ? p.lse[row] : 0.f;
    dl_s[r] = r < rows ? p.delta[row] : 0.f;
  }
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int nk = key_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(k_s, ldt, kg + (long long)k0 * p.k_ss, p.k_ss,
              min(BK, p.Sk - k0), BK, D);
    load_tile(v_s, ldt, vg + (long long)k0 * p.v_ss, p.v_ss,
              min(BK, p.Sk - k0), BK, D);
    __syncthreads();
    block_mma<false, true>(s_s, lds, q_s, ldt, k_s, ldt, BQ, BK, D, false);
    block_mma<false, true>(dp_s, lds, do_s, ldt, v_s, ldt, BQ, BK, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int c = i - r * BK;
      float ds = 0.f;
      if (r < rows && key_valid(p, q0 + r, k0 + c)) {
        const float pr = expf(s_s[r * lds + c] * p.scale - lse_s[r]);
        ds = pr * (dp_s[r * lds + c] - dl_s[r]) * p.scale;
      }
      ds_s[r * ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();
    block_mma<false, false>(dq_s, lda, ds_s, ldp, k_s, ldt, BQ, D, BK, true);
  }
  __syncthreads();
  T* dqg = static_cast<T*>(p.dq);
  const long long o_ss = (long long)p.H * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dqg[(long long)b * p.Sq * o_ss + (long long)(q0 + r) * o_ss +
        (long long)h * D + d] = from_f32<T>(dq_s[r * lda + d]);
  }
}

template <typename T>
size_t dkv_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  return 2 * carve((size_t)BK * ldt * sizeof(T)) +
         2 * carve((size_t)BQ * ldt * sizeof(T)) +
         2 * carve((size_t)BQ * lds * 4) +
         2 * carve((size_t)BQ * ldp * sizeof(T)) +
         2 * carve((size_t)BK * lda * 4) + 2 * carve((size_t)BQ * 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int D = p.D;
  const int ldt = D + kPad, lds = BK + 4, ldp = BK + kPad, lda = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* k_s = cv.take<T>(BK * ldt);
  T* v_s = cv.take<T>(BK * ldt);
  T* q_s = cv.take<T>(BQ * ldt);
  T* do_s = cv.take<T>(BQ * ldt);
  float* s_s = cv.take<float>(BQ * lds);
  float* dp_s = cv.take<float>(BQ * lds);
  T* p_s = cv.take<T>(BQ * ldp);
  T* ds_s = cv.take<T>(BQ * ldp);
  float* dk_s = cv.take<float>(BK * lda);
  float* dv_s = cv.take<float>(BK * lda);
  float* lse_s = cv.take<float>(BQ);
  float* dl_s = cv.take<float>(BQ);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int k0 = blockIdx.x * BK;
  const int krows = min(BK, p.Sk - k0);
  load_tile(k_s, ldt,
            static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                (long long)k0 * p.k_ss,
            p.k_ss, krows, BK, D);
  load_tile(v_s, ldt,
            static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                (long long)k0 * p.v_ss,
            p.v_ss, krows, BK, D);
  for (int i = threadIdx.x; i < BK * lda; i += kThreads) {
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int nq = (p.Sq + BQ - 1) / BQ;
  // causal: query tiles whose last row is >= the key tile's first key
  const int qt0 = p.causal ? k0 / BQ : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    const int rows = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous query tile's Q, dO, P, dS are consumed
    load_tile(q_s, ldt, qg + (long long)q0 * p.q_ss, p.q_ss, rows, BQ, D);
    load_tile(do_s, ldt, dog + (long long)q0 * p.do_ss, p.do_ss, rows, BQ,
              D);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const long long row = (long long)bh * p.Sq + q0 + r;
      lse_s[r] = r < rows ? p.lse[row] : 0.f;
      dl_s[r] = r < rows ? p.delta[row] : 0.f;
    }
    __syncthreads();
    block_mma<false, true>(s_s, lds, q_s, ldt, k_s, ldt, BQ, BK, D, false);
    block_mma<false, true>(dp_s, lds, do_s, ldt, v_s, ldt, BQ, BK, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int c = i - r * BK;
      float pr = 0.f, ds = 0.f;
      if (r < rows && key_valid(p, q0 + r, k0 + c)) {
        pr = expf(s_s[r * lds + c] * p.scale - lse_s[r]);
        ds = pr * (dp_s[r * lds + c] - dl_s[r]) * p.scale;
      }
      p_s[r * ldp + c] = from_f32<T>(pr);
      ds_s[r * ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: P and dS read transposed
    block_mma<true, false>(dv_s, lda, p_s, ldp, do_s, ldt, BK, D, BQ, true);
    block_mma<true, false>(dk_s, lda, ds_s, ldp, q_s, ldt, BK, D, BQ, true);
  }
  __syncthreads();
  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
  const long long o_ss = (long long)p.H * D;
  for (int i = threadIdx.x; i < krows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const long long off = (long long)b * p.Sk * o_ss +
                          (long long)(k0 + r) * o_ss + (long long)h * D + d;
    dkg[off] = from_f32<T>(dk_s[r * lda + d]);
    dvg[off] = from_f32<T>(dv_s[r * lda + d]);
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

int launch(void (*kernel)(Params), size_t smem, dim3 grid, const Params& p,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
dim3 query_grid(const Params& p) {
  return dim3((p.Sq + Tiles<T>::BQ - 1) / Tiles<T>::BQ, p.B * p.H);
}

// meta (host): B, H, Sq, Sk, D, then (batch, seq, head) element strides of
// q, k, v and dO (dO's are ignored by the forward).
int run(Which which, const void* q, const void* k, const void* v,
        const void* dout, void* o, void* dq, void* dk, void* dv, void* lse,
        const void* delta, const long long* meta, float scale, int causal,
        int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.o = o;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = (int)meta[0];
  p.H = (int)meta[1];
  p.Sq = (int)meta[2];
  p.Sk = (int)meta[3];
  p.D = (int)meta[4];
  p.q_sb = meta[5];
  p.q_ss = meta[6];
  p.q_sh = meta[7];
  p.k_sb = meta[8];
  p.k_ss = meta[9];
  p.k_sh = meta[10];
  p.v_sb = meta[11];
  p.v_ss = meta[12];
  p.v_sh = meta[13];
  p.do_sb = meta[14];
  p.do_ss = meta[15];
  p.do_sh = meta[16];
  p.scale = scale;
  p.causal = causal;
  if (p.D <= 0 || p.D > 128 || p.D % 16 || p.B <= 0 || p.H <= 0 ||
      p.Sq <= 0 || p.Sk <= 0 || (long long)p.B * p.H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && which == kFwd)
    return launch(flash_fwd_kernel<float>, fwd_smem<float>(p.D),
                  query_grid<float>(p), p, s);
  if (dtype == 0 && which == kDq)
    return launch(flash_bwd_dq_kernel<float>, dq_smem<float>(p.D),
                  query_grid<float>(p), p, s);
  if (dtype == 0 && which == kDkv)
    return launch(flash_bwd_dkv_kernel<float>, dkv_smem<float>(p.D),
                  dim3((p.Sk + Tiles<float>::BK - 1) / Tiles<float>::BK,
                       p.B * p.H),
                  p, s);
  // bf16 runs in flash_attention_sm90.cu
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (bfloat16 and float16 are flash_attention_sm90.cu's).
// Each returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape or type the kernels do not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const long long* meta, float scale,
                                   int causal, int dtype, void* stream) {
  return run(kFwd, q, k, v, nullptr, o, nullptr, nullptr, nullptr, lse,
             nullptr, meta, scale, causal, dtype, stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const long long* meta,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  return run(kDq, q, k, v, dout, nullptr, dq, nullptr, nullptr,
             const_cast<void*>(lse), delta, meta, scale, causal, dtype,
             stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* meta, float scale,
                                       int causal, int dtype, void* stream) {
  return run(kDkv, q, k, v, dout, nullptr, nullptr, dk, dv,
             const_cast<void*>(lse), delta, meta, scale, causal, dtype,
             stream);
}
