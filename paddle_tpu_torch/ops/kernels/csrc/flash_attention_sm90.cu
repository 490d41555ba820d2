// bf16 and f16 flash attention forward and backward (dQ, dK/dV) for
// Hopper (sm_90a): wgmma with register accumulators, a TMA ring fed by a
// producer warp, two consumer warpgroups.
//
// Replaces, for bfloat16 and float16 inputs, the three Pallas kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   * paddle_tpu/ops/pallas/flash_attention.py:106 (_flash_fwd, body
//     _fwd_kernel :51): O and the per-row logsumexp, online softmax over
//     key tiles;
//   * paddle_tpu/ops/pallas/flash_attention.py:262 (the dQ call of
//     _flash_bwd, body _bwd_dq_kernel :143): P recomputed from lse,
//     dS = P (dP - delta) scale, dQ = sum dS K;
//   * paddle_tpu/ops/pallas/flash_attention.py:285 (the dK/dV call of
//     _flash_bwd, body _bwd_dkv_kernel :193): dV = sum P^T dO and
//     dK = sum dS^T Q per key tile.
// The function is flash_attention.cu's (which keeps the f32
// instantiations): s = (q . k) * scale; a key counts for a query row when
// kpos < Sk and, if causal, kpos <= qpos; a masked key adds exactly 0; l is
// floored at 1e-30; lse = m + log(l) (natural log, f32 [B, H, Sq]); P and
// dS are rounded to the input type before their products; delta comes from the
// caller. q, k, v and dO are [B, S, H, D] read through their strides (the
// GPT's views of its fused QKV projection, no copy); O, dK and dV are
// written contiguous [B, S, H, D]; so is dQ. D is a multiple of 16 up to
// 128. Every kernel is instantiated for T = __nv_bfloat16 and T = __half:
// both are 2 bytes, so tiles, boxes, swizzles and fragments are the same,
// and only the wgmma type, the tensor maps' data type and the rounding of
// P, dS and the outputs differ (sm90.cuh's Elem<T>).
//
// Bound: bytes (just) for the forward, operations (just) for dQ and dK/dV.
// At the GPT's shapes (B 8, S 1024, H 16, D 128, causal) the forward does
// 34.4 GFLOP against 134.7 MB (0.035 ms of tensor-core time at 989
// TFLOP/s, 0.040 ms of bytes at 3.35 TB/s), dQ 51.6 GFLOP against 168.8 MB
// (0.052 vs 0.050 ms) and dK/dV 68.8 GFLOP against 202.4 MB (0.070 vs
// 0.060 ms): all three sit at the ridge, so the tensor cores and the loads
// have to be kept busy at once.
//
// Design (sm90.cuh holds the primitives). A block is 384 threads: two
// consumer warpgroups (setmaxnreg 240) and a producer warpgroup (24) of
// which one warp works. The producer keeps TMA loads in flight through a
// three-stage ring of 128-byte-swizzled tiles with full/empty mbarrier
// pairs; a head dim below the tile's width (D_PAD 64 or 128) is
// zero-filled by the TMA box running past D, and rows past S by the box
// running past S.
//   * Forward: one block per (b*h, 128 query rows), 64 rows a consumer
//     warpgroup; Q is loaded once, K and V stream in 128-key tiles. S =
//     Q.K^T runs on wgmma (both operands K-major in shared memory) into
//     registers; the online softmax runs in registers (exp2 with
//     scale*log2(e) folded in, row max and sum over the 4 threads sharing a
//     row); P is the S accumulator converted to T in place, the
//     register-A operand of O += P.V (V MN-major, transpose-B). O stays in
//     registers until the epilogue. The loop is software-pipelined: tile
//     j's Q.K^T and softmax run while tile j-1's P.V does, and the two
//     warpgroups take turns to issue their products (ping-pong on named
//     barriers), so one's softmax runs under the other's wgmma. Key tiles
//     above the diagonal are not loaded; only diagonal and tail tiles pay
//     for the mask. Blocks run in sections of 16 heads that share their K
//     and V through L2, the last query tiles (the heaviest under causal)
//     first.
//   * dK/dV: one block per (b*h, 128 keys), 64 keys a consumer warpgroup;
//     K and V are loaded once and stay; Q and dO stream in 64-row tiles
//     from the first tile on or below the diagonal, with their lse and
//     delta rows (written by the producer warp's lanes). Per tile, in the
//     transposed form so that P^T and dS^T land as wgmma A fragments:
//     S^T = K.Q^T and dP^T = V.dO^T (K-major), P^T = exp2(S^T*scale*log2e
//     - lse*log2e) masked, dS^T = P^T (dP^T - delta) scale, then dV +=
//     P^T.dO and dK += dS^T.Q (register A, dO and Q MN-major). dK and dV
//     accumulate in registers for the whole loop; the block owns its keys,
//     so no atomics. The warpgroups take turns to issue S^T and dP^T, as
//     the forward's do. Blocks run in sections of 16 heads that share their Q
//     and dO through L2, the first key tiles (the heaviest) first.
//   * dQ: the forward's shape, one block per (b*h, 128 query rows), 64 rows
//     a consumer warpgroup; Q, dO and the block's lse and delta rows
//     (written by the producer warp's lanes) are loaded once, K and V
//     stream in 64-key tiles (S, dP and dQ take 32 + 32 + 64 f32 registers
//     a thread, which 128-key tiles would spill). Per tile: S = Q.K^T and
//     dP = dO.V^T (K-major), P = exp2(S*scale*log2e - lse*log2e) masked,
//     dS = P (dP - delta) scale in registers, converted to T in place,
//     then dQ += dS.K (register A, the same K tile read MN-major). dQ stays
//     in registers and is stored once. Software-pipelined as the forward:
//     tile j's S and dP run while tile j-1's dQ product does, the
//     warpgroups take turns to issue, and blocks run in 16-head sections,
//     the last query tiles first.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;                     // TMA ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr int kMapRefused = -1;                // return code

struct Shape {
  int B, H, Sq, Sk, D;
  float scale;
  int causal;
};

__device__ __forceinline__ bool counts(const Shape& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Sk && (!p.causal || kpos <= qpos);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block order. The blocks of one (b, h) read the same K and V (forward)
// or Q and dO (dK/dV) tiles, and all heads' together outgrow the 50 MB L2
// at the GPT's shapes, so the grid runs in sections of kSection heads: the
// blocks of a section are resident together and share those tiles through
// L2. Inside a section the heaviest tile rank (0) of every head goes
// first. -> the block's (b*h, tile rank).
constexpr int kSection = 16;

__device__ __forceinline__ int2 block_tile(int BH, int ntiles) {
  const int per = kSection * ntiles;
  const int sec = blockIdx.x / per, r = blockIdx.x % per;
  const int heads = min(kSection, BH - sec * kSection);
  return make_int2(sec * kSection + r % heads, r / heads);
}

// Shared memory is carved from a 1024-byte-aligned base (128-byte swizzle).
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// Stores rows (row0, row0 + 8) of an m64 x DP accumulator, times inv[h],
// as T into a contiguous [B, S, H, D] tensor, clipped to S and D.
template <typename T, int R>
__device__ __forceinline__ void store_rows(const float (&acc)[R], T* out,
                                           const Shape& p, int S, int b,
                                           int h, int row0, const float* inv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    T* dst = out + (((long long)b * S + row) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(dst + col) =
            Elem<T>::pack(acc[4 * j + 2 * hh] * inv[hh],
                          acc[4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
}

// ---------------------------------------------------------------- forward
template <int DP>
struct Fwd {
  static constexpr int BQ = 64 * kConsumers, BK = 128;
  static constexpr uint32_t kQBox = BQ * 128, kKBox = BK * 128;
  static constexpr uint32_t kQBytes = BQ * DP * 2, kKBytes = BK * DP * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKBytes + 8 * (1 + 2 * kStages);
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, T* o_out,
                          float* lse_out, Shape p) {
  using L = Fwd<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_base(smem_raw);
  unsigned char* k_s = q_s + L::kQBytes;
  unsigned char* v_s = k_s + kStages * L::kKBytes;
  uint64_t* q_bar =
      reinterpret_cast<uint64_t*>(v_s + kStages * L::kKBytes);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int BH = p.B * p.H;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int2 tile = block_tile(BH, nqt);  // rank 0: the last query tile
  const int bh = tile.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (nqt - 1 - tile.y) * BQ;
  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x == 128 * kConsumers) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_bar, L::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(q_s + j * L::kQBox, &tq, q_bar, 64 * j, h, q0, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKBytes);
        unsigned char* kd = k_s + s * L::kKBytes;
        unsigned char* vd = v_s + s * L::kKBytes;
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(kd + j * L::kKBox, &tk, &full[s], 64 * j, h, kt * BK, b);
          tma_load_4d(vd + j * L::kKBox, &tv, &full[s], 64 * j, h, kt * BK, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t & 31;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const unsigned char* qw = q_s + wg * 64 * 128;
    const float sl2 = p.scale * kLog2e;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f}, corr[2];
    float sc[BK / 2];
    uint32_t pf[BK / 16][4];
    // S = Q.K^T of key tile kt into sc (issued, not waited for)
    auto scores = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<T, 0, 0>(sc, desc_kmajor(qw, kk, L::kQBox),
                        desc_kmajor(k_s + s * L::kKBytes, kk, L::kKBox),
                        kk > 0);
      wgmma_commit();
    };
    // O += P.V of key tile kt, P in pf (issued, not waited for)
    auto pv = [&](int kt) {
      const unsigned char* vt = v_s + (kt % kStages) * L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<T, 1>(o, pf[kk], desc_mnmajor(vt, kk, L::kKBox));
      wgmma_commit();
    };
    // Masks key tile kt's scores where it has to, folds them into m and
    // lsum and turns them into probabilities in place; corr is what the
    // rows of O must be rescaled by.
    auto softmax = [&](int kt) {
      const int k0 = kt * BK;
      if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + wg * 64)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
          const int qpos = row0 + 8 * ((i / 2) & 1);
          if (!(kpos < p.Sk && (!p.causal || kpos <= qpos)))
            sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, ml2[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mnew = fmaxf(m[hh], quad_max(mx[hh]) * p.scale);
        corr[hh] = ex2((m[hh] - mnew) * kLog2e);
        ml2[hh] = mnew * kLog2e;
        m[hh] = mnew;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i / 2) & 1;
        sc[i] = ex2(fmaf(sc[i], sl2, -ml2[hh]));
        rs[hh] += sc[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) lsum[hh] = lsum[hh] * corr[hh] + rs[hh];
    };
    // Software pipeline: tile kt's S = Q.K^T runs while tile kt-1's P.V
    // does, and the softmax of tile kt overlaps that P.V. The two
    // warpgroups take turns to issue their products (named barriers 1 and
    // 2), so one's softmax runs under the other's wgmma.
    auto my_turn = [&] { bar_sync(1 + wg, 256); };
    auto your_turn = [&] { bar_arrive(2 - wg, 256); };
    if (wg == 1) your_turn();
    mbar_wait(q_bar, 0);
    my_turn();
    scores(0);
    your_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    frag_from_acc<T>(sc, pf);
    for (int kt = 1; kt < nk; ++kt) {
      my_turn();
      scores(kt);
      pv(kt - 1);
      your_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(kt);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[(kt - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) & 1];
      frag_from_acc<T>(sc, pf);
    }
    my_turn();
    wgmma_fence();
    pv(nk - 1);
    if (wg == 0) your_turn();  // the last turn: nobody waits after it
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(nk - 1) % kStages]);
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float l = fmaxf(quad_sum(lsum[hh]), 1e-30f);
      inv[hh] = 1.f / l;
      const int row = row0 + 8 * hh;
      if ((lane & 3) == 0 && row < p.Sq)
        lse_out[(long long)bh * p.Sq + row] = m[hh] + logf(l);
    }
    store_rows(o, o_out, p, p.Sq, b, h, row0, inv);
  }
}

// ------------------------------------------------------------------ dK/dV
template <int DP>
struct Dkv {
  static constexpr int BK = 64 * kConsumers, BQ = 64;
  static constexpr uint32_t kKBox = BK * 128, kQBox = BQ * 128;
  static constexpr uint32_t kKBytes = BK * DP * 2, kQBytes = BQ * DP * 2;
  // one ring stage: Q, dO, then lse and delta rows (f32)
  static constexpr uint32_t kStage = 2 * kQBytes + 1024;
  static constexpr size_t kSmem =
      1024 + 2 * kKBytes + kStages * kStage + 8 * (1 + 2 * kStages);
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* lse, const float* delta,
                              T* dk_out, T* dv_out, Shape p) {
  using L = Dkv<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = aligned_base(smem_raw);
  unsigned char* v_s = k_s + L::kKBytes;
  unsigned char* ring = v_s + L::kKBytes;
  uint64_t* kv_bar =
      reinterpret_cast<uint64_t*>(ring + kStages * L::kStage);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int BH = p.B * p.H;
  const int2 tile = block_tile(BH, (p.Sk + BK - 1) / BK);  // rank 0: first
  const int bh = tile.x, b = bh / p.H, h = bh % p.H;
  const int k0 = tile.y * BK;
  const int nq = (p.Sq + BQ - 1) / BQ;
  // causal: the query tiles whose last row reaches the block's first key
  const int qt0 = p.causal ? min(k0 / BQ, nq) : 0;
  const int n_it = nq - qt0;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes, then the 32 lanes' rows
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x < 128 * kConsumers + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tdo);
        mbar_arrive_expect_tx(kv_bar, 2 * L::kKBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(k_s + j * L::kKBox, &tk, kv_bar, 64 * j, h, k0, b);
          tma_load_4d(v_s + j * L::kKBox, &tv, kv_bar, 64 * j, h, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (qt0 + it) * BQ;
        unsigned char* st = ring + s * L::kStage;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes);
          for (int j = 0; j < NB; ++j) {
            tma_load_4d(st + j * L::kQBox, &tq, &full[s], 64 * j, h, q0, b);
            tma_load_4d(st + L::kQBytes + j * L::kQBox, &tdo, &full[s],
                        64 * j, h, q0, b);
          }
        }
        float* rows = reinterpret_cast<float*>(st + 2 * L::kQBytes);
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < p.Sq;
          const long long r = (long long)bh * p.Sq + q0 + i;
          rows[i] = in ? lse[r] : 0.f;
          rows[BQ + i] = in ? delta[r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t & 31;
    const int kw0 = k0 + wg * 64;
    const int krow0 = kw0 + (t / 32) * 16 + lane / 4;
    const unsigned char* kw = k_s + wg * 64 * 128;
    const unsigned char* vw = v_s + wg * 64 * 128;
    const float sl2 = p.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    // The two warpgroups take turns to issue S^T and dP^T (named barriers
    // 1 and 2), so one's elementwise work runs under the other's wgmma.
    auto my_turn = [&] { bar_sync(1 + wg, 256); };
    auto your_turn = [&] { bar_arrive(2 - wg, 256); };
    if (wg == 1 && n_it > 0) your_turn();
    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it) * BQ;
      const unsigned char* q_t = ring + s * L::kStage;
      const unsigned char* do_t = q_t + L::kQBytes;
      const float* ls = reinterpret_cast<const float*>(q_t + 2 * L::kQBytes);
      const float* dl = ls + BQ;
      mbar_wait(&full[s], (it / kStages) & 1);
      float st[BQ / 2], dpt[BQ / 2];
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<T, 0, 0>(st, desc_kmajor(kw, kk, L::kKBox),
                        desc_kmajor(q_t, kk, L::kQBox), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<T, 0, 0>(dpt, desc_kmajor(vw, kk, L::kKBox),
                        desc_kmajor(do_t, kk, L::kQBox), kk > 0);
      wgmma_commit();
      if (wg == 0 || it + 1 < n_it) your_turn();  // none waits after the last
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const bool mask = q0 + BQ > p.Sq || kw0 + 64 > p.Sk ||
                        (p.causal && kw0 + 63 > q0);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        float pv = ex2(fmaf(st[i], sl2, -ls[c] * kLog2e));
        if (mask && !counts(p, q0 + c, krow0 + 8 * ((i / 2) & 1))) pv = 0.f;
        st[i] = pv;
        dpt[i] = pv * (dpt[i] - dl[c]) * p.scale;
      }
      uint32_t pf[BQ / 16][4], df[BQ / 16][4];
      frag_from_acc<T>(st, pf);
      frag_from_acc<T>(dpt, df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<T, 1>(dv, pf[kk], desc_mnmajor(do_t, kk, L::kQBox));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<T, 1>(dk, df[kk], desc_mnmajor(q_t, kk, L::kQBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(&empty[s]);
    }
    const float one[2] = {1.f, 1.f};
    store_rows(dk, dk_out, p, p.Sk, b, h, krow0, one);
    store_rows(dv, dv_out, p, p.Sk, b, h, krow0, one);
  }
}

// --------------------------------------------------------------------- dQ
template <int DP>
struct Dq {
  static constexpr int BQ = 64 * kConsumers, BK = 64;
  static constexpr uint32_t kQBox = BQ * 128, kKBox = BK * 128;
  static constexpr uint32_t kQBytes = BQ * DP * 2, kKBytes = BK * DP * 2;
  // one ring stage: a K tile, then a V tile
  static constexpr uint32_t kStage = 2 * kKBytes;
  // Q, dO, the ring, then the block's lse (times log2 e) and delta rows
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + kStages * kStage +
                                  2 * BQ * 4 + 8 * (1 + 2 * kStages);
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* lse, const float* delta,
                             T* dq_out, Shape p) {
  using L = Dq<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_base(smem_raw);
  unsigned char* do_s = q_s + L::kQBytes;
  unsigned char* ring = do_s + L::kQBytes;
  float* rows = reinterpret_cast<float*>(ring + kStages * L::kStage);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(rows + 2 * BQ);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int BH = p.B * p.H;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int2 tile = block_tile(BH, nqt);  // rank 0: the last query tile
  const int bh = tile.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (nqt - 1 - tile.y) * BQ;
  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1 + 32);  // the TMA bytes, then the 32 lanes' rows
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x < 128 * kConsumers + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        mbar_arrive_expect_tx(q_bar, 2 * L::kQBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(q_s + j * L::kQBox, &tq, q_bar, 64 * j, h, q0, b);
          tma_load_4d(do_s + j * L::kQBox, &tdo, q_bar, 64 * j, h, q0, b);
        }
      }
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < p.Sq;
        const long long r = (long long)bh * p.Sq + q0 + i;
        rows[i] = in ? lse[r] * kLog2e : 0.f;
        rows[BQ + i] = in ? delta[r] : 0.f;
      }
      mbar_arrive(q_bar);
      if (lane == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % kStages;
          unsigned char* st = ring + s * L::kStage;
          mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], L::kStage);
          for (int j = 0; j < NB; ++j) {
            tma_load_4d(st + j * L::kKBox, &tk, &full[s], 64 * j, h, kt * BK,
                        b);
            tma_load_4d(st + L::kKBytes + j * L::kKBox, &tv, &full[s],
                        64 * j, h, kt * BK, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t & 31;
    const int rl0 = wg * 64 + (t / 32) * 16 + lane / 4;  // rows rl0, rl0 + 8
    const int row0 = q0 + rl0;
    const unsigned char* qw = q_s + wg * 64 * 128;
    const unsigned char* dow = do_s + wg * 64 * 128;
    const float sl2 = p.scale * kLog2e;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    float sc[BK / 2], dp[BK / 2];
    uint32_t df[BK / 16][4];
    mbar_wait(q_bar, 0);
    const float ls[2] = {rows[rl0], rows[rl0 + 8]};
    const float dl[2] = {rows[BQ + rl0], rows[BQ + rl0 + 8]};
    // S = Q.K^T and dP = dO.V^T of key tile kt (issued, not waited for)
    auto products = [&](int kt) {
      const unsigned char* k_t = ring + (kt % kStages) * L::kStage;
      mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<T, 0, 0>(sc, desc_kmajor(qw, kk, L::kQBox),
                        desc_kmajor(k_t, kk, L::kKBox), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<T, 0, 0>(dp, desc_kmajor(dow, kk, L::kQBox),
                        desc_kmajor(k_t + L::kKBytes, kk, L::kKBox), kk > 0);
      wgmma_commit();
    };
    // dQ += dS.K of key tile kt, dS in df (issued, not waited for)
    auto accumulate = [&](int kt) {
      const unsigned char* k_t = ring + (kt % kStages) * L::kStage;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<T, 1>(dq, df[kk], desc_mnmajor(k_t, kk, L::kKBox));
      wgmma_commit();
    };
    // dS = P (dP - delta) scale into dp, P recomputed from lse and masked
    // where a key does not count
    auto grads = [&](int kt) {
      const int k0 = kt * BK;
      const bool mask =
          k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + wg * 64);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i / 2) & 1;
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        float pr = ex2(fmaf(sc[i], sl2, -ls[hh]));
        if (mask && !counts(p, row0 + 8 * hh, kpos)) pr = 0.f;
        dp[i] = pr * (dp[i] - dl[hh]) * p.scale;
      }
    };
    // Software pipeline: tile kt's S and dP run while tile kt-1's dQ
    // product does. The warpgroups alternate in issuing (named barriers
    // 1 and 2), so one's dS arithmetic overlaps the other's products.
    auto my_turn = [&] { bar_sync(1 + wg, 256); };
    auto your_turn = [&] { bar_arrive(2 - wg, 256); };
    if (wg == 1) your_turn();
    my_turn();
    products(0);
    your_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grads(0);
    frag_from_acc<T>(dp, df);
    for (int kt = 1; kt < nk; ++kt) {
      my_turn();
      products(kt);
      accumulate(kt - 1);
      your_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      grads(kt);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dp);  // df is rewritten only once its product is done
      mbar_arrive(&empty[(kt - 1) % kStages]);
      frag_from_acc<T>(dp, df);
    }
    my_turn();
    wgmma_fence();
    accumulate(nk - 1);
    if (wg == 0) your_turn();  // the last turn: nobody waits after it
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[(nk - 1) % kStages]);
    const float one[2] = {1.f, 1.f};
    store_rows(dq, dq_out, p, p.Sq, b, h, row0, one);
  }
}

// ------------------------------------------------------------------- host
struct View {
  const void* ptr;
  long long sb, ss, sh;
};

// meta: B, H, Sq, Sk, D, then the (batch, seq, head) element strides of
// q, k, v and dO.
bool parse(const long long* meta, float scale, int causal, Shape* p,
           View* views, const void* const* ptrs, int n) {
  p->B = (int)meta[0];
  p->H = (int)meta[1];
  p->Sq = (int)meta[2];
  p->Sk = (int)meta[3];
  p->D = (int)meta[4];
  p->scale = scale;
  p->causal = causal;
  for (int i = 0; i < n; ++i)
    views[i] = View{ptrs[i], meta[5 + 3 * i], meta[6 + 3 * i],
                    meta[7 + 3 * i]};
  return p->D > 0 && p->D <= 128 && p->D % 16 == 0 && p->B > 0 &&
         p->H > 0 && p->Sq > 0 && p->Sk > 0;
}

template <typename T>
bool encode(CUtensorMap* map, const Shape& p, const View& v, int S,
            int rows) {
  return encode_bshd(map, Elem<T>::kMapType, v.ptr, p.B, S, p.H, p.D, v.sb,
                     v.ss, v.sh, rows);
}

template <int DP, typename T>
int launch_fwd(const Shape& p, const View* v, void* o, void* lse,
               cudaStream_t stream) {
  using L = Fwd<DP>;
  CUtensorMap tq, tk, tv;
  if (!encode<T>(&tq, p, v[0], p.Sq, L::BQ) ||
      !encode<T>(&tk, p, v[1], p.Sk, L::BK) ||
      !encode<T>(&tv, p, v[2], p.Sk, L::BK))
    return kMapRefused;
  auto kernel = flash_fwd_sm90_kernel<DP, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((p.Sq + L::BQ - 1) / L::BQ) * p.B * p.H;
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

template <int DP, typename T>
int launch_dkv(const Shape& p, const View* v, const void* lse,
               const void* delta, void* dk, void* dv, cudaStream_t stream) {
  using L = Dkv<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<T>(&tq, p, v[0], p.Sq, L::BQ) ||
      !encode<T>(&tk, p, v[1], p.Sk, L::BK) ||
      !encode<T>(&tv, p, v[2], p.Sk, L::BK) ||
      !encode<T>(&tdo, p, v[3], p.Sq, L::BQ))
    return kMapRefused;
  auto kernel = flash_bwd_dkv_sm90_kernel<DP, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((p.Sk + L::BK - 1) / L::BK) * p.B * p.H;
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), p);
  return (int)cudaGetLastError();
}

template <int DP, typename T>
int launch_dq(const Shape& p, const View* v, const void* lse,
              const void* delta, void* dq, cudaStream_t stream) {
  using L = Dq<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<T>(&tq, p, v[0], p.Sq, L::BQ) ||
      !encode<T>(&tk, p, v[1], p.Sk, L::BK) ||
      !encode<T>(&tv, p, v[2], p.Sk, L::BK) ||
      !encode<T>(&tdo, p, v[3], p.Sq, L::BQ))
    return kMapRefused;
  auto kernel = flash_bwd_dq_sm90_kernel<DP, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((p.Sq + L::BQ - 1) / L::BQ) * p.B * p.H;
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

// The element type code the entries take: 1 bf16, 2 f16 (the f32
// library's 0 is not taken here).
constexpr int kBF16 = 1, kF16 = 2;

}  // namespace

// Dynamic shared memory a block of kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) launches with at head dim `d` (the same for both element types).
extern "C" int flash_attention_sm90_smem_bytes(int which, int d) {
  if (which == 0) return (int)(d <= 64 ? Fwd<64>::kSmem : Fwd<128>::kSmem);
  if (which == 2) return (int)(d <= 64 ? Dq<64>::kSmem : Dq<128>::kSmem);
  return (int)(d <= 64 ? Dkv<64>::kSmem : Dkv<128>::kSmem);
}

// `dtype` 1 (bf16) or 2 (f16). Each returns cudaGetLastError() after its
// launch (0 on success), cudaErrorInvalidValue for a shape or a type the
// kernels do not take, or -1 when the driver refuses a tensor map (a base
// or a stride that is not 16-byte aligned).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const long long* meta, float scale,
                                        int causal, int dtype, void* stream) {
  Shape p;
  View views[3];
  const void* ptrs[3] = {q, k, v};
  if (!parse(meta, scale, causal, &p, views, ptrs, 3) ||
      (dtype != kBF16 && dtype != kF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return p.D <= 64 ? launch_fwd<64, __half>(p, views, o, lse, s)
                     : launch_fwd<128, __half>(p, views, o, lse, s);
  return p.D <= 64 ? launch_fwd<64, __nv_bfloat16>(p, views, o, lse, s)
                   : launch_fwd<128, __nv_bfloat16>(p, views, o, lse, s);
}

extern "C" int flash_attention_sm90_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* meta, float scale, int causal, int dtype, void* stream) {
  Shape p;
  View views[4];
  const void* ptrs[4] = {q, k, v, dout};
  if (!parse(meta, scale, causal, &p, views, ptrs, 4) ||
      (dtype != kBF16 && dtype != kF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return p.D <= 64
               ? launch_dkv<64, __half>(p, views, lse, delta, dk, dv, s)
               : launch_dkv<128, __half>(p, views, lse, delta, dk, dv, s);
  return p.D <= 64
             ? launch_dkv<64, __nv_bfloat16>(p, views, lse, delta, dk, dv, s)
             : launch_dkv<128, __nv_bfloat16>(p, views, lse, delta, dk, dv,
                                              s);
}

extern "C" int flash_attention_sm90_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, const long long* meta,
                                           float scale, int causal, int dtype,
                                           void* stream) {
  Shape p;
  View views[4];
  const void* ptrs[4] = {q, k, v, dout};
  if (!parse(meta, scale, causal, &p, views, ptrs, 4) ||
      (dtype != kBF16 && dtype != kF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return p.D <= 64 ? launch_dq<64, __half>(p, views, lse, delta, dq, s)
                     : launch_dq<128, __half>(p, views, lse, delta, dq, s);
  return p.D <= 64
             ? launch_dq<64, __nv_bfloat16>(p, views, lse, delta, dq, s)
             : launch_dq<128, __nv_bfloat16>(p, views, lse, delta, dq, s);
}
