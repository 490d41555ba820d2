// Fused AdamW update over a whole parameter list in one launch, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_adamw.py:60 (fused_adamw, body
// _kernel :32), which the JAX Adam/AdamW call once per large parameter.
// Same function, per element, in f32:
//   w <- w * (1 - lr*wd)                          (decoupled decay)
//   m <- b1*m + (1-b1)*g
//   v <- b2*v + (1-b2)*g*g
//   w <- w - lr * (m*bc1) / (sqrt(v*bc2) + eps)
// Each tensor carries a type code (0 f32, 1 bf16, 2 f16) for w, g, the
// moments and p. w keeps its type (a 16-bit result rounded to nearest
// even); g is any of the three; m and v are f32, or both bf16 or both f16
// (stored rounded to nearest even: O2 without master weights, where the
// JAX optimizer keeps a low-precision parameter's moments in its type and
// casts the kernel's f32 results back,
// paddle_tpu/optimizer/optimizers.py:155-156). Master mode
// (paddle_tpu/optimizer/optimizer.py:107-152, multi_precision): w is the
// f32 master of a bf16 or f16 parameter p, and the same pass also writes
// p <- w rounded to p's type, as the JAX step's new_w.astype(p.dtype)
// does. The update is IN PLACE: w, m, v (and p) are overwritten where
// they lie, where the JAX kernel is functional and returns new arrays.
//
// Design. The Pallas kernel runs one grid per parameter over 512 x 128
// tiles. Here one launch covers every tensor: a device table holds one
// entry per tensor (pointers, element count, its own lr, wd, bc1 and bc2,
// dtypes, and the index of its first block), so one step is one launch
// whatever mix of modes its tensors hold; each block finds its tensor
// by a binary search of the first-block column, branches once on the
// tensor's type codes to a loop instantiated for those types (no type
// test per element), takes one chunk of kChunk elements of it, and reads
// each element of w, g, m and v once and writes w, m and v (and p) once,
// with neighbouring threads on neighbouring elements.
//
// Bound: bytes. ~12 flops per element against 28 bytes (f32 w and g: read
// w, g, m, v, write w, m, v), far below the ridge, so the floor is the
// bytes over 3.35 TB/s: 11.0 ms for the 1.3136 B parameters of gpt_1p3b.
// Master mode moves 28 bytes too (read g 2 + w 4 + m 4 + v 4, write w 4 +
// m 4 + v 4 + p 2), the same 11.0 ms; 16-bit moments with a 16-bit w and
// g move 14.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;

// Type codes of Entry's *_type fields.
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// One tensor. Must match _ENTRY in fused_adamw.py (88 bytes). p is the
// bf16 or f16 parameter of an f32 master w (master mode), or 0.
struct Entry {
  unsigned long long w, g, m, v, p;
  long long n, block0;
  float lr, wd, bc1, bc2;
  int w_type, g_type, mv_type, p_type;
};
static_assert(sizeof(Entry) == 88, "Entry layout");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// __float2bfloat16 and __float2half round to nearest even, as astype does
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16(x);
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half(x);
  else
    return x;
}

// One block's chunk [start, end) of entry e with its types fixed at
// compile time (W: w, G: g, M: m and v, P: the master's parameter, void
// for none), so the loop carries no per-element type test.
template <typename W, typename G, typename M, typename P>
__device__ __forceinline__ void update(const Entry& e, long long start,
                                       long long end, float b1, float b2,
                                       float eps) {
  W* w = reinterpret_cast<W*>(e.w);
  const G* g = reinterpret_cast<const G*>(e.g);
  M* m = reinterpret_cast<M*>(e.m);
  M* v = reinterpret_cast<M*>(e.v);
  const float decay = 1.f - e.lr * e.wd;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = to_f32(g[i]);
    float wi = to_f32(w[i]) * decay;
    const float mi = b1 * to_f32(m[i]) + (1.f - b1) * gi;
    const float vi = b2 * to_f32(v[i]) + (1.f - b2) * gi * gi;
    wi = wi - e.lr * (mi * e.bc1) / (sqrtf(vi * e.bc2) + eps);
    m[i] = from_f32<M>(mi);
    v[i] = from_f32<M>(vi);
    w[i] = from_f32<W>(wi);
    if constexpr (!std::is_void<P>::value)
      reinterpret_cast<P*>(e.p)[i] = from_f32<P>(wi);
  }
}

// The block's entry is one tensor, so its type codes are uniform over the
// block: dispatch once, outside the loop. Master mode (a parameter p) only
// comes with an f32 w and f32 moments.
template <typename W, typename G, typename M>
__device__ __forceinline__ void with_p(const Entry& e, long long start,
                                       long long end, float b1, float b2,
                                       float eps) {
  if constexpr (std::is_same<W, float>::value &&
                std::is_same<M, float>::value) {
    if (e.p && e.p_type == kBF16)
      return update<W, G, M, __nv_bfloat16>(e, start, end, b1, b2, eps);
    if (e.p)
      return update<W, G, M, __half>(e, start, end, b1, b2, eps);
  }
  update<W, G, M, void>(e, start, end, b1, b2, eps);
}

template <typename W, typename G>
__device__ __forceinline__ void with_m(const Entry& e, long long start,
                                       long long end, float b1, float b2,
                                       float eps) {
  if (e.mv_type == kBF16)
    with_p<W, G, __nv_bfloat16>(e, start, end, b1, b2, eps);
  else if (e.mv_type == kF16)
    with_p<W, G, __half>(e, start, end, b1, b2, eps);
  else
    with_p<W, G, float>(e, start, end, b1, b2, eps);
}

template <typename W>
__device__ __forceinline__ void with_g(const Entry& e, long long start,
                                       long long end, float b1, float b2,
                                       float eps) {
  if (e.g_type == kBF16)
    with_m<W, __nv_bfloat16>(e, start, end, b1, b2, eps);
  else if (e.g_type == kF16)
    with_m<W, __half>(e, start, end, b1, b2, eps);
  else
    with_m<W, float>(e, start, end, b1, b2, eps);
}

__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const Entry* __restrict__ table, int n_tensors,
                       float b1, float b2, float eps) {
  __shared__ int sel;
  if (threadIdx.x == 0) {
    // the last tensor whose first block is <= blockIdx.x
    int lo = 0, hi = n_tensors;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (table[mid].block0 <= (long long)blockIdx.x) lo = mid; else hi = mid;
    }
    sel = lo;
  }
  __syncthreads();
  const Entry e = table[sel];
  const long long start = ((long long)blockIdx.x - e.block0) * kChunk;
  const long long end = min(start + kChunk, e.n);
  if (e.w_type == kBF16)
    with_g<__nv_bfloat16>(e, start, end, b1, b2, eps);
  else if (e.w_type == kF16)
    with_g<__half>(e, start, end, b1, b2, eps);
  else
    with_g<float>(e, start, end, b1, b2, eps);
}

}  // namespace

// table: device array of n_tensors entries, sorted by block0 with
// block0[0] == 0; n_blocks: the chunks of all tensors together. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fused_adamw(const void* table, int n_tensors,
                           long long n_blocks, float b1, float b2, float eps,
                           void* stream) {
  if (n_tensors <= 0 || n_blocks <= 0 || n_blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  fused_adamw_kernel<<<(unsigned)n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), n_tensors, b1, b2, eps);
  return (int)cudaGetLastError();
}

extern "C" int fused_adamw_chunk() { return kChunk; }
