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
// w keeps its type (f32 or bf16, rounded to nearest even); g is f32 or
// bf16; m and v are f32, or bf16 (stored rounded to nearest even: O2
// without master weights, where the JAX optimizer keeps a bf16 parameter's
// moments in bf16 and casts the kernel's f32 results back,
// paddle_tpu/optimizer/optimizers.py:155-156). Master mode
// (paddle_tpu/optimizer/optimizer.py:107-152, multi_precision): w is the
// f32 master of a bf16 parameter p, and the same pass also writes
// p <- bf16(w), as the JAX step's new_w.astype(bf16) does. The update is
// IN PLACE: w, m, v (and p) are overwritten where they lie, where the JAX
// kernel is functional and returns new arrays.
//
// Design. The Pallas kernel runs one grid per parameter over 512 x 128
// tiles. Here one launch covers every tensor: a device table holds one
// entry per tensor (pointers, element count, its own lr, wd, bc1 and bc2,
// dtypes, and the index of its first block), so one step is one launch
// whatever mix of modes its tensors hold; each block finds its tensor
// by a binary search of the first-block column, takes one chunk of
// kChunk elements of it, and reads each element of w, g, m and v once and
// writes w, m and v (and p) once, with neighbouring threads on neighbouring
// elements.
//
// Bound: bytes. ~12 flops per element against 28 bytes (f32 w and g: read
// w, g, m, v, write w, m, v), far below the ridge, so the floor is the
// bytes over 3.35 TB/s: 11.0 ms for the 1.3136 B parameters of gpt_1p3b.
// Master mode moves 28 bytes too (read g 2 + w 4 + m 4 + v 4, write w 4 +
// m 4 + v 4 + p 2), the same 11.0 ms; bf16 moments with a bf16 w and g
// move 14.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;

// One tensor. Must match _ENTRY in fused_adamw.py (88 bytes). p is the
// bf16 parameter of an f32 master w (master mode), or 0.
struct Entry {
  unsigned long long w, g, m, v, p;
  long long n, block0;
  float lr, wd, bc1, bc2;
  int w_bf16, g_bf16, mv_bf16, pad;
};
static_assert(sizeof(Entry) == 88, "Entry layout");

__device__ __forceinline__ float load(unsigned long long p, long long i,
                                      int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// __float2bfloat16 rounds to nearest even, as astype(bfloat16) does
__device__ __forceinline__ void store(unsigned long long p, long long i,
                                      float x, int bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    reinterpret_cast<float*>(p)[i] = x;
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
  const float decay = 1.f - e.lr * e.wd;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = load(e.g, i, e.g_bf16);
    float w = load(e.w, i, e.w_bf16) * decay;
    const float mi = b1 * load(e.m, i, e.mv_bf16) + (1.f - b1) * gi;
    const float vi = b2 * load(e.v, i, e.mv_bf16) + (1.f - b2) * gi * gi;
    w = w - e.lr * (mi * e.bc1) / (sqrtf(vi * e.bc2) + eps);
    store(e.m, i, mi, e.mv_bf16);
    store(e.v, i, vi, e.mv_bf16);
    store(e.w, i, w, e.w_bf16);
    if (e.p) reinterpret_cast<__nv_bfloat16*>(e.p)[i] = __float2bfloat16(w);
  }
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
