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
// m and v are f32; w keeps its type (f32 or bf16, rounded to nearest even);
// g is f32 or bf16. The update is IN PLACE: w, m and v are overwritten
// where they lie, where the JAX kernel is functional and returns new
// arrays.
//
// Design. The Pallas kernel runs one grid per parameter over 512 x 128
// tiles. Here one launch covers every tensor: a device table holds one
// entry per tensor (pointers, element count, its own lr, wd, bc1 and bc2,
// dtypes, and the index of its first block); each block finds its tensor
// by a binary search of the first-block column, takes one chunk of
// kChunk elements of it, and reads each element of w, g, m and v once and
// writes w, m and v once, with neighbouring threads on neighbouring
// elements.
//
// Bound: bytes. ~12 flops per element against 28 bytes (f32 w and g: read
// w, g, m, v, write w, m, v), far below the ridge, so the floor is the
// bytes over 3.35 TB/s: 11.0 ms for the 1.3136 B parameters of gpt_1p3b.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;

// One tensor. Must match _ENTRY in fused_adamw.py (72 bytes).
struct Entry {
  unsigned long long w, g, m, v;
  long long n, block0;
  float lr, wd, bc1, bc2;
  int w_bf16, g_bf16;
};
static_assert(sizeof(Entry) == 72, "Entry layout");

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
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
  float* m = reinterpret_cast<float*>(e.m);
  float* v = reinterpret_cast<float*>(e.v);
  const void* g = reinterpret_cast<const void*>(e.g);
  const float decay = 1.f - e.lr * e.wd;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = load(g, i, e.g_bf16);
    float w = load(reinterpret_cast<const void*>(e.w), i, e.w_bf16) * decay;
    const float mi = b1 * m[i] + (1.f - b1) * gi;
    const float vi = b2 * v[i] + (1.f - b2) * gi * gi;
    w = w - e.lr * (mi * e.bc1) / (sqrtf(vi * e.bc2) + eps);
    m[i] = mi;
    v[i] = vi;
    if (e.w_bf16)
      reinterpret_cast<__nv_bfloat16*>(e.w)[i] = __float2bfloat16(w);
    else
      reinterpret_cast<float*>(e.w)[i] = w;
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
