// Linear-attention core for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_linear_attention of
// diffsheg_tpu/ops/linear_attention.py (_kernel :69, _pallas_forward :92,
// custom VJP :114).  Per (batch row, head) of pre-softmax, pre-masked
// q, k, v (B, T, D), head width hd = D / H:
//
//   k' = softmax(k, axis=time)      ctx = k'^T v    (hd x hd, f32)
//   q' = softmax(q, axis=feature)   y   = q' ctx    (T x hd)
//
// everything in f32 (bf16 inputs are widened), ctx kept in f32 (the
// Pallas kernel's numerics, not the bf16 composition's), the output in
// the input dtype.  The backward is the plain composition (PyTorch
// autograd, ops/linear_attention.py), as the JAX custom VJP's is.
//
// What bounds it.  The function reads q, k, v once and writes y once:
// 4 B T D elements.  At the shapes the sampler gives it (B 1-2, T 34-88,
// D 512, H 8) that is 0.3-1.4 MB against ~4.5-12 MFLOP of contraction,
// so bytes bind, and at ~0.1-0.4 us the launch itself dominates.  The
// level cache's audio encoder gives it B = 750 rows of (34, 128), H 8
// (hd 16): 52 MB, again bytes.
//
// What the design does.  The TPU kernel's grid runs one batch row per
// step with a static loop over heads, all of T resident in VMEM.  Here
// one block takes one (row, head) pair, so the 750-row case fills the
// card and every shape runs on one code path: the block loops over T in
// tiles of TT rows held in shared memory.
//   1. column max of k over T, then the column sum of exp(k - max):
//      256 threads as (feature column, row stripe), stripes combined in
//      shared memory; a masked key (-1e6 + logit) stays exact in f32;
//   2. ctx accumulated over the tiles of k' and v, each thread holding
//      hd*hd / 256 entries of ctx in registers, then ctx to shared memory
//      (at most 64 x 64 x 4 = 16 KB);
//   3. per tile of q: the feature softmax of each row, then y = q' ctx.
// expf and the divisions stay IEEE (no --use_fast_math).  A simple
// kernel: with hd 16 most of a block's threads idle in step 2, and no
// tile is prefetched while the previous one is used.
//
// C interface (ctypes): diffsheg_linear_attention(dtype, q, k, v, out,
// B, T, D, H, stream) returns a cudaError_t code (0 = launched); dtype
// 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int TT = 32;                // rows of T per tile
constexpr int HDMAX = 64;             // largest head width
constexpr int LD = HDMAX + 1;         // padded tile row (no bank conflicts)
constexpr int NACC = HDMAX * HDMAX / NT;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename W>
__global__ void __launch_bounds__(NT)
linear_attention_kernel(const W* __restrict__ q, const W* __restrict__ k,
                        const W* __restrict__ v, W* __restrict__ out,
                        int T, int D, int H) {
  __shared__ float ctx[HDMAX * HDMAX];
  __shared__ float ta[TT * LD];       // k' tile, then q / q' tile
  __shared__ float tb[TT * LD];       // v tile
  __shared__ float part[NT];
  __shared__ float colmax[HDMAX], colsum[HDMAX];

  const int hd = D / H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  // element (b, t, h, c) lies at base + t * D + c
  const size_t base = (size_t)b * T * D + (size_t)h * hd;

  // 1. time softmax statistics of k, per feature column
  const int stripes = NT / hd, c = tid % hd, s = tid / hd;
  float m = -INFINITY;
  if (s < stripes)
    for (int t = s; t < T; t += stripes) m = fmaxf(m, ld(k, base + (size_t)t * D + c));
  part[tid] = m;
  __syncthreads();
  if (tid < hd) {
    float mm = part[tid];
    for (int j = 1; j < stripes; ++j) mm = fmaxf(mm, part[j * hd + tid]);
    colmax[tid] = mm;
  }
  __syncthreads();
  float sum = 0.f;
  if (s < stripes)
    for (int t = s; t < T; t += stripes)
      sum += expf(ld(k, base + (size_t)t * D + c) - colmax[c]);
  part[tid] = sum;
  __syncthreads();
  if (tid < hd) {
    float ss = part[tid];
    for (int j = 1; j < stripes; ++j) ss += part[j * hd + tid];
    colsum[tid] = ss;
  }
  __syncthreads();

  // 2. ctx = k'^T v over tiles of TT rows
  const int nctx = hd * hd;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int rows = min(TT, T - t0);
    for (int e = tid; e < rows * hd; e += NT) {
      const int r = e / hd, cc = e % hd;
      const size_t gi = base + (size_t)(t0 + r) * D + cc;
      ta[r * LD + cc] = expf(ld(k, gi) - colmax[cc]) / colsum[cc];
      tb[r * LD + cc] = ld(v, gi);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * NT;
      if (e < nctx) {
        const int d = e / hd, l = e % hd;
        float a = acc[i];
        for (int r = 0; r < rows; ++r) a += ta[r * LD + d] * tb[r * LD + l];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * NT;
    if (e < nctx) ctx[e] = acc[i];
  }
  __syncthreads();

  // 3. per tile of q: feature softmax of each row, then y = q' ctx
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int rows = min(TT, T - t0);
    for (int e = tid; e < rows * hd; e += NT) {
      const int r = e / hd, cc = e % hd;
      ta[r * LD + cc] = ld(q, base + (size_t)(t0 + r) * D + cc);
    }
    __syncthreads();
    if (tid < rows) {
      float* row = ta + tid * LD;
      float mx = -INFINITY;
      for (int j = 0; j < hd; ++j) mx = fmaxf(mx, row[j]);
      float sm = 0.f;
      for (int j = 0; j < hd; ++j) {
        const float ex = expf(row[j] - mx);
        row[j] = ex;
        sm += ex;
      }
      for (int j = 0; j < hd; ++j) row[j] = row[j] / sm;
    }
    __syncthreads();
    for (int e = tid; e < rows * hd; e += NT) {
      const int r = e / hd, l = e % hd;
      float a = 0.f;
      for (int d = 0; d < hd; ++d) a += ta[r * LD + d] * ctx[d * hd + l];
      st(out, base + (size_t)(t0 + r) * D + l, a);
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int D, int H, cudaStream_t stream) {
  linear_attention_kernel<W><<<B * H, NT, 0, stream>>>(
      static_cast<const W*>(q), static_cast<const W*>(k),
      static_cast<const W*>(v), static_cast<W*>(out), T, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int diffsheg_linear_attention(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* out, int B, int T, int D,
                                         int H, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D % H || D / H > HDMAX ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(q, k, v, out, B, T, D, H, s)
                    : launch<float>(q, k, v, out, B, T, D, H, s);
}
