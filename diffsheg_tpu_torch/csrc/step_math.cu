// Fused eta=0 DDIM + RePaint step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_ddim_repaint_step of
// diffsheg_tpu/ops/step_math.py (_kernel :82, call :153).  From the
// sample x and the model's epsilon (B, T, C), with the level's scalars
// ab_prev, r = sqrt(1/ab), rm1 = sqrt(1/ab - 1) and prev_valid:
//
//   x0   = r x - rm1 eps
//   mean = sqrt(ab_prev) x0 + sqrt(1 - ab_prev) eps
//   head = saved tail if (has_tail and prev_valid > 0)
//          else sqrt(ab_prev) gt + sqrt(1 - ab_prev) gt_noise
//   head = head (1 - w) + mean w, w = t / max(ov - 1, 1),
//          when add_blend and sqrt(1 - ab_prev) < 0.2
//   out  = head on the first ov frames (with has_gt), mean elsewhere
//
// What bounds it.  A pure elementwise pass: it reads x and eps once,
// on the first ov frames the valid tail or else gt and gt_noise, and
// writes out once (~0.08 MB at BEAT's (1, 34, 192) with a valid tail),
// so bytes bind (0.0000243 ms), and at that size the launch dominates.
//
// What the design does.  A block row takes one frame row (b, t) of the
// (B, T, C) arrays per step of a loop over rows, so a thread learns t and
// b from its 32-bit row index once per row, with no division per element;
// each thread takes V = 4 consecutive channels with float4 loads and
// stores when C % 4 == 0 and the pointers are 16-byte aligned (the launch
// plan, ops/step_math.py::_step_plan, decides), else V = 1.  The four
// scalars and the switches are kernel arguments (the host holds them
// already, so no device table and no sync).  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), in the
// plain version's order, so the kernel gives the plain PyTorch version's
// bits, and a level whose sqrt(1 - ab_prev) lies next to 0.2 takes the
// same branch in both.
//
// C interface (ctypes): diffsheg_ddim_repaint_step(x, eps, gt, gt_noise,
// tail, out, B, T, C, ov, ab_prev, r, rm1, prev_valid, has_gt, has_tail,
// add_blend, vec, threads, grid_x, grid_y, stream) returns a cudaError_t
// code (0 = launched).  All tensors float32; gt, gt_noise and tail may be
// null when unused; vec, threads and the grid are the plan's.
// diffsheg_empty_launch(grid_x, grid_y, threads, stream) launches a kernel
// that does nothing with the same shape: the floor a launch of the step
// kernel stands on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> ld(const float* p) {
  if constexpr (V == 1) {
    return {{p[0]}};
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    return {{f.x, f.y, f.z, f.w}};
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const Vec<V>& o) {
  if constexpr (V == 1) {
    p[0] = o.x[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(o.x[0], o.x[1], o.x[2], o.x[3]);
  }
}

template <int V>
__global__ void ddim_repaint_step_kernel(const float* __restrict__ x,
                                         const float* __restrict__ eps,
                                         const float* __restrict__ gt,
                                         const float* __restrict__ gt_noise,
                                         const float* __restrict__ tail,
                                         float* __restrict__ out, int rows,
                                         int T, int C, int ov, float ab_prev,
                                         float r, float rm1, float prev_valid,
                                         int has_gt, int has_tail,
                                         int add_blend) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= C) return;
  const float sqrt_ab_prev = sqrtf(ab_prev);
  const float noise_w = sqrtf(__fsub_rn(1.f, ab_prev));
  const bool use_tail = has_tail && prev_valid > 0.f;
  const bool blend = add_blend && noise_w < 0.2f;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t i = (size_t)row * C + c;
    const int t = row % T;
    const Vec<V> xv = ld<V>(x + i), e = ld<V>(eps + i);
    Vec<V> mean;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float x0 = __fsub_rn(__fmul_rn(r, xv.x[u]), __fmul_rn(rm1, e.x[u]));
      mean.x[u] = __fadd_rn(__fmul_rn(sqrt_ab_prev, x0), __fmul_rn(noise_w, e.x[u]));
    }
    if (!has_gt || t >= ov) {
      st<V>(out + i, mean);
      continue;
    }
    Vec<V> head;
    if (use_tail) {
      head = ld<V>(tail + ((size_t)(row / T) * ov + t) * C + c);
    } else {
      const Vec<V> g = ld<V>(gt + i), n = ld<V>(gt_noise + i);
#pragma unroll
      for (int u = 0; u < V; ++u)
        head.x[u] = __fadd_rn(__fmul_rn(sqrt_ab_prev, g.x[u]), __fmul_rn(noise_w, n.x[u]));
    }
    if (blend) {
      const float w = __fdiv_rn((float)t, (float)max(ov - 1, 1));
#pragma unroll
      for (int u = 0; u < V; ++u)
        head.x[u] = __fadd_rn(__fmul_rn(head.x[u], __fsub_rn(1.f, w)),
                              __fmul_rn(mean.x[u], w));
    }
    st<V>(out + i, head);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int diffsheg_ddim_repaint_step(
    const float* x, const float* eps, const float* gt, const float* gt_noise,
    const float* tail, float* out, int B, int T, int C, int ov, float ab_prev,
    float r, float rm1, float prev_valid, int has_gt, int has_tail,
    int add_blend, int vec, int threads, int grid_x, int grid_y,
    void* stream) {
  const long long rows = (long long)B * T;
  const int V = vec ? 4 : 1;
  if (B < 1 || T < 1 || C < 1 || rows > 0x7fffffffLL ||
      (has_gt && (gt == nullptr || gt_noise == nullptr || ov < 1 || ov > T)) ||
      (has_tail && tail == nullptr) || (vec && C % 4) || threads < 1 ||
      threads > 1024 || grid_x < 1 || grid_y < 1 || grid_y > 65535 ||
      (long long)grid_x * threads * V < C)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    ddim_repaint_step_kernel<4><<<grid, threads, 0, s>>>(
        x, eps, gt, gt_noise, tail, out, (int)rows, T, C, ov, ab_prev, r, rm1,
        prev_valid, has_gt, has_tail, add_blend);
  else
    ddim_repaint_step_kernel<1><<<grid, threads, 0, s>>>(
        x, eps, gt, gt_noise, tail, out, (int)rows, T, C, ov, ab_prev, r, rm1,
        prev_valid, has_gt, has_tail, add_blend);
  return (int)cudaGetLastError();
}

extern "C" int diffsheg_empty_launch(int grid_x, int grid_y, int threads,
                                     void* stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
