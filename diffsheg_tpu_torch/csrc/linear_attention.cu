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
// 4 B T D elements.  The shapes split in two regimes.  The sampler's
// branch rows (B 1-2, T 12-88, D 512, H 8, hd 64) are 0.1-1.4 MB: there is
// nothing to stream, and the time is the kernel's critical path.  The
// level cache's audio encoder gives B = 750 rows of (34, 128), H 8 (hd
// 16): 52 MB, bound by bytes (15.6 us at 3.35 TB/s).
//
// What the design does.  A block takes one batch row, a group of `heads`
// heads and `width` of the hd output columns of ctx and y; the launch plan
// (ops/linear_attention.py::_launch_plan) picks them.  At small B*H it
// splits each (row, head) over hd / width blocks, so the card's SMs share
// the critical path; every block recomputes both softmaxes (cheap) and
// builds only its columns of ctx and y, so no product is done twice.  At
// narrow heads (hd <= 16) with many rows a block takes several heads of
// one row, so its loads run over whole rows of D.  In the staged mode all
// of T of q and k and the block's columns of v are copied into shared
// memory once, 16 bytes a copy, every copy in flight before the first is
// used (f32 by cp.async; bf16 through registers, widened):
//   1. per column of k, its max over T (a column's rows striped over a
//      few neighbouring lanes, combined by shuffles), then exp(k - max)
//      in place; in the same pass, per (time row, head) of q, its max
//      and the sum of exp(q - max) (a few lanes per row, shuffles), the
//      exponentials in place;
//   2. ctx = exp(k)^T v over the block's columns, each thread holding
//      quads of four columns in registers with float4 reads of v, the
//      rows split over lanes; each column's sum of exp(k) is taken on the
//      way and ctx divided by it;
//   3. y = exp(q) ctx / row sum, four columns a thread, the reduction over
//      d split over lanes, stored with one 16-byte store.
// Three block barriers.  The time is each phase's dependent chain, so the
// main path's plans run kernels compiled for their head width, columns
// and heads a block (their divisions and lane counts fold away), with 256
// threads, or 512 from T 64 on.  A masked key (-1e6 + logit) stays exact
// in f32.  When whole-T staging does not fit in a block's 227 KB, the
// tiled mode runs the same steps over tiles of `tile_rows` rows (k read
// twice: for its max, then for ctx), so any T works.  Head widths that
// are not a multiple of four (or unaligned pointers) take the same code
// with single columns (V = 1).  expf and the divisions stay IEEE (no
// --use_fast_math).
//
// C interface (ctypes): diffsheg_linear_attention(dtype, q, k, v, out,
// B, T, D, H, heads, width, tile_rows, staged, vec, threads, smem_bytes,
// stream) returns a cudaError_t code (0 = launched); dtype 0 = float32, 1 =
// bfloat16; the plan's fields as ops/linear_attention.py computes them
// (the kernel checks them and the shared bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HDMAX = 512;            // largest head width: a thread a
                                      // column of k
constexpr int ACC = 16;               // ctx accumulators per thread
constexpr int UNROLL = 8;             // loads in flight per thread, staging
constexpr int QV = 16;                // values of a q row a lane, at most
constexpr int QB = 4;                 // values of a q row a lane loads at once
constexpr int KV = 4;                 // rows of a k column a lane loads at once
constexpr int PAD = 4;                // floats after each staged row
constexpr int SMEM_MAX = 232448;      // shared bytes a block can use
constexpr int MAX_DEVICES = 64;

template <int V>
struct Vec {
  float x[V];
};

__device__ __forceinline__ void gload(const float* p, Vec<1>& o) { o.x[0] = p[0]; }
__device__ __forceinline__ void gload(const __nv_bfloat16* p, Vec<1>& o) {
  o.x[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void gload(const float* p, Vec<4>& o) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o.x[0] = f.x; o.x[1] = f.y; o.x[2] = f.z; o.x[3] = f.w;
}
__device__ __forceinline__ void gload(const __nv_bfloat16* p, Vec<4>& o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o.x[0] = a.x; o.x[1] = a.y; o.x[2] = b.x; o.x[3] = b.y;
}
__device__ __forceinline__ void gstore(float* p, const Vec<1>& o) { p[0] = o.x[0]; }
__device__ __forceinline__ void gstore(__nv_bfloat16* p, const Vec<1>& o) {
  p[0] = __float2bfloat16(o.x[0]);
}
__device__ __forceinline__ void gstore(float* p, const Vec<4>& o) {
  *reinterpret_cast<float4*>(p) = make_float4(o.x[0], o.x[1], o.x[2], o.x[3]);
}
__device__ __forceinline__ void gstore(__nv_bfloat16* p, const Vec<4>& o) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(o.x[0], o.x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(o.x[2], o.x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
template <int V>
__device__ __forceinline__ Vec<V> sload4(const float* p) {
  if constexpr (V == 1) {
    return {{p[0]}};
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    return {{f.x, f.y, f.z, f.w}};
  }
}
template <int V>
__device__ __forceinline__ void sstore4(float* p, const Vec<V>& o) {
  if constexpr (V == 1) {
    p[0] = o.x[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(o.x[0], o.x[1], o.x[2], o.x[3]);
  }
}

// V floats from global to shared memory, asynchronously (cp.async: 16
// bytes bypass L1, 4 bytes through it)
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// max / sum over groups of `lanes` neighbouring lanes (a power of two, at
// most 32; the same in the whole warp), unrolled
__device__ __forceinline__ float warp_max(float x, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// shared floats of a plan: k (and q, when staged) tiles of LQ, v of LV,
// ctx (heads * hd x width), the row sums of exp(q) (tile_rows x heads)
__host__ __device__ inline long long smem_floats(int hd, int heads, int width,
                                                 int rows, bool staged) {
  const long long cw = (long long)heads * hd, lq = cw + PAD,
                  lv = (long long)heads * width + PAD;
  return rows * (lq * (staged ? 2 : 1) + lv) + cw * width + (long long)rows * heads;
}

// HD, WD, HBC: the head width, output columns a block and heads a block
// fixed at compile time for the main path's plans (0: read at run time),
// so their divisions, loop bounds and lane counts fold away
template <typename E, int V, int NT, bool STAGED, int HD = 0, int WD = 0,
          int HBC = 0>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 1)
linear_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, E* __restrict__ out, int T,
                        int D, int H, int heads, int width, int TR) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int hd = HD ? HD : D / H, W = WD ? WD : width, HB = HBC ? HBC : heads;
  const int CW = HB * hd, S = hd / W, NG = H / HB;
  const int LQ = CW + PAD, LV = HB * W + PAD;
  const int j = blockIdx.x % S, g = (blockIdx.x / S) % NG,
            b = blockIdx.x / (S * NG);
  float* ks = sm;                                  // k tile, exp(k) in place
  float* qs = STAGED ? ks + TR * LQ : ks;          // tiled: k's buffer, reused
  float* vs = qs + TR * LQ;                        // the block's v columns
  float* cx = vs + TR * LV;                        // ctx, CW x W
  float* rsum = cx + CW * W;                       // sum of exp(q), TR x HB
  // element (b, t, column c of the block's heads) lies at g0 + t * D + c
  const size_t g0 = (size_t)b * T * D + (size_t)g * CW;
  const int per = W / V;                           // quads of a ctx row

  // rows [t0, t0 + rows) of q, k and / or v into shared memory: a staged
  // row is npr quads (q's, k's, then the block's v columns), walked by
  // (row, quad) without a division per quad.  f32 is copied by cp.async,
  // every copy in flight at once and no register held; bf16 is widened
  // through registers, every load of a round issued before the first store
  auto stage = [&](int t0, int rows, bool wq, bool wk, bool wv) {
    const int nq = wq ? CW / V : 0, nk = wk ? CW / V : 0;
    const int npr = nq + nk + (wv ? HB * per : 0);
    const int dr = NT / npr, dc = NT % npr;
    int r = tid / npr, c = tid % npr;
    // quad (r, c): its source, and its place in shared memory
    auto locate = [&](const E*& src) -> int {
      const size_t row = g0 + (size_t)(t0 + r) * D;
      if (c < nq) {
        src = q + row + c * V;
        return (int)(qs - sm) + r * LQ + c * V;
      }
      if (c < nq + nk) {
        const int cc = (c - nq) * V;
        src = k + row + cc;
        return r * LQ + cc;
      }
      const int cv = c - nq - nk, hh = cv / per, cc = (cv % per) * V;
      src = v + row + hh * hd + j * W + cc;
      return (int)(vs - sm) + r * LV + hh * W + cc;
    };
    auto next = [&]() {
      r += dr;
      c += dc;
      if (c >= npr) {
        c -= npr;
        ++r;
      }
    };
    if constexpr (std::is_same<E, float>::value) {
      for (; r < rows; next()) {
        const E* src;
        cp_async<V>(sm + locate(src), src);
      }
      cp_async_wait_all();
    } else {
      while (r < rows) {
        Vec<V> buf[UNROLL];
        int dst[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          dst[u] = -1;
          if (r < rows) {
            const E* src;
            dst[u] = locate(src);
            gload(src, buf[u]);
          }
          next();
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (dst[u] >= 0) sstore4<V>(sm + dst[u], buf[u]);
      }
    }
  };

  // per (time row, head) of a staged q tile: exp(q - max) in place and
  // its sum in rsum[head * rows + row]; G2 neighbouring lanes a row (at
  // most QV values a lane, more lanes while one round holds every row),
  // neighbouring rows on neighbouring lane groups
  auto q_stats = [&](int rows) {
    const int nseg = rows * HB;
    int G2 = 1;
    while (G2 * QV < hd) G2 <<= 1;
    while (G2 < 32 && G2 < hd && nseg * G2 * 2 <= NT) G2 <<= 1;
    for (int s0 = 0; s0 < nseg; s0 += NT / G2) {
      const int seg = s0 + tid / G2, l = tid % G2;
      const bool act = seg < nseg;
      const int r = HBC == 1 ? seg : seg % rows, hh = HBC == 1 ? 0 : seg / rows;
      float* row = qs + (act ? r * LQ + hh * hd : 0);
      // the lane's values in batches of QB, each batch's loads issued
      // together (max, then exponentials)
      float mx = -INFINITY;
#pragma unroll 1
      for (int c0 = l; c0 < hd; c0 += G2 * QB) {
        float x[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int c = c0 + u * G2;
          x[u] = act && c < hd ? row[c] : -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) mx = fmaxf(mx, x[u]);
      }
      mx = warp_max(mx, G2);
      float s = 0.f;
#pragma unroll 1
      for (int c0 = l; c0 < hd; c0 += G2 * QB) {
        float x[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int c = c0 + u * G2;
          if (act && c < hd) x[u] = row[c];
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int c = c0 + u * G2;
          if (act && c < hd) {
            const float e = expf(x[u] - mx);
            row[c] = e;
            s += e;
          }
        }
      }
      s = warp_sum(s, G2);
      if (act && l == 0) rsum[seg] = s;
    }
  };

  // k's columns: G neighbouring lanes a column, rows striped over them
  int G = 32;
  while (G > 1 && CW * G > NT) G >>= 1;
  const int kc = tid / G, kst = tid % G;
  const bool kact = kc < CW;

  if constexpr (STAGED) {
    stage(0, T, true, true, true);
    __syncthreads();
  }
  // 1. the max of each column of k over T
  float m = -INFINITY;
  for (int t0 = 0; t0 < T; t0 += TR) {
    const int rows = min(TR, T - t0);
    if constexpr (!STAGED) {
      stage(t0, rows, false, true, false);
      __syncthreads();
    }
#pragma unroll 1
    for (int r0 = kact ? kst : rows; r0 < rows; r0 += G * KV) {
      float x[KV];
#pragma unroll
      for (int u = 0; u < KV; ++u) {
        const int r = r0 + u * G;
        x[u] = r < rows ? ks[r * LQ + kc] : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < KV; ++u) m = fmaxf(m, x[u]);
    }
    if constexpr (!STAGED) __syncthreads();
  }
  m = warp_max(m, G);

  // 2. exp(k - max) in place, then ctx = exp(k)^T v / column sum, quads of
  //    V columns (d, l..l+V) a thread per round, rows split over P lanes
  const int nquad = CW * per;
  int P = 8;
  while (P > 1 && nquad * P > NT) P >>= 1;
  const int nround = (nquad + NT / P - 1) / (NT / P);   // <= ACC / V (plan)
  const int p = tid % P;
  float acc[ACC / V][V], colsum[ACC / V];
#pragma unroll
  for (int i = 0; i < ACC / V; ++i) {
    colsum[i] = 0.f;
#pragma unroll
    for (int x = 0; x < V; ++x) acc[i][x] = 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += TR) {
    const int rows = min(TR, T - t0);
    if constexpr (!STAGED) {
      stage(t0, rows, false, true, true);
      __syncthreads();
    }
#pragma unroll 1
    for (int r0 = kact ? kst : rows; r0 < rows; r0 += G * KV) {
      float x[KV];
#pragma unroll
      for (int u = 0; u < KV; ++u) {
        const int r = r0 + u * G;
        if (r < rows) x[u] = ks[r * LQ + kc];
      }
#pragma unroll
      for (int u = 0; u < KV; ++u) {
        const int r = r0 + u * G;
        if (r < rows) ks[r * LQ + kc] = expf(x[u] - m);
      }
    }
    if constexpr (STAGED) q_stats(T);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC / V; ++i) {
      const int qd = i * (NT / P) + tid / P;
      if (i < nround && qd < nquad) {
        const int d = qd / per, l = (qd % per) * V;
        const float* kp = ks + d;
        const float* vp = vs + (d / hd) * W + l;
        float cs = colsum[i];
#pragma unroll 2
        for (int r = p; r < rows; r += P) {
          const float a = kp[r * LQ];
          const Vec<V> vv = sload4<V>(vp + r * LV);
          cs += a;
#pragma unroll
          for (int x = 0; x < V; ++x) acc[i][x] += a * vv.x[x];
        }
        colsum[i] = cs;
      }
    }
    if constexpr (!STAGED) __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ACC / V; ++i) {
    if (i >= nround) break;
    colsum[i] = warp_sum(colsum[i], P);
#pragma unroll
    for (int x = 0; x < V; ++x) acc[i][x] = warp_sum(acc[i][x], P);
    const int qd = i * (NT / P) + tid / P;
    if (p == 0 && qd < nquad) {
      const int d = qd / per, l = (qd % per) * V;
      Vec<V> c;
#pragma unroll
      for (int x = 0; x < V; ++x) c.x[x] = acc[i][x] / colsum[i];
      sstore4<V>(cx + d * W + l, c);
    }
  }
  __syncthreads();

  // 3. y = exp(q) ctx / row sum, V columns a thread, d split over P2
  //    lanes; neighbouring threads take the column quads, then the rows,
  //    of one head, so a warp's reads of q fall on distinct banks
  for (int t0 = 0; t0 < T; t0 += TR) {
    const int rows = min(TR, T - t0);
    if constexpr (!STAGED) {
      stage(t0, rows, true, false, false);
      __syncthreads();
      q_stats(rows);
      __syncthreads();
    }
    const int nyq = rows * HB * per;
    int P2 = 8;
    while (P2 > 1 && nyq * P2 > NT) P2 >>= 1;
    const int p2 = tid % P2;
    for (int y0 = 0; y0 < nyq; y0 += NT / P2) {
      const int yq = y0 + tid / P2;
      const bool act = yq < nyq;
      const int rr = yq / per, l = (yq % per) * V;
      const int r = !act ? 0 : HBC == 1 ? rr : rr % rows;
      const int hh = HBC == 1 ? 0 : rr / rows;
      float a[V];
#pragma unroll
      for (int x = 0; x < V; ++x) a[x] = 0.f;
      if (act) {
        const float* qp = qs + r * LQ + hh * hd;
        const float* cp = cx + hh * hd * W + l;
#pragma unroll 2
        for (int d = p2; d < hd; d += P2) {
          const float e = qp[d];
          const Vec<V> c = sload4<V>(cp + d * W);
#pragma unroll
          for (int x = 0; x < V; ++x) a[x] += e * c.x[x];
        }
      }
#pragma unroll
      for (int x = 0; x < V; ++x) a[x] = warp_sum(a[x], P2);
      if (act && p2 == 0) {
        const float s = rsum[hh * rows + r];
        Vec<V> o;
#pragma unroll
        for (int x = 0; x < V; ++x) o.x[x] = a[x] / s;
        gstore(out + g0 + (size_t)(t0 + r) * D + hh * hd + j * W + l, o);
      }
    }
    if constexpr (!STAGED) __syncthreads();
  }
}

template <typename E, int V, int NT, bool STAGED, int HD = 0, int WD = 0,
          int HBC = 0>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int D, int H, int heads, int width, int tile_rows, int smem,
           cudaStream_t stream) {
  auto kernel = linear_attention_kernel<E, V, NT, STAGED, HD, WD, HBC>;
  // above 48 KB a block's shared memory is opt-in, once per device
  static bool opted[MAX_DEVICES];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
      if (err != cudaSuccess) return (int)err;
      opted[dev] = true;
    }
  }
  const long long grid = (long long)B * (H / heads) * ((D / H) / width);
  kernel<<<(unsigned)grid, NT, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), T, D, H, heads, width,
      tile_rows);
  return (int)cudaGetLastError();
}

// the main path's plans (ops/linear_attention.py::_launch_plan) run
// kernels specialised to their shape; every other plan the general ones
template <typename E>
int launch_typed(int vec, int threads, int staged, const void* q,
                 const void* k, const void* v, void* out, int B, int T, int D,
                 int H, int heads, int width, int tile_rows, int smem,
                 cudaStream_t s) {
  const int hd = D / H;
#define ARGS q, k, v, out, B, T, D, H, heads, width, tile_rows, smem, s
  if (vec && hd == 64 && heads == 1) {            // branch rows, hd 64
    if (width == 4 && threads == 256 && staged)
      return launch<E, 4, 256, true, 64, 4, 1>(ARGS);
    if (width == 8 && threads == 512 && staged)
      return launch<E, 4, 512, true, 64, 8, 1>(ARGS);
    if (width == 4 && threads == 512 && !staged)
      return launch<E, 4, 512, false, 64, 4, 1>(ARGS);
  }
  if (vec && hd == 16 && heads == 8 && width == 16 && threads == 256 && staged)
    return launch<E, 4, 256, true, 16, 16, 8>(ARGS);  // audio encoder
  if (threads == 512) {
    if (vec)
      return staged ? launch<E, 4, 512, true>(ARGS) : launch<E, 4, 512, false>(ARGS);
    return staged ? launch<E, 1, 512, true>(ARGS) : launch<E, 1, 512, false>(ARGS);
  }
  if (vec)
    return staged ? launch<E, 4, 256, true>(ARGS) : launch<E, 4, 256, false>(ARGS);
  return staged ? launch<E, 1, 256, true>(ARGS) : launch<E, 1, 256, false>(ARGS);
#undef ARGS
}

}  // namespace

extern "C" int diffsheg_linear_attention(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* out, int B, int T, int D,
                                         int H, int heads, int width,
                                         int tile_rows, int staged, int vec,
                                         int threads, int smem_bytes,
                                         void* stream) {
  if (B < 1 || T < 1 || H < 1 || D % H || D / H > HDMAX || heads < 1 ||
      H % heads || width < 1 || (D / H) % width ||
      (threads != 256 && threads != 512))
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const long long grid = (long long)B * (H / heads) * (hd / width);
  if (heads * hd > threads || heads * hd * width > threads * ACC ||
      (vec && (hd % 4 || width % 4)) || grid > 0x7fffffffLL ||
      (staged ? tile_rows != T : (tile_rows < 1 || tile_rows > T)) ||
      (long long)smem_bytes != 4 * smem_floats(hd, heads, width, tile_rows, staged) ||
      smem_bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_typed<__nv_bfloat16>(vec, threads, staged, q, k, v, out,
                                           B, T, D, H, heads, width, tile_rows,
                                           smem_bytes, s)
             : launch_typed<float>(vec, threads, staged, q, k, v, out, B, T, D,
                                   H, heads, width, tile_rows, smem_bytes, s);
}
