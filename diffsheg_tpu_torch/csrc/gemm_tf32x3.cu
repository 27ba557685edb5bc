// Split-TF32 ("3xTF32") matrix product of f32 matrices on Hopper's tensor
// cores: C = A B (+ bias), f32-grade, for the three products of a dense
// layer's training step.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA's
// `dot`.  On the H100 an f32 product outside the tensor cores is bounded by
// the CUDA cores' 67 TFLOP/s, and cuBLAS's f32 kernels run near it; TF32 on
// the tensor cores runs at 495 TFLOP/s but keeps 11 significant bits.  Here
// each f32 operand x is two TF32 values, hi = rna(x) and lo = x - hi (which
// the tensor cores read truncated to TF32; x = hi + lo to 2^-22 relative),
// and a product accumulates lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of the
// product, is dropped): three TF32 products, so the bound is 495 / 3 =
// 165 TFLOP/s of f32-grade products.
//
// Layouts (row-major operands, as torch keeps them):
//   layout 0, NT: C[M,N] = A[M,K] B[N,K]^T + bias   (the forward, X W^T + b)
//   layout 1, NN: C[M,N] = A[M,K] B[K,N]            (dX = dY W)
//   layout 2, TN: C[M,N] = A[K,M]^T B[K,N]          (dW = dY^T X)
// wgmma takes TF32 operands only K-major, so a split step also transposes
// where a layout keeps an operand M- or N-major.
//
// Design.  A persistent, warp-specialised block per SM walks output tiles
// of 128 x 128 (BM x BN) over k-steps of 32 (BK):
// - one producer thread keeps TMA loads in flight into a ring of four
//   stages (mbarriers full / empty), all 128-byte swizzled so that the
//   split steps read them without bank conflicts; K-major tiles come as
//   one box, M- or N-major tiles as boxes of 32 x 32;
// - two consumer warpgroups (64 rows of the tile each) split their A rows
//   of each stage into registers (wgmma's register-A form, two sets, so
//   that the split of one k-step overlaps the products of the last), then
//   issue wgmma.m64n128k8.f32.tf32.tf32 three times per 8 columns of k:
//   the k-step's lo*hi and hi*lo first, its hi*hi last;
// - B: the weight of NT and NN (at most a few MB) is split beforehand, by
//   gemm_tf32x3_split_kernel, into hi and lo matrices, K-major (NN's
//   transposed), which TMA loads straight into wgmma's layout.  TN's B
//   (the layer's input, as long as the batch) arrives as f32 and the
//   consumers split and transpose it into a ring of three (hi, lo) tiles,
//   a barrier between the two warpgroups marking each one written (a
//   split of one stage, in shared memory, costs less than a pass over a
//   matrix of 85 000 rows);
// - the tensor cores add into their accumulator with truncation, so the
//   error grows with the length of a chain of wgmma into one accumulator
//   (measured: 3.6e-6 rel-RMS at K 512 and 1.5e-4 at K 85 000 in one
//   chain, against cuBLAS f32's 4e-7 and 1.3e-6).  Each k-step's chain
//   starts from zero and is added into an f32 sum of its own on the CUDA
//   cores; with the small terms first the chain truncates at the result's
//   scale only in its last four steps (1.5e-7 at K 512, 3.6e-7 to 6.7e-7
//   at K 85 000; interleaved, 1.8e-7 and 4.1e-7 to 7.0e-7, and training's
//   loss read twice as far from the f32 reference's);
// - the epilogue adds the bias and stores straight from the registers.
// A contraction too long for the tiles to fill the card (dW: over 85 000
// rows into a 1024 x 512 matrix) is split over k: each split writes its
// partial tile to scratch and gemm_tf32x3_reduce_kernel sums the splits in
// a fixed order.  There are no float atomics, so two calls on the same
// inputs give the same bits.
//
// Every kernel of the product has "gemm" in its name: the benchmark's
// products_ms_per_step.train reads product kernels by name.
//
// TMA needs 16-byte aligned rows: the inner dimension of every operand
// (K for K-major A and B, M for TN's A, N for N-major B) a multiple of 4;
// the C entry refuses anything else (-1) and unaligned pointers (-2).
// hi of a finite value within 2^-12 of the top of the f32 range rounds to
// infinity, as its products would overflow anyway.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;                 // tile rows: two warpgroups of 64
constexpr int BN = 128;                 // tile columns: one wgmma's N
constexpr int BK = 32;                  // k per stage: one 128-byte row
constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and the producer's warpgroup
constexpr int STAGES = 4;               // stages in the TMA ring
constexpr int SPLITS = 3;               // TN: (hi, lo) tiles of B in a ring
constexpr int A_BYTES = BM * BK * 4;    // 16 KB
constexpr int B_BYTES = BN * BK * 4;    // 16 KB, and as much for lo
constexpr int BOX = 32 * 32 * 4;        // an M- or N-major box, 4 KB
// a stage: A (f32), then B: hi and lo (split beforehand) or f32 (TN)
__host__ __device__ constexpr int stage_bytes(bool pre) { return A_BYTES + (pre ? 2 : 1) * B_BYTES; }
// TN's ring of (hi, lo) tiles after the stages, then the barriers
__host__ __device__ constexpr int hl_off(bool pre) { return STAGES * stage_bytes(pre); }
__host__ __device__ constexpr int bar_off(bool pre) {
  return hl_off(pre) + (pre ? 0 : SPLITS * 2 * B_BYTES);
}
__host__ __device__ constexpr int smem_bytes(bool pre) {
  return bar_off(pre) + 2 * STAGES * 8 + 1024;   // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed.  A wait of 2^37
// SM cycles (over a minute at the H100's clocks; a load that never lands)
// traps.  A trap is fatal to the process's CUDA context: every later CUDA
// call of the process fails, and the process has to exit.  It stands
// against the alternative, a kernel that never ends and holds the card
// until its process is killed.  The bound is far above any wait a sound
// launch sees, even with its context time-sliced against other processes
// on the card (slices of milliseconds).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 37)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile of 128-byte rows,
// 128-byte swizzled: 8-row groups 1024 bytes apart.  The tile is
// 1024-byte aligned; a step of 8 k (32 bytes) within the row moves the
// start address only.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// f32 -> TF32 rounded to nearest (ties away from zero; the low 13 bits
// zero) in two integer operations, as fused_layer.cu's tf32_rna.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi is x rounded to TF32, lo = x - hi exactly (at most
// 2^-11 |x|), which the tensor cores read truncated to TF32, so that x =
// hi + lo to 2^-22 relative.  An infinite x: lo = 0 (x - hi would be a
// NaN); a NaN x: lo is a NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  const float h = __uint_as_float(hi);
  lo = __float_as_uint(x == h ? 0.f : x - h);
}

__device__ __forceinline__ void split4(const float4& v, float4& h, float4& l) {
  uint32_t a, b;
  split_tf32(v.x, a, b); h.x = __uint_as_float(a); l.x = __uint_as_float(b);
  split_tf32(v.y, a, b); h.y = __uint_as_float(a); l.y = __uint_as_float(b);
  split_tf32(v.z, a, b); h.z = __uint_as_float(a); l.z = __uint_as_float(b);
  split_tf32(v.w, a, b); h.w = __uint_as_float(a); l.w = __uint_as_float(b);
}

// D (64 x 128, f32) = (scale_d ? D : 0) + A (64 x 8, TF32 in registers)
// B (8 x 128, TF32 in shared memory, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Ties registers to this point of the program: what reads them stays
// after it, and the compiler keeps them (no reuse for other values) up to
// it, while an asynchronous wgmma may still read them.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[q][i])::"memory");
}

// TN: B's f32 stage (B stored [K][N], boxes of 32 k x 32 n) -> TF32 hi and
// lo tiles, K-major, 128-byte swizzled: element (n, k) at byte n * 128 +
// ((k / 4) ^ (n % 8)) * 16 + (k % 4) * 4.  An item reads 4 k of column n
// (a warp: 32 n of one row, one 128-byte row of a box) and writes them as
// one 16-byte chunk; the consumers take 4 items each.
__device__ __forceinline__ void split_b(const uint8_t* stage, uint8_t* hi,
                                        uint8_t* lo, int tid) {
  const int n = tid & (BN - 1);
  const float* box = reinterpret_cast<const float*>(stage) + (n >> 5) * 1024;
  const int nc = (n & 31) >> 2, nw = n & 3;
#pragma unroll
  for (int i = 0; i < BK / 4 / (CONSUMERS / BN); ++i) {
    const int c = (tid / BN) + i * (CONSUMERS / BN);
    float4 v;
    v.x = box[(4 * c + 0) * 32 + ((nc ^ ((4 * c + 0) & 7)) << 2) + nw];
    v.y = box[(4 * c + 1) * 32 + ((nc ^ ((4 * c + 1) & 7)) << 2) + nw];
    v.z = box[(4 * c + 2) * 32 + ((nc ^ ((4 * c + 2) & 7)) << 2) + nw];
    v.w = box[(4 * c + 3) * 32 + ((nc ^ ((4 * c + 3) & 7)) << 2) + nw];
    float4 h, l;
    split4(v, h, l);
    const int o = n * 32 + ((c ^ (n & 7)) << 2);
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(hi) + o) = h;
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(lo) + o) = l;
  }
}

// A(r, k) of an f32 stage: K-major (A stored [M][K]: one box of BM rows of
// 32 k) or M-major (A stored [K][M]: boxes of 32 k rows x 32 m).
template <bool KMAJOR>
__device__ __forceinline__ float a_at(const float* sa, int r, int k) {
  if (KMAJOR) return sa[r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)];
  return sa[(r >> 5) * 1024 + k * 32 + ((((r & 31) >> 2) ^ (k & 7)) << 2) +
            (r & 3)];
}

// This thread's A fragments of the stage, split: for each 8 k (q), rows
// r0 = 16 * warp + g and r0 + 8 of the warpgroup's 64, columns t and t + 4
// (g = lane / 4, t = lane % 4), wgmma's register-A layout for TF32.
template <bool KMAJOR>
__device__ __forceinline__ void load_split_a(const float* sa, int r0, int t,
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split_tf32(a_at<KMAJOR>(sa, r0, 8 * q + t), hi[q][0], lo[q][0]);
    split_tf32(a_at<KMAJOR>(sa, r0 + 8, 8 * q + t), hi[q][1], lo[q][1]);
    split_tf32(a_at<KMAJOR>(sa, r0, 8 * q + t + 4), hi[q][2], lo[q][2]);
    split_tf32(a_at<KMAJOR>(sa, r0 + 8, 8 * q + t + 4), hi[q][3], lo[q][3]);
  }
}

struct Work {
  int m0, n0, kb0, kb1, split;
};

// Work unit u: splits outermost (units running together read the same
// rows of k), then row tiles, then column tiles (the blocks of one row
// tile read its A together).
__device__ __forceinline__ Work unit(int u, int tiles_m, int tiles_n,
                                     int k_steps, int kps) {
  const int tiles = tiles_m * tiles_n;
  const int split = u / tiles, r = u % tiles;
  Work w;
  w.m0 = (r / tiles_n) * BM;
  w.n0 = (r % tiles_n) * BN;
  w.kb0 = split * kps;
  w.kb1 = min(w.kb0 + kps, k_steps);
  w.split = split;
  return w;
}

// The consumers' state: each k-step's chain (wgmma's accumulator), the f32
// sum of the chains, two sets of A fragments (hi, lo).
struct Acc {
  float chain[64];
  float sum[64];
  uint32_t ahi[2][4][4];
  uint32_t alo[2][4][4];
};

// One k-step of a consumer warpgroup (`it` the block's running k-step, `j`
// the tile's), fragment set P = j % 2: split the stage while the last
// k-step's products run, then add that chain into the sum and issue this
// k-step's products.  PRE: B was split beforehand and lies in the stage;
// the stage is free once its products are done.  Otherwise (TN) B is split
// here into (hi, lo) tile it % 3, last read by the products of k-step
// it - 3, which both warpgroups waited for before the last barrier.
template <bool AK, bool PRE, int P>
__device__ __forceinline__ void k_step(Acc& st, uint8_t* smem, uint32_t full,
                                       uint32_t empty, int it, int j, int tid,
                                       int lane, int r0, int t) {
  const int s = it % STAGES;
  uint8_t* stage = smem + s * stage_bytes(PRE);
  mbar_wait(full + 8 * s, (it / STAGES) & 1);
  uint8_t* hi = stage + A_BYTES;
  if (!PRE) {
    hi = smem + hl_off(PRE) + (it % SPLITS) * 2 * B_BYTES;
    split_b(stage + A_BYTES, hi, hi + B_BYTES, tid);
  }
  load_split_a<AK>(reinterpret_cast<const float*>(stage), r0, t, st.ahi[P],
                   st.alo[P]);
  if (!PRE) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    // the split tiles visible to wgmma (the async proxy) of both
    // warpgroups
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(st.chain);
  fence_regs(st.ahi[1 - P]);
  fence_regs(st.alo[1 - P]);
  if (j > 0) {
    if (PRE) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) st.sum[i] += st.chain[i];
  }
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  const uint32_t hi_a = smem_u32(hi), lo_a = hi_a + B_BYTES;
  // the small terms first: while they are all the chain holds, its
  // truncation errors are ~2^-11 of the result's; the four hi*hi products
  // come last
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wgmma_tf32(st.chain, st.alo[P][q], kmajor_desc(hi_a + 32 * q), q > 0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wgmma_tf32(st.chain, st.ahi[P][q], kmajor_desc(lo_a + 32 * q), 1);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wgmma_tf32(st.chain, st.ahi[P][q], kmajor_desc(hi_a + 32 * q), 1);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// AK: A K-major (NT, NN) or M-major (TN).  PRE: B split beforehand into
// K-major hi (map_b) and lo (map_lo) (NT, NN), else f32 N-major (TN).
template <bool AK, bool PRE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_lo,
                       float* __restrict__ c, const float* __restrict__ bias,
                       int M, int N, int k_steps, int kps, int tiles_m,
                       int tiles_n, int units) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + bar_off(PRE), empty = full + STAGES * 8;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer's warpgroup gives its registers to the consumers; one
    // thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Work w = unit(u, tiles_m, tiles_n, k_steps, kps);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, stage_bytes(PRE));
          const uint32_t sa = base + s * stage_bytes(PRE);
          const uint32_t sb = sa + A_BYTES;
          const int k0 = kb * BK;
          if (AK) {
            tma_load(sa, &map_a, k0, w.m0, bar);
          } else {
#pragma unroll
            for (int i = 0; i < BM / 32; ++i)
              tma_load(sa + i * BOX, &map_a, w.m0 + 32 * i, k0, bar);
          }
          if (PRE) {
            tma_load(sb, &map_b, k0, w.n0, bar);
            tma_load(sb + B_BYTES, &map_lo, k0, w.n0, bar);
          } else {
#pragma unroll
            for (int i = 0; i < BN / 32; ++i)
              tma_load(sb + i * BOX, &map_b, w.n0 + 32 * i, k0, bar);
          }
        }
      }
    }
  } else {
    // the consumers: two warpgroups, 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 16 * warp + g;          // row of the tile (and r0 + 8)
    Acc st;
#pragma unroll
    for (int i = 0; i < 64; ++i) st.chain[i] = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) st.ahi[p][q][i] = st.alo[p][q][i] = 0u;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = unit(u, tiles_m, tiles_n, k_steps, kps);
      const int nk = w.kb1 - w.kb0;
#pragma unroll
      for (int i = 0; i < 64; ++i) st.sum[i] = 0.f;
      int j = 0;
      for (; j + 1 < nk; j += 2, it += 2) {
        k_step<AK, PRE, 0>(st, smem, full, empty, it, j, tid, lane, r0, t);
        k_step<AK, PRE, 1>(st, smem, full, empty, it + 1, j + 1, tid, lane, r0, t);
      }
      if (j < nk) {
        k_step<AK, PRE, 0>(st, smem, full, empty, it, j, tid, lane, r0, t);
        ++it;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(st.chain);
      fence_regs(st.ahi[0]);
      fence_regs(st.alo[0]);
      fence_regs(st.ahi[1]);
      fence_regs(st.alo[1]);
      if (PRE) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }

      // epilogue: rows r0, r0 + 8; columns 8 i + 2 t, + 1
      float* out = c + static_cast<size_t>(w.split) * M * N;
      const int row = w.m0 + r0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = w.n0 + 8 * i + 2 * t;
        if (col >= N) continue;            // N is even
        float2 b = make_float2(0.f, 0.f);
        if (bias) b = *reinterpret_cast<const float2*>(bias + col);
        const float* v = st.sum + 4 * i;
        const float* d = st.chain + 4 * i;
        if (row < M)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
              make_float2(v[0] + d[0] + b.x, v[1] + d[1] + b.y);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
              make_float2(v[2] + d[2] + b.x, v[3] + d[3] + b.y);
      }
    }
  }
}

// NT and NN: B (rows x cols, row-major) -> hi, lo (N x K, K-major): B
// itself (NT: rows N, cols K) or its transpose (NN: rows K, cols N),
// through a 32 x 33 tile in shared memory so that both sides are read and
// written along rows.
__global__ void gemm_tf32x3_split_kernel(const float* __restrict__ b,
                                         int rows, int cols, int transpose,
                                         float* __restrict__ hi,
                                         float* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;   // 32 x 8
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, cc = c0 + tx;
    if (r < rows && cc < cols) tile[i][tx] = b[static_cast<size_t>(r) * cols + cc];
  }
  __syncthreads();
  const int orows = transpose ? cols : rows, ocols = transpose ? rows : cols;
  for (int i = ty; i < 32; i += 8) {
    // element (orow, ocol) of the K-major matrix
    const int orow = transpose ? c0 + i : r0 + i;
    const int ocol = transpose ? r0 + tx : c0 + tx;
    if (orow < orows && ocol < ocols) {
      uint32_t h, l;
      split_tf32(transpose ? tile[tx][i] : tile[i][tx], h, l);
      const size_t o = static_cast<size_t>(orow) * ocols + ocol;
      hi[o] = __uint_as_float(h);
      lo[o] = __uint_as_float(l);
    }
  }
}

// c = sum over the splits of the partials, in split order (+ bias).
__global__ void gemm_tf32x3_reduce_kernel(const float4* __restrict__ parts,
                                          int splits, int64_t n4, int cols4,
                                          const float4* __restrict__ bias,
                                          float4* __restrict__ c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 s = parts[i];
    for (int p = 1; p < splits; ++p) {
      const float4 v = parts[p * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (bias) {
      const float4 b = bias[i % cols4];
      s.x += b.x; s.y += b.y; s.z += b.z; s.w += b.w;
    }
    c[i] = s;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a row-major f32 matrix of `rows` x `cols` whose boxes are
// box_rows x box_cols (box_cols * 4 = 128 bytes, the swizzle's width);
// out-of-range elements load as zeros.
bool make_map(CUtensorMap* map, const float* p, int rows, int cols,
              int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                   const_cast<float*>(p), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool AK, bool PRE>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& ml,
           float* out, const float* bias, int M, int N, int k_steps, int kps,
           int splits, int grid, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = gemm_tf32x3_kernel<AK, PRE>;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(PRE));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int units = tiles_m * tiles_n * splits;
  kernel<<<std::min(grid, units), THREADS, smem_bytes(PRE), stream>>>(
      ma, mb, ml, out, bias, M, N, k_steps, kps, tiles_m, tiles_n, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (M x N) = op(A) op(B) (+ bias), split TF32.  layout 0 NT (A [M,K],
// B [N,K]), 1 NN (A [M,K], B [K,N]), 2 TN (A [K,M], B [K,N]).  `kps`
// k-steps of 32 per split.  `scratch`: NT and NN, 2 N K floats (B's hi
// and lo; one split); TN with more than one split (`splits` =
// ceil(ceil(K / 32) / kps)), splits M N floats (the partials, summed into
// c in split order).  `grid`: blocks at most (the SMs).  Returns 0, a CUDA
// error, or a refusal: -1 an inner dimension not a multiple of 4, -2 an
// operand not 16-byte aligned, -3 a bad layout or shape, -4 no
// cuTensorMapEncodeTiled, -5 a tensor map refused.
extern "C" int diffsheg_gemm_tf32x3(int layout, const float* a, const float* b,
                                    const float* bias, float* c, float* scratch,
                                    int M, int N, int K, int kps, int grid,
                                    void* stream) {
  if (layout < 0 || layout > 2 || M < 1 || N < 1 || K < 1 || kps < 1 ||
      grid < 1)
    return -3;
  const bool pre = layout != 2;
  if (N % 4 || (pre ? K % 4 : M % 4)) return -1;
  for (const void* p : {static_cast<const void*>(a), static_cast<const void*>(b),
                        static_cast<const void*>(c),
                        static_cast<const void*>(bias),
                        static_cast<const void*>(scratch)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return -2;
  if (!encoder()) return -4;
  const int k_steps = (K + BK - 1) / BK;
  const int splits = (k_steps + kps - 1) / kps;
  if ((pre && splits > 1) || ((pre || splits > 1) && !scratch)) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma, mb, ml;
  if (pre) {
    float* hi = scratch;
    float* lo = scratch + static_cast<size_t>(N) * K;
    const int rows = layout == 0 ? N : K, cols = layout == 0 ? K : N;
    gemm_tf32x3_split_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32),
                               dim3(32, 8), 0, s>>>(b, rows, cols, layout == 1,
                                                    hi, lo);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!make_map(&ma, a, M, K, BM, 32) || !make_map(&mb, hi, N, K, BN, 32) ||
        !make_map(&ml, lo, N, K, BN, 32))
      return -5;
    return launch<true, true>(ma, mb, ml, c, bias, M, N, k_steps, kps, 1,
                              grid, s);
  }
  if (!make_map(&ma, a, K, M, 32, 32) || !make_map(&mb, b, K, N, 32, 32))
    return -5;
  float* out = splits > 1 ? scratch : c;
  const int err = launch<false, false>(ma, mb, mb, out,
                                       splits > 1 ? nullptr : bias, M, N,
                                       k_steps, kps, splits, grid, s);
  if (err || splits == 1) return err;
  const int64_t n4 = static_cast<int64_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min<int64_t>((n4 + 255) / 256, 4 * 132));
  gemm_tf32x3_reduce_kernel<<<blocks, 256, 0, s>>>(
      reinterpret_cast<const float4*>(scratch), splits, n4, N / 4,
      reinterpret_cast<const float4*>(bias), reinterpret_cast<float4*>(c));
  return static_cast<int>(cudaGetLastError());
}
