// Whole-layer and whole-branch denoiser kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of diffsheg_tpu/ops/fused_layer.py:
//   - fused_layer  (ops/fused_layer.py:505, body _kernel :492): one
//     DiffusionTransformerLayer on pre-assembled feats;
//   - fused_branch (ops/fused_layer.py:398, body _chain_kernel :374 and
//     _chain_step :327): a branch's whole layer stack, feats assembled
//     per layer from the resident hidden state and the condition, with
//     the optional classifier-free null-row blend.
// Both compute _layer_math (ops/fused_layer.py:205-306); here that is one
// kernel body (fused_layers_kernel) with two entry modes.
//
// What bounds it.  At serving shapes (B = 1..2 rows, T = 34..88 frames,
// L = 512, F = 1024) a layer does ~0.26 GFLOP but reads 7.6-7.9 MB of
// bf16 weights, so the card's limit is the weight stream from HBM
// (~2.3 us per layer at 3.35 TB/s).  The Pallas grid is (B,) or
// (B, layers) with the layer axis sequential; a literal copy with one
// block per batch row would put the whole weight read on one SM of 132.
//
// What the design does about it.  One cooperative launch per call; the
// grid covers every SM (one block each at this kernel's register use).
// Each layer runs as twelve phases separated by grid-wide barriers:
//   LN(feats) | fc1 | fc2 | LN | QKV | attention | LN+AdaLN | sa_out |
//   ffn l1 | ffn l2 | LN+AdaLN | ffn_out.
// Every weight product is split by output columns (8 per work item, one
// mma n-tile) across all blocks, so each weight byte is read once per call
// by one block and every SM streams a share.  A block copies the product's
// operand rows (L2-resident; a larger B*T in chunks of rows) to shared
// memory and splits the contraction over its 8 warps, on the tensor cores
// (bf16: mma.sync m16n8k16; f32: split TF32, below).  A row phase
// (one block per row) computes each LayerNorm / AdaLN / SiLU once and
// writes the next product's rounded operand.  The attention phase splits
// (batch row, head, 8-column chunk of ctx): column j of y = Q.ctx needs
// only column j of ctx = K^T.V.  For the branch kernel the layer loop
// runs inside the launch with the hidden state in a global f32 scratch
// buffer (it never leaves L2), taking the place of the TPU grid's
// sequential layer axis.
//
// Where it stands: each phase is a short chain of dependent latencies
// (barrier, operand copy, weight slice, multiply, epilogue), so the kernel
// runs far above the weight-stream bound.  What shortens the chains:
//   - weights are constants, so a block loads its first weight slice of a
//     product into registers before the grid barrier that precedes the
//     product, between the barrier's two halves (barrier_arrive,
//     fetch_ahead, barrier_wait), and only stores it to shared memory
//     afterwards: the HBM round trip hides behind the wait;
//   - a thread asks for what its epilogue needs (bias, scale, residual)
//     before its products, and a row phase for its vectors' values
//     together with the row, which it keeps in registers between passes;
//   - every fragment of an mma step is loaded before the step's products.
// The operand copy itself moves B*T x K values into every block of the
// product, ~31 MB a layer at the BEAT shape against 7.9 MB of weights: it
// is bound by the L2's rate, and asynchronous copies (cp.async, TMA bulk)
// did not beat plain 16-byte loads (PERF.md has the ladder, the per-phase
// and in-phase times chip_smoke.py measures, and the next steps).
// bf16 QB = 0 sits at the 255-register limit: more values in flight in any
// phase spill (measured), so the phases cannot all be unrolled further.
//
// The f32 route (f32 weights: the default compute dtype).  Split TF32 on
// mma.sync m16n8k8: each f32 value x is two TF32 values, hi = rna(x) and
// lo = rna(x - hi) (tf32_rna), and a product accumulates a_lo w_hi +
// a_hi w_lo + a_hi w_hi into f32, small terms first, which keeps about f32
// accuracy (one TF32 product alone is ~5e-4 off).  The weight slice is
// split once, as put_w writes it to shared memory (a hi and a lo tile);
// the operand in the multiply, five integer / float operations a value.
// With QB = 8 / 4 the codes are exact in TF32, so a product is two,
// a_lo w + a_hi w.  A block holds an item's split slice while it walks
// the operand's row chunks (product_tf32): each weight is read and split
// once per product, and at one 34-row window the operand is staged once.
// Against the plain version (full f32 products) the layer's output is
// 1.0e-6 to 1.6e-6 rel-RMS off at the BEAT and SHOW shapes, 5e-7 to 8e-7
// with int8 / int4 codes (the tensor cores' f32 accumulation is not IEEE
// addition), far inside the 1e-5 band.  What bounds it: at one window the
// f32 weight stream (15.7 MB a layer, 0.0048 ms), with four and more the
// three TF32 products at 495 TFLOP/s plus the attention at the CUDA cores'
// f32 rate (0.0067 ms at (4, 34)); like bf16 it runs on its chains of
// latencies, and its operand copy moves twice bf16's bytes (PERF.md has
// the times, 1.4x bf16's).
//
// Quantized variants (the Pallas kernels' use_quant, ops/fused_layer.py
// :374-395 and :492-497; the `sc` branch of _layer_math's mm, :221-248).
// The kernel is templated on QB in {0, 8, 4} beside the weight dtype W.
// With QB = 8 the nine weight matrices are int8 codes, with QB = 4 int4
// codes packed two to a byte (high nibble: left column half of the
// matrix, low nibble: right half), each with per-column f32 scales.
// Only the weight side changes: stage_w reads the item's code bytes and
// writes them to shared memory already converted to W (|code| <= 127 is
// exact in bf16 and TF32), so the products run on the same tensor-core
// path (f32: two TF32 products, not three), and the epilogue computes
// acc * s + b, each rounded as _layer_math's `y * s + b`.  No int8
// tensor-core product: that would need int8 activations, a different
// function.  A QB = 4 item reads
// each packed byte of its slice once and runs two n-tiles, columns c and
// c + ncol / 2 of one matrix (the QKV product maps each of its three
// matrices separately), so a product has half as many items and a block
// runs its two multiplies in series.  The bound falls with the bytes
// (half of bf16's for int8, a quarter for int4), but the kernel is
// latency-bound, so int8 runs as fast as QB = 0 and int4 a little slower
// (PERF.md).  QB = 0 is the unquantized kernel.
//
// K passes (fused_layers_kernel<W, QB, true>).  A block holds one work
// item's weight slice beside at least 16 operand rows, both at the widest
// contraction K = max(Cp, 2L, F, L).  Where that does not fit in shared
// memory (f32 above K = 1680, 1840 with int8 codes; bf16 above 4464, 3344
// with int4 codes), the host's plan (ops/fused_layer.py::k_pass_plan, the
// one place that lays out shared memory) sets a pass width kp of 1024 and
// the launch takes this instantiation: a product wider than kp walks its
// contraction in passes, per work item and row chunk, each pass staging
// operand columns k0 .. k0 + kp and the same rows of the item's slice, and
// the warps add its mma steps to the fragments they hold across the
// passes; the epilogue runs once, after the last pass (product_passes).
// The JAX kernels keep every weight in VMEM and take these widths.  Shapes
// that fit in one pass run the instantiation with false, the code they ran
// before.  The passes cost what the one-pass code saves: the operand and
// the slice staged anew in every pass, no slice fetched ahead of a barrier
// (PERF.md has the times; still bound by the same chains of latencies).
//
// Attention in chunks of T (attention_chunks).  attention() stages a whole
// window's q and k tiles (T x (hd + 1) each) in front of the operand rows;
// at T 256 with 128-wide heads, or past ~268 frames in f32 at SHOW's widths,
// that no longer fits beside the products' room, and its 8-column items
// need hd % 8 == 0.  Where either holds, the host's plan sets a chunk of tc
// frames (and, for heads too wide for one group, k features in groups of
// dg) and the launch takes the K-pass instantiation (its products in one
// pass where they fit) with attention_chunks(): each pass over the window
// (k's max, k's sum, k' and ctx, then q' and y) walks it chunk by chunk,
// carrying per-feature maxima and sums and ctx's partial sums in shared
// memory, in the order attention() adds them, and the last item of a head
// takes its hd % 8 columns.  The JAX kernels hold the whole (T, L) window
// in VMEM and take any T and head width.  Shapes whose tiles fit take
// attention(), the code they ran before; a window is never split across
// launches (ops/fused_layer.py groups a batch by whole windows).
//
// All eight weight products and both attention contractions are computed
// here with f32 accumulation (no library GEMM): the weight products on the
// tensor cores, the attention on CUDA cores.  Numerics
// follow _layer_math: product inputs are rounded to the weight dtype,
// activations are f32, ctx is rounded before y = Q.ctx, GELU is the
// Abramowitz-Stegun erf form, the first LayerNorm is masked to c_real,
// and each layer's output is rounded to the activation dtype.
//
// C interface (ctypes): diffsheg_fused_layers(dtype, ptrs, ints, stream)
// returns a cudaError_t code (0 = launched), or a negative Refusal code for
// arguments the kernel does not take (the wrapper names each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int RB = 64;       // most operand rows a product stages at once
constexpr int AC = 8;        // ctx columns per attention work item
constexpr float LN_EPS = 1e-5f;

// weight fields, in LayerParams order (ops/fused_layer.py)
enum Field {
  FP_NORM_S, FP_NORM_B, FC1_K, FC1_B, FC2_K, FC2_B,
  SA_NORM_S, SA_NORM_B, Q_K, Q_B, K_K, K_B, V_K, V_B,
  SA_SO_S, SA_SO_B, SA_OUT_K, SA_OUT_B,
  L1_K, L1_B, L2_K, L2_B, FF_SO_S, FF_SO_B, FF_OUT_K, FF_OUT_B,
  N_FIELDS
};

// the nine weight matrices' scales, in LayerScales order
constexpr int N_SCALES = 9;
__host__ __device__ constexpr int scale_of(int field) {
  return field == FC1_K ? 0 : field == FC2_K ? 1 : field == Q_K ? 2
       : field == K_K ? 3 : field == V_K ? 4 : field == SA_OUT_K ? 5
       : field == L1_K ? 6 : field == L2_K ? 7 : 8;
}

struct Args {
  const void* w[N_FIELDS];      // field base (layer 0)
  long long wstride[N_FIELDS];  // bytes between layers
  const void* sc[N_SCALES];     // quantized: (N) f32 scales (layer 0)
  long long sstride[N_SCALES];  // bytes between layers
  const void* x;                // (M, L)
  const void* feats;            // layer mode (M, Cp); chain mode cond (M, Cp-L)
  const void* mod_sa;           // (B, 2L) of layer 0
  const void* mod_ffn;
  long long mod_layer_stride;   // elements between layers' mods
  const void* null_emb;         // (Cp) or nullptr
  const float* null_mask;       // (B) or nullptr
  void* out;                    // (M, L)
  float* scratch;               // f32 work buffers, see layout below
  unsigned* barrier;            // the grid barrier's word, see barrier_arrive
  int chain, n_layers, B, T, L, Cp, c_real, F, H;
  int a_elems;                  // shared-memory operand capacity (elements)
  int w_off, part_off;          // shared-memory offsets (bytes)
  unsigned long long* trace;    // globaltimer stamps (ns) or nullptr: one per
                                // phase end, then NSUB per phase from inside
  int kp;                       // widest contraction a product stages at once
  int tc, dg;                   // attention: 0, the one-tile attention(); else
                                // frames a chunk and k features a group
                                // (attention_chunks)
};

constexpr int NPHASE = 12;   // phases (grid barriers) per layer
constexpr int NSUB = 5;      // block 0's stamps inside a phase, see stamp()
// The stamps are compiled in only with -DDIFFSHEG_TRACE (ops/build.py
// builds that library beside the plain one), so that a launch that is not
// traced carries nothing for them.
#ifdef DIFFSHEG_TRACE
constexpr bool TRACE = true;
#else
constexpr bool TRACE = false;
#endif

template <typename W> __device__ __forceinline__ float ld(const void* p, long long i);
template <> __device__ __forceinline__ float ld<float>(const void* p, long long i) {
  return static_cast<const float*>(p)[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const void* p, long long i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// round an f32 value to the weight dtype (the `.astype(cdtype)` of _layer_math)
template <typename W> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename W> __device__ __forceinline__ void st(void* p, long long i, float v);
template <> __device__ __forceinline__ void st<float>(void* p, long long i, float v) {
  static_cast<float*>(p)[i] = v;
}
template <> __device__ __forceinline__ void st<__nv_bfloat16>(void* p, long long i, float v) {
  static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

template <typename W> __device__ __forceinline__ W to_w(float v);
template <> __device__ __forceinline__ float to_w<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_w<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// exact GELU with the Abramowitz & Stegun 7.1.26 erf (ops/fused_layer.py:49-64)
__device__ __forceinline__ float gelu_as(float x) {
  float z = x * 0.7071067811865476f;
  float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  float a = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * a);
  float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float erf = s * (1.0f - poly * expf(-a * a));
  return 0.5f * x * (1.0f + erf);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// What a row phase writes: the next product's operand, rounded to the
// weight dtype (the `.astype(cdtype)` every product of _layer_math makes).
enum RowMode { R_FEATS, R_LN, R_LNMOD };
// What a product's epilogue does with acc + bias.
enum Epi { E_SILU_RND, E_RES, E_BIAS, E_GELU_RND, E_RES_FINAL };

struct Prod {
  const void* A;          // (M, K) operand rows in the weight dtype
  int K, N, ncol;         // ncol: columns per weight matrix
  const void* wk0;        // (K, ncol) row-major weight matrices; the QKV
  const void* wk1;        // product walks the columns of all three
  const void* wk2;
  const void* wb0;        // their biases (ncol)
  const void* wb1;
  const void* wb2;
  const float* ws0;       // quantized: their scales (ncol)
  const float* ws1;
  const float* ws2;
  int epi;
  const float* res;       // residual (M, N) f32 (E_RES*)
  float* dst;             // f32 output (M, N)
  void* dst_w;            // output in the weight dtype (E_*_RND; E_RES: a
                          // rounded copy, or null)
  int last;               // E_RES_FINAL: write args.out instead of dst
};

#ifdef DIFFSHEG_TRACE
// Where block 0 writes its stamps inside the current phase: set by its
// thread 0 when the phase begins and read by no other thread.
__shared__ unsigned long long* trace_sub;
#endif

// Stamp k of the current phase (traced launches, block 0, thread 0).  A
// product stamps 0: operand rows staged, 1: first weight slice staged, 2:
// first tile accumulated, 3: its epilogue done, 4: every item done; the
// attention 0: q, k, v staged, 1: both softmaxes, 2: ctx, 3: y, 4: every
// item done; a row phase only 4.  The phase's own stamp follows the grid
// barrier, so barrier wait = phase stamp - stamp 4.
__device__ __forceinline__ void stamp(const Args& a, int k) {
#ifdef DIFFSHEG_TRACE
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    trace_sub[k] = t;
  }
#endif
}

// Grid-wide barrier of a cooperative launch (every block is resident), in
// two halves, so that a block can ask for constants of the next phase
// between arriving and waiting: the loads then neither delay its arrival
// nor wait behind it.  The algorithm is cooperative_groups' grid.sync():
// thread 0 of each block adds to one word in global memory, block 0 adds
// 2^31 - (blocks - 1) and the others 1, so the word's top bit flips when the
// last block arrives and its low bits return to what they were; a block
// waits until the top bit differs from the one its own add saw.  The add
// releases the block's writes (ordered before it by the block barrier), the
// poll acquires the other blocks'.  The word is zero before the first
// launch and needs no reset after a launch.
__device__ __forceinline__ unsigned barrier_arrive(unsigned* word) {
  unsigned seen = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(seen) : "l"(word), "r"(add) : "memory");
  }
  return seen;
}
__device__ __forceinline__ void barrier_wait(unsigned* word, unsigned seen) {
  if (threadIdx.x == 0) {
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(word) : "memory");
    } while (((seen ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // red is reused across calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// Source value of row m, column k of a row phase.
template <typename W>
__device__ __forceinline__ float row_src(const Args& a, int mode,
                                         const float* src, int K,
                                         const float* h, int m, int k) {
  if (mode != R_FEATS) return src[(long long)m * K + k];
  if (!a.chain) return ld<W>(a.feats, (long long)m * a.Cp + k);
  // fused_branch: concat(h, cond) then the f32 null-row blend (_chain_step)
  float v = k < a.L ? h[(long long)m * a.L + k]
                    : ld<W>(a.feats, (long long)m * (a.Cp - a.L) + (k - a.L));
  if (a.null_emb != nullptr) {
    const float nm = a.null_mask[m / a.T];
    v = v * (1.0f - nm) + ld<W>(a.null_emb, k) * nm;
  }
  return v;
}

// Row phase: one block per row.  LayerNorm of the row (R_FEATS: masked to
// c_real — mean over all Cp columns / c_real, the pads being zero), then
// AdaLN + SiLU (R_LNMOD), rounded to the weight dtype into the product
// operand dst (M, K).
template <typename W>
__device__ void row_phase(const Args& a, int mode, const float* src, int K,
                          const void* ln_s, const void* ln_b, const void* mod,
                          const float* h, W* dst, float* red) {
  const int M = a.B * a.T;
  const float n = mode == R_FEATS ? (float)a.c_real : (float)K;
  const int kmax = mode == R_FEATS ? a.c_real : K;
  constexpr int RV = 4;   // a thread's values of a row of up to RV * NT
  const bool keep = K <= RV * NT;   // columns stay in registers
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    // x: the row's values; with them, before the reductions, the vectors'
    // values that the last pass needs (scale, bias, AdaLN scale and shift)
    float x[RV], sc[RV], bi[RV], ms[RV], mh[RV];
    const long long b = m / a.T;
    float s = 0.f;
    if (keep) {
#pragma unroll
      for (int j = 0; j < RV; ++j) {
        const int k = threadIdx.x + j * NT;
        x[j] = k < K ? row_src<W>(a, mode, src, K, h, m, k) : 0.f;
        if (k < K) {
          sc[j] = ld<W>(ln_s, k);
          bi[j] = ld<W>(ln_b, k);
          if (mode == R_LNMOD) {
            ms[j] = ld<W>(mod, b * 2 * a.L + k);
            mh[j] = ld<W>(mod, b * 2 * a.L + a.L + k);
          }
          s += x[j];
        }
      }
    } else {
      for (int k = threadIdx.x; k < K; k += NT)
        s += row_src<W>(a, mode, src, K, h, m, k);
    }
    const float mean = block_sum(s, red) / n;
    float q = 0.f;
    if (keep) {
#pragma unroll
      for (int j = 0; j < RV; ++j)
        if (threadIdx.x + j * NT < kmax) {
          const float d = x[j] - mean;
          q += d * d;
        }
    } else {
      for (int k = threadIdx.x; k < kmax; k += NT) {
        const float d = row_src<W>(a, mode, src, K, h, m, k) - mean;
        q += d * d;
      }
    }
    const float rs = rsqrtf(block_sum(q, red) / n + LN_EPS);
    auto emit = [&](int k, float xv, float scale, float bias, float mscale,
                    float mshift) {
      float v = (xv - mean) * rs * scale + bias;
      if (mode == R_LNMOD) v = silu(v * (1.0f + mscale) + mshift);
      dst[(long long)m * K + k] = to_w<W>(v);
    };
    if (keep) {
#pragma unroll
      for (int j = 0; j < RV; ++j)
        if (threadIdx.x + j * NT < K)
          emit(threadIdx.x + j * NT, x[j], sc[j], bi[j], ms[j], mh[j]);
    } else {
      for (int k = threadIdx.x; k < K; k += NT) {
        const bool md = mode == R_LNMOD;
        emit(k, row_src<W>(a, mode, src, K, h, m, k), ld<W>(ln_s, k),
             ld<W>(ln_b, k), md ? ld<W>(mod, b * 2 * a.L + k) : 0.f,
             md ? ld<W>(mod, b * 2 * a.L + a.L + k) : 0.f);
      }
    }
  }
  stamp(a, 4);
}

// Copy operand rows r0 .. r0 + rows to shared memory (row stride lda),
// 16 bytes per load.
template <typename W>
__device__ void stage_a(const Prod& p, int r0, int rows, W* As, int lda) {
  const int per_row = p.K * (int)sizeof(W) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const W*>(p.A) + (long long)r0 * p.K);
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, q = i - r * per_row;
    reinterpret_cast<uint4*>(As + r * lda)[q] = src[i];
  }
}

// Which of the product's (up to three) matrices holds product column n0,
// and the column within it (the QKV product walks the columns of three
// matrices).  No dynamic indexing into p: that would put it in local
// memory.
struct Cols { int mat, c0; };
__device__ __forceinline__ Cols cols_of(const Prod& p, int n0) {
  const int mat = n0 / p.ncol;
  return {mat, n0 - mat * p.ncol};
}
template <typename T>
__device__ __forceinline__ T pick(int mat, T m0, T m1, T m2) {
  return mat == 0 ? m0 : (mat == 1 ? m1 : m2);
}

// Columns per product work item: one mma n-tile, for both weight dtypes.
constexpr int TN = 8;
// n-tiles per work item: two for packed int4 (both halves of a byte)
template <int QB> __host__ __device__ constexpr int item_tiles() {
  return QB == 4 ? 2 : 1;
}

// Packed int4 work item -> its matrix and first packed byte column; its
// two tiles are that matrix's columns b0 .. b0 + tn (high nibbles) and
// ncol / 2 + b0 .. (low nibbles).
__device__ __forceinline__ Cols int4_item(const Prod& p, int item, int tn) {
  const int per = p.ncol / 2 / tn;
  const int mat = item / per;
  return {mat, (item - mat * per) * tn};
}

// One row of an item's codes: 8 signed bytes.
__device__ __forceinline__ void codes_of(uint2 r, int (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = (int)(int8_t)(r.x >> (8 * j));
    v[4 + j] = (int)(int8_t)(r.y >> (8 * j));
  }
}

// Codes as 16 bytes of bf16, exactly.
__device__ __forceinline__ uint32_t bf16_bits(int v) {
  return __bfloat16_as_ushort(__float2bfloat16((float)v));
}
__device__ __forceinline__ uint4 as_w(const int (&v)[8]) {
  return make_uint4(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                    bf16_bits(v[2]) | bf16_bits(v[3]) << 16,
                    bf16_bits(v[4]) | bf16_bits(v[5]) << 16,
                    bf16_bits(v[6]) | bf16_bits(v[7]) << 16);
}

// f32 -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero; 10 mantissa bits, the low 13 bits zero), in two integer operations
// on the bits: half an ulp added to the magnitude, then truncated (a carry
// into the exponent is the right result).  The cvt instruction itself
// compiles to a longer sequence with a NaN test (measured slower).  A NaN
// input may come out as an infinity; its lo part is then NaN, so the
// product is.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 2^-22 relative, both TF32 (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Where an f32 item's weight (row k, column g) lies in its shared-memory
// tile: per 16 rows, 32 lanes x 4 floats, lane 4 g + t holding column g of
// rows 4 t .. 4 t + 3, so that one 16-byte load gives a lane its B
// fragments of two m16n8k8 steps (mma_slice).
__device__ __forceinline__ int tf32_at(int k, int g) {
  return (k >> 4) * 128 + g * 16 + (k & 15);
}

// A thread's part of a work item's K x TN weight slice, as it lies in
// global memory: WR rows, one row a pass over the block; a row is TN
// weights of W (QB 0), TN int8 codes or TN packed int4 bytes.  Loading
// (fetch_w) and converting into shared memory (put_w) are apart so that
// the loads of a phase's first slice can be issued before the grid barrier
// that precedes it (weights are constants): they are in flight while the
// block waits, and the phase begins with the slice in registers.
constexpr int WR = 4;
struct f32x8 { uint4 a, b; };
template <typename W, int QB> struct raw_row { using type = uint2; };
template <> struct raw_row<__nv_bfloat16, 0> { using type = uint4; };
template <> struct raw_row<float, 0> { using type = f32x8; };
template <typename W, int QB>
struct Slice {
  typename raw_row<W, QB>::type r[WR];
  bool have;        // holds the block's first slice of the coming product
};

// Rows k0 + threadIdx.x + j * NT (j < WR) of item `item`'s slice.
template <typename W, int QB>
__device__ __forceinline__ void fetch_w(const Prod& p, int item, int k0,
                                        Slice<W, QB>& s) {
  using Raw = typename raw_row<W, QB>::type;
  const Cols c = QB == 4 ? int4_item(p, item, TN) : cols_of(p, item * TN);
  // bytes: a matrix row, and the item's first column in it
  const long long row = QB == 0 ? (long long)p.ncol * (int)sizeof(W)
                      : QB == 8 ? p.ncol : p.ncol / 2;
  const char* base = static_cast<const char*>(pick(c.mat, p.wk0, p.wk1, p.wk2))
      + (QB == 0 ? c.c0 * (int)sizeof(W) : c.c0);
#pragma unroll
  for (int j = 0; j < WR; ++j) {
    const int k = k0 + threadIdx.x + j * NT;
    if (k < p.K) s.r[j] = *reinterpret_cast<const Raw*>(base + k * row);
    else if constexpr (sizeof(W) == 4) s.r[j] = Raw{};
  }
}

// The same rows into Ws.  bf16: QB 0 as they are; QB 8 the codes
// converted; QB 4 the packed bytes split into the high-nibble tile (Ws) and
// the low-nibble tile (Ws + K * TN).  f32, in the tf32_at layout: QB 0 each
// weight split once into its TF32 hi (tile Ws) and lo (tile Ws + K * TN)
// parts; QB 8 the codes and QB 4 the two nibble tiles as floats, exact in
// TF32 (|code| <= 127), so with no lo part.
template <typename W, int QB>
__device__ __forceinline__ void put_w(const Prod& p, int k0,
                                      const Slice<W, QB>& s, W* Ws) {
#pragma unroll
  for (int j = 0; j < WR; ++j) {
    const int k = k0 + threadIdx.x + j * NT;
    if (k >= p.K) continue;
    if constexpr (sizeof(W) == 4) {
      float* lo_tile = Ws + TN * p.K;
      if constexpr (QB == 0) {
        const uint4 u = s.r[j].a, v = s.r[j].b;
        const uint32_t w[TN] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
        for (int g = 0; g < TN; ++g) {
          uint32_t hi, lo;
          split_tf32(__uint_as_float(w[g]), hi, lo);
          Ws[tf32_at(k, g)] = __uint_as_float(hi);
          lo_tile[tf32_at(k, g)] = __uint_as_float(lo);
        }
      } else {
        int v[TN];
        codes_of(s.r[j], v);
#pragma unroll
        for (int g = 0; g < TN; ++g) {
          if constexpr (QB == 8) {
            Ws[tf32_at(k, g)] = (float)v[g];
          } else {
            Ws[tf32_at(k, g)] = (float)(v[g] >> 4);
            lo_tile[tf32_at(k, g)] = (float)(((v[g] & 0xF) ^ 8) - 8);
          }
        }
      }
    } else if constexpr (QB == 0) {
      reinterpret_cast<uint4*>(Ws)[k] = s.r[j];
    } else {
      uint4* dst = reinterpret_cast<uint4*>(Ws);
      int v[TN];
      codes_of(s.r[j], v);
      if constexpr (QB == 8) {
        dst[k] = as_w(v);
      } else {
        int hi[TN], lo[TN];
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          hi[i] = v[i] >> 4;                    // byte = 16 hi + (lo & 0xF)
          lo[i] = ((v[i] & 0xF) ^ 8) - 8;       // sign-extended low nibble
        }
        dst[k] = as_w(hi);
        dst[p.K + k] = as_w(lo);
      }
    }
  }
}

// Copy work item `item`'s whole slice to Ws.
template <typename W, int QB>
__device__ void stage_w(const Prod& p, int item, W* Ws) {
  Slice<W, QB> s;
  for (int k0 = 0; k0 < p.K; k0 += WR * NT) {
    fetch_w<W, QB>(p, item, k0, s);
    put_w<W, QB>(p, k0, s, Ws);
  }
}

// Before the grid barrier that precedes product `pn`: ask for this block's
// first slice of it, if it has one and the slice fits the registers.
template <typename W, int QB>
__device__ __forceinline__ void fetch_ahead(const Prod& pn, Slice<W, QB>& s) {
  s.have = pn.K <= WR * NT
      && (int)blockIdx.x < pn.N / (TN * item_tiles<QB>());
  if (s.have) fetch_w<W, QB>(pn, blockIdx.x, 0, s);
  else if constexpr (sizeof(W) == 4)
    for (int j = 0; j < WR; ++j) s.r[j] = typename raw_row<W, QB>::type{};
}

// acc -> the product's output before the epilogue: acc + b, or with
// quantized weights acc * s + b, rounded as _layer_math's `y * s + b`.
template <int QB>
__device__ __forceinline__ float dequant(float acc, float s, float b) {
  if constexpr (QB == 0) return acc + b;
  else return __fadd_rn(__fmul_rn(acc, s), b);
}
template <int QB>
__device__ __forceinline__ float scale_at(const float* s, int c) {
  if constexpr (QB == 0) return 1.0f;
  else return s[c];
}

// The product epilogue for output element o of row-major (M, N); res: its
// residual p.res[o] (E_RES*), fetched by the caller.
template <typename W>
__device__ __forceinline__ void epilogue(const Args& a, const Prod& p,
                                         long long o, float y, float res) {
  switch (p.epi) {
    case E_SILU_RND: st<W>(p.dst_w, o, silu(y)); break;
    case E_GELU_RND: st<W>(p.dst_w, o, gelu_as(y)); break;
    case E_BIAS: p.dst[o] = y; break;
    case E_RES: {
      const float out = y + res;
      p.dst[o] = out;
      if (p.dst_w != nullptr) st<W>(p.dst_w, o, out);
    } break;
    case E_RES_FINAL: {
      const float out = rnd<W>(y + res);       // layer output in x.dtype
      if (p.last) st<W>(a.out, o, out); else p.dst[o] = out;
    } break;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp's mma.sync m16n8k16 steps ks0 .. ks1 of its K slice over MT
// 16-row tiles.  Every fragment of a step is loaded before its products
// are issued, and two steps are unrolled, so the shared-memory and
// tensor-core latencies of a step overlap instead of adding up; each
// accumulator still sums its steps in order.
template <int MT, int QB>
__device__ __forceinline__ void mma_slice(float (&d)[RB / 16][4],
                                          const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Ws, int,
                                          int ks0, int ks1, int g, int t) {
  const unsigned short* Wu = reinterpret_cast<const unsigned short*>(Ws);
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    const uint32_t b0 = Wu[k0 * TN + g] | ((uint32_t)Wu[(k0 + 1) * TN + g] << 16);
    const uint32_t b1 = Wu[(k0 + 8) * TN + g] | ((uint32_t)Wu[(k0 + 9) * TN + g] << 16);
    uint32_t f[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const __nv_bfloat16* r = As + (m * 16 + g) * lda + k0;
      f[m][0] = *reinterpret_cast<const uint32_t*>(r);
      f[m][1] = *reinterpret_cast<const uint32_t*>(r + 8 * lda);
      f[m][2] = *reinterpret_cast<const uint32_t*>(r + 8);
      f[m][3] = *reinterpret_cast<const uint32_t*>(r + 8 * lda + 8);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      mma_bf16(d[m], f[m][0], f[m][1], f[m][2], f[m][3], b0, b1);
  }
}

// One m16n8k8 step of a split-TF32 product into d: the A fragment (rows g
// and g + 8, contraction slots t and t + 4) split into hi + lo, then
// a_lo w_hi + a_hi w_lo + a_hi w_hi (QB 0), or a_lo w + a_hi w (QB 8 / 4:
// the codes are exact in TF32), small terms first.
template <int QB>
__device__ __forceinline__ void tf32_step(float (&d)[4], float a0, float a1,
                                          float a2, float a3, float wh0,
                                          float wh1, float wl0, float wl1) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split_tf32(a0, h0, l0);
  split_tf32(a1, h1, l1);
  split_tf32(a2, h2, l2);
  split_tf32(a3, h3, l3);
  const uint32_t b0 = __float_as_uint(wh0), b1 = __float_as_uint(wh1);
  mma_tf32(d, l0, l1, l2, l3, b0, b1);
  if constexpr (QB == 0)
    mma_tf32(d, h0, h1, h2, h3, __float_as_uint(wl0), __float_as_uint(wl1));
  mma_tf32(d, h0, h1, h2, h3, b0, b1);
}

// The f32 counterpart: each step ks covers 16 contraction rows as two
// m16n8k8 steps.  Which 8 of the 16 rows a step takes is free as long as A
// and B agree, so lane (g, t) takes rows 4 t .. 4 t + 3 (slot t of the
// first step <- row 4 t, slot t + 4 <- 4 t + 1; the second step 4 t + 2
// and 4 t + 3): one 16-byte load gives a row's A values of both steps, and
// one of each weight tile its B values (the tf32_at layout).
template <int MT, int QB>
__device__ __forceinline__ void mma_slice(float (&d)[RB / 16][4],
                                          const float* As, int lda,
                                          const float* Ws, int K, int ks0,
                                          int ks1, int g, int t) {
  const float4* wh = reinterpret_cast<const float4*>(Ws) + 4 * g + t;
  const float4* wl = reinterpret_cast<const float4*>(Ws + TN * K) + 4 * g + t;
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) {
    const float4 bh = wh[ks * 32];
    const float4 bl = QB == 0 ? wl[ks * 32] : bh;
    float4 x[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* r = As + (m * 16 + g) * lda + ks * 16 + 4 * t;
      x[m][0] = *reinterpret_cast<const float4*>(r);
      x[m][1] = *reinterpret_cast<const float4*>(r + 8 * lda);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      tf32_step<QB>(d[m], x[m][0].x, x[m][1].x, x[m][0].y, x[m][1].y,
                    bh.x, bh.y, bl.x, bl.y);
      tf32_step<QB>(d[m], x[m][0].z, x[m][1].z, x[m][0].w, x[m][1].w,
                    bh.z, bh.w, bl.z, bl.w);
    }
  }
}

// Multiply one n-tile: the block's staged rows x the K x TN slice Ws of
// product columns n0 .. n0 + TN, then the epilogue.  Each of the 8 warps
// runs the mma.sync steps of its K / 8 slice over every 16-row tile (bf16
// m16n8k16, f32 split-TF32 m16n8k8) and the warps' partial tiles are
// summed through shared memory in warp order, so a row's value depends
// neither on the other rows nor on where the row lies in the launch.
template <typename W, int QB>
__device__ void multiply(const Args& a, const Prod p, int r0, int rows,
                         int n0, const W* As, int lda, const W* Ws,
                         float* part, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ksteps = p.K / 16, kper = (ksteps + 7) / 8;
  const int ks0 = warp * kper, ks1 = min(ksteps, ks0 + kper);
  const int mtiles = (rows + 15) / 16;
  // the bias, scale and residual of this thread's first output element are
  // asked for before the products, so they arrive behind them
  const Cols cc = cols_of(p, n0);
  const void* wb = pick(cc.mat, p.wb0, p.wb1, p.wb2);
  const float* sc = pick(cc.mat, p.ws0, p.ws1, p.ws2);
  const bool own = (int)threadIdx.x < rows * TN;
  const int col0 = cc.c0 + (threadIdx.x & (TN - 1));
  float bias = own ? ld<W>(wb, col0) : 0.f;
  float scale = own ? scale_at<QB>(sc, col0) : 1.f;
  float res = own && p.res != nullptr
      ? p.res[(long long)(r0 + threadIdx.x / TN) * p.N + n0
              + (threadIdx.x & (TN - 1))] : 0.f;
  float d[RB / 16][4];
#pragma unroll
  for (int m = 0; m < RB / 16; ++m) d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
  switch (mtiles) {
    case 1: mma_slice<1, QB>(d, As, lda, Ws, p.K, ks0, ks1, g, t); break;
    case 2: mma_slice<2, QB>(d, As, lda, Ws, p.K, ks0, ks1, g, t); break;
    case 3: mma_slice<3, QB>(d, As, lda, Ws, p.K, ks0, ks1, g, t); break;
    default: mma_slice<4, QB>(d, As, lda, Ws, p.K, ks0, ks1, g, t); break;
  }
  if (first) stamp(a, 2);
#pragma unroll
  for (int m = 0; m < RB / 16; ++m) {
    if (m >= mtiles) break;
    float* pr = part + (warp * RB + m * 16 + g) * TN + 2 * t;
    pr[0] = d[m][0];
    pr[1] = d[m][1];
    pr[8 * TN] = d[m][2];
    pr[8 * TN + 1] = d[m][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * TN; i += NT) {
    const int r = i / TN, j = i - r * TN;
    const long long o = (long long)(r0 + r) * p.N + n0 + j;
    if (i >= NT) {
      bias = ld<W>(wb, cc.c0 + j);
      scale = scale_at<QB>(sc, cc.c0 + j);
      res = p.res != nullptr ? p.res[o] : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += part[(w * RB + r) * TN + j];
    epilogue<W>(a, p, o, dequant<QB>(v, scale, bias), res);
  }
}

// Operand row stride in shared memory, so that a warp's fragment loads
// fall in distinct banks: bf16 K + 8 (4-byte loads of 8 rows); f32 16
// floats past a multiple of 32 (16-byte loads, rows g and g + 1 in one
// quarter warp).  Widths are multiples of 16.
template <typename W> __host__ __device__ constexpr int lda_of(int K) {
  return sizeof(W) == 2 ? K + 8 : K + 16 - K % 32;
}

// f32 weights: the same work items, but the block holds an item's split
// slice while it walks the operand's row chunks, so each slice is read and
// split once per product; when all M rows fit they are staged once.
template <int QB>
__device__ void product_tf32(const Args& a, const Prod p, unsigned char* smem,
                             Slice<float, QB>& ahead) {
  const int M = a.B * a.T;
  const int n_items = p.N / (TN * item_tiles<QB>());
  if ((int)blockIdx.x >= n_items) return;   // never block 0: no stamps owed
  const int lda = lda_of<float>(p.K);
  const int fit = min(RB, a.a_elems / lda);
  const bool whole = M <= fit;
  const int rb = whole ? M : fit / 16 * 16;
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + a.w_off);
  float* part = reinterpret_cast<float*>(smem + a.part_off);
  // the first slice first: the registers that hold it are then free for
  // the products (the room is free: the attention phase's tiles lie below
  // it, and a grid barrier ends the previous product)
  if (ahead.have) put_w<float, QB>(p, 0, ahead, Ws);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int r0 = 0; r0 < M; r0 += rb) {
      const int rows = min(rb, M - r0);
      const bool first = r0 == 0 && item == (int)blockIdx.x;
      __syncthreads();                            // As, Ws, part are free
      if (!whole || first) stage_a<float>(p, r0, rows, As, lda);
      if (first) stamp(a, 0);
      if (r0 == 0 && !(first && ahead.have)) stage_w<float, QB>(p, item, Ws);
      __syncthreads();
      if (first) stamp(a, 1);
      if constexpr (QB == 4) {
        const Cols c = int4_item(p, item, TN);
        const int n0 = c.mat * p.ncol + c.c0;
        multiply<float, QB>(a, p, r0, rows, n0, As, lda, Ws, part, first);
        __syncthreads();                          // part is free
        multiply<float, QB>(a, p, r0, rows, n0 + p.ncol / 2, As, lda,
                            Ws + TN * p.K, part, false);
      } else {
        multiply<float, QB>(a, p, r0, rows, item * TN, As, lda, Ws, part,
                            first);
      }
      if (first) stamp(a, 3);
    }
  }
  stamp(a, 4);
}

// bf16 weights: one weight product over all M rows.  Work items are
// column tiles spread over the grid; a block copies up to `rb` operand
// rows once, then walks its items: copy the item's weight slice, multiply
// (packed int4: both of its tiles).  `ahead`: the block's first slice,
// asked for before the grid barrier (fetch_ahead).
template <int QB>
__device__ void product_bf16(const Args& a, const Prod p, unsigned char* smem,
                             Slice<__nv_bfloat16, QB>& ahead) {
  using W = __nv_bfloat16;
  const int M = a.B * a.T;
  const int n_items = p.N / (TN * item_tiles<QB>());
  if ((int)blockIdx.x >= n_items) return;   // never block 0: no stamps owed
  const int lda = lda_of<W>(p.K);
  const int rb = min(RB, (a.a_elems / lda) / 16 * 16);
  W* As = reinterpret_cast<W*>(smem);
  W* Ws = reinterpret_cast<W*>(smem + a.w_off);
  float* part = reinterpret_cast<float*>(smem + a.part_off);
  for (int r0 = 0; r0 < M; r0 += rb) {
    const int rows = min(rb, M - r0);
    __syncthreads();                              // As is free
    stage_a<W>(p, r0, rows, As, lda);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const bool first = r0 == 0 && item == (int)blockIdx.x;
      __syncthreads();                            // Ws is free
      if (first) stamp(a, 0);
      if (first && ahead.have) put_w<W, QB>(p, 0, ahead, Ws);
      else stage_w<W, QB>(p, item, Ws);
      __syncthreads();
      if (first) stamp(a, 1);
      if constexpr (QB == 4) {
        const Cols c = int4_item(p, item, TN);
        const int n0 = c.mat * p.ncol + c.c0;
        multiply<W, QB>(a, p, r0, rows, n0, As, lda, Ws, part, first);
        __syncthreads();                          // part is free
        multiply<W, QB>(a, p, r0, rows, n0 + p.ncol / 2, As, lda,
                        Ws + p.K * TN, part, false);
      } else {
        multiply<W, QB>(a, p, r0, rows, item * TN, As, lda, Ws, part, first);
      }
      if (first) stamp(a, 3);
    }
  }
  stamp(a, 4);
}

// The K-pass form (fused_layers_kernel<W, QB, true>).  The one-pass
// functions above keep their own code, so that the shapes they run compile
// as before; these are used by the pass instantiation alone.
//
// Product p over contraction rows k0 .. k0 + kp: its weight matrices from
// row k0 on, K = kp (the operand keeps p's row stride, see stage_cols).
template <typename W, int QB>
__device__ __forceinline__ Prod pass_of(const Prod& p, int k0, int kp) {
  const long long row = QB == 0 ? (long long)p.ncol * (int)sizeof(W)
                      : QB == 8 ? p.ncol : p.ncol / 2;   // bytes, as fetch_w
  auto at = [&](const void* w) -> const void* {
    return w == nullptr ? w : static_cast<const char*>(w) + k0 * row;
  };
  Prod q = p;
  q.wk0 = at(p.wk0);
  q.wk1 = at(p.wk1);
  q.wk2 = at(p.wk2);
  q.K = kp;
  return q;
}

// Columns k0 .. k0 + kp of operand rows r0 .. r0 + rows (row stride p.K)
// to shared memory (row stride lda), 16 bytes per load.
template <typename W>
__device__ void stage_cols(const Prod& p, int r0, int rows, int k0, int kp,
                           W* As, int lda) {
  const int per_row = kp * (int)sizeof(W) / 16;
  const W* src = static_cast<const W*>(p.A) + (long long)r0 * p.K + k0;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, q = i - r * per_row;
    reinterpret_cast<uint4*>(As + r * lda)[q] =
        reinterpret_cast<const uint4*>(src + (long long)r * p.K)[q];
  }
}

// The warps' accumulated tiles d of product columns n0 .. n0 + TN, rows
// r0 .. r0 + rows: summed through shared memory in warp order, then the
// epilogue (multiply's last part).
template <typename W, int QB>
__device__ void finish_tile(const Args& a, const Prod& p, int r0, int rows,
                            int n0, const float (&d)[RB / 16][4],
                            float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (rows + 15) / 16;
#pragma unroll
  for (int m = 0; m < RB / 16; ++m) {
    if (m >= mtiles) break;
    float* pr = part + (warp * RB + m * 16 + g) * TN + 2 * t;
    pr[0] = d[m][0];
    pr[1] = d[m][1];
    pr[8 * TN] = d[m][2];
    pr[8 * TN + 1] = d[m][3];
  }
  __syncthreads();
  const Cols cc = cols_of(p, n0);
  const void* wb = pick(cc.mat, p.wb0, p.wb1, p.wb2);
  const float* sc = pick(cc.mat, p.ws0, p.ws1, p.ws2);
  for (int i = threadIdx.x; i < rows * TN; i += NT) {
    const int r = i / TN, j = i - r * TN;
    const long long o = (long long)(r0 + r) * p.N + n0 + j;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += part[(w * RB + r) * TN + j];
    epilogue<W>(a, p, o, dequant<QB>(v, scale_at<QB>(sc, cc.c0 + j),
                                     ld<W>(wb, cc.c0 + j)),
                p.res != nullptr ? p.res[o] : 0.f);
  }
}

// One product in passes of at most a.kp contraction rows.  Loop order:
// work item -> row chunk -> (QB = 4: tile ->) pass; all M rows are one
// chunk when they fit (a 34-row window at kp = 1024).  A product of one
// pass stages its item's slice once for every chunk and tile, and the rows
// once for the whole product when they fit; a product of several passes
// stages both anew in every pass.  Each warp takes a K / 8 share of every
// pass and keeps its fragments d across the passes.
template <typename W, int QB>
__device__ void product_passes(const Args& a, const Prod p,
                               unsigned char* smem) {
  const int M = a.B * a.T;
  const int n_items = p.N / (TN * item_tiles<QB>());
  if ((int)blockIdx.x >= n_items) return;   // never block 0: no stamps owed
  const int kp = min(p.K, a.kp);
  const bool one = kp == p.K;
  const int lda = lda_of<W>(kp);
  const int fit = min(RB, a.a_elems / lda_of<W>(a.kp));   // the planned rows
  const bool all = M <= fit;                  // every row in one chunk ...
  const bool whole = one && all;              // ... staged once a product
  const int rb = all ? M : fit / 16 * 16;
  W* As = reinterpret_cast<W*>(smem);
  W* Ws = reinterpret_cast<W*>(smem + a.w_off);
  float* part = reinterpret_cast<float*>(smem + a.part_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int r0 = 0; r0 < M; r0 += rb) {
      const int rows = min(rb, M - r0), mtiles = (rows + 15) / 16;
      const bool first_chunk = r0 == 0 && item == (int)blockIdx.x;
      for (int tile = 0; tile < item_tiles<QB>(); ++tile) {
        const bool first = first_chunk && tile == 0;
        float d[RB / 16][4];
#pragma unroll
        for (int m = 0; m < RB / 16; ++m)
          d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
        for (int k0 = 0; k0 < p.K; k0 += kp) {
          const Prod q = pass_of<W, QB>(p, k0, min(kp, p.K - k0));
          __syncthreads();                        // As, Ws, part are free
          if (!one || (tile == 0 && (!whole || first_chunk)))
            stage_cols<W>(p, r0, rows, k0, q.K, As, lda);
          if (first && k0 == 0) stamp(a, 0);
          if (!one || (tile == 0 && r0 == 0)) stage_w<W, QB>(q, item, Ws);
          __syncthreads();
          if (first && k0 == 0) stamp(a, 1);
          const W* Wt = Ws + tile * TN * q.K;     // QB = 4: the item's tile
          const int ksteps = q.K / 16, kper = (ksteps + 7) / 8;
          const int ks0 = warp * kper, ks1 = min(ksteps, ks0 + kper);
          switch (mtiles) {
            case 1: mma_slice<1, QB>(d, As, lda, Wt, q.K, ks0, ks1, g, t); break;
            case 2: mma_slice<2, QB>(d, As, lda, Wt, q.K, ks0, ks1, g, t); break;
            case 3: mma_slice<3, QB>(d, As, lda, Wt, q.K, ks0, ks1, g, t); break;
            default: mma_slice<4, QB>(d, As, lda, Wt, q.K, ks0, ks1, g, t); break;
          }
        }
        if (first) stamp(a, 2);
        int n0 = item * TN;
        if constexpr (QB == 4) {
          const Cols c = int4_item(p, item, TN);
          n0 = c.mat * p.ncol + c.c0 + tile * (p.ncol / 2);
        }
        finish_tile<W, QB>(a, p, r0, rows, n0, d, part);
        if (first) stamp(a, 3);
      }
    }
  }
  stamp(a, 4);
}

template <typename W, int QB, bool PASSES>
__device__ __forceinline__ void product(const Args& a, const Prod p,
                                        unsigned char* smem,
                                        Slice<W, QB>& ahead) {
  if constexpr (PASSES) product_passes<W, QB>(a, p, smem);
  else if constexpr (sizeof(W) == 4) product_tf32<QB>(a, p, smem, ahead);
  else product_bf16<QB>(a, p, smem, ahead);
}

// Linear attention core, per (batch row, head, AC-column chunk of ctx):
// q' = softmax(q) over features, k' = softmax(k) over time,
// ctx[:, c] = k'^T v[:, c], y[:, c] = q' ctx[:, c].  The head's q and k
// and the v chunk are staged in shared memory with coalesced loads first.
template <typename W>
__device__ void attention(const Args& a, const float* qkv, float* y,
                          float* smem) {
  const int T = a.T, L = a.L, hd = L / a.H, nc = hd / AC;
  const int n_items = a.B * a.H * nc;
  const int ld_ = hd + 1;
  float* Qs = smem;                 // T x (hd + 1)
  float* Ks = Qs + T * ld_;         // T x (hd + 1)
  float* Vs = Ks + T * ld_;         // T x AC
  float* Cs = Vs + T * AC;          // hd x AC
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % nc, hh = (item / nc) % a.H, b = item / (nc * a.H);
    const float* base = qkv + (long long)b * T * 3 * L;
    for (int i = threadIdx.x; i < T * hd; i += NT) {
      const int t = i / hd, d = i - t * hd;
      Qs[t * ld_ + d] = base[(long long)t * 3 * L + hh * hd + d];
      Ks[t * ld_ + d] = base[(long long)t * 3 * L + L + hh * hd + d];
    }
    for (int i = threadIdx.x; i < T * AC; i += NT) {
      const int t = i / AC, cc = i - t * AC;
      Vs[i] = rnd<W>(base[(long long)t * 3 * L + 2 * L + hh * hd + c * AC + cc]);
    }
    __syncthreads();
    const bool first = item == (int)blockIdx.x;
    if (first) stamp(a, 0);
    // softmax(q) over the head's features, one warp per frame
    for (int t = warp; t < T; t += NT / 32) {
      float* q = Qs + t * ld_;
      float mx = -FLT_MAX;
      for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, q[d]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += expf(q[d] - mx);
      s = warp_sum(s);
      for (int d = lane; d < hd; d += 32) q[d] = rnd<W>(expf(q[d] - mx) / s);
    }
    // softmax(k) over time: 4 neighbouring lanes share a feature and split
    // the frames, combining with shuffles (hd % 8 == 0 keeps whole warps
    // in every pass of the loop)
    constexpr int parts = 4;
    for (int i = threadIdx.x; i < hd * parts; i += NT) {
      const int d = i / parts, part = i - d * parts;
      float mx = -FLT_MAX;
      for (int t = part; t < T; t += parts) mx = fmaxf(mx, Ks[t * ld_ + d]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s = 0.f;
      for (int t = part; t < T; t += parts) s += expf(Ks[t * ld_ + d] - mx);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      for (int t = part; t < T; t += parts)
        Ks[t * ld_ + d] = rnd<W>(expf(Ks[t * ld_ + d] - mx) / s);
    }
    __syncthreads();
    if (first) stamp(a, 1);
    // ctx[:, c] = k'^T v[:, c] and y[:, c] = q' ctx[:, c], four partial
    // sums each to shorten the dependent chains
    for (int i = threadIdx.x; i < hd * AC; i += NT) {
      const int d = i / AC, cc = i - d * AC;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int t = 0;
      for (; t + 3 < T; t += 4) {
        s0 = fmaf(Ks[t * ld_ + d], Vs[t * AC + cc], s0);
        s1 = fmaf(Ks[(t + 1) * ld_ + d], Vs[(t + 1) * AC + cc], s1);
        s2 = fmaf(Ks[(t + 2) * ld_ + d], Vs[(t + 2) * AC + cc], s2);
        s3 = fmaf(Ks[(t + 3) * ld_ + d], Vs[(t + 3) * AC + cc], s3);
      }
      for (; t < T; ++t) s0 = fmaf(Ks[t * ld_ + d], Vs[t * AC + cc], s0);
      Cs[i] = rnd<W>((s0 + s1) + (s2 + s3));
    }
    __syncthreads();
    if (first) stamp(a, 2);
    for (int i = threadIdx.x; i < T * AC; i += NT) {
      const int t = i / AC, cc = i - t * AC;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int d = 0;
      for (; d + 3 < hd; d += 4) {
        s0 = fmaf(Qs[t * ld_ + d], Cs[d * AC + cc], s0);
        s1 = fmaf(Qs[t * ld_ + d + 1], Cs[(d + 1) * AC + cc], s1);
        s2 = fmaf(Qs[t * ld_ + d + 2], Cs[(d + 2) * AC + cc], s2);
        s3 = fmaf(Qs[t * ld_ + d + 3], Cs[(d + 3) * AC + cc], s3);
      }
      for (; d < hd; ++d) s0 = fmaf(Qs[t * ld_ + d], Cs[d * AC + cc], s0);
      y[((long long)b * T + t) * L + hh * hd + c * AC + cc] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
    if (first) stamp(a, 3);
  }
  stamp(a, 4);
}

// Shared floats of attention_chunks: a tile of tc frames of q (hd + 1
// wide) or of a k feature group, the item's v columns of those frames, ctx
// (hd x AC), and per feature of a group of dg: ctx's four partial sums per
// column, the softmax's four parts' max and sum, and its max and sum.
__host__ __device__ constexpr long long chunk_floats(int tc, int hd, int dg) {
  return (long long)tc * (hd + 1 + AC) + (long long)hd * AC
       + (long long)dg * (4 * AC + 10);
}

// The attention phase in chunks of a.tc frames (the host plans a.tc > 0
// where the window's tiles do not fit beside the products' room, or the
// head width is not a multiple of AC).  The same work items, and every
// value computed by the same operations in the same order as attention():
// a feature's softmax over time in four parts (part p takes the frames
// t = p mod 4 in order; a chunk starts at a multiple of 4), ctx's columns as
// four partial sums over time, each carried across the chunks in shared
// memory, and the same rnd points.  So per item: (a) per feature its max
// over time, (b) its sum of exponentials, (c) k' = softmax(k) rounded and
// ctx accumulated chunk by chunk, each pass walking the window; k's
// features in groups of a.dg (all of them unless a very wide head needs
// less room); then (d) softmax(q) and y, which are per frame, chunk by
// chunk.  An item of the head's last ctx columns takes hd - c AC < AC of
// them.  A window of one chunk is staged once for (a) - (c).  Compiled
// into the K-pass instantiation alone (fused_layers_kernel<W, QB, true>,
// which a plan with tc > 0 takes), so that the one-pass instantiations
// keep their code and registers.
template <typename W>
__device__ void attention_chunks(const Args& a, const float* qkv, float* y,
                                 float* smem) {
  const int T = a.T, L = a.L, H = a.H, tc = a.tc, dg = a.dg;
  const int hd = L / H, nc = (hd + AC - 1) / AC, ldq = hd + 1;
  const int n_items = a.B * H * nc;
  constexpr int parts = 4;
  float* Xs = smem;                   // tc x (hd + 1): q, or a k feature group
  float* Vs = Xs + tc * ldq;          // tc x AC
  float* Cs = Vs + tc * AC;           // hd x AC: ctx, rounded
  float* Acc = Cs + hd * AC;          // dg x AC x 4: ctx's partial sums
  float* Mx = Acc + dg * AC * 4;      // dg x 4: each part's max
  float* Sx = Mx + dg * parts;        // dg x 4: each part's sum
  float* Md = Sx + dg * parts;        // dg: the max over time
  float* Sd = Md + dg;                // dg: the sum over time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool one = tc >= T;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % nc, hh = (item / nc) % H, b = item / (nc * H);
    const int cw = min(AC, hd - c * AC);
    const float* base = qkv + (long long)b * T * 3 * L;
    const bool first = item == (int)blockIdx.x;
    for (int g0 = 0; g0 < hd; g0 += dg) {
      const int gw = min(dg, hd - g0), ldk = gw + 1;
      // frames t0 .. t0 + rows of k's features g0 .. g0 + gw
      auto stage_k = [&](int t0, int rows) {
        __syncthreads();                          // Xs is free
        for (int i = threadIdx.x; i < rows * gw; i += NT) {
          const int t = i / gw, d = i - t * gw;
          Xs[t * ldk + d] =
              base[(long long)(t0 + t) * 3 * L + L + hh * hd + g0 + d];
        }
        __syncthreads();
      };
      for (int i = threadIdx.x; i < gw * parts; i += NT) {
        Mx[i] = -FLT_MAX;
        Sx[i] = 0.f;
      }
      for (int i = threadIdx.x; i < gw * AC * 4; i += NT) Acc[i] = 0.f;
      // (a) each part's max (a thread keeps its own (feature, part) entries)
      for (int t0 = 0; t0 < T; t0 += tc) {
        const int rows = min(tc, T - t0);
        stage_k(t0, rows);
        if (first && t0 == 0 && g0 == 0) stamp(a, 0);
        for (int i = threadIdx.x; i < gw * parts; i += NT) {
          const int d = i / parts, part = i - d * parts;
          float mx = Mx[i];
          for (int t = part; t < rows; t += parts) mx = fmaxf(mx, Xs[t * ldk + d]);
          Mx[i] = mx;
        }
      }
      __syncthreads();
      for (int d = threadIdx.x; d < gw; d += NT)
        Md[d] = fmaxf(fmaxf(Mx[parts * d], Mx[parts * d + 1]),
                      fmaxf(Mx[parts * d + 2], Mx[parts * d + 3]));
      __syncthreads();
      // (b) each part's sum of exponentials, then theirs as the shuffles of
      // attention() add them
      for (int t0 = 0; t0 < T; t0 += tc) {
        const int rows = min(tc, T - t0);
        if (!one) stage_k(t0, rows);
        for (int i = threadIdx.x; i < gw * parts; i += NT) {
          const int d = i / parts, part = i - d * parts;
          const float mx = Md[d];
          float s = Sx[i];
          for (int t = part; t < rows; t += parts) s += expf(Xs[t * ldk + d] - mx);
          Sx[i] = s;
        }
      }
      __syncthreads();
      for (int d = threadIdx.x; d < gw; d += NT)
        Sd[d] = (Sx[parts * d] + Sx[parts * d + 1])
              + (Sx[parts * d + 2] + Sx[parts * d + 3]);
      __syncthreads();
      if (first && g0 == 0) stamp(a, 1);
      // (c) k' rounded, and ctx[:, c] = k'^T v[:, c] summed chunk by chunk
      for (int t0 = 0; t0 < T; t0 += tc) {
        const int rows = min(tc, T - t0);
        if (!one) stage_k(t0, rows);
        if (!one || g0 == 0)
          for (int i = threadIdx.x; i < rows * AC; i += NT) {
            const int t = i / AC, cc = i - t * AC;
            Vs[i] = cc < cw ? rnd<W>(base[(long long)(t0 + t) * 3 * L + 2 * L
                                          + hh * hd + c * AC + cc]) : 0.f;
          }
        for (int i = threadIdx.x; i < rows * gw; i += NT) {
          const int t = i / gw, d = i - t * gw;
          Xs[t * ldk + d] = rnd<W>(expf(Xs[t * ldk + d] - Md[d]) / Sd[d]);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < gw * AC; i += NT) {
          const int d = i / AC, cc = i - d * AC;
          float* p = Acc + 4 * i;
          float s0 = p[0], s1 = p[1], s2 = p[2], s3 = p[3];
          int t = 0;
          for (; t + 3 < rows; t += 4) {
            s0 = fmaf(Xs[t * ldk + d], Vs[t * AC + cc], s0);
            s1 = fmaf(Xs[(t + 1) * ldk + d], Vs[(t + 1) * AC + cc], s1);
            s2 = fmaf(Xs[(t + 2) * ldk + d], Vs[(t + 2) * AC + cc], s2);
            s3 = fmaf(Xs[(t + 3) * ldk + d], Vs[(t + 3) * AC + cc], s3);
          }
          for (; t < rows; ++t) s0 = fmaf(Xs[t * ldk + d], Vs[t * AC + cc], s0);
          p[0] = s0;
          p[1] = s1;
          p[2] = s2;
          p[3] = s3;
        }
      }
      for (int i = threadIdx.x; i < gw * AC; i += NT) {
        const float* p = Acc + 4 * i;
        Cs[(g0 + i / AC) * AC + i % AC] = rnd<W>((p[0] + p[1]) + (p[2] + p[3]));
      }
      __syncthreads();                            // Acc and Xs are free
    }
    if (first) stamp(a, 2);
    // (d) softmax(q) over the head's features, one warp per frame, and
    // y[:, c] = q' ctx[:, c], chunk by chunk
    for (int t0 = 0; t0 < T; t0 += tc) {
      const int rows = min(tc, T - t0);
      for (int i = threadIdx.x; i < rows * hd; i += NT) {
        const int t = i / hd, d = i - t * hd;
        Xs[t * ldq + d] = base[(long long)(t0 + t) * 3 * L + hh * hd + d];
      }
      __syncthreads();
      for (int t = warp; t < rows; t += NT / 32) {
        float* q = Xs + t * ldq;
        float mx = -FLT_MAX;
        for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, q[d]);
        mx = warp_max(mx);
        float s = 0.f;
        for (int d = lane; d < hd; d += 32) s += expf(q[d] - mx);
        s = warp_sum(s);
        for (int d = lane; d < hd; d += 32) q[d] = rnd<W>(expf(q[d] - mx) / s);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows * AC; i += NT) {
        const int t = i / AC, cc = i - t * AC;
        if (cc >= cw) continue;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int d = 0;
        for (; d + 3 < hd; d += 4) {
          s0 = fmaf(Xs[t * ldq + d], Cs[d * AC + cc], s0);
          s1 = fmaf(Xs[t * ldq + d + 1], Cs[(d + 1) * AC + cc], s1);
          s2 = fmaf(Xs[t * ldq + d + 2], Cs[(d + 2) * AC + cc], s2);
          s3 = fmaf(Xs[t * ldq + d + 3], Cs[(d + 3) * AC + cc], s3);
        }
        for (; d < hd; ++d) s0 = fmaf(Xs[t * ldq + d], Cs[d * AC + cc], s0);
        y[((long long)b * T + t0 + t) * L + hh * hd + c * AC + cc] =
            (s0 + s1) + (s2 + s3);
      }
      __syncthreads();                            // Xs is free
    }
    if (first) stamp(a, 3);
  }
  stamp(a, 4);
}

// Field f of layer `layer`, and (quantized) the scales of matrix field f.
__device__ __forceinline__ const void* wp(const Args& a, int f, int layer) {
  return static_cast<const char*>(a.w[f]) + layer * a.wstride[f];
}
__device__ __forceinline__ const float* sp(const Args& a, int f, int layer) {
  const int q = scale_of(f);
  return reinterpret_cast<const float*>(static_cast<const char*>(a.sc[q])
                                        + layer * a.sstride[q]);
}

// Phase stamp n (after the grid barrier that ends phase n - 1), and where
// the stamps inside phase n go.
__device__ __forceinline__ void mark(const Args& a, int& n) {
#ifdef DIFFSHEG_TRACE
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[n] = t;
    trace_sub = a.trace + 1 + NPHASE * a.n_layers + n * NSUB;
  }
#endif
  ++n;
}

// Product `i` (0 .. 6, phase order) of one layer.
template <typename W, int QB>
__device__ __forceinline__ Prod layer_prod(const Args& a, int layer, int i,
                                           float* h, float* x1, float* qkv,
                                           float* x2, float* g, W* act,
                                           W* opA, W* opB) {
  const int L = a.L;
  Prod p{};
  auto w = [&](Prod& q, int k0, int k1, int k2) {
    q.wk0 = wp(a, k0, layer); q.wb0 = wp(a, k0 + 1, layer);
    q.wk1 = k1 < 0 ? nullptr : wp(a, k1, layer);
    q.wb1 = k1 < 0 ? nullptr : wp(a, k1 + 1, layer);
    q.wk2 = k2 < 0 ? nullptr : wp(a, k2, layer);
    q.wb2 = k2 < 0 ? nullptr : wp(a, k2 + 1, layer);
    if constexpr (QB != 0) {
      q.ws0 = sp(a, k0, layer);
      q.ws1 = k1 < 0 ? nullptr : sp(a, k1, layer);
      q.ws2 = k2 < 0 ? nullptr : sp(a, k2, layer);
    }
  };
  switch (i) {
    case 0:   // LN(feats) -> fc1 -> SiLU
      p.A = opA; p.K = a.Cp; p.N = p.ncol = 2 * L; w(p, FC1_K, -1, -1);
      p.epi = E_SILU_RND; p.dst_w = act; break;
    case 1:   // fc2 + x
      p.A = act; p.K = 2 * L; p.N = p.ncol = L; w(p, FC2_K, -1, -1);
      p.epi = E_RES; p.res = h; p.dst = x1; break;
    case 2:   // LN -> Q, K, V (one product over the three matrices' columns)
      p.A = opA; p.K = L; p.N = 3 * L; p.ncol = L; w(p, Q_K, K_K, V_K);
      p.epi = E_BIAS; p.dst = qkv; break;
    case 3:   // LN -> AdaLN -> SiLU -> out + x1 (and x2 rounded, for l1)
      p.A = opA; p.K = L; p.N = p.ncol = L; w(p, SA_OUT_K, -1, -1);
      p.epi = E_RES; p.res = x1; p.dst = x2; p.dst_w = opB; break;
    case 4:   // FFN l1 -> GELU
      p.A = opB; p.K = L; p.N = p.ncol = a.F; w(p, L1_K, -1, -1);
      p.epi = E_GELU_RND; p.dst_w = act; break;
    case 5:   // l2
      p.A = act; p.K = a.F; p.N = p.ncol = L; w(p, L2_K, -1, -1);
      p.epi = E_BIAS; p.dst = g; break;
    default:  // LN -> AdaLN -> SiLU -> out + x2: the layer's output
      p.A = opA; p.K = L; p.N = p.ncol = L; w(p, FF_OUT_K, -1, -1);
      p.epi = E_RES_FINAL; p.res = x2; p.dst = h;
      p.last = layer == a.n_layers - 1; break;
  }
  return p;
}

// One block an SM (its shared memory takes no more): without the 1, ptxas
// held <float, 8> to 128 registers, and it spilled.  PASSES: the K-pass
// products (product_passes), which take no slice ahead, and the attention
// in chunks of T where the plan asks for it (a.tc > 0).
template <typename W, int QB, bool PASSES>
__global__ void __launch_bounds__(NT, 1) fused_layers_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NT / 32];
  const int M = a.B * a.T, L = a.L;
  // scratch: f32 rows (resident state and intermediates), then the
  // products' operands in the weight dtype
  float* h = a.scratch;                 // M x L
  float* x1 = h + (size_t)M * L;        // M x L
  float* qkv = x1 + (size_t)M * L;      // M x 3L
  float* y = qkv + (size_t)M * 3 * L;   // M x L
  float* x2 = y + (size_t)M * L;        // M x L
  float* g = x2 + (size_t)M * L;        // M x L
  W* act = reinterpret_cast<W*>(g + (size_t)M * L);         // M x max(2L, F)
  W* opA = act + (size_t)M * (2 * L > a.F ? 2 * L : a.F);   // M x max(Cp, L)
  W* opB = opA + (size_t)M * (a.Cp > L ? a.Cp : L);         // M x L
#define PROD(layer, i) layer_prod<W, QB>(a, layer, i, h, x1, qkv, x2, g, act, opA, opB)
#define SYNC() \
  do { barrier_wait(a.barrier, barrier_arrive(a.barrier)); mark(a, n); } while (0)
// the barrier before product i, the block's first slice asked for inside it
#define SYNC_BEFORE(layer, i) do { \
    const unsigned seen = barrier_arrive(a.barrier); \
    if constexpr (!PASSES) fetch_ahead<W, QB>(PROD(layer, i), ahead); \
    barrier_wait(a.barrier, seen); mark(a, n); } while (0)

  int n = 0;
  Slice<W, QB> ahead;
  ahead.have = false;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = tid; i < (long long)M * L; i += (long long)gridDim.x * NT)
    h[i] = ld<W>(a.x, i);
  SYNC();

  for (int layer = 0; layer < a.n_layers; ++layer) {
    const void* msa = static_cast<const char*>(a.mod_sa)
        + (size_t)layer * a.mod_layer_stride * sizeof(W);
    const void* mffn = static_cast<const char*>(a.mod_ffn)
        + (size_t)layer * a.mod_layer_stride * sizeof(W);
    row_phase<W>(a, R_FEATS, nullptr, a.Cp, wp(a, FP_NORM_S, layer),
                 wp(a, FP_NORM_B, layer), nullptr, h, opA, red);
    SYNC_BEFORE(layer, 0);
    product<W, QB, PASSES>(a, PROD(layer, 0), smem, ahead);
    SYNC_BEFORE(layer, 1);
    product<W, QB, PASSES>(a, PROD(layer, 1), smem, ahead);
    SYNC();
    row_phase<W>(a, R_LN, x1, L, wp(a, SA_NORM_S, layer),
                 wp(a, SA_NORM_B, layer), nullptr, h, opA, red);
    SYNC_BEFORE(layer, 2);
    product<W, QB, PASSES>(a, PROD(layer, 2), smem, ahead);
    SYNC();
    if constexpr (PASSES) {
      float* tiles = reinterpret_cast<float*>(smem);
      if (a.tc != 0) attention_chunks<W>(a, qkv, y, tiles);
      else attention<W>(a, qkv, y, tiles);
    } else {
      attention<W>(a, qkv, y, reinterpret_cast<float*>(smem));
    }
    SYNC();
    row_phase<W>(a, R_LNMOD, y, L, wp(a, SA_SO_S, layer),
                 wp(a, SA_SO_B, layer), msa, h, opA, red);
    SYNC_BEFORE(layer, 3);
    product<W, QB, PASSES>(a, PROD(layer, 3), smem, ahead);
    SYNC_BEFORE(layer, 4);
    product<W, QB, PASSES>(a, PROD(layer, 4), smem, ahead);
    SYNC_BEFORE(layer, 5);
    product<W, QB, PASSES>(a, PROD(layer, 5), smem, ahead);
    SYNC();
    row_phase<W>(a, R_LNMOD, g, L, wp(a, FF_SO_S, layer),
                 wp(a, FF_SO_B, layer), mffn, h, opA, red);
    SYNC_BEFORE(layer, 6);
    product<W, QB, PASSES>(a, PROD(layer, 6), smem, ahead);
    if (layer + 1 < a.n_layers || (TRACE && a.trace != nullptr)) SYNC();
  }
#undef PROD
#undef SYNC_BEFORE
#undef SYNC
}

// Shared memory of one block: [operand rows | attention tiles] (the larger
// of the two), then the weight slice room, then the warps' partial tiles.
// The host lays it out (ops/fused_layer.py::k_pass_plan, which gives the
// pass width kp, a_elems, w_off, part_off and the bytes): bf16 gives the
// operand up to 160 KB, all B*T rows of a kp-wide operand when they fit
// (serving shapes), else row blocks of 16; f32 gives the slice room one
// item's split slice and the operand what is left, with 15 rows of its
// width free behind it for a last tile's reads past the staged rows (at
// kp = 1024, 35 rows, 40 with int8 codes: one 34-row window is staged
// whole).  The attention tiles are the whole window's (tc 0) where they fit
// beside the slice room, else chunks of tc frames that do (tc, dg above).
// fits_plan holds that layout to what the kernel touches.
constexpr size_t SMEM_CAP = 227 * 1024 - 1024;  // dynamic, beside the static
__host__ __device__ inline int widest_k(const Args& a) {
  return max(max(a.Cp, 2 * a.L), max(a.F, a.L));
}
template <typename W, int QB>
bool fits_plan(const Args& a, size_t bytes) {
  if (a.kp < 16 || a.kp % 16 || a.kp > widest_k(a) || bytes > SMEM_CAP
      || a.w_off % 16)
    return false;
  const int hd = a.L / a.H, lda = lda_of<W>(a.kp);
  const int rows = a.a_elems / lda;
  const size_t part = sizeof(float) * (NT / 32) * RB * TN;
  // attention(): the whole window's q and k tiles, its v columns, ctx (whole
  // 8-column items); attention_chunks(): chunks of tc frames, a multiple of
  // 4 unless one chunk holds the window, k features in groups of dg
  if (a.tc == 0 ? hd % AC != 0
      : a.tc < 1 || (a.tc < a.T && a.tc % 4) || a.tc > a.T || a.dg < 1
        || a.dg > hd)
    return false;
  const size_t attn = a.tc == 0
      ? sizeof(float) * ((size_t)2 * a.T * (hd + 1) + (size_t)a.T * AC
                         + (size_t)hd * AC)
      : sizeof(float) * (size_t)chunk_floats(a.tc, hd, a.dg);
  // f32: the split slice (QB 0: hi and lo tiles; QB 8: one of codes; QB 4:
  // two of nibbles); bf16: one tile, two for packed int4
  const size_t wbytes = sizeof(W) == 4
      ? sizeof(float) * TN * (size_t)a.kp * (QB == 8 ? 1 : 2)
      : sizeof(W) * TN * (size_t)a.kp * item_tiles<QB>();
  // a product reads whole 16-row tiles of the staged rows
  const size_t reach = sizeof(W) * (size_t)lda * ((rows + 15) / 16 * 16);
  return rows >= 16 && (size_t)a.w_off >= max(sizeof(W) * a.a_elems, attn)
      && (size_t)a.part_off >= a.w_off + wbytes
      && bytes >= a.part_off + part && bytes >= reach;
}

// Refusals of a launch's arguments, apart from the cudaError_t codes
// (ops/fused_layer.py::_launch names each).
enum Refusal {
  REFUSE_PLAN = -3,     // the host's shared-memory plan does not fit
  REFUSE_ARGS = -4,     // no barrier word, a trace without the traced build,
                        // a qb other than 0, 8, 4, or heads that do not
                        // divide L
};

// Launch geometry of fused_layers_kernel<W, QB, PASSES> at the host's
// plan: the dynamic shared memory and the grid.
template <typename W, int QB, bool PASSES>
int plan(const Args& a, size_t smem, int* grid_out) {
  // cached per instantiation: the SM count never changes and the
  // occupancy only with the dynamic shared memory size
  static int sms = 0, occ = 0;
  static size_t smem_set = 0;
  if (!fits_plan<W, QB>(a, smem)) return REFUSE_PLAN;
  void* fn = (void*)fused_layers_kernel<W, QB, PASSES>;
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
  }
  if (smem != smem_set) {
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem)) != cudaSuccess)
      return (int)e;
    smem_set = smem;
  }
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid_out = sms * (occ < 2 ? occ : 2);
  return 0;
}

// The instantiation the plan asks for: K passes where the pass width is
// narrower than the widest product, or the attention runs in chunks (its
// products then take one pass, product_passes with kp = K).
template <typename W, int QB>
int plan_of(const Args& a, size_t smem, int* grid, void** fn) {
  if (a.kp < widest_k(a) || a.tc != 0) {
    *fn = (void*)fused_layers_kernel<W, QB, true>;
    return plan<W, QB, true>(a, smem, grid);
  }
  *fn = (void*)fused_layers_kernel<W, QB, false>;
  return plan<W, QB, false>(a, smem, grid);
}

template <typename W>
int plan_qb(int qb, const Args& a, size_t smem, int* grid, void** fn) {
  return qb == 0 ? plan_of<W, 0>(a, smem, grid, fn)
       : qb == 8 ? plan_of<W, 8>(a, smem, grid, fn)
       : qb == 4 ? plan_of<W, 4>(a, smem, grid, fn) : REFUSE_ARGS;
}

int cooperative(void* fn, int grid, void** params, size_t smem,
                cudaStream_t stream) {
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT), params,
                                              smem, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Probes on the kernel's own grid and dynamic shared memory (chip_smoke.py
// times them).  The barrier probe runs n grid barriers and nothing else:
// the floor the layers' barriers set.  The copy probe has every block stage
// the same `rows` operand rows of K elements n times with the products'
// own stage_a, as a product phase does; the repeats rotate through
// COPY_SETS row sets, more than an SM's L1 holds, so each copy comes out
// of L2 as a product's freshly written operand does.
constexpr int COPY_SETS = 4;
__global__ void __launch_bounds__(NT)
barrier_probe_kernel(int n, unsigned* word) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = 0; i < n; ++i) barrier_wait(word, barrier_arrive(word));
}

template <typename W>
__global__ void __launch_bounds__(NT)
copy_probe_kernel(const W* src, int rows, int K, int lda, int n,
                  float* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  Prod p{};
  p.K = K;
  W* As = reinterpret_cast<W*>(smem);
  for (int i = 0; i < n; ++i) {
    p.A = src + (long long)(i % COPY_SETS) * rows * K;
    stage_a<W>(p, 0, rows, As, lda);
    __syncthreads();
  }
  if (sink != nullptr) *sink = ld<W>(As, threadIdx.x);   // never taken
}

template <typename W>
int copy_probe(const Args& a, size_t smem, int grid, int n, const void* buf,
               cudaStream_t stream) {
  const int lda = lda_of<W>(a.kp);
  const int rows = min(a.B * a.T, a.a_elems / lda);
  if (cudaError_t e = cudaFuncSetAttribute(
          copy_probe_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem))
    return (int)e;
  copy_probe_kernel<W><<<grid, NT, smem, stream>>>(
      static_cast<const W*>(buf), rows, a.kp, lda, n, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the N_FIELDS weight bases, then x, feats|cond, mod_sa, mod_ffn,
//       null_emb, null_mask, out, scratch, trace (0 for absent), then the
//       N_SCALES scale bases (0 unquantized), then the grid barrier's word
//       (4 bytes, zero before the first launch that uses it, shared only by
//       launches that cannot run side by side: those of one stream).
//       scratch holds M * 8 L
//       floats then M * (L + max(2 L, F) + max(Cp, L)) weight-dtype
//       elements, M = B * T; trace, when given, receives
//       1 + 12 * n_layers globaltimer stamps (ns), one per phase end, then
//       block 0's NSUB = 5 stamps inside each of the 12 * n_layers phases
//       (see stamp()).
// ints: the N_FIELDS per-layer strides in bytes, then mod_layer_stride
//       (elements), chain, n_layers, B, T, L, Cp, c_real, F, H, qb (0, 8
//       or 4), then the N_SCALES per-layer scale strides in bytes, then the
//       host's plan (ops/fused_layer.py::k_pass_plan): the pass width kp,
//       a_elems, w_off, part_off, the dynamic shared memory bytes, and the
//       attention's tc (0: the whole window in one tile) and dg.
// dtype: 0 = float32, 1 = bfloat16 (x, feats/cond, mods, out, vectors and
//       unquantized matrices; the compute dtype of the products).
namespace {
// The arguments, and 0 or the refusal of arguments the kernel never takes.
int parse(const uint64_t* ptrs, const int64_t* ints, Args* out, int* qb_out,
          size_t* smem_out) {
  Args a{};
  for (int f = 0; f < N_FIELDS; ++f) {
    a.w[f] = reinterpret_cast<const void*>(ptrs[f]);
    a.wstride[f] = ints[f];
  }
  int i = N_FIELDS;
  a.x = reinterpret_cast<const void*>(ptrs[i++]);
  a.feats = reinterpret_cast<const void*>(ptrs[i++]);
  a.mod_sa = reinterpret_cast<const void*>(ptrs[i++]);
  a.mod_ffn = reinterpret_cast<const void*>(ptrs[i++]);
  a.null_emb = reinterpret_cast<const void*>(ptrs[i++]);
  a.null_mask = reinterpret_cast<const float*>(ptrs[i++]);
  a.out = reinterpret_cast<void*>(ptrs[i++]);
  a.scratch = reinterpret_cast<float*>(ptrs[i++]);
  a.trace = reinterpret_cast<unsigned long long*>(ptrs[i++]);
  for (int q = 0; q < N_SCALES; ++q) a.sc[q] = reinterpret_cast<const void*>(ptrs[i++]);
  a.barrier = reinterpret_cast<unsigned*>(ptrs[i++]);
  int j = N_FIELDS;
  a.mod_layer_stride = ints[j++];
  a.chain = (int)ints[j++];
  a.n_layers = (int)ints[j++];
  a.B = (int)ints[j++];
  a.T = (int)ints[j++];
  a.L = (int)ints[j++];
  a.Cp = (int)ints[j++];
  a.c_real = (int)ints[j++];
  a.F = (int)ints[j++];
  a.H = (int)ints[j++];
  *qb_out = (int)ints[j++];
  for (int q = 0; q < N_SCALES; ++q) a.sstride[q] = ints[j++];
  a.kp = (int)ints[j++];
  a.a_elems = (int)ints[j++];
  a.w_off = (int)ints[j++];
  a.part_off = (int)ints[j++];
  *smem_out = (size_t)ints[j++];
  a.tc = (int)ints[j++];
  a.dg = (int)ints[j++];
  *out = a;
  if (a.barrier == nullptr || (!TRACE && a.trace != nullptr) || a.H < 1
      || a.L % a.H)
    return REFUSE_ARGS;
  return 0;
}

// The launch's instantiation, shared memory and grid.
int plan_all(int dtype, int qb, const Args& a, size_t smem, int* grid,
             void** fn) {
  return dtype == 1 ? plan_qb<__nv_bfloat16>(qb, a, smem, grid, fn)
                    : plan_qb<float>(qb, a, smem, grid, fn);
}
}  // namespace

extern "C" int diffsheg_fused_layers(int dtype, const uint64_t* ptrs,
                                     const int64_t* ints, void* stream) {
  Args a{};
  int qb = 0, grid = 0;
  size_t smem = 0;
  void* fn = nullptr;
  if (const int e = parse(ptrs, ints, &a, &qb, &smem)) return e;
  if (const int e = plan_all(dtype, qb, a, smem, &grid, &fn)) return e;
  void* params[] = {&a};
  return cooperative(fn, grid, params, smem,
                     reinterpret_cast<cudaStream_t>(stream));
}

// The probes above, on the grid and shared memory that a launch with these
// ptrs and ints would get (out[0]: blocks, out[1]: dynamic shared memory
// bytes, out[2]: rows x out[3]: elements a block copies per repeat, at the
// pass width).  kind 0: n grid barriers; kind 1: every block copies the
// same operand rows n times.  buf (kind 1): COPY_SETS * out[2] * out[3]
// elements of the launch's dtype; n < 0 only fills out.
extern "C" int diffsheg_fused_layers_probe(int dtype, const uint64_t* ptrs,
                                           const int64_t* ints, void* stream,
                                           int kind, int n, uint64_t buf,
                                           int64_t* out) {
  Args a{};
  int qb = 0, grid = 0;
  size_t smem = 0;
  void* fn = nullptr;
  if (const int e = parse(ptrs, ints, &a, &qb, &smem)) return e;
  if (const int e = plan_all(dtype, qb, a, smem, &grid, &fn)) return e;
  out[0] = grid;
  out[1] = (int64_t)smem;
  out[2] = min(a.B * a.T, a.a_elems / (dtype == 1 ? lda_of<__nv_bfloat16>(a.kp)
                                                  : lda_of<float>(a.kp)));
  out[3] = a.kp;
  if (n < 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (cudaError_t ce = cudaFuncSetAttribute(
            barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
      return (int)ce;
    void* params[] = {&n, &a.barrier};
    return cooperative((void*)barrier_probe_kernel, grid, params, smem, s);
  }
  const void* b = reinterpret_cast<const void*>(buf);
  return dtype == 1
      ? copy_probe<__nv_bfloat16>(a, smem, grid, n, b, s)
      : copy_probe<float>(a, smem, grid, n, b, s);
}
