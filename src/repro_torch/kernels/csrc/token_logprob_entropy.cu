// Fused token log-probability + entropy over a tiled vocabulary, forward
// and the logit cotangent of the backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/logprob/kernel.py,
//   token_logprob_entropy_pallas (the Pallas TPU kernel), and the autodiff
//   of src/repro/kernels/logprob/ref.py that the JAX package uses for its
//   backward (it has no backward kernel).
//   hidden [T,d], w [d,V] (any two strides, one of them 1: the tied
//   embedding's transposed view [V,d] is read in place), targets [T] int32.
//   Forward -> logp, entropy, logz, mean logit, float32 [T].
//   Backward -> dl [T,V] for one chunk of tokens,
//     dl_j = g_logp*(1[j=t] - p_j) - g_ent*p_j*(l_j - mu),
//   from which the caller forms dh = dl w^T and dw = h^T dl with two
//   library products.
//
// What bounds it: operations. A pass computes 2*T*d*V flops of logits
//   (1.07 TFLOP at T = 2300, d = 1536, V = 151,936, about 1.09 ms at the
//   card's 989 TFLOP/s in bf16) against ~0.5 GB of operands, far above the
//   card's ~295 flop/byte balance point. The logits never reach device
//   memory in the forward: a block folds each logit tile into four online
//   per-row statistics (max m, sum of exp(l - m), sum of exp(l - m) *
//   (l - m), target logit), and a second small pass merges the blocks'
//   vocab ranges. The third sum is relative to the running max, not sum
//   exp * l: a sum of terms ~|l| (tens) loses ~|l| 2^-24 an add, ~1e-5
//   absolute over a vocabulary, which the backward's l - mu carries into
//   dh; relative to m the dominant terms are near 0. The backward
//   is three such products (this kernel's logit recompute, then dh and
//   dw): 3.26 ms at the tensor-core rate at that shape.
//
// What the design does about it (bf16 operands whose rows are 16-byte
//   aligned, namespace wg): the tensor cores at their full rate through
//   wgmma, fed by TMA, for both directions; one kernel (walk) with the
//   forward's and the backward's epilogues as a template parameter.
//   - One block of three warpgroups per (128-token tile, vocab range); the
//     grid runs the token tiles of a range side by side, so that w streams
//     from device memory about once and is reread from L2 (h, 7 MB at the
//     step's shape, stays there). The wrapper's plan picks the ranges from
//     host-known sizes to fill the 132 SMs in whole waves.
//   - The producer warpgroup gives up its registers (setmaxnreg); one of its
//     threads keeps a ring of 4 stages of (h: 128 tokens x 64 deep, w: 64
//     deep x 128 vocab) in flight by TMA, 128-byte swizzled, with a full
//     and an empty mbarrier per stage. w is read through either layout
//     (the tied head's k-contiguous view, or an untied [d, V] head,
//     V-contiguous), as wgmma's K-major or MN-major B operand; tensor maps
//     zero-fill the edges (tokens past T, vocab past V, depth past d).
//   - Two consumer warpgroups own 64 tokens each and run wgmma m64n128k16
//     (float32 accumulators in registers), one k-step's group in flight
//     while the next stage is awaited. Products of bf16 values are exact
//     in float32, so this is the reference's float32 upcast up to
//     summation order.
//   - Forward epilogue (Stats) in registers: each thread holds 2 rows x 32
//     columns of the tile; the row maximum by quad shuffles, then one FFMA
//     and one ex2 a logit for the sums, no shared-memory logit tile.
//   - Backward epilogue (Cotangent): dl from the saved logz and mu in
//     registers (one FFMA and one ex2 for p), stored as a bf16 high part
//     and the bf16 rounding of the remainder, two planes of rows padded to
//     a multiple of 8 entries: ~16 bits, the float32 dl to 2^-16, in half
//     the bytes of a float32 dl. The caller's two gradient products then
//     run on the tensor cores with bf16 operands (both parts at once,
//     float32 accumulation): float32 products of a float32 dl would run on
//     the CUDA cores at a fifteenth of that rate, on float32 copies of W
//     and h.
//   What still holds the backward back: the parts double the two products'
//   work (5/3 of the bound's flops), dl makes a round trip through device
//   memory (1.4 GB written and read twice at the step's shape), and each
//   tile's epilogue leaves the tensor cores idle (one accumulator set: 168
//   registers, the launch's limit for 384 threads, no spill).
// Other operands (float32, or bf16 rows not 16-byte aligned) take the
//   first design (namespace-level kernels below): a block owns 64 tokens
//   and a contiguous range of 128-entry vocab tiles, computes each tile
//   with wmma 16x16x16 (bf16) or float32 FMAs through a shared-memory
//   logit tile; the backward recomputes each tile and writes the float32
//   cotangent tile, and the caller's products run in float32. Masked edges
//   as above.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;    // tokens per tile
constexpr int BN = 128;   // vocab entries per tile
constexpr int BK = 32;    // depth per step
constexpr int NT = 256;   // threads per block (8 warps)
constexpr int LD16 = BK + 8;   // bf16 operand tiles (wmma: ldm % 8 == 0)
constexpr int LD32 = BK + 1;   // float operand tiles (bank-conflict free)
constexpr int LDL = BN + 4;    // float logit tile
// the operand tiles and the logit tile are never live together
constexpr int SMEM_BYTES = BM * LDL * 4;
static_assert(BM * LD16 * 2 + BN * LD16 * 2 <= SMEM_BYTES, "smem");
static_assert(BM * LD32 * 4 + BN * LD32 * 4 <= SMEM_BYTES, "smem");

struct Shape {
  int rows;           // tokens
  int d;              // depth
  int V;              // vocabulary
  long long sk, sn;   // strides of w along d and along V (elements)
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.0f);
}

// hidden tile [BM][BK] -> As (row stride lda)
template <typename T, bool VEC>
__device__ __forceinline__ void load_a(const T* __restrict__ h,
                                       const Shape& s, int m0, int k0, T* As,
                                       int lda) {
  if constexpr (VEC) {  // 8 bf16 = 16 bytes a thread, one load each
    int r = threadIdx.x / (BK / 8), c = (threadIdx.x % (BK / 8)) * 8;
    int m = m0 + r, k = k0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < s.rows && k < s.d)
      v = *reinterpret_cast<const uint4*>(h + (long long)m * s.d + k);
    *reinterpret_cast<uint4*>(As + r * lda + c) = v;
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      As[r * lda + c] =
          (m < s.rows && k < s.d) ? h[(long long)m * s.d + k] : zero_of<T>();
    }
  }
}

// w tile (k in [k0,k0+BK), n in [n0,n0+BN)) -> Bs[n][k] (row stride ldb)
template <typename T, bool WK1, bool VEC>
__device__ __forceinline__ void load_b(const T* __restrict__ w,
                                       const Shape& s, int n0, int k0, T* Bs,
                                       int ldb) {
  if constexpr (VEC) {  // bf16, k contiguous: 16-byte loads along k
    for (int i = threadIdx.x; i < BN * (BK / 8); i += NT) {
      int n = i / (BK / 8), c = (i % (BK / 8)) * 8;
      int vn = n0 + n, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (vn < s.V && k < s.d)
        v = *reinterpret_cast<const uint4*>(w + (long long)vn * s.sn + k);
      *reinterpret_cast<uint4*>(Bs + n * ldb + c) = v;
    }
  } else if constexpr (WK1) {  // neighbouring threads along k
    for (int i = threadIdx.x; i < BN * BK; i += NT) {
      int n = i / BK, c = i % BK, vn = n0 + n, k = k0 + c;
      Bs[n * ldb + c] = (vn < s.V && k < s.d)
                            ? w[(long long)vn * s.sn + k]
                            : zero_of<T>();
    }
  } else {  // neighbouring threads along n
    for (int i = threadIdx.x; i < BN * BK; i += NT) {
      int n = i % BN, c = i / BN, vn = n0 + n, k = k0 + c;
      Bs[n * ldb + c] = (vn < s.V && k < s.d)
                            ? w[(long long)k * s.sk + vn]
                            : zero_of<T>();
    }
  }
}

// The logit tile rows [m0, m0+BM) x vocab [n0, n0+BN) into smem as float
// [BM][LDL]; returns after a barrier, so every thread may read it.
template <typename T, bool WK1, bool VEC>
__device__ void logit_tile(const T* __restrict__ h, const T* __restrict__ w,
                           const Shape& s, int m0, int n0,
                           unsigned char* smem) {
  float* Ls = reinterpret_cast<float*>(smem);
  if constexpr (sizeof(T) == 2) {
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + BM * LD16;
    const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < s.d; k0 += BK) {
      __syncthreads();  // earlier readers of the tiles are done
      load_a<T, VEC>(h, s, m0, k0, As, LD16);
      load_b<T, WK1, VEC>(w, s, n0, k0, Bs, LD16);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LD16 + kk,
                                 LD16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LD16 + kk,
                                 LD16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // the logit tile overwrites the operand tiles
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Ls + (wm * 32 + i * 16) * LDL + wn * 32 + j * 16, acc[i][j], LDL,
            wmma::mem_row_major);
  } else {
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + BM * LD32;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < s.d; k0 += BK) {
      __syncthreads();
      load_a<T, false>(h, s, m0, k0, As, LD32);
      load_b<T, WK1, false>(w, s, n0, k0, Bs, LD32);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * LD32 + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * LD32 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ls[(ty * 4 + i) * LDL + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pass 1: per (token tile, vocab range) the four online statistics of
// each row, written to part[4][splits][rows].
template <typename T, bool WK1, bool VEC>
__global__ void __launch_bounds__(NT)
    forward_partial(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ targets, Shape s,
                    int tiles_per_split, int n_tiles,
                    float* __restrict__ part) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Ls = reinterpret_cast<const float*>(smem);
  const int m0 = blockIdx.x * BM, split = blockIdx.y, splits = gridDim.y;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  // four threads per row; thread q reads columns q, q+4, ... (no bank
  // conflicts: a warp's 8 rows x 4 quarters cover all 32 banks)
  const int r = threadIdx.x / 4, q = threadIdx.x % 4, row = m0 + r;
  const int tgt = row < s.rows ? targets[row] : -1;
  float run_m = -INFINITY, run_l = 0.0f, run_s = 0.0f, tgt_logit = 0.0f;
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    logit_tile<T, WK1, VEC>(h, w, s, m0, n0, smem);
    const int valid = min(BN, s.V - n0);
    const float* lrow = Ls + r * LDL;
    float bmax = -INFINITY;
    for (int c = q; c < valid; c += 4) bmax = fmaxf(bmax, lrow[c]);
    const float m_new = fmaxf(run_m, quad_max(bmax));
    float se = 0.0f, ss = 0.0f;
    for (int c = q; c < valid; c += 4) {
      const float v = lrow[c], e = expf(v - m_new);
      se += e;
      ss += e * (v - m_new);
    }
    const float corr = expf(run_m - m_new);  // 0 on the first tile
    // the running sum of exp(l - m) (l - m), moved from run_m to m_new
    const float shift = run_l > 0.0f ? (m_new - run_m) * run_l : 0.0f;
    run_s = (run_s - shift) * corr + quad_sum(ss);
    run_l = run_l * corr + quad_sum(se);
    run_m = m_new;
    const int lt = tgt - n0;
    if (lt >= 0 && lt < valid && (lt & 3) == q) tgt_logit = lrow[lt];
  }
  tgt_logit = quad_sum(tgt_logit);  // one lane of one range holds it
  if (q == 0 && row < s.rows) {
    const long long plane = (long long)splits * s.rows;
    const long long at = (long long)split * s.rows + row;
    part[at] = run_m;
    part[plane + at] = run_l;
    part[2 * plane + at] = run_s;
    part[3 * plane + at] = tgt_logit;
  }
}

// Pass 2: merge the ranges of each row.
__global__ void forward_merge(const float* __restrict__ part, int splits,
                              int rows, float* __restrict__ logp,
                              float* __restrict__ ent,
                              float* __restrict__ logz,
                              float* __restrict__ mean_logit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long plane = (long long)splits * rows;
  float M = -INFINITY;
  for (int k = 0; k < splits; ++k) M = fmaxf(M, part[(long long)k * rows + i]);
  // S: sum of exp(l - M) (l - M), from each range's sum relative to its m
  float L = 0.0f, S = 0.0f, tgt = 0.0f;
  for (int k = 0; k < splits; ++k) {
    const long long at = (long long)k * rows + i;
    const float l = part[plane + at];
    if (l > 0.0f) {  // an empty range has m = -inf
      const float f = expf(part[at] - M);
      L += l * f;
      S += (part[2 * plane + at] + (part[at] - M) * l) * f;
    }
    tgt += part[3 * plane + at];
  }
  const float lz = M + logf(L), rel = S / L;
  logp[i] = tgt - lz;
  ent[i] = logf(L) - rel;
  logz[i] = lz;
  mean_logit[i] = M + rel;
}

// Backward: the float32 logit cotangent of one tile, written to dl[T][V].
template <typename T, bool WK1, bool VEC>
__global__ void __launch_bounds__(NT)
    dlogits(const T* __restrict__ h, const T* __restrict__ w,
            const int* __restrict__ targets, const float* __restrict__ logz,
            const float* __restrict__ mean_logit,
            const float* __restrict__ g_logp, const float* __restrict__ g_ent,
            Shape s, float* __restrict__ dl) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Ls = reinterpret_cast<const float*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  logit_tile<T, WK1, VEC>(h, w, s, m0, n0, smem);
  // a warp writes 32 neighbouring vocab entries of one row
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN, row = m0 + r, n = n0 + c;
    if (row >= s.rows || n >= s.V) continue;
    const float l = Ls[r * LDL + c];
    const float p = expf(l - logz[row]);
    float g = 0.0f;
    if (g_logp) g = g_logp[row] * ((n == targets[row] ? 1.0f : 0.0f) - p);
    if (g_ent) g -= g_ent[row] * p * (l - mean_logit[row]);
    dl[(long long)row * s.V + n] = g;
  }
}

template <typename T, bool WK1, bool VEC>
cudaError_t launch_forward(const void* h, const void* w, const int* targets,
                           const Shape& s, int splits, int tiles_per_split,
                           float* part, cudaStream_t stream) {
  const int n_tiles = (s.V + BN - 1) / BN;
  dim3 grid((s.rows + BM - 1) / BM, splits);
  forward_partial<T, WK1, VEC><<<grid, NT, 0, stream>>>(
      (const T*)h, (const T*)w, targets, s, tiles_per_split, n_tiles, part);
  return cudaGetLastError();
}

template <typename T, bool WK1, bool VEC>
cudaError_t launch_dlogits(const void* h, const void* w, const int* targets,
                           const float* logz, const float* mu,
                           const float* g_logp, const float* g_ent,
                           const Shape& s, float* dl, cudaStream_t stream) {
  dim3 grid((s.rows + BM - 1) / BM, (s.V + BN - 1) / BN);
  dlogits<T, WK1, VEC><<<grid, NT, 0, stream>>>(
      (const T*)h, (const T*)w, targets, logz, mu, g_logp, g_ent, s, dl);
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16; vec (bf16, w k-contiguous, d % 8 == 0,
// 16-byte aligned operands) selects 16-byte loads.
template <template <typename, bool, bool> class L, typename F>
cudaError_t dispatch(int dtype, const Shape& s, int vec, F&& call) {
  const bool wk1 = s.sk == 1;
  if (!wk1 && s.sn != 1) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (vec && wk1) return call(L<bf16, true, true>{});
    if (wk1) return call(L<bf16, true, false>{});
    return call(L<bf16, false, false>{});
  }
  if (dtype == 0 && !vec) {
    if (wk1) return call(L<float, true, false>{});
    return call(L<float, false, false>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool WK1, bool VEC>
struct Variant {
  using type = T;
  static constexpr bool wk1 = WK1, vec = VEC;
};

// ------------------------------------------- bf16 forward: TMA + wgmma
namespace wg {

constexpr int BM = 128;      // tokens per block (two consumers of 64)
constexpr int BN = 128;      // vocab entries per tile
constexpr int BK = 64;       // depth per stage: one 128-byte swizzle row
constexpr int kStages = 4;   // ring depth
constexpr int NT = 384;      // producer + two consumer warpgroups
constexpr int kBox = 64 * 64 * 2;  // bytes of a [64 x 64] bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// dynamic shared memory, every tile 1024-byte aligned (the 128-byte swizzle
// repeats every 8 rows of 128 bytes). A stage holds h (two boxes of [64
// tokens x 64 deep], one per consumer) and w: one box of [128 vocab x 64
// deep] (k-contiguous w) or two of [64 deep x 64 vocab] (V-contiguous w).
struct Smem {
  static constexpr int a = 0;
  static constexpr int b = a + kStages * 2 * kBox;
  static constexpr int bar = b + kStages * 2 * kBox;  // full, empty
  static constexpr int total = bar + 8 * 2 * kStages;
  static constexpr int alloc = total + 1024;  // room to align the base
};

struct Params {
  const int* targets;
  float* part;  // forward: [4][splits][rows]
  const float *logz, *mu, *g_logp, *g_ent;  // backward (null g: zero)
  bf16* dl;     // backward: [2][rows][ldv], the high parts then the low
  long long ldv;
  int rows, V, d, n_tiles, tiles_per_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 2-D map at (inner coordinate c0, outer c1)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}
// K-major operand (h, k-contiguous w): 16 deep at k-step kk of rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + kk * 32, 16, 1024);
}
// MN-major operand (V-contiguous w): 16 deep rows at k-step kk of a [64
// deep x 128 vocab] tile whose two 64-column boxes lie kBox apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, kBox, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across an async wgmma
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n128k16, A and B from shared memory; B K-major (MN = 0)
// or MN-major (MN = 1); accumulate = 0 overwrites d
template <int MN>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(MN));
}

// the k-steps of one vocab tile into acc, each stage handed back to the
// producer as soon as the products that read it are complete
template <int MN>
__device__ __forceinline__ void tile_products(float (&acc)[64], int& kv,
                                              int KT, int c, int lane,
                                              uint32_t sm_a, uint32_t sm_b,
                                              uint32_t full, uint32_t empty) {
  for (int ks = 0; ks < KT; ++ks, ++kv) {
    const int st = kv % kStages;
    mbar_wait(full + 8 * st, (kv / kStages) & 1);
    const uint32_t sa = sm_a + st * 2 * kBox + c * kBox;
    const uint32_t sb = sm_b + st * 2 * kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n128<MN>(acc, desc_k(sa, kk),
                     MN ? desc_mn(sb, kk) : desc_k(sb, kk), ks > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-step is done: its stage goes back
    __syncwarp();
    if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * ((kv - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * ((kv - 1) % kStages));
}

// The forward's epilogue: fold each tile into four running statistics of
// the thread's rows a and b (the maximum, and the sums of exp and of exp *
// logit relative to it, partial over this thread's columns; the target
// logit, held by one thread of the row), written to part at the end.
struct Stats {
  int row_a, row_b, tgt_a, tgt_b, col0;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float s_a = 0.f, s_b = 0.f, lt_a = 0.f, lt_b = 0.f;

  __device__ Stats(const Params& a, int row, int lane)
      : row_a(row), row_b(row + 8), col0(2 * (lane % 4)) {
    tgt_a = row_a < a.rows ? a.targets[row_a] : -1;
    tgt_b = row_b < a.rows ? a.targets[row_b] : -1;
  }

  __device__ __forceinline__ void tile(float (&acc)[64], int n0,
                                       const Params& a) {
    if (n0 + BN > a.V) {  // the ragged last tile: columns past V are out
#pragma unroll
      for (int j = 0; j < 64; ++j)
        if (n0 + 8 * (j / 4) + col0 + (j & 1) >= a.V) acc[j] = -INFINITY;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 64; j += 4) {
      mx_a = fmaxf(mx_a, fmaxf(acc[j], acc[j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(acc[j + 2], acc[j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite
    const float corr_a = exp2f((m_a - mn_a) * kLog2e);  // 0 on the first
    const float corr_b = exp2f((m_b - mn_b) * kLog2e);
    // the running sums of exp(l - m) (l - m), moved from m to the new max
    const float sh_a = l_a > 0.f ? (mn_a - m_a) * l_a : 0.f;
    const float sh_b = l_b > 0.f ? (mn_b - m_b) * l_b : 0.f;
    m_a = mn_a;
    m_b = mn_b;
    const float na = -mn_a * kLog2e, nb = -mn_b * kLog2e;
    float se_a = 0.f, se_b = 0.f, ss_a = 0.f, ss_b = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const float x = acc[j];
      const float e = exp2f(fmaf(x, kLog2e, (j & 2) ? nb : na));  // 0: masked
      const float ex = e > 0.f ? e * (x - ((j & 2) ? mn_b : mn_a)) : 0.f;
      if (j & 2) {
        se_b += e;
        ss_b += ex;
      } else {
        se_a += e;
        ss_a += ex;
      }
    }
    s_a = (s_a - sh_a) * corr_a + ss_a;
    s_b = (s_b - sh_b) * corr_b + ss_b;
    l_a = l_a * corr_a + se_a;
    l_b = l_b * corr_b + se_b;
    const int ca = tgt_a - n0, cb = tgt_b - n0;
    if (ca >= 0 && ca < BN) {
#pragma unroll
      for (int j = 0; j < 64; ++j)
        if (!(j & 2) && 8 * (j / 4) + col0 + (j & 1) == ca) lt_a = acc[j];
    }
    if (cb >= 0 && cb < BN) {
#pragma unroll
      for (int j = 0; j < 64; ++j)
        if ((j & 2) && 8 * (j / 4) + col0 + (j & 1) == cb) lt_b = acc[j];
    }
  }

  __device__ __forceinline__ void finish(const Params& a, int split,
                                         int lane) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, off);
      lt_a += __shfl_xor_sync(0xffffffffu, lt_a, off);
      lt_b += __shfl_xor_sync(0xffffffffu, lt_b, off);
    }
    if (lane % 4 == 0) {
      const long long plane = (long long)gridDim.y * a.rows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row_b : row_a;
        if (row >= a.rows) continue;
        const long long at = (long long)split * a.rows + row;
        a.part[at] = h ? m_b : m_a;
        a.part[plane + at] = h ? l_b : l_a;
        a.part[2 * plane + at] = h ? s_b : s_a;
        a.part[3 * plane + at] = h ? lt_b : lt_a;
      }
    }
  }
};

// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The backward's epilogue: the logit cotangent of each tile,
//   dl_j = g_logp (1[j = t] - p_j) - g_ent p_j (l_j - mu),
//        = 1[j = t] g_logp - p_j (g_logp + g_ent (l_j - mu)),
// p_j = exp(l_j - logz) from the forward's saved logz and mu, stored as a
// bf16 high part (plane 0 of dl) and the bf16 rounding of the remainder
// (plane 1): together ~16 bits, the float32 value to a relative 2^-16.
struct Cotangent {
  int row_a, row_b, tgt_a, tgt_b, col0;
  float nz_a = 0.f, nz_b = 0.f, mu_a = 0.f, mu_b = 0.f;
  float gl_a = 0.f, gl_b = 0.f, ge_a = 0.f, ge_b = 0.f;

  __device__ Cotangent(const Params& a, int row, int lane)
      : row_a(row), row_b(row + 8), tgt_a(-1), tgt_b(-1),
        col0(2 * (lane % 4)) {
    if (row_a < a.rows) load(a, row_a, tgt_a, nz_a, mu_a, gl_a, ge_a);
    if (row_b < a.rows) load(a, row_b, tgt_b, nz_b, mu_b, gl_b, ge_b);
  }

  __device__ static void load(const Params& a, int row, int& tgt, float& nz,
                              float& mu, float& gl, float& ge) {
    tgt = a.targets[row];
    nz = -a.logz[row] * kLog2e;
    mu = a.mu[row];
    gl = a.g_logp ? a.g_logp[row] : 0.f;
    ge = a.g_ent ? a.g_ent[row] : 0.f;
  }

  __device__ __forceinline__ void tile(float (&acc)[64], int n0,
                                       const Params& a) {
    const long long plane = (long long)a.rows * a.ldv;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const bool b = j & 2;
      const int row = b ? row_b : row_a, col = n0 + 8 * (j / 4) + col0;
      const float nz = b ? nz_b : nz_a, mu = b ? mu_b : mu_a;
      const float gl = b ? gl_b : gl_a, ge = b ? ge_b : ge_a;
      const int tgt = b ? tgt_b : tgt_a;
      float g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = acc[j + e];
        const float p = exp2f(fmaf(l, kLog2e, nz));
        g[e] = (col + e == tgt ? gl : 0.f) - p * fmaf(ge, l - mu, gl);
      }
      // a pair of columns: 4-byte aligned since ldv is a multiple of 8; a
      // column in [V, ldv) is never read
      if (row < a.rows && col < a.V) {
        const uint32_t hi = cvt_bf16x2(g[0], g[1]);
        const uint32_t lo = cvt_bf16x2(g[0] - __uint_as_float(hi << 16),
                                       g[1] - __uint_as_float(hi & 0xffff0000u));
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(a.dl + (long long)row * a.ldv + col);
        dst[0] = hi;
        dst[plane / 2] = lo;
      }
    }
  }

  __device__ __forceinline__ void finish(const Params&, int, int) {}
};

// grid (token tile, vocab range); MN: w V-contiguous. One block walks its
// range's vocab tiles: the producer warpgroup streams h and w through the
// ring, and each consumer warpgroup hands its 64 x 128 logit tile to the
// epilogue Epi (Stats: the forward; Cotangent: the backward's dl).
template <int MN, class Epi>
__global__ void __launch_bounds__(NT, 1)
walk(const __grid_constant__ CUtensorMap th,
     const __grid_constant__ CUtensorMap tw, const Params a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t sm_a = s_base + Smem::a, sm_b = s_base + Smem::b;
  const uint32_t full = s_base + Smem::bar, empty = full + 8 * kStages;
  const int m0 = blockIdx.x * BM, split = blockIdx.y;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, a.n_tiles);
  const int KT = (a.d + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler sees it uniform:
  // otherwise every branch on it is divergent and ptxas serialises wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {  // ------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int kv = 0;  // stages filled so far: stage kv % kStages
      for (int tile = t0; tile < t1; ++tile)
        for (int ks = 0; ks < KT; ++ks, ++kv) {
          const int st = kv % kStages;
          if (kv >= kStages)
            mbar_wait(empty + 8 * st, ((kv / kStages) - 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t sa = sm_a + st * 2 * kBox, sb = sm_b + st * 2 * kBox;
          mbar_expect_tx(bar, 4 * kBox);
          tma_load(sa, &th, bar, ks * BK, m0);
          tma_load(sa + kBox, &th, bar, ks * BK, m0 + 64);
          if (MN) {
            tma_load(sb, &tw, bar, tile * BN, ks * BK);
            tma_load(sb + kBox, &tw, bar, tile * BN + 64, ks * BK);
          } else {
            tma_load(sb, &tw, bar, ks * BK, tile * BN);
          }
        }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
  // accumulator rows of wgmma m64nN: row a (registers j with j & 2 == 0)
  // and row b = row a + 8; columns 8 (j / 4) + 2 (lane % 4) + (j & 1)
  Epi epi(a, m0 + 64 * c + 16 * warp + lane / 4, lane);
  int kv = 0;
  for (int tile = t0; tile < t1; ++tile) {
    float acc[64];
    tile_products<MN>(acc, kv, KT, c, lane, sm_a, sm_b, full, empty);
    epi.tile(acc, tile * BN, a);
  }
  epi.finish(a, split, lane);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime so that the build links no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D bf16 map over [outer, inner] at `ptr` (row stride `ld` elements),
// boxes of [box_outer x 64], 128-byte swizzled, zero fill out of bounds
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
              long long inner, long long outer, long long ld, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {2ull * (unsigned long long)ld};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// h [rows, d] contiguous; w [d, V] with strides (sk, sn), one of them 1
template <class Epi>
cudaError_t launch(const void* h, const void* w, const Shape& s, Params p,
                   int splits, cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool mn = s.sk != 1;  // V-contiguous w: [d, V] rows of stride sk
  CUtensorMap th, tw;
  if (!make_map(enc, &th, h, s.d, s.rows, s.d, 64) ||
      !(mn ? make_map(enc, &tw, w, s.V, s.d, s.sk, 64)
           : make_map(enc, &tw, w, s.d, s.V, s.sn, BN)))
    return cudaErrorInvalidValue;
  p.rows = s.rows;
  p.V = s.V;
  p.d = s.d;
  p.n_tiles = (s.V + BN - 1) / BN;
  dim3 grid((s.rows + BM - 1) / BM, splits);
  auto kern = mn ? &walk<1, Epi> : &walk<0, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::alloc);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, Smem::alloc, stream>>>(th, tw, p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" int token_logprob_entropy_forward(
    const void* h, const void* w, const void* targets, void* part,
    void* logp, void* ent, void* logz, void* mean_logit, int rows, int d,
    int V, long long sk, long long sn, int splits, int tiles_per_split,
    int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  const Shape s{rows, d, V, sk, sn};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dispatch<Variant>(dtype, s, vec, [&](auto v) {
    using V_ = decltype(v);
    return launch_forward<typename V_::type, V_::wk1, V_::vec>(
        h, w, (const int*)targets, s, splits, tiles_per_split, (float*)part,
        st);
  });
  if (err != cudaSuccess) return (int)err;
  forward_merge<<<(rows + 255) / 256, 256, 0, st>>>(
      (const float*)part, splits, rows, (float*)logp, (float*)ent,
      (float*)logz, (float*)mean_logit);
  return (int)cudaGetLastError();
}

extern "C" int token_logprob_entropy_dlogits(
    const void* h, const void* w, const void* targets, const void* logz,
    const void* mean_logit, const void* g_logp, const void* g_ent, void* dl,
    int rows, int d, int V, long long sk, long long sn, int dtype, int vec,
    void* stream) {
  if (rows <= 0) return 0;
  const Shape s{rows, d, V, sk, sn};
  return (int)dispatch<Variant>(dtype, s, vec, [&](auto v) {
    using V_ = decltype(v);
    return launch_dlogits<typename V_::type, V_::wk1, V_::vec>(
        h, w, (const int*)targets, (const float*)logz,
        (const float*)mean_logit, (const float*)g_logp, (const float*)g_ent,
        s, (float*)dl, (cudaStream_t)stream);
  });
}

// The bf16 forward through TMA and wgmma (namespace wg): h [rows, d]
// contiguous, w [d, V] with strides (sk, sn), one of them 1; d and the
// other stride multiples of 8, both operands 16-byte aligned (the tensor
// maps); the caller checks.
extern "C" int token_logprob_entropy_forward_wgmma(
    const void* h, const void* w, const void* targets, void* part,
    void* logp, void* ent, void* logz, void* mean_logit, int rows, int d,
    int V, long long sk, long long sn, int splits, int tiles_per_split,
    void* stream) {
  if (rows <= 0) return 0;
  if ((sk != 1 && sn != 1) || d % 8 != 0 || (sk == 1 ? sn : sk) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Shape s{rows, d, V, sk, sn};
  cudaStream_t st = (cudaStream_t)stream;
  wg::Params p = {};
  p.targets = (const int*)targets;
  p.part = (float*)part;
  p.tiles_per_split = tiles_per_split;
  cudaError_t err = wg::launch<wg::Stats>(h, w, s, p, splits, st);
  if (err != cudaSuccess) return (int)err;
  forward_merge<<<(rows + 255) / 256, 256, 0, st>>>(
      (const float*)part, splits, rows, (float*)logp, (float*)ent,
      (float*)logz, (float*)mean_logit);
  return (int)cudaGetLastError();
}

// The backward's logit cotangent of bf16 operands through TMA and wgmma
// (namespace wg): the forward's operands and checks; logz, mean_logit,
// g_logp and g_ent float32 [rows] (a null cotangent counts as zero); dl
// bf16 [2][rows][ldv], ldv >= V a multiple of 8: the high parts, then the
// remainders. Grid and plan as the forward's.
extern "C" int token_logprob_entropy_dlogits_wgmma(
    const void* h, const void* w, const void* targets, const void* logz,
    const void* mean_logit, const void* g_logp, const void* g_ent, void* dl,
    int rows, int d, int V, long long sk, long long sn, long long ldv,
    int splits, int tiles_per_split, void* stream) {
  if (rows <= 0) return 0;
  if ((sk != 1 && sn != 1) || d % 8 != 0 || (sk == 1 ? sn : sk) % 8 != 0 ||
      ldv < V || ldv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Shape s{rows, d, V, sk, sn};
  wg::Params p = {};
  p.targets = (const int*)targets;
  p.logz = (const float*)logz;
  p.mu = (const float*)mean_logit;
  p.g_logp = (const float*)g_logp;
  p.g_ent = (const float*)g_ent;
  p.dl = (bf16*)dl;
  p.ldv = ldv;
  p.tiles_per_split = tiles_per_split;
  return (int)wg::launch<wg::Cotangent>(h, w, s, p, splits,
                                        (cudaStream_t)stream);
}
