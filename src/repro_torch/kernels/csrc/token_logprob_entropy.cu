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
//   Backward -> dl [T,V] float32 for one chunk of tokens,
//     dl_j = g_logp*(1[j=t] - p_j) - g_ent*p_j*(l_j - mu),
//   from which the caller forms dh = dl w^T and dw = h^T dl with two
//   float32 library products.
//
// What bounds it: operations. A pass computes 2*T*d*V flops of logits
//   (1.07 TFLOP at T = 2300, d = 1536, V = 151,936, about 1.09 ms at the
//   card's 989 TFLOP/s in bf16) against ~0.5 GB of operands, far above the
//   card's ~295 flop/byte balance point.
//
// What the design does about it: the logits never reach device memory in
//   the forward. A block owns 64 tokens and a contiguous range of vocab
//   tiles (split-V, so that a few thousand tokens still fill 132 SMs),
//   computes each 64 x 128 logit tile with bf16 tensor-core MMA (wmma,
//   float32 accumulation; products of bf16 values are exact in float32, so
//   this is the reference's float32 upcast up to summation order) or, for
//   float32 operands, float32 FMAs, and folds the tile into four online
//   per-row statistics (max, sum of exp, sum of exp*logit, target logit).
//   A second small pass merges the ranges. The backward recomputes each
//   tile with the same code and writes the float32 cotangent tile. Masked
//   edges: tokens past T load zeros and are not written; vocab columns past
//   V are excluded; d need not be a multiple of the tile depth. Not done
//   yet (later work): wgmma and TMA, a multi-stage cp.async pipeline,
//   keeping the token tile resident across vocab tiles.
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
      ss += e * v;
    }
    const float corr = expf(run_m - m_new);  // 0 on the first tile
    run_l = run_l * corr + quad_sum(se);
    run_s = run_s * corr + quad_sum(ss);
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
  float L = 0.0f, S = 0.0f, tgt = 0.0f;
  for (int k = 0; k < splits; ++k) {
    const long long at = (long long)k * rows + i;
    const float f = expf(part[at] - M);
    L += part[plane + at] * f;
    S += part[2 * plane + at] * f;
    tgt += part[3 * plane + at];
  }
  const float lz = M + logf(L), mu = S / L;
  logp[i] = tgt - lz;
  ent[i] = lz - mu;
  logz[i] = lz;
  mean_logit[i] = mu;
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
