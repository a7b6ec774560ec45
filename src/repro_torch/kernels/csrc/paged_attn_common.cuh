// Body of the chunked paged prefill attention kernel over one layer's
// paged K/V pool (csrc/paged_prefill_attn.cu).
//
// Layouts (all row-major, contiguous):
//   q, out         [R, H, HD]              R chunk rows
//   pool_k, pool_v [n_blocks, bs, KV, HD]  one layer's pool
//   tables         [S, mb] int32           -1 = unmapped (clamped to block 0)
//
// One thread block serves a tile of `rows_per_block` consecutive query rows
// and one KV head: the tile's rows x the G = H / KV query heads of that KV
// head form up to kMaxQ query vectors that share every K/V page the block
// reads. Each row r attends the keys of its own segment (its slot's block
// table) at positions 0..lim[r] inclusive, lim[r] = -1 meaning no keys.
// The block walks each distinct segment of its tile once, page by page up
// to the last page any of its rows needs (never the whole table), with an
// online softmax in float32 per query vector. Rows with no keys write 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace paged {

constexpr int kThreads = 256;
constexpr int kMaxQ = 32;  // query vectors (rows x heads) per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
inline size_t smem_bytes(int bs) {
  // q_s [kMaxQ][HD+1], k_s [bs][HD+1], v_s [bs][HD], p_s [kMaxQ][bs],
  // m/l/corr [kMaxQ] floats; seg/lim [kMaxQ] ints
  size_t floats = (size_t)kMaxQ * (HD + 1) + (size_t)bs * (HD + 1) +
                  (size_t)bs * HD + (size_t)kMaxQ * bs + 3 * kMaxQ;
  return floats * sizeof(float) + 2 * kMaxQ * sizeof(int);
}

// Row r is segment seg[r] (`meta` = seg_ids [R], -1 = padding) and attends
// keys 0..q_pos[r].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v, const int* __restrict__ tables,
                  const int* __restrict__ meta, const int* __restrict__ q_pos,
                  T* __restrict__ out, int R, int H, int KV, int bs, int mb,
                  int rows_per_block, float scale) {
  constexpr int QS = HD + 1;  // padded row stride: conflict-free columns
  constexpr int kAcc = kMaxQ * HD / kThreads;
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, R - r0);
  const int nq = nrows * G;  // query vector qi = t * G + g
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kMaxQ * QS;
  float* v_s = k_s + bs * QS;
  float* p_s = v_s + bs * HD;
  float* m_s = p_s + kMaxQ * bs;
  float* l_s = m_s + kMaxQ;
  float* c_s = l_s + kMaxQ;
  int* seg_s = reinterpret_cast<int*>(c_s + kMaxQ);
  int* lim_s = seg_s + kMaxQ;

  for (int t = tid; t < nrows; t += kThreads) {
    const int r = r0 + t;
    const int sg = meta[r];
    seg_s[t] = sg;
    lim_s[t] = sg >= 0 ? q_pos[r] : -1;
  }
  for (int idx = tid; idx < nq * HD; idx += kThreads) {
    const int qi = idx / HD, d = idx % HD;
    const int t = qi / G, h = kvh * G + qi % G;
    q_s[qi * QS + d] = to_f(q[((size_t)(r0 + t) * H + h) * HD + d]);
  }
  for (int i = tid; i < nq; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < nrows; ++t0) {
    const int sg = seg_s[t0];
    if (sg < 0) continue;
    bool seen = false;
    int lim = -1;
    for (int t = 0; t < nrows; ++t) {
      if (seg_s[t] != sg) continue;
      seen |= t < t0;
      lim = max(lim, lim_s[t]);
    }
    if (seen || lim < 0) continue;  // walked already, or nothing to attend
    const int n_pages = min(lim / bs + 1, mb);
    const int* table = tables + (size_t)sg * mb;

    for (int pg = 0; pg < n_pages; ++pg) {
      const size_t base =
          ((size_t)max(table[pg], 0) * bs * KV + kvh) * HD;  // row j: + j*KV*HD
      for (int idx = tid; idx < bs * HD; idx += kThreads) {
        const int j = idx / HD, d = idx % HD;
        const size_t off = base + (size_t)j * KV * HD + d;
        k_s[j * QS + d] = to_f(pool_k[off]);
        v_s[idx] = to_f(pool_v[off]);
      }
      __syncthreads();

      // scores of every (query vector, key) pair of the page
      for (int idx = tid; idx < nq * bs; idx += kThreads) {
        const int qi = idx / bs, j = idx % bs;
        const int t = qi / G;
        float s = -INFINITY;
        if (seg_s[t] == sg && pg * bs + j <= lim_s[t]) {
          const float* qr = q_s + qi * QS;
          const float* kr = k_s + j * QS;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * scale;
        }
        p_s[idx] = s;
      }
      __syncthreads();

      // online softmax: fold the page into each query vector's (m, l)
      for (int qi = tid; qi < nq; qi += kThreads) {
        float* pr = p_s + qi * bs;
        float mx = -INFINITY;
        for (int j = 0; j < bs; ++j) mx = fmaxf(mx, pr[j]);
        const float m_old = m_s[qi];
        const float m_new = fmaxf(m_old, mx);
        if (m_new == -INFINITY) {  // no key of this vector seen yet
          for (int j = 0; j < bs; ++j) pr[j] = 0.f;
          c_s[qi] = 1.f;
          continue;
        }
        const float corr = expf(m_old - m_new);
        float sum = 0.f;
        for (int j = 0; j < bs; ++j) {
          const float p = expf(pr[j] - m_new);
          pr[j] = p;
          sum += p;
        }
        l_s[qi] = l_s[qi] * corr + sum;
        m_s[qi] = m_new;
        c_s[qi] = corr;
      }
      __syncthreads();

      // acc[qi, d] = acc * corr + sum_j p[qi, j] * v[j, d]
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int idx = tid + i * kThreads;
        const int qi = idx / HD, d = idx % HD;
        if (qi < nq) {
          const float* pr = p_s + qi * bs;
          float a = acc[i] * c_s[qi];
          for (int j = 0; j < bs; ++j) a = fmaf(pr[j], v_s[j * HD + d], a);
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    const int qi = idx / HD, d = idx % HD;
    if (qi < nq) {
      const int t = qi / G, h = kvh * G + qi % G;
      out[((size_t)(r0 + t) * H + h) * HD + d] =
          from_f<T>(acc[i] / fmaxf(l_s[qi], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* tables, const void* meta, const void* q_pos,
                   void* out, int R, int H, int KV, int bs, int mb,
                   int rows_per_block, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(bs);
  auto kern = paged_attn_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((R + rows_per_block - 1) / rows_per_block, KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(q_pos),
      static_cast<T*>(out), R, H, KV, bs, mb, rows_per_block,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; HD in {64, 128}; H % KV == 0 and
// rows_per_block * (H / KV) <= kMaxQ are the caller's to hold.
inline int dispatch(const void* q, const void* pool_k, const void* pool_v,
                    const void* tables, const void* meta, const void* q_pos,
                    void* out, int R, int H, int KV, int hd, int bs, int mb,
                    int rows_per_block, int dtype, void* stream) {
  if (R <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || mb <= 0 ||
      rows_per_block <= 0 || rows_per_block * (H / KV) > kMaxQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, HD)                                                   \
  return (int)launch<T, HD>(q, pool_k, pool_v, tables, meta, q_pos, out, R,  \
                            H, KV, bs, mb, rows_per_block, st)
  if (dtype == 0 && hd == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
