// Causal (optionally windowed) GQA flash attention, forward, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
//   (the Pallas TPU kernel; the JAX package has no backward kernel).
//   q [B,H,S,hd], k/v [B,KV,S,hd] -> out [B,H,S,hd] in q's dtype; head h
//   reads KV head h / G (G = H / KV). Query position i attends key
//   positions j <= i, and with a window only i - j < window. Scale
//   hd**-0.5, float32 online softmax, masked scores -1e30 and a 1e-30 floor
//   on the row sum, as the Pallas kernel. Every tensor is addressed through
//   its (batch, head, position) strides with hd contiguous, so the model's
//   [B,S,H,hd] activations are read and written in place, without a
//   transposed copy. S need not be a multiple of any tile: the ragged last
//   query and key tiles are masked here.
//
// What bounds it: operations. A causal pass does 4*B*H*S^2*hd/2 flops
//   (51.5 GFLOP at B 16, H 12, S 1024, hd 128: 0.052 ms at 989 TFLOP/s in
//   bf16) against ~117 MB of q, k, v and out (0.035 ms at 3.35 TB/s).
//
// What the design does about it: one block per (16-position query tile,
//   KV head, batch row) serves the whole GQA group: its G query heads x 16
//   positions form M = 16*G query rows that share every K/V tile the block
//   loads, so K/V are read from device memory once per group, not once per
//   head. The block walks key tiles of 64 only from the first one the
//   window reaches to the one holding its last query position (the causal
//   skip that halves the work). Scores Q K^T and the product P V run on
//   the bf16 tensor cores (wmma, float32 accumulation; bf16 products are
//   exact in float32). P is split into a bf16 high part and a bf16
//   remainder, two products, so the softmax weights keep ~16 bits and the
//   result is the float32 reference's up to summation order. The running
//   max, row sum and output accumulator stay in shared memory in float32.
//   Float32 operands take the same tiles with float32 FMAs. Not done yet
//   (later work): wgmma and TMA, a cp.async pipeline over the K/V tiles,
//   several blocks per SM (the tiles need ~150 KB of shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 16;    // query positions per block
constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_G = 8;  // query heads per KV head
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qb, qh, qs;  // strides (elements): batch, head, position
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int S, H, KV, window;  // window <= 0: no window
  float scale;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory tiles of one block, M = 16 * G query rows (row m is head
// m / 16 of the group at position q0 + m % 16), BK keys per tile.
template <typename T, int HD>
struct Tiles {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BK = kBf16 ? 64 : 32;
  static constexpr int LQ = kBf16 ? HD + 8 : HD + 1;  // Q and K rows (T)
  static constexpr int LV = kBf16 ? HD + 8 : HD;      // V rows (T)
  static constexpr int LS = kBf16 ? BK + 4 : BK + 1;  // scores (float)
  static constexpr int LP = BK + 8;                   // P hi / lo (bf16)
  static constexpr int LO = kBf16 ? HD + 4 : HD;      // output acc (float)

  size_t q, k, v, s, p_hi, p_lo, o, m, l, total;

  __host__ __device__ static size_t up(size_t x) { return (x + 127) & ~size_t(127); }
  __host__ __device__ explicit Tiles(int M) {
    size_t at = 0;
    q = at;    at = up(at + (size_t)M * LQ * sizeof(T));
    k = at;    at = up(at + (size_t)BK * LQ * sizeof(T));
    v = at;    at = up(at + (size_t)BK * LV * sizeof(T));
    s = at;    at = up(at + (size_t)M * LS * sizeof(float));
    p_hi = at; at = up(at + (kBf16 ? (size_t)M * LP * 2 : 0));
    p_lo = at; at = up(at + (kBf16 ? (size_t)M * LP * 2 : 0));
    o = at;    at = up(at + (size_t)M * LO * sizeof(float));
    m = at;    at = up(at + (size_t)M * sizeof(float));
    l = at;    at = up(at + (size_t)M * sizeof(float));
    total = at;
  }
};

// dst[r][0..HD) = src[r * stride + 0..HD) for r < valid, zeros for
// valid <= r < rows. bf16 rows move as 16-byte vectors (the wrapper
// guarantees 16-byte aligned rows).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int valid) {
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < rows * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid)
        x = *reinterpret_cast<const uint4*>(src + r * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  using TL = Tiles<T, HD>;
  constexpr int BK = TL::BK;
  const int G = a.H / a.KV;
  const int M = BQ * G;
  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = a.S;

  extern __shared__ __align__(128) unsigned char smem[];
  const TL L(M);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  bf16* Ph = reinterpret_cast<bf16*>(smem + L.p_hi);
  bf16* Pl = reinterpret_cast<bf16*>(smem + L.p_lo);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k) + b * a.kb + kvh * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + kvh * a.vh;
  const int q_valid = min(BQ, S - q0);
  for (int g = 0; g < G; ++g)
    load_rows<T, HD>(Qs + g * BQ * TL::LQ, TL::LQ,
                     q + b * a.qb + (kvh * G + g) * a.qh + q0 * a.qs, a.qs,
                     BQ, q_valid);
  for (int i = tid; i < M * HD; i += NT)
    Os[(i / HD) * TL::LO + i % HD] = 0.0f;
  for (int i = tid; i < M; i += NT) {
    m_s[i] = NEG;
    l_s[i] = 0.0f;
  }

  // key tiles: from the first the window reaches to the one holding the
  // block's last query position
  const int q_last = q0 + q_valid - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int t = k_first / BK; t <= q_last / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HD>(Ks, TL::LQ, k + k0 * a.ks, a.ks, BK, min(BK, S - k0));
    load_rows<T, HD>(Vs, TL::LV, v + k0 * a.vs, a.vs, BK, min(BK, S - k0));
    __syncthreads();

    // raw scores S[m][j] = q_m . k_j
    if constexpr (TL::kBf16) {
      constexpr int TN = BK / 16;
      for (int tt = warp; tt < (M / 16) * TN; tt += NW) {
        const int mi = tt / TN, nj = tt % TN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fa, Qs + mi * 16 * TL::LQ + kk, TL::LQ);
          wmma::load_matrix_sync(fb, Ks + nj * 16 * TL::LQ + kk, TL::LQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + mi * 16 * TL::LS + nj * 16, acc, TL::LS,
                                wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < M * BK; i += NT) {
        const int m = i / BK, j = i % BK;
        const float* qr = Qs + m * TL::LQ;
        const float* kr = Ks + j * TL::LQ;
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        Ss[m * TL::LS + j] = dot;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row: mask, fold the tile into the
    // row's (max, sum), rescale its output row, write P
    for (int m = warp; m < M; m += NW) {
      const int qpos = q0 + m % BQ;
      float s[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int j = lane + 32 * c, kpos = k0 + j;
        const bool ok = kpos <= qpos && kpos < S &&
                        (a.window <= 0 || qpos - kpos < a.window);
        s[c] = ok ? Ss[m * TL::LS + j] * a.scale : NEG;
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int j = lane + 32 * c;
        const float p = expf(s[c] - m_new);
        sum += p;
        if constexpr (TL::kBf16) {
          const bf16 hi = __float2bfloat16(p);
          Ph[m * TL::LP + j] = hi;
          Pl[m * TL::LP + j] = __float2bfloat16(p - __bfloat162float(hi));
        } else {
          Ss[m * TL::LS + j] = p;
        }
      }
      sum = warp_sum(sum);
      for (int d = lane; d < HD; d += 32) Os[m * TL::LO + d] *= corr;
      if (lane == 0) {  // every lane read m_s[m] before the reductions
        m_s[m] = m_new;
        l_s[m] = l_s[m] * corr + sum;
      }
    }
    __syncthreads();

    // O += P V
    if constexpr (TL::kBf16) {
      constexpr int TD = HD / 16;
      for (int tt = warp; tt < (M / 16) * TD; tt += NW) {
        const int mi = tt / TD, dj = tt % TD;
        float* o = Os + mi * 16 * TL::LO + dj * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, o, TL::LO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fh, fl;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fh, Ph + mi * 16 * TL::LP + kk, TL::LP);
          wmma::load_matrix_sync(fl, Pl + mi * 16 * TL::LP + kk, TL::LP);
          wmma::load_matrix_sync(fb, Vs + kk * TL::LV + dj * 16, TL::LV);
          wmma::mma_sync(acc, fh, fb, acc);
          wmma::mma_sync(acc, fl, fb, acc);
        }
        wmma::store_matrix_sync(o, acc, TL::LO, wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < M * HD; i += NT) {
        const int m = i / HD, d = i % HD;
        const float* pr = Ss + m * TL::LS;
        float acc = Os[m * TL::LO + d];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], Vs[j * TL::LV + d], acc);
        Os[m * TL::LO + d] = acc;
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < M * HD; i += NT) {
    const int m = i / HD, d = i % HD, g = m / BQ, pos = q0 + m % BQ;
    if (pos < S)
      out[b * a.ob + (kvh * G + g) * a.oh + pos * a.os + d] =
          from_f<T>(Os[m * TL::LO + d] / fmaxf(l_s[m], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const Tiles<T, HD> L(BQ * G);
  auto kern = flash_fwd<T, HD>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.S + BQ - 1) / BQ, a.KV, B);
  kern<<<grid, NT, L.total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; H % KV == 0 and
// H / KV <= 8. bf16 rows must be 16-byte aligned (strides multiples of 8,
// pointers 16-byte aligned); the caller checks.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int S, int H, int KV, int hd, int window, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAX_G)
    return (int)cudaErrorInvalidValue;
  Args a{q,  k,  v,  out, qb, qh, qs, kb, kh, ks, vb,     vh,
         vs, ob, oh, os,  S,  H,  KV, window, 1.0f / sqrtf((float)hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return (int)launch<float, 64>(a, B, st);
  if (dtype == 0 && hd == 128) return (int)launch<float, 128>(a, B, st);
  if (dtype == 1 && hd == 64) return (int)launch<bf16, 64>(a, B, st);
  if (dtype == 1 && hd == 128) return (int)launch<bf16, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
