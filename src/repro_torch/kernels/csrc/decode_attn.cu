// Single-token (decode) attention over a dense KV cache, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn/kernel.py, decode_attention_pallas
//   (the Pallas TPU kernel).
//   q [B,H,hd]; k_cache, v_cache [B,L,KV,hd]; lengths [B] int32 valid-key
//   counts -> out [B,H,hd] in q's dtype. Head h reads KV head h / G
//   (G = H / KV); keys at positions >= lengths[b] are masked. Scale
//   hd**-0.5, float32 scores and online softmax, 1e-30 floor on the row
//   sum. A row with no keys (length 0) writes 0; the Pallas kernel averages
//   V over the masked cache there. The rollout engine never passes 0.
//
// What bounds it: bytes. Each generated token reads every sequence's
//   resident K and V once per layer (2 * lengths * KV * hd * elem bytes)
//   against about 4 flops per byte pair, far below the card's ~295
//   flop/byte balance point: the floor is the K/V bytes over HBM bandwidth.
//
// What the design does about it: one block per (sequence, KV head, chunk
//   of at most 8 of its query heads) serves the chunk's heads, so each key
//   and value row is read from device memory once per chunk, not once per
//   head, and any group size G = H / KV is taken (a group of 6 is one
//   chunk, 48 is six). The block reads
//   only the first lengths[b] keys (the TPU kernel streams the whole cache
//   and masks). Its 8 warps take interleaved chunks of 32 keys: for scores
//   a lane owns one key and reads its whole row in 16-byte vectors against
//   the group's queries in shared memory; for the value sum a lane owns
//   hd/32 dimensions and walks the chunk's rows, so each row read is one
//   coalesced 256-byte load per warp. Each warp keeps its own running max,
//   sum and accumulator in registers (float32); the warps merge at the end
//   through shared memory. Not done yet (later work): split-K across
//   blocks when B * KV is far below the 132 SMs, deeper load pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAX_G = 8;  // query heads per block (a chunk of the group)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// n consecutive elements at p (16-byte aligned) as float
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* out) {
  if constexpr (sizeof(T) == 2) {
    static_assert(N % 8 == 0, "bf16 vectors of 8");
#pragma unroll
    for (int c = 0; c < N; c += 8) {
      uint4 x = *reinterpret_cast<const uint4*>(p + c);
      const bf16* h = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[c + e] = __bfloat162float(h[e]);
    }
  } else {
    static_assert(N % 4 == 0, "float vectors of 4");
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      float4 x = *reinterpret_cast<const float4*>(p + c);
      out[c] = x.x;
      out[c + 1] = x.y;
      out[c + 2] = x.z;
      out[c + 3] = x.w;
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
__global__ void __launch_bounds__(NT)
decode_attn(const T* __restrict__ q, const T* __restrict__ kc,
            const T* __restrict__ vc, const int* __restrict__ lengths,
            T* __restrict__ out, int H, int KV, int L, float scale) {
  constexpr int DPL = HD / 32;       // value dimensions per lane
  constexpr int KCH = sizeof(T) == 2 ? 32 : 16;  // key dims per load step
  const int b = blockIdx.x;
  const int Gq = H / KV, n_hc = (Gq + MAX_G - 1) / MAX_G;
  const int kvh = blockIdx.y / n_hc, g0 = (blockIdx.y % n_hc) * MAX_G;
  const int G = min(MAX_G, Gq - g0);  // the block's heads: h0 .. h0 + G - 1
  const int h0 = kvh * Gq + g0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(lengths[b], 0), L);

  __shared__ __align__(16) float q_s[MAX_G][HD];
  __shared__ float p_s[NW][MAX_G][32];
  __shared__ float wm_s[NW][MAX_G], wl_s[NW][MAX_G];
  __shared__ float wacc_s[NW][MAX_G][HD];

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f(q[((size_t)b * H + h0 + g) * HD + d]);
  }
  __syncthreads();

  const size_t row = (size_t)KV * HD;  // elements between positions
  const T* kbase = kc + (size_t)b * L * row + (size_t)kvh * HD;
  const T* vbase = vc + (size_t)b * L * row + (size_t)kvh * HD;

  float m[MAX_G], l[MAX_G], acc[MAX_G][DPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;
  }

  for (int c0 = warp * 32; c0 < len; c0 += NW * 32) {
    // scores: lane owns key c0 + lane
    const int j = c0 + lane;
    const bool valid = j < len;
    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = 0.0f;
    if (valid) {
      const T* kr = kbase + (size_t)j * row;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += KCH) {
        float kf[KCH];
        load_f<T, KCH>(kr + d0, kf);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float a = s[g];
#pragma unroll
            for (int e = 0; e < KCH; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  &q_s[g][d0 + e]);
              a = fmaf(qv.x, kf[e], a);
              a = fmaf(qv.y, kf[e + 1], a);
              a = fmaf(qv.z, kf[e + 2], a);
              a = fmaf(qv.w, kf[e + 3], a);
            }
            s[g] = a;
          }
        }
      }
    }
    // fold the chunk into each head's running (max, sum, acc); lane 0's key
    // c0 < len is always valid, so the chunk max is finite
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float sc = valid ? s[g] * scale : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(sc));
        const float corr = expf(m[g] - m_new);
        const float p = valid ? expf(sc - m_new) : 0.0f;
        l[g] = l[g] * corr + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
        p_s[warp][g][lane] = p;
      }
    }
    __syncwarp();
    // values: lane owns dimensions lane * DPL .. + DPL
    const int nk = min(32, len - c0);
    for (int jj = 0; jj < nk; ++jj) {
      float vf[DPL];
      const T* vr = vbase + (size_t)(c0 + jj) * row + lane * DPL;
      if constexpr (sizeof(T) == 2 && DPL == 4) {
        uint2 x = *reinterpret_cast<const uint2*>(vr);
        const bf16* h = reinterpret_cast<const bf16*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[e] = __bfloat162float(h[e]);
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = to_f(vr[e]);
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float p = p_s[warp][g][jj];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next chunk
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm_s[warp][g] = m[g];
        wl_s[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) wacc_s[warp][g][lane * DPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm_s[w][g]);
    float num = 0.0f, den = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (wm_s[w][g] != -INFINITY) {
          const float f = expf(wm_s[w][g] - mx);
          num = fmaf(wacc_s[w][g][d], f, num);
          den = fmaf(wl_s[w][g], f, den);
        }
      }
    }
    out[((size_t)b * H + h0 + g) * HD + d] =
        from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* out, int B, int H, int KV,
                   int L, cudaStream_t stream) {
  dim3 grid(B, KV * ((H / KV + MAX_G - 1) / MAX_G));
  decode_attn<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KV, L, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; H % KV == 0 (any
// group size); every operand contiguous.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, int B, int H, int KV, int L,
                                int hd, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_LAUNCH(T, HD) \
  return (int)launch<T, HD>(q, k_cache, v_cache, lengths, out, B, H, KV, L, st)
  if (dtype == 0 && hd == 64) DECODE_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) DECODE_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) DECODE_LAUNCH(bf16, 64);
  if (dtype == 1 && hd == 128) DECODE_LAUNCH(bf16, 128);
#undef DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
