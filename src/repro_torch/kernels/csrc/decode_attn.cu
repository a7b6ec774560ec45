// Single-token (decode) attention over a dense KV cache, for Hopper
// (sm_90a), split over the keys ("flash-decoding").
//
// Replaces: src/repro/kernels/decode_attn/kernel.py, decode_attention_pallas
//   (the Pallas TPU kernel).
//   q [B,H,hd]; k_cache, v_cache [B,L,KV,hd]; lengths [B] int32 valid-key
//   counts -> out [B,H,hd] in q's dtype. Head h reads KV head h / G
//   (G = H / KV, any G); keys at positions >= lengths[b] are masked. Scale
//   hd**-0.5, float32 scores and online softmax. A row with no keys
//   (length 0) writes 0; the Pallas kernel averages V over the masked cache
//   there. The rollout engine never passes 0.
//
// What bounds it: bytes. Each generated token reads every sequence's
//   resident K and V once per layer (2 * lengths * KV * hd * elem bytes)
//   against about 4 flops per byte pair, far below the card's ~295
//   flop/byte balance point: the floor is the K/V bytes over HBM bandwidth,
//   a few microseconds at the rollout's sizes (B 16, KV 2, L 1056), so what
//   bounds a real kernel is latency: loads in flight, and the blocks that
//   carry them.
//
// What the design does about it (bf16): the split-KV walk that paged decode
//   runs (decode_split.cuh), instantiated with DenseKeys, so the key at
//   position j of row b is row (b * L + j) * KV + kv of the cache.
//   - kernel.split_plan cuts L into at most 8 splits of whole 16-key tiles
//     from B, KV, L and the SM count only (never the lengths, which the
//     decode loop must not read on the host). Without splits a row's keys
//     are one block's work: at the rollout's B 16, KV 2 that is 32 blocks
//     on 132 SMs; with them, 8 splits x 2 x 16 = 256 blocks. A block whose
//     split starts at or past its row's length exits at once; a tile that
//     reaches past the length is zero-filled and masked, so any L is taken.
//   - each warp keeps its next key tiles in flight through a cp.async ring;
//     both products run on mma.sync m16n8k16 (q in registers, P split into
//     bf16 hi and lo parts), softmax state and accumulator in float32;
//   - a row's splits merge in a thread-block cluster through distributed
//     shared memory, in split order: no partial in device memory, one
//     launch.
//   What holds it back: a split of 144 keys gives each warp two or three
//   16-key tiles, so the ring never reaches a steady state, and the fixed
//   part (the cluster's two barriers, q's cold load, the merge) is a large
//   share of each block's time. ptxas: 129 registers (hd 128) and 83
//   (hd 64), no spill.
//
// float32 keeps the first design (namespace simple): one block per (row,
//   KV head, chunk of at most 8 of its query heads); 8 warps take
//   interleaved chunks of 32 keys, a lane owns one key for the scores and
//   hd/32 dimensions for the value sum, exact float32 FMAs; the warps merge
//   in shared memory. The dispatch is on dtype in decode_attention below.
#include "decode_split.cuh"

namespace {

namespace simple {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAX_G = 8;  // query heads per block (a chunk of the group)

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

template <int HD>
__global__ void __launch_bounds__(NT)
decode_attn(const float* __restrict__ q, const float* __restrict__ kc,
            const float* __restrict__ vc, const int* __restrict__ lengths,
            float* __restrict__ out, int H, int KV, int L, float scale) {
  constexpr int DPL = HD / 32;  // value dimensions per lane
  constexpr int KCH = 16;       // key dims per load step
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
    q_s[g][d] = q[((size_t)b * H + h0 + g) * HD + d];
  }
  __syncthreads();

  const size_t row = (size_t)KV * HD;  // elements between positions
  const float* kbase = kc + (size_t)b * L * row + (size_t)kvh * HD;
  const float* vbase = vc + (size_t)b * L * row + (size_t)kvh * HD;

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
      const float* kr = kbase + (size_t)j * row;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += KCH) {
        float kf[KCH];
#pragma unroll
        for (int c = 0; c < KCH; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(kr + d0 + c);
          kf[c] = x.x;
          kf[c + 1] = x.y;
          kf[c + 2] = x.z;
          kf[c + 3] = x.w;
        }
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
      const float* vr = vbase + (size_t)(c0 + jj) * row + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vf[e] = vr[e];
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
    out[((size_t)b * H + h0 + g) * HD + d] = num / fmaxf(den, 1e-30f);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* out, int B, int H, int KV,
                   int L, cudaStream_t stream) {
  dim3 grid(B, KV * ((H / KV + MAX_G - 1) / MAX_G));
  decode_attn<HD><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const int*>(lengths),
      static_cast<float*>(out), H, KV, L, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace simple

}  // namespace

// dtype: 0 = float32 (the first design; split_keys and n_splits unread),
// 1 = bfloat16 (the split-KV walk: split_keys * n_splits >= L, n_splits <=
// kMaxSplits, the portable cluster size); hd in {64, 128}; H % KV == 0
// (any group size); every operand contiguous, q and the caches 16-byte
// aligned; the caller checks.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, int B, int H, int KV, int L,
                                int hd, int split_keys, int n_splits,
                                int dtype, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return (int)simple::launch<64>(q, k_cache, v_cache, lengths, out, B, H,
                                   KV, L, st);
  if (dtype == 0 && hd == 128)
    return (int)simple::launch<128>(q, k_cache, v_cache, lengths, out, B, H,
                                    KV, L, st);
  if (dtype != 1 || split_keys <= 0 || n_splits <= 0 ||
      n_splits > kMaxSplits || (long long)split_keys * n_splits < L)
    return (int)cudaErrorInvalidValue;
  Args a{q, k_cache, v_cache, nullptr, static_cast<const int*>(lengths),
         out, H, KV, 0, 0, 0, L, split_keys, n_splits, 1,
         kLog2e / sqrtf((float)hd)};
  if (hd == 64) return (int)launch_bf16<64, DenseKeys>(a, B, st);
  if (hd == 128) return (int)launch_bf16<128, DenseKeys>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
