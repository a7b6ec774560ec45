// Paged single-token decode attention for Hopper (sm_90a), split over the
// keys ("flash-decoding").
//
// Replaces: src/repro/kernels/decode_attn/paged_kernel.py,
//   paged_decode_attention_pallas (the Pallas TPU kernel).
//   q [S,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb] int32
//   (-1 = unmapped); lengths [S] int32 valid-token counts -> out [S,H,hd].
//   A row of length 0 writes 0.
//
// What bounds it: bytes. Every decoded token reads each slot's resident K
//   and V once per layer (2 * len * KV * hd * elem bytes per slot) against
//   about 4 flops per element read, far below the card's ~295 flop/byte
//   balance point, so the floor is K/V bytes over HBM bandwidth. At serving
//   sizes (8 slots, a few MB) that floor is a few microseconds, so what
//   bounds a real kernel is latency: how many page loads are in flight, and
//   how many instructions stand between a page's arrival and the result.
//
// What the design does about it: the split-KV walk of decode_split.cuh
//   (one block per key split, KV head x head chunk and slot; a per-warp
//   cp.async ring; bf16 products on mma.sync with P in hi and lo parts; the
//   splits of a slot merged in a cluster through distributed shared memory)
//   with PagedKeys: a split is a run of whole pages (kernel.split_plan picks
//   pages per split from mb, bs, S, KV and the SM count, never the
//   lengths), and its block-table entries are read into shared memory first.
//   - bf16 blocks serve 16 query heads of one KV head, so each K/V byte is
//     read once per group of up to 16.
//   - float32 (below): each lane holds 16 bytes of a key row; a score is a
//     dot product of lane partials reduced by shuffles (exact float32
//     FMAs); blocks serve up to 8 heads.
#include "decode_split.cuh"

namespace {

// ------------------------------------------------- float32: CUDA-core FMAs
namespace fp {

constexpr int kStages = 2;
constexpr int EPL = 4;  // floats in 16 bytes: a lane's chunk of a key row

template <int HD, int GC>
struct Layout {
  static constexpr int LPK = HD / EPL;       // lanes per key row
  static constexpr int RPW = 32 / LPK;       // key rows per warp step
  static constexpr int STEPS = kTile / RPW;  // warp steps per tile
  static constexpr int NS = 4;               // steps per softmax fold
  static constexpr size_t ring =
      (size_t)kWarps * kStages * 2 * kTile * HD * sizeof(float);
  static constexpr size_t merge =
      ((size_t)(kWarps + 1) * GC * (HD + 2)) * sizeof(float);
  static size_t smem(int pps) {
    return table_bytes<PagedKeys>(pps) + (ring > merge ? ring : merge) + 16;
  }
};

template <int HD, int GC>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  using L = Layout<HD, GC>;
  constexpr int LPK = L::LPK, RPW = L::RPW, NS = L::NS;
  const Split p = locate<PagedKeys>(a, GC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPK, rr = lane / LPK;  // 16-byte chunk, row in step

  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  unsigned char* work = smem + table_bytes<PagedKeys>(a.pps);
  float* ring = reinterpret_cast<float*>(work);
  load_table<PagedKeys>(a, p, tbl);

  // q for the block's heads, this lane's chunk, pre-scaled
  const float* q = static_cast<const float*>(a.q);
  float qr[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < p.ng ? q[((size_t)p.slot * a.H + p.h0 + g) * HD +
                              c * EPL + e] * a.scale
                          : 0.f;
  float* wo = reinterpret_cast<float*>(work);  // [kWarps][GC][HD]
  float* wm = wo + kWarps * GC * HD;
  float* wl = wm + kWarps * GC;
  float* bo = wl + kWarps * GC;
  float* bm = bo + GC * HD;
  float* bl = bm + GC;
  if (p.s0 >= p.s1) {  // the row has no key in this split: merge only
    finish<float, HD>(a, p, bo, bm, bl);
    return;
  }
  __syncthreads();

  const float* pk = static_cast<const float*>(a.k);
  const float* pv = static_cast<const float*>(a.v);
  const int n_tiles = (p.s1 - p.s0 + kTile - 1) / kTile;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  float* wring = ring + (size_t)warp * kStages * 2 * kTile * HD;

  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int t0 = p.s0 + (warp + i * kWarps) * kTile;
      float* kd = wring + (size_t)(i % kStages) * 2 * kTile * HD;
      float* vd = kd + kTile * HD;
#pragma unroll
      for (int u = 0; u < kTile * LPK / 32; ++u) {
        const int row = u * RPW + rr;
        const int j = t0 + row;
        const bool ok = j < p.s1;
        const size_t off =
            PagedKeys::row(a, p, tbl, ok ? j : p.s0) * HD + c * EPL;
        cp_async16(kd + row * HD + c * EPL, pk + off, ok ? 16 : 0);
        cp_async16(vd + row * HD + c * EPL, pv + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float m[GC], l[GC], o[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[g][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < my_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* ks = wring + (size_t)(i % kStages) * 2 * kTile * HD;
    const float* vs = ks + kTile * HD;
    const int t0 = p.s0 + (warp + i * kWarps) * kTile;
#pragma unroll
    for (int sub = 0; sub < L::STEPS / NS; ++sub) {
      if (t0 + sub * NS * RPW >= p.s1) break;  // warp-uniform
      float s[GC][NS];
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int row = (sub * NS + st) * RPW + rr;
        const float4 kf =
            *reinterpret_cast<const float4*>(ks + row * HD + c * EPL);
        const bool ok = t0 + row < p.s1;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = qr[g][0] * kf.x;
          d = fmaf(qr[g][1], kf.y, d);
          d = fmaf(qr[g][2], kf.z, d);
          d = fmaf(qr[g][3], kf.w, d);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          s[g][st] = ok ? d : -INFINITY;
        }
      }
      // fold the NS * RPW rows into (m, l) and rescale the accumulator;
      // l and o stay partial over this lane's rows until the end
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = s[g][0];
#pragma unroll
        for (int st = 1; st < NS; ++st) mx = fmaxf(mx, s[g][st]);
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);  // finite: row 0 of sub is valid
        const float corr = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[g][e] *= corr;
#pragma unroll
        for (int st = 0; st < NS; ++st) {
          const float pe = exp2f(s[g][st] - m_new);
          s[g][st] = pe;
          l[g] += pe;
        }
      }
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int row = (sub * NS + st) * RPW + rr;
        const float4 vf =
            *reinterpret_cast<const float4*>(vs + row * HD + c * EPL);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          o[g][0] = fmaf(s[g][st], vf.x, o[g][0]);
          o[g][1] = fmaf(s[g][st], vf.y, o[g][1]);
          o[g][2] = fmaf(s[g][st], vf.z, o[g][2]);
          o[g][3] = fmaf(s[g][st], vf.w, o[g][3]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // sum l and o over the lanes that held other rows of the same chunk
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        o[g][e] += __shfl_xor_sync(0xffffffffu, o[g][e], off);
    }
  }

  __syncthreads();
  if (rr == 0)
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        wo[(warp * GC + g) * HD + c * EPL + e] = o[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      wm[warp * GC + g] = m[g];
      wl[warp * GC + g] = l[g];
    }
  __syncthreads();
  merge_warps<HD, HD>(wo, wm, wl, GC, p.ng, bo, bm, bl);
  __syncthreads();
  finish<float, HD>(a, p, bo, bm, bl);
}

}  // namespace fp

template <int HD>
cudaError_t launch_f32(Args& a, int S, cudaStream_t st) {
  const int G = a.H / a.KV;
  const int gc = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  a.n_hc = (G + gc - 1) / gc;
#define F32_LAUNCH(GC_)                                                    \
  return launch(fp::split_kernel<HD, GC_>, fp::Layout<HD, GC_>::smem(a.pps), \
                a, S, st)
  if (gc == 1) F32_LAUNCH(1);
  if (gc == 2) F32_LAUNCH(2);
  if (gc == 4) F32_LAUNCH(4);
  F32_LAUNCH(8);
#undef F32_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; H % KV == 0; pps
// pages per split, n_splits * pps >= mb and n_splits <= kMaxSplits (the
// portable cluster size). Operands contiguous, q and pools 16-byte
// aligned; the caller checks.
extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v, const void* tables,
                                      const void* lengths, void* out, int S,
                                      int H, int KV, int hd, int bs, int mb,
                                      int pps, int n_splits, int dtype,
                                      void* stream) {
  if (S <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || mb <= 0 || pps <= 0 ||
      n_splits <= 0 || n_splits > kMaxSplits ||
      (long long)pps * n_splits < mb)
    return (int)cudaErrorInvalidValue;
  Args a{q,       pool_k, pool_v, static_cast<const int*>(tables),
         static_cast<const int*>(lengths), out, H, KV, bs, mb, pps, 0,
         pps * bs, n_splits, 1, kLog2e / sqrtf((float)hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return (int)launch_f32<64>(a, S, st);
  if (dtype == 0 && hd == 128) return (int)launch_f32<128>(a, S, st);
  if (dtype == 1 && hd == 64)
    return (int)launch_bf16<64, PagedKeys>(a, S, st);
  if (dtype == 1 && hd == 128)
    return (int)launch_bf16<128, PagedKeys>(a, S, st);
  return (int)cudaErrorInvalidValue;
}
