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
// What the design does about it:
//   - One block per (key split, KV head x head chunk, slot). A split is a
//     run of whole pages whose size the wrapper picks from host-known sizes
//     only (mb, bs, S, KV, the SM count: kernel.split_plan), so a few long
//     slots still fill the card. A block whose split starts at or past its
//     slot's length exits at once.
//   - The block serves the query heads of its KV head (up to 16 in bf16, 8
//     in float32), so each K/V byte is read once per group.
//   - Each warp walks its own tiles of kTile keys (tile w, w + 4, ...)
//     through a private ring of stages in shared memory, filled by 16-byte
//     cp.async, so the next tiles' loads are in flight while the current one
//     computes; no block-wide barrier inside the walk.
//   - bf16: the tile's products run on the tensor cores (mma.sync m16n8k16,
//     operands by ldmatrix from padded rows): the group's heads are the 16
//     rows of the A operand (q, held in registers), the tile's 16 keys two
//     n-blocks of the scores; P goes back as the A operand of P V, split
//     into a bf16 high part and a bf16 remainder so that the softmax weights
//     keep ~16 bits (the float32 reference up to summation order). Softmax
//     state and the output accumulator stay in float32 registers.
//   - float32: each lane holds 16 bytes of a key row; a score is a dot
//     product of lane partials reduced by shuffles (exact float32 FMAs).
//   - The warps are merged in shared memory. The splits of one (slot, head
//     chunk) form a thread-block cluster: each keeps its float32 partial
//     (accumulator, m, l) in its own shared memory, and after a cluster
//     barrier each block merges a slice of the outputs from the slot's
//     non-empty splits, read through distributed shared memory, in split
//     order with the log-sum-exp rescale. No partial goes through device
//     memory and there is no second launch. A row of no keys writes 0.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;  // keys per warp tile (one ring stage)
constexpr int kMaxSplits = 8;  // splits per cluster (the portable size)
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* tables;
  const int* lengths;
  void* out;
  int H, KV, bs, mb, pps, n_splits, n_hc;  // n_splits: the cluster size
  float scale;  // hd**-0.5 * log2(e)
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What both kernels share around the walk: the block's split (its key
// range [s0, s1) of the slot, s1 <= s0 when empty), KV head and ng query
// heads from h0; its block-table entries in shared memory; and the merge.
struct Split {
  int slot, split, kvh, ng, h0, len, s0, s1, first_page;
};

__device__ __forceinline__ Split locate(const Args& a, int gc) {
  Split p;
  p.split = blockIdx.x;
  p.slot = blockIdx.z;
  p.kvh = blockIdx.y / a.n_hc;
  const int G = a.H / a.KV, g0 = (blockIdx.y % a.n_hc) * gc;
  p.ng = min(gc, G - g0);
  p.h0 = p.kvh * G + g0;
  p.len = a.lengths[p.slot];
  p.s0 = p.split * a.pps * a.bs;
  p.s1 = min(p.len, p.s0 + a.pps * a.bs);
  p.first_page = p.split * a.pps;
  return p;
}

// the split's pages of the slot's block table, read before the length is
// known (entries past it are -1 and never used; clamped all the same)
__device__ __forceinline__ void load_table(const Args& a, const Split& p,
                                           int* tbl) {
  const int n_pages = min(a.pps, a.mb - p.first_page);
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    tbl[i] = max(a.tables[(size_t)p.slot * a.mb + p.first_page + i], 0);
}

// The block's result for its ng heads in shared memory: bo [ng][HD] (the
// accumulator relative to bm), bm [ng] (log2 domain), bl [ng]; unset in a
// block whose split has no key. After a cluster barrier, block `split`
// merges its slice of the ng * HD outputs over the slot's non-empty splits
// (the first n_act of the cluster) and writes it; a second barrier keeps
// every block's shared memory alive until all have read it.
template <typename T, int HD>
__device__ void finish(const Args& a, const Split& p, float* bo, float* bm,
                       float* bl) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split_keys = a.pps * a.bs, len = max(p.len, 0);
  const int n_act = min(a.n_splits, (len + split_keys - 1) / split_keys);
  const int total = p.ng * HD;
  const int per = (total + a.n_splits - 1) / a.n_splits;
  const int i1 = min(total, (p.split + 1) * per);
  T* out = static_cast<T*>(a.out);
  for (int i = p.split * per + threadIdx.x; i < i1; i += kThreads) {
    const int g = i / HD;
    float M = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < n_act; ++s)
      M = fmaxf(M, *cluster.map_shared_rank(bm + g, s));
    float acc = 0.f, sum = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_act; ++s) {
      const float f = exp2f(*cluster.map_shared_rank(bm + g, s) - M);
      acc = fmaf(f, *cluster.map_shared_rank(bo + i, s), acc);
      sum = fmaf(f, *cluster.map_shared_rank(bl + g, s), sum);
    }
    out[((size_t)p.slot * a.H + p.h0 + g) * HD + i % HD] =
        from_f<T>(n_act > 0 ? acc / sum : 0.f);
  }
  cluster.sync();
}

// Merge the warps' (m, l, o) of gc heads: wo [kWarps][gc][WS] (rows of HD
// at stride WS), wm and wl [kWarps][gc] (m = -inf for a warp without
// tiles) into bo, bm, bl.
template <int HD, int WS>
__device__ __forceinline__ void merge_warps(const float* wo, const float* wm,
                                            const float* wl, int gc, int ng,
                                            float* bo, float* bm, float* bl) {
  for (int i = threadIdx.x; i < ng * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * gc + g]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * gc + g];
      if (mw == -INFINITY) continue;
      const float f = exp2f(mw - M);
      acc = fmaf(f, wo[(w * gc + g) * WS + d], acc);
      sum = fmaf(f, wl[w * gc + g], sum);
    }
    bo[i] = acc;
    if (d == 0) {
      bm[g] = M;
      bl[g] = sum;
    }
  }
}

// ------------------------------------------------- bf16: tensor-core tiles
namespace tc {

constexpr int GC = 16;     // heads per block: the rows of the mma A operand
constexpr int kStages = 3;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;  // padded rows: conflict-free ldmatrix
  static constexpr int WS = HD + 8;  // warp results: conflict-free stores
  static constexpr size_t qbytes = GC * LD * 2;     // q, the A operand
  static constexpr size_t stage = 2 * kTile * LD;  // K and V, elements
  static constexpr size_t ring = kWarps * kStages * stage * 2;
  static constexpr size_t merge =
      ((size_t)kWarps * GC * WS + GC * HD + 2 * kWarps * GC + 2 * GC) *
      sizeof(float);
  static size_t smem(int pps) {
    const size_t tbl = ((size_t)pps * sizeof(int) + 15) & ~size_t(15);
    return tbl + qbytes + (ring > merge ? ring : merge);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// d += A B, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// (p0, p1) as a bf16 pair and the pair of their bf16 remainders
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = cvt_bf16x2(p0, p1);
  lo = cvt_bf16x2(p0 - __uint_as_float(hi << 16),
                  p1 - __uint_as_float(hi & 0xffff0000u));
}

template <int HD>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  using L = Layout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, WS = L::WS, KS = HD / 16, NB = HD / 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  const Split p = locate(a, GC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, tq = lane % 4;  // fragment row and column pair

  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(
      smem + (((size_t)a.pps * sizeof(int) + 15) & ~size_t(15)));
  unsigned char* work = reinterpret_cast<unsigned char*>(qs) + L::qbytes;
  bf16* ring = reinterpret_cast<bf16*>(work);
  load_table(a, p, tbl);

  // q, the A operand: row r = head g0 + r (zero past the group)
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < GC * CH; i += kThreads) {
    const int row = i / CH, ch = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.ng)
      v = *reinterpret_cast<const uint4*>(
          q + ((size_t)p.slot * a.H + p.h0 + row) * HD + ch * 8);
    *reinterpret_cast<uint4*>(qs + row * LD + ch * 8) = v;
  }
  // the warps' and the block's results, over the ring's space once the
  // walk is done
  float* wo = reinterpret_cast<float*>(work);  // [kWarps][GC][WS]
  float* wm = wo + kWarps * GC * WS;           // [kWarps][GC]
  float* wl = wm + kWarps * GC;
  float* bo = wl + kWarps * GC;  // [GC][HD]
  float* bm = bo + GC * HD;
  float* bl = bm + GC;
  if (p.s0 >= p.s1) {  // the slot has no key in this split: merge only
    finish<bf16, HD>(a, p, bo, bm, bl);
    return;
  }
  __syncthreads();

  const bf16* pk = static_cast<const bf16*>(a.pool_k);
  const bf16* pv = static_cast<const bf16*>(a.pool_v);
  const int n_tiles = (p.s1 - p.s0 + kTile - 1) / kTile;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  bf16* wring = ring + (size_t)warp * kStages * L::stage;

  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int t0 = p.s0 + (warp + i * kWarps) * kTile;
      bf16* kd = wring + (size_t)(i % kStages) * L::stage;
      bf16* vd = kd + kTile * LD;
#pragma unroll
      for (int u = 0; u < kTile * CH / 32; ++u) {
        const int idx = u * 32 + lane, row = idx / CH, ch = idx % CH;
        const int j = t0 + row;
        const bool ok = j < p.s1;
        const int jj = ok ? j : p.s0;
        const int page = tbl[jj / a.bs - p.first_page];
        const size_t off =
            (((size_t)page * a.bs + jj % a.bs) * a.KV + p.kvh) * HD + ch * 8;
        cp_async16(kd + row * LD + ch * 8, pk + off, ok ? 16 : 0);
        cp_async16(vd + row * LD + ch * 8, pv + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  // ldmatrix row addresses: matrix lane / 8, its row lane % 8
  const int mi = lane / 8, mr = lane % 8;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < my_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const bf16* ks = wring + (size_t)(i % kStages) * L::stage;
    const bf16* vs = ks + kTile * LD;
    const int t0 = p.s0 + (warp + i * kWarps) * kTile;

    // scores: n-block nb = keys 8nb .. 8nb + 7 of the tile
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], b[4];
      ldsm_x4(qa, qs + (8 * (mi & 1) + mr) * LD + 16 * kk + 8 * (mi >> 1));
      ldsm_x4(b, ks + (8 * (mi >> 1) + mr) * LD + 16 * kk + 8 * (mi & 1));
      mma(sc[0], qa, b[0], b[1]);
      mma(sc[1], qa, b[2], b[3]);
    }
    // mask past the split, scale, fold into (m, l) of rows qr and qr + 8
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + 8 * nb + 2 * tq + (e & 1);
        const float x = j < p.s1 ? sc[nb][e] * a.scale : -INFINITY;
        sc[nb][e] = x;
        if (e & 2)
          mx_b = fmaxf(mx_b, x);
        else
          mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= corr_a;
      o[nb][1] *= corr_a;
      o[nb][2] *= corr_b;
      o[nb][3] *= corr_b;
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sc[nb][e] - ((e & 2) ? mn_b : mn_a));
        sc[nb][e] = pe;
        if (e & 2)
          l_b += pe;
        else
          l_a += pe;
      }
    // P as the A operand (k = the tile's 16 keys), high and low parts
    uint32_t ph[4], pl[4];
    split2(sc[0][0], sc[0][1], ph[0], pl[0]);
    split2(sc[0][2], sc[0][3], ph[1], pl[1]);
    split2(sc[1][0], sc[1][1], ph[2], pl[2]);
    split2(sc[1][2], sc[1][3], ph[3], pl[3]);
    // o += P V: n-blocks 2np, 2np + 1 = dims 16np .. 16np + 15
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (8 * (mi & 1) + mr) * LD + 16 * np + 8 * (mi >> 1));
      mma(o[2 * np], ph, b[0], b[1]);
      mma(o[2 * np], pl, b[0], b[1]);
      mma(o[2 * np + 1], ph, b[2], b[3]);
      mma(o[2 * np + 1], pl, b[2], b[3]);
    }
    __syncwarp();  // every lane is done with the stage before its refill
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // merge the warps (the ring's space is free now)
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)  // rows qr and qr + 8
      *reinterpret_cast<float2*>(wo + (warp * GC + qr + 8 * h) * WS + 8 * nb +
                                 2 * tq) =
          make_float2(o[nb][2 * h], o[nb][2 * h + 1]);
  if (tq == 0) {
    wm[warp * GC + qr] = m_a;
    wm[warp * GC + qr + 8] = m_b;
    wl[warp * GC + qr] = l_a;
    wl[warp * GC + qr + 8] = l_b;
  }
  __syncthreads();
  merge_warps<HD, WS>(wo, wm, wl, GC, p.ng, bo, bm, bl);
  __syncthreads();
  finish<bf16, HD>(a, p, bo, bm, bl);
}

}  // namespace tc

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
    const size_t tbl = ((size_t)pps * sizeof(int) + 15) & ~size_t(15);
    return tbl + (ring > merge ? ring : merge) + 16;
  }
};

template <int HD, int GC>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  using L = Layout<HD, GC>;
  constexpr int LPK = L::LPK, RPW = L::RPW, NS = L::NS;
  const Split p = locate(a, GC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPK, rr = lane / LPK;  // 16-byte chunk, row in step

  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  unsigned char* work =
      smem + (((size_t)a.pps * sizeof(int) + 15) & ~size_t(15));
  float* ring = reinterpret_cast<float*>(work);
  load_table(a, p, tbl);

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
  if (p.s0 >= p.s1) {  // the slot has no key in this split: merge only
    finish<float, HD>(a, p, bo, bm, bl);
    return;
  }
  __syncthreads();

  const float* pk = static_cast<const float*>(a.pool_k);
  const float* pv = static_cast<const float*>(a.pool_v);
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
        const int jj = ok ? j : p.s0;
        const int page = tbl[jj / a.bs - p.first_page];
        const size_t off =
            (((size_t)page * a.bs + jj % a.bs) * a.KV + p.kvh) * HD + c * EPL;
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

// grid (splits, KV heads x head chunks, slots); the splits of one (slot,
// head chunk) form a cluster
template <typename K>
cudaError_t launch(K kern, size_t smem, const Args& a, int S,
                   cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.KV * a.n_hc, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <int HD>
cudaError_t launch_bf16(Args& a, int S, cudaStream_t st) {
  a.n_hc = (a.H / a.KV + tc::GC - 1) / tc::GC;
  return launch(tc::split_kernel<HD>, tc::Layout<HD>::smem(a.pps), a, S, st);
}

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
  Args a{q,  pool_k, pool_v,   static_cast<const int*>(tables),
         static_cast<const int*>(lengths), out, H, KV, bs, mb, pps,
         n_splits, 1, kLog2e / sqrtf((float)hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return (int)launch_f32<64>(a, S, st);
  if (dtype == 0 && hd == 128) return (int)launch_f32<128>(a, S, st);
  if (dtype == 1 && hd == 64) return (int)launch_bf16<64>(a, S, st);
  if (dtype == 1 && hd == 128) return (int)launch_bf16<128>(a, S, st);
  return (int)cudaErrorInvalidValue;
}
