// The split-KV single-token decode walk that paged and dense decode share
// (included by paged_decode_attn.cu and decode_attn.cu; see their headers
// for the function each computes and what bounds it).
//
// A key's address is a template parameter (Keys): PagedKeys looks the key
// up through the slot's block table, DenseKeys forms it as b * L + pos in a
// [B, L, KV, hd] cache. Everything else is one code path:
//   - One block per (key split, KV head x head chunk, row). A split is a
//     run of split_keys positions (whole pages when paged) that the wrapper
//     picks from host-known sizes only, so a few long rows still fill the
//     card. A block whose split starts at or past its row's length exits
//     at once.
//   - bf16 (namespace tc): each warp walks its own tiles of kTile keys
//     (tile w, w + 4, ...) through a private ring of stages in shared
//     memory, filled by 16-byte cp.async (the tail past the row's length
//     zero-filled), so the next tiles' loads are in flight while the
//     current one computes; no block-wide barrier inside the walk. The
//     tile's products run on the tensor cores (mma.sync m16n8k16, operands
//     by ldmatrix from padded rows): the group's heads are the 16 rows of
//     the A operand (q, held in registers), the tile's 16 keys two n-blocks
//     of the scores; P goes back as the A operand of P V, split into a bf16
//     high part and a bf16 remainder so that the softmax weights keep ~16
//     bits (the float32 reference up to summation order). Softmax state and
//     the output accumulator stay in float32 registers.
//   - The warps are merged in shared memory. The splits of one (row, head
//     chunk) form a thread-block cluster: each keeps its float32 partial
//     (accumulator, m, l) in its own shared memory, and after a cluster
//     barrier each block merges a slice of the outputs from the row's
//     non-empty splits, read through distributed shared memory, in split
//     order with the log-sum-exp rescale. No partial goes through device
//     memory and there is no second launch. A row of no keys writes 0.
#pragma once

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
  const void* k;  // paged: the pool [n_blocks,bs,KV,hd]; dense: [B,L,KV,hd]
  const void* v;
  const int* tables;  // paged only
  const int* lengths;
  void* out;
  int H, KV;
  int bs, mb, pps;  // paged: page size, table width, pages per split
  int L;            // dense: positions per row
  int split_keys, n_splits, n_hc;  // n_splits: the cluster size
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

// What the walk knows of its block: the split (its key range [s0, s1) of
// the row, s1 <= s0 when empty), KV head and ng query heads from h0, and
// (paged) the first block-table entry of the split.
struct Split {
  int slot, split, kvh, ng, h0, len, s0, s1, first_page;
};

// Keys at position j of the block's row and KV head: the row of hd
// elements at Keys::row(a, p, tbl, j) of k and v; Keys::length(a, n) is
// the number of keys the walk reads of a row whose length is n (a dense
// cache holds at most L; a paged slot's length is trusted, as the engine
// maps its table up to it).
struct PagedKeys {
  static constexpr bool kTable = true;
  __device__ static int length(const Args&, int n) { return n; }
  __device__ static size_t row(const Args& a, const Split& p, const int* tbl,
                               int j) {
    return ((size_t)tbl[j / a.bs - p.first_page] * a.bs + j % a.bs) * a.KV +
           p.kvh;
  }
};
struct DenseKeys {
  static constexpr bool kTable = false;
  __device__ static int length(const Args& a, int n) { return min(n, a.L); }
  __device__ static size_t row(const Args& a, const Split& p, const int*,
                               int j) {
    return ((size_t)p.slot * a.L + j) * a.KV + p.kvh;
  }
};

template <class Keys>
__device__ __forceinline__ Split locate(const Args& a, int gc) {
  Split p;
  p.split = blockIdx.x;
  p.slot = blockIdx.z;
  p.kvh = blockIdx.y / a.n_hc;
  const int G = a.H / a.KV, g0 = (blockIdx.y % a.n_hc) * gc;
  p.ng = min(gc, G - g0);
  p.h0 = p.kvh * G + g0;
  p.len = Keys::length(a, a.lengths[p.slot]);
  p.s0 = p.split * a.split_keys;
  p.s1 = min(p.len, p.s0 + a.split_keys);
  p.first_page = p.split * a.pps;
  return p;
}

// bytes of shared memory ahead of the walk's own: the split's table entries
template <class Keys>
__host__ __device__ __forceinline__ size_t table_bytes(int pps) {
  return Keys::kTable ? (((size_t)pps * sizeof(int) + 15) & ~size_t(15)) : 0;
}

// the split's pages of the slot's block table, read before the length is
// known (entries past it are -1 and never used; clamped all the same)
template <class Keys>
__device__ __forceinline__ void load_table(const Args& a, const Split& p,
                                           int* tbl) {
  if constexpr (Keys::kTable) {
    const int n_pages = min(a.pps, a.mb - p.first_page);
    for (int i = threadIdx.x; i < n_pages; i += kThreads)
      tbl[i] = max(a.tables[(size_t)p.slot * a.mb + p.first_page + i], 0);
  }
}

// The block's result for its ng heads in shared memory: bo [ng][HD] (the
// accumulator relative to bm), bm [ng] (log2 domain), bl [ng]; unset in a
// block whose split has no key. After a cluster barrier, block `split`
// merges its slice of the ng * HD outputs over the row's non-empty splits
// (the first n_act of the cluster) and writes it; a second barrier keeps
// every block's shared memory alive until all have read it.
template <typename T, int HD>
__device__ void finish(const Args& a, const Split& p, float* bo, float* bm,
                       float* bl) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int len = max(p.len, 0);
  const int n_act = min(a.n_splits, (len + a.split_keys - 1) / a.split_keys);
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
  template <class Keys>
  static size_t smem(int pps) {
    return table_bytes<Keys>(pps) + qbytes + (ring > merge ? ring : merge);
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

template <int HD, class Keys>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  using L = Layout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, WS = L::WS, KS = HD / 16, NB = HD / 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  const Split p = locate<Keys>(a, GC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, tq = lane % 4;  // fragment row and column pair

  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + table_bytes<Keys>(a.pps));
  unsigned char* work = reinterpret_cast<unsigned char*>(qs) + L::qbytes;
  bf16* ring = reinterpret_cast<bf16*>(work);
  load_table<Keys>(a, p, tbl);

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
  if (p.s0 >= p.s1) {  // the row has no key in this split: merge only
    finish<bf16, HD>(a, p, bo, bm, bl);
    return;
  }
  __syncthreads();

  const bf16* pk = static_cast<const bf16*>(a.k);
  const bf16* pv = static_cast<const bf16*>(a.v);
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
        const size_t off = Keys::row(a, p, tbl, ok ? j : p.s0) * HD + ch * 8;
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

// grid (splits, KV heads x head chunks, rows); the splits of one (row, head
// chunk) form a cluster
template <typename K>
cudaError_t launch(K kern, size_t smem, const Args& a, int rows,
                   cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.KV * a.n_hc, rows);
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

template <int HD, class Keys>
cudaError_t launch_bf16(Args& a, int rows, cudaStream_t st) {
  a.n_hc = (a.H / a.KV + tc::GC - 1) / tc::GC;
  return launch(tc::split_kernel<HD, Keys>,
                tc::Layout<HD>::template smem<Keys>(a.pps), a, rows, st);
}

}  // namespace
