// Chunked, segment-packed paged prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prefill_attn/kernel.py,
//   paged_prefill_attention_pallas (the Pallas TPU kernel).
//   q [C,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb] int32
//   (-1 = unmapped); seg_ids [C] int32 slot per row (-1 = padding);
//   q_pos [C] int32 absolute positions -> out [C,H,hd]. Row i attends its
//   own slot's keys at positions <= q_pos[i]; padding rows, and rows with
//   no key, write zeros (the Pallas kernel averages V there).
//
// What bounds it: bytes in principle, latency in practice. The chunk's rows
//   of one slot share that slot's K/V, so the unique traffic is each
//   resident K/V byte once plus q and out (a few MB at serving sizes, a few
//   microseconds at HBM rate), and the products (4 * rows * keys * hd per
//   head) stay below the bf16 balance point for chunks of a few hundred
//   rows. What a real kernel waits on is the number of page loads in
//   flight and the instructions between a page's arrival and its use.
//
// What the design does about it (bf16):
//   - The query vectors of one KV head are the (row, head) pairs of the
//     chunk, numbered row-major (row t, head g -> t * G + g); a block takes
//     64 consecutive ones, so its rows x the G heads of the KV head share
//     every K/V page it reads, and any group size G = H / KV is taken (a
//     tile may start or end inside a row's group).
//   - Tensor cores for both products: mma.sync m16n8k16 with operands by
//     ldmatrix from padded rows. Each of the 4 warps owns 16 vectors (the
//     rows of the A operand, q held in shared memory); a 32-key stage gives
//     four n-blocks of scores; P goes back as the A operand of P V split
//     into a bf16 high part and a bf16 remainder, so that the softmax
//     weights keep ~16 bits (bf16 P alone misses 1e-4 + 1e-2 |ref| near 0).
//     Softmax state and the output accumulator stay in float32 registers.
//   - Page loads: the block's 128 threads keep a ring of 3 stages of 32
//     keys filled ahead by 16-byte cp.async (rows gathered through the
//     block table, zero-filled past the walk's end); one __syncthreads per
//     stage.
//   - Causal skipping: the block walks each distinct segment of its rows
//     once, only up to the largest position among its rows of that
//     segment. A warp skips the stages past all of its vectors' positions,
//     and masks only the stages that hold one of its rows' own positions
//     (or the split's end).
//   - Split over keys: the table's key positions are cut into n_splits runs
//     of whole pages (the wrapper's plan, from host-known sizes only: C, G,
//     KV, bs, mb and the SM count, never seg_ids or q_pos, which live on
//     the device), so that a few hundred rows still fill the card. The
//     splits of one vector tile form a thread-block cluster (at most 8): each
//     keeps its float32 partial (accumulator, max, sum) in its own shared
//     memory and after a cluster barrier each merges a slice of the outputs
//     over the splits that hold keys, through distributed shared memory.
//     No partial goes through device memory and there is no second launch.
// Float32 operands take a simple kernel (nothing times it): one block per
//   32 query vectors and KV head, scalar float32 FMAs, no split.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;  // splits per cluster (the portable size)
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* tables;
  const int* seg;
  const int* pos;
  void* out;
  int C, H, KV, bs, mb, pps, n_splits;
  float scale;  // hd**-0.5 (float32 kernel), times log2(e) (bf16 kernel)
};

// The rows a tile of vectors [v0, v0 + n) touches, in shared memory: seg
// and lim (the last key position a row attends, -1 for padding) per row,
// and for the first row of each distinct segment its largest lim (first,
// else -2). Returns after a barrier.
struct Rows {
  int t_lo, n;
};

__device__ __forceinline__ Rows load_rows(const Args& a, int v0, int nv,
                                          int* seg_s, int* lim_s,
                                          int* head_s, int threads) {
  const int G = a.H / a.KV;
  Rows r;
  r.t_lo = v0 / G;
  r.n = (v0 + nv - 1) / G - r.t_lo + 1;
  for (int t = threadIdx.x; t < r.n; t += threads) {
    const int sg = a.seg[r.t_lo + t];
    seg_s[t] = sg;
    lim_s[t] = sg >= 0 ? a.pos[r.t_lo + t] : -1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < r.n; t += threads) {
    const int sg = seg_s[t];
    int first = sg >= 0, lim = -1;
    for (int u = 0; u < r.n; ++u) {
      if (seg_s[u] != sg) continue;
      first &= u >= t;
      lim = max(lim, lim_s[u]);
    }
    head_s[t] = first ? lim : -2;
  }
  __syncthreads();
  return r;
}

// ------------------------------------------------- bf16: tensor-core tiles
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BM = 16 * kWarps;  // query vectors per block
constexpr int NK = 32;           // keys per ring stage
constexpr int kStages = 3;
constexpr int kMaxRows = BM + 1;  // rows a tile of BM vectors can touch

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;  // padded rows: conflict-free ldmatrix
  static constexpr int WS = HD + 8;  // block result rows
  static constexpr size_t meta = ((3 * kMaxRows * sizeof(int)) + 15) & ~15;
  static constexpr size_t qbytes = (size_t)BM * LD * 2;
  static constexpr size_t stage = 2 * NK * LD;  // K and V, elements
  static constexpr size_t ring = kStages * stage * 2;
  static constexpr size_t merge =
      ((size_t)BM * WS + (2 + kMaxSplits) * BM) * sizeof(float);
  static size_t smem(int pps) {
    const size_t tbl = ((size_t)pps * sizeof(int) + 15) & ~size_t(15);
    return tbl + meta + qbytes + (ring > merge ? ring : merge);
  }
};

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

// grid (split, vector tile, KV head); the splits of a tile form a cluster
template <int HD>
__global__ void __launch_bounds__(kThreads) prefill_split_kernel(Args a) {
  using L = Layout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, WS = L::WS, KS = HD / 16, NB = HD / 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  const int split = blockIdx.x, kvh = blockIdx.z;
  const int G = a.H / a.KV, n_vec = a.C * G;
  const int v0 = blockIdx.y * BM, nv = min(BM, n_vec - v0);
  const int split_keys = a.pps * a.bs, first_page = split * a.pps;
  const int ks0 = split * split_keys;
  const int ks1 = min(ks0 + split_keys, a.mb * a.bs);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, tq = lane % 4;  // fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix and its row

  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  int* seg_s = reinterpret_cast<int*>(
      smem + (((size_t)a.pps * sizeof(int) + 15) & ~size_t(15)));
  int* lim_s = seg_s + kMaxRows;
  int* head_s = lim_s + kMaxRows;
  bf16* qs = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(seg_s) +
                                     L::meta);
  unsigned char* work = reinterpret_cast<unsigned char*>(qs) + L::qbytes;
  bf16* ring = reinterpret_cast<bf16*>(work);
  float* bo = reinterpret_cast<float*>(work);  // [BM][WS], after the walk
  float* bm = bo + BM * WS;
  float* bl = bm + BM;
  float* wt = bl + BM;  // [kMaxSplits][BM]: each split's weight of a row

  // q, the A operand: row r = vector v0 + r (zero past the chunk)
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < BM * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH, v = v0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nv)
      x = *reinterpret_cast<const uint4*>(
          q + ((size_t)(v / G) * a.H + kvh * G + v % G) * HD + ch * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + ch * 8) = x;
  }
  const Rows rows = load_rows(a, v0, nv, seg_s, lim_s, head_s, kThreads);
  // the tile's largest position: splits past it hold no key of the tile
  int tile_lim = -1;
  for (int t = 0; t < rows.n; ++t) tile_lim = max(tile_lim, lim_s[t]);
  const int n_act = min(a.n_splits, tile_lim / split_keys + 1);

  // the lane's accumulator rows qr and qr + 8: local row indices
  const int va = warp * 16 + qr, vb = va + 8;
  const int ta = va < nv ? (v0 + va) / G - rows.t_lo : -1;
  const int tb = vb < nv ? (v0 + vb) / G - rows.t_lo : -1;

  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  // running maxima start finite, so that a vector with no key yet keeps
  // corr = 1 and p = 0 (masked scores are -inf)
  float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;

  const bf16* pk = static_cast<const bf16*>(a.pool_k);
  const bf16* pv = static_cast<const bf16*>(a.pool_v);
  for (int t0 = 0; t0 < rows.n && split < n_act; ++t0) {
    const int seg_lim = head_s[t0];
    if (seg_lim < ks0) continue;  // not a segment's first row, or no key here
    const int sg = seg_s[t0];
    const int k_end = min(ks1, seg_lim + 1);
    const int n_pages = (k_end - 1) / a.bs - first_page + 1;
    const int* table = a.tables + (size_t)sg * a.mb + first_page;
    for (int i = tid; i < n_pages; i += kThreads) tbl[i] = max(table[i], 0);
    __syncthreads();

    // each vector's exclusive key end in this split (0: not this segment)
    const int ea = ta >= 0 && seg_s[ta] == sg ? min(lim_s[ta] + 1, ks1) : 0;
    const int eb = tb >= 0 && seg_s[tb] == sg ? min(lim_s[tb] + 1, ks1) : 0;
    int w_lo = min(ea, eb), w_hi = max(ea, eb);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
      w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
    }

    const int n_tiles = (k_end - ks0 + NK - 1) / NK;
    auto issue = [&](int i) {
      if (i < n_tiles) {
        const int kt0 = ks0 + i * NK;
        bf16* kd = ring + (size_t)(i % kStages) * L::stage;
        bf16* vd = kd + NK * LD;
#pragma unroll
        for (int u = 0; u < NK * CH / kThreads; ++u) {
          const int idx = u * kThreads + tid, row = idx / CH, ch = idx % CH;
          const int j = kt0 + row;
          const bool ok = j < k_end;
          const int jj = ok ? j : ks0;
          const int page = tbl[jj / a.bs - first_page];
          const size_t off =
              (((size_t)page * a.bs + jj % a.bs) * a.KV + kvh) * HD + ch * 8;
          cp_async16(kd + row * LD + ch * 8, pk + off, ok ? 16 : 0);
          cp_async16(vd + row * LD + ch * 8, pv + off, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i landed for all; stage i - 1 is free
      issue(i + kStages - 1);
      const int kt0 = ks0 + i * NK;
      if (kt0 >= w_hi) continue;  // warp-uniform: every vector done
      const bf16* ks = ring + (size_t)(i % kStages) * L::stage;
      const bf16* vs = ks + NK * LD;

      // scores: n-block nb = keys 8nb .. 8nb + 7 of the stage, the even
      // and the odd k-steps summed apart (two independent mma chains, half
      // as deep: the products wait on mma latency, not on its rate)
      float sc[4][4], s2[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = s2[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + (warp * 16 + 8 * (mi & 1) + mr) * LD + 16 * kk +
                        8 * (mi >> 1));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, ks + (16 * np + 8 * (mi >> 1) + mr) * LD + 16 * kk +
                         8 * (mi & 1));
          mma((kk & 1) ? s2[2 * np] : sc[2 * np], qa, b[0], b[1]);
          mma((kk & 1) ? s2[2 * np + 1] : sc[2 * np + 1], qa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] += s2[nb][e];
      // scale (log2 domain); mask only a stage that holds a vector's end
      if (kt0 + NK <= w_lo) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nb][e] *= a.scale;
      } else {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kt0 + 8 * nb + 2 * tq + (e & 1);
            sc[nb][e] = j < ((e & 2) ? eb : ea) ? sc[nb][e] * a.scale
                                                : -INFINITY;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        mx_a = fmaxf(mx_a, fmaxf(sc[nb][0], sc[nb][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[nb][2], sc[nb][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
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
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[nb][e] - ((e & 2) ? mn_b : mn_a));
          sc[nb][e] = p;
          if (e & 2)
            l_b += p;
          else
            l_a += p;
        }
      // o += P V over the stage's two 16-key k-steps, P in hi and lo parts
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t ph[4], pl[4];
        split2(sc[2 * kp][0], sc[2 * kp][1], ph[0], pl[0]);
        split2(sc[2 * kp][2], sc[2 * kp][3], ph[1], pl[1]);
        split2(sc[2 * kp + 1][0], sc[2 * kp + 1][1], ph[2], pl[2]);
        split2(sc[2 * kp + 1][2], sc[2 * kp + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, vs + (16 * kp + 8 * (mi & 1) + mr) * LD + 16 * np +
                           8 * (mi >> 1));
          mma(o[2 * np], ph, b[0], b[1]);
          mma(o[2 * np], pl, b[0], b[1]);
          mma(o[2 * np + 1], ph, b[2], b[3]);
          mma(o[2 * np + 1], pl, b[2], b[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the table are free for the next walk
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // the block's partial in shared memory (over the ring's space)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)  // rows qr and qr + 8
      *reinterpret_cast<float2*>(bo + (va + 8 * h) * WS + 8 * nb + 2 * tq) =
          make_float2(o[nb][2 * h], o[nb][2 * h + 1]);
  if (tq == 0) {
    bm[va] = m_a;
    bm[vb] = m_b;
    bl[va] = l_a;
    bl[vb] = l_b;
  }

  // merge the tile's splits that hold keys (the first n_act of the
  // cluster), through distributed shared memory: first each row's weight
  // of each split (its rescale over the row's sum; 0 for a row with no
  // key), then block `split` writes a slice of the outputs, 4 a thread
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int r = tid; r < nv; r += kThreads) {
    float ms[kMaxSplits], M = -INFINITY, sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < n_act) {
        ms[s] = *cluster.map_shared_rank(bm + r, s);
        M = fmaxf(M, ms[s]);
      }
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < n_act) {
        ms[s] = exp2f(ms[s] - M);
        sum = fmaf(ms[s], *cluster.map_shared_rank(bl + r, s), sum);
      }
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < n_act) wt[s * BM + r] = ms[s] * inv;
  }
  __syncthreads();
  constexpr int Q4 = HD / 4;  // float4 groups of a row
  const int total = nv * Q4;
  const int per = (total + a.n_splits - 1) / a.n_splits;
  const int i1 = min(total, (split + 1) * per);
  bf16* out = static_cast<bf16*>(a.out);
  for (int i = split * per + tid; i < i1; i += kThreads) {
    const int r = i / Q4, d = 4 * (i % Q4), v = v0 + r;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < n_act) {
        const float w = wt[s * BM + r];
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(bo + r * WS + d, s));
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
      }
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)(v / G) * a.H + kvh * G + v % G) * HD + d);
    o2[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o2[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  cluster.sync();  // every block's shared memory stays until all have read
}

}  // namespace tc

// ---------------------------------------- float32: a simple scalar kernel
namespace fp {

constexpr int kThreads = 256;
constexpr int kMaxQ = 32;  // query vectors per block
constexpr int kMaxRows = kMaxQ + 1;

template <int HD>
inline size_t smem_bytes(int bs) {
  // q_s [kMaxQ][HD+1], k_s [bs][HD+1], v_s [bs][HD], p_s [kMaxQ][bs],
  // m/l/corr [kMaxQ] floats; seg/lim/head [kMaxRows] ints
  size_t floats = (size_t)kMaxQ * (HD + 1) + (size_t)bs * (HD + 1) +
                  (size_t)bs * HD + (size_t)kMaxQ * bs + 3 * kMaxQ;
  return floats * sizeof(float) + 3 * kMaxRows * sizeof(int);
}

// grid (vector tile, KV head): vectors v0 .. v0 + nq - 1 of the KV head
template <int HD>
__global__ void __launch_bounds__(kThreads) prefill_simple_kernel(Args a) {
  constexpr int QS = HD + 1;  // padded row stride: conflict-free columns
  constexpr int kAcc = kMaxQ * HD / kThreads;
  const int G = a.H / a.KV, kvh = blockIdx.y, bs = a.bs;
  const int v0 = blockIdx.x * kMaxQ;
  const int nq = min(kMaxQ, a.C * G - v0);
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
  int* lim_s = seg_s + kMaxRows;
  int* head_s = lim_s + kMaxRows;

  const float* q = static_cast<const float*>(a.q);
  for (int idx = tid; idx < nq * HD; idx += kThreads) {
    const int qi = idx / HD, d = idx % HD, v = v0 + qi;
    q_s[qi * QS + d] = q[((size_t)(v / G) * a.H + kvh * G + v % G) * HD + d];
  }
  for (int i = tid; i < nq; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const Rows rows = load_rows(a, v0, nq, seg_s, lim_s, head_s, kThreads);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const float* pk = static_cast<const float*>(a.pool_k);
  const float* pv = static_cast<const float*>(a.pool_v);
  for (int t0 = 0; t0 < rows.n; ++t0) {
    const int lim = head_s[t0];
    if (lim < 0) continue;  // not a segment's first row, or nothing to attend
    const int sg = seg_s[t0];
    const int n_pages = min(lim / bs + 1, a.mb);
    const int* table = a.tables + (size_t)sg * a.mb;

    for (int pg = 0; pg < n_pages; ++pg) {
      const size_t base =
          ((size_t)max(table[pg], 0) * bs * a.KV + kvh) * HD;  // + j*KV*HD
      for (int idx = tid; idx < bs * HD; idx += kThreads) {
        const int j = idx / HD, d = idx % HD;
        const size_t off = base + (size_t)j * a.KV * HD + d;
        k_s[j * QS + d] = pk[off];
        v_s[idx] = pv[off];
      }
      __syncthreads();

      // scores of every (query vector, key) pair of the page
      for (int idx = tid; idx < nq * bs; idx += kThreads) {
        const int qi = idx / bs, j = idx % bs;
        const int t = (v0 + qi) / G - rows.t_lo;
        float s = -INFINITY;
        if (seg_s[t] == sg && pg * bs + j <= lim_s[t]) {
          const float* qr = q_s + qi * QS;
          const float* kr = k_s + j * QS;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * a.scale;
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
          float x = acc[i] * c_s[qi];
          for (int j = 0; j < bs; ++j) x = fmaf(pr[j], v_s[j * HD + d], x);
          acc[i] = x;
        }
      }
      __syncthreads();
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    const int qi = idx / HD, d = idx % HD, v = v0 + qi;
    if (qi < nq)
      out[((size_t)(v / G) * a.H + kvh * G + v % G) * HD + d] =
          acc[i] / fmaxf(l_s[qi], 1e-30f);
  }
}

}  // namespace fp

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
  auto kern = tc::prefill_split_kernel<HD>;
  const size_t smem = tc::Layout<HD>::smem(a.pps);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const long long n_vec = (long long)a.C * (a.H / a.KV);
  const int tiles = (int)((n_vec + tc::BM - 1) / tc::BM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, tiles, a.KV);
  cfg.blockDim = dim3(tc::kThreads);
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
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  auto kern = fp::prefill_simple_kernel<HD>;
  const size_t smem = fp::smem_bytes<HD>(a.bs);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const long long n_vec = (long long)a.C * (a.H / a.KV);
  dim3 grid((unsigned)((n_vec + fp::kMaxQ - 1) / fp::kMaxQ), a.KV);
  kern<<<grid, fp::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; H % KV == 0 (any
// group size). bf16: pps pages per split, n_splits * pps >= mb and
// n_splits <= 8 (the portable cluster size); float32 takes n_splits = 1.
// Operands contiguous, q and pools 16-byte aligned; the caller checks.
extern "C" int paged_prefill_attention(const void* q, const void* pool_k,
                                       const void* pool_v, const void* tables,
                                       const void* seg_ids, const void* q_pos,
                                       void* out, int C, int H, int KV,
                                       int hd, int bs, int mb, int pps,
                                       int n_splits, int dtype, void* stream) {
  if (C <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || mb <= 0 || pps <= 0 ||
      n_splits <= 0 || n_splits > kMaxSplits ||
      (long long)pps * n_splits < mb || (dtype == 0 && n_splits != 1))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  Args a{q,  pool_k, pool_v, static_cast<const int*>(tables),
         static_cast<const int*>(seg_ids), static_cast<const int*>(q_pos),
         out, C, H, KV, bs, mb, pps, n_splits,
         dtype == 1 ? scale * kLog2e : scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return (int)launch_f32<64>(a, st);
  if (dtype == 0 && hd == 128) return (int)launch_f32<128>(a, st);
  if (dtype == 1 && hd == 64) return (int)launch_bf16<64>(a, st);
  if (dtype == 1 && hd == 128) return (int)launch_bf16<128>(a, st);
  return (int)cudaErrorInvalidValue;
}
