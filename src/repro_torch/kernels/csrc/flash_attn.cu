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
// What the design does about it (bf16): the tensor cores through wgmma,
//   with nothing but the operand tiles in shared memory.
//   - A persistent kernel, one block of three warpgroups per SM, walking
//     work items of (128 query positions, head, batch row): the heaviest
//     (last) causal query tiles first, the G query heads of one KV head
//     next to each other so that their K/V tiles come from L2; block k
//     takes items k, k + grid, ... so that one item's epilogue overlaps the
//     next one's loads.
//   - The producer warpgroup gives up its registers (setmaxnreg); one thread
//     of it loads Q (two buffers) and keeps a ring of kStages K/V tiles
//     (64 keys x hd) filled ahead by TMA, one tensor map per operand over
//     its strided [B, heads, S, hd] view, 128-byte swizzled, with a full and
//     an empty mbarrier per stage. No __syncthreads in the loop.
//   - Two consumer warpgroups own 64 query rows each. Per K/V tile:
//     S = Q K^T by wgmma m64n64k16 (Q and K from shared memory, float32
//     accumulators in registers); the mask and the online softmax in
//     registers (row max and sum over the four threads of a row by
//     shuffles, one FFMA and one ex2 a score); P split into a bf16 high
//     part and a bf16 remainder in registers, the A operands of two wgmma
//     m64n{hd}k16 against V read MN-major from shared memory (V stays
//     [keys, hd]); O in registers. The split keeps ~16 bits of the softmax
//     weights, so the result is the float32 reference's up to summation
//     order (bf16 P alone misses a 1e-4 + 1e-2 |ref| tolerance near 0), at
//     1.5x the nominal flops.
//   - Overlap: a consumer issues tile t's scores together with tile t-1's
//     P V and runs tile t's softmax while P V runs; the two consumers take
//     turns on the tensor cores (named barriers). A block walks key tiles
//     only from the first its window reaches to the one holding its last
//     query position, and each consumer skips the tiles wholly masked for
//     its own rows.
//   Float32 operands take a simple kernel (nothing times it): one block per
//   (16 positions, chunk of at most 8 query heads of one KV head, batch
//   row), so any group size G = H / KV is taken; tiles in shared memory,
//   float32 FMAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
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

// ------------------------------------------------------------------ float32
namespace f32 {

constexpr int BQ = 16;   // query positions per block
constexpr int BK = 32;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int GC = 8;    // query heads per block: a chunk of the group

// shared-memory tiles of one block, M = 16 * ng query rows (row m is head
// m / 16 of the block's chunk at position q0 + m % 16)
template <int HD>
struct Tiles {
  static constexpr int LQ = HD + 1;  // Q and K rows: conflict-free columns
  static constexpr int LS = BK + 1;  // scores
  size_t q, k, v, s, o, m, l, total;
  __host__ __device__ explicit Tiles(int M) {
    q = 0;
    k = q + (size_t)M * LQ;
    v = k + (size_t)BK * LQ;
    s = v + (size_t)BK * HD;
    o = s + (size_t)M * LS;
    m = o + (size_t)M * HD;
    l = m + M;
    total = (l + M) * sizeof(float);
  }
};

// dst[r][0..HD) = src[r * stride + 0..HD) for r < valid, zeros below rows
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int rows,
                                          int valid) {
  for (int i = threadIdx.x; i < rows * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  using TL = Tiles<HD>;
  const int G = a.H / a.KV, n_hc = (G + GC - 1) / GC;
  const int kvh = blockIdx.y / n_hc, g0 = (blockIdx.y % n_hc) * GC;
  const int ng = min(GC, G - g0), h0 = kvh * G + g0;  // the block's heads
  const int M = BQ * ng;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = a.S;

  extern __shared__ float smem[];
  const TL L(BQ * GC);
  float* Qs = smem + L.q;
  float* Ks = smem + L.k;
  float* Vs = smem + L.v;
  float* Ss = smem + L.s;
  float* Os = smem + L.o;
  float* m_s = smem + L.m;
  float* l_s = smem + L.l;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k) + b * a.kb + kvh * a.kh;
  const float* v = static_cast<const float*>(a.v) + b * a.vb + kvh * a.vh;
  const int q_valid = min(BQ, S - q0);
  for (int g = 0; g < ng; ++g)
    load_rows<HD>(Qs + g * BQ * TL::LQ, TL::LQ,
                  q + b * a.qb + (h0 + g) * a.qh + q0 * a.qs, a.qs, BQ,
                  q_valid);
  for (int i = tid; i < M * HD; i += NT) Os[i] = 0.0f;
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
    load_rows<HD>(Ks, TL::LQ, k + k0 * a.ks, a.ks, BK, min(BK, S - k0));
    load_rows<HD>(Vs, HD, v + k0 * a.vs, a.vs, BK, min(BK, S - k0));
    __syncthreads();

    for (int i = tid; i < M * BK; i += NT) {  // raw scores q_m . k_j
      const int m = i / BK, j = i % BK;
      const float* qr = Qs + m * TL::LQ;
      const float* kr = Ks + j * TL::LQ;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ss[m * TL::LS + j] = dot;
    }
    __syncthreads();

    // online softmax, one warp per query row: mask, fold the tile into the
    // row's (max, sum), rescale its output row, write P over the scores
    for (int m = warp; m < M; m += NW) {
      const int qpos = q0 + m % BQ;
      const int kpos = k0 + lane;
      const bool ok = kpos <= qpos && kpos < S &&
                      (a.window <= 0 || qpos - kpos < a.window);
      const float s = ok ? Ss[m * TL::LS + lane] * a.scale : NEG;
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float corr = expf(m_old - m_new);
      const float p = expf(s - m_new);
      Ss[m * TL::LS + lane] = p;
      const float sum = warp_sum(p);
      for (int d = lane; d < HD; d += 32) Os[m * HD + d] *= corr;
      if (lane == 0) {  // every lane read m_s[m] before the reductions
        m_s[m] = m_new;
        l_s[m] = l_s[m] * corr + sum;
      }
    }
    __syncthreads();

    for (int i = tid; i < M * HD; i += NT) {  // O += P V
      const int m = i / HD, d = i % HD;
      const float* pr = Ss + m * TL::LS;
      float acc = Os[i];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], Vs[j * HD + d], acc);
      Os[i] = acc;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out);
  for (int i = tid; i < M * HD; i += NT) {
    const int m = i / HD, d = i % HD, g = m / BQ, pos = q0 + m % BQ;
    if (pos < S)
      out[b * a.ob + (h0 + g) * a.oh + pos * a.os + d] =
          Os[i] / fmaxf(l_s[m], 1e-30f);
  }
}

template <int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const Tiles<HD> L(BQ * GC);
  auto kern = flash_fwd<HD>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return e;
  }
  const int n_hc = (a.H / a.KV + GC - 1) / GC;
  dim3 grid((a.S + BQ - 1) / BQ, a.KV * n_hc, B);
  kern<<<grid, NT, L.total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// --------------------------------------------------------------------- bf16
namespace wg {

constexpr int BM = 128;      // query positions per work item
constexpr int BN = 64;       // keys per K/V tile
constexpr int kStages = 3;   // K/V ring depth
constexpr int NT = 384;      // producer + two consumer warpgroups
constexpr int kHalf = 64 * 64 * 2;  // bytes of a [64 rows x 64 cols] bf16 box

// dynamic shared memory, every tile 1024-byte aligned (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): a tile of 64 rows x HD is HD / 64
// boxes of [64 rows x 64 columns], each row 128 bytes, swizzled as TMA
// writes it and as the wgmma descriptors read it
template <int HD>
struct Smem {
  static constexpr int kTile = (HD / 64) * kHalf;
  static constexpr int q = 0;  // two buffers of two consumer tiles
  static constexpr int k = q + 4 * kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int bar = v + kStages * kTile;  // full, empty, q x 4
  static constexpr int total = bar + 8 * (2 * kStages + 4);
  static constexpr int alloc = total + 1024;  // room to align the base
};

struct Params {
  void* out;
  long long ob, oh, os;
  int B, S, H, KV, window;
  float scale_log2;  // hd**-0.5 * log2(e)
};

// One work item: 128 query positions of one head of one batch row. Items
// are numbered heaviest first (the last causal query tiles), heads of one
// KV head next to each other; block k takes items k, k + gridDim.x, ...
struct Item {
  int h, b, kvh, q0;
  int first[2], last[2];  // key tiles of each consumer (last < first: none)
  int t_first, t_last;    // the union, which the producer loads
};

__device__ __forceinline__ Item item_at(const Params& a, int w) {
  Item it;
  const int n_qt = (a.S + BM - 1) / BM;
  it.h = w % a.H;
  it.b = (w / a.H) % a.B;
  it.q0 = (n_qt - 1 - w / (a.H * a.B)) * BM;
  it.kvh = it.h / (a.H / a.KV);
  // each consumer c (rows q0 + 64c ..): from the first key tile its window
  // reaches to the one holding its last row
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int r0 = it.q0 + 64 * c, r1 = min(r0 + 63, a.S - 1);
    it.first[c] = (a.window > 0 ? max(0, r0 - a.window + 1) : 0) / BN;
    it.last[c] = r0 < a.S ? r1 / BN : -1;  // none: rows past S
  }
  it.t_first = it.first[0];
  it.t_last = max(it.last[0], it.last[1]);
  return it;
}

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
// one [64 rows x 64 columns] box at (column c0, row c1, head c2, batch c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
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
// K-major operand (Q, K): 16 columns at k-step kk of a [64 x HD] tile
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024);
}
// MN-major operand (V): 16 key rows at k-step kk of a [64 keys x HD] tile;
// the HD / 64 column boxes lie kHalf apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, kHalf, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// named barriers 1 and 2 over the 256 consumer threads: one consumer
// waits for its turn while the other arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// d (+)= A B, m64n64k16: A (64 x 16) and B (16 x 64, K-major) from shared
// memory through descriptors; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16: A (64 x 16) from registers (the accumulator
// layout of a score tile), B (16 x 64) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A (64 x 16) from registers (the accumulator
// layout of a score tile), B (16 x 128) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const Params a) {
  using SM = Smem<HD>;
  constexpr int ND = HD / 2;  // O accumulators a thread holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_q = s_base + SM::q, s_k = s_base + SM::k,
                 s_v = s_base + SM::v;
  const uint32_t full = s_base + SM::bar, empty = full + 8 * kStages,
                 q_full = empty + 8 * kStages, q_empty = q_full + 16;
  const int n_items = ((a.S + BM - 1) / BM) * a.B * a.H;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, 8);
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
      int kv = 0;  // K/V tiles loaded so far: stage kv % kStages
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        const Item it = item_at(a, w);
        const int x = n & 1;  // Q buffer, free once item n - 2 is done
        if (n >= 2) mbar_wait(q_empty + 8 * x, ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * x, 2 * SM::kTile);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int y = 0; y < HD / 64; ++y)
            tma_load(s_q + (2 * x + c) * SM::kTile + y * kHalf, &tq,
                     q_full + 8 * x, 64 * y, it.q0 + 64 * c, it.h, it.b);
        for (int t = it.t_first; t <= it.t_last; ++t, ++kv) {
          const int st = kv % kStages;
          if (kv >= kStages)
            mbar_wait(empty + 8 * st, ((kv / kStages) - 1) & 1);
          mbar_expect_tx(full + 8 * st, 2 * SM::kTile);
#pragma unroll
          for (int y = 0; y < HD / 64; ++y) {
            tma_load(s_k + st * SM::kTile + y * kHalf, &tk, full + 8 * st,
                     64 * y, t * BN, it.kvh, it.b);
            tma_load(s_v + st * SM::kTile + y * kHalf, &tv, full + 8 * st,
                     64 * y, t * BN, it.kvh, it.b);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
  const int W = a.window;

  float o[ND];
  float m_a, m_b, l_a, l_b;
  uint32_t p_hi[4][4], p_lo[4][4];  // P of the previous tile, A operands
  int kv0 = 0;                      // K/V tiles of the earlier items
  int t_first = 0, r0 = 0, row_a = 0, row_b = 0;
  uint32_t s_qc = 0;

  // stage and phase of the item's key tile t; a stage goes back to the
  // producer when lane 0 of each of the 8 consumer warps has arrived (tile
  // t-1's stage only after its P V product is complete)
  auto stage = [&](int t) { return (kv0 + t - t_first) % kStages; };
  auto wait_full = [&](int t) {
    mbar_wait(full + 8 * stage(t), ((kv0 + t - t_first) / kStages) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage(t));
  };
  auto qk = [&](float (&s)[32], int t) {  // s = Q K_t^T, issued
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k(s_qc, kk),
                   desc_k(s_k + stage(t) * SM::kTile, kk), kk > 0);
  };
  auto pv = [&](int t) {  // o += P V_t, issued
    const uint32_t s_vt = s_v + stage(t) * SM::kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (HD == 128) {
        wgmma_rs_n128(o, p_hi[kk], desc_mn(s_vt, kk));
        wgmma_rs_n128(o, p_lo[kk], desc_mn(s_vt, kk));
      } else {
        wgmma_rs_n64(o, p_hi[kk], desc_mn(s_vt, kk));
        wgmma_rs_n64(o, p_lo[kk], desc_mn(s_vt, kk));
      }
    }
  };
  // scores of tile t -> P = 2^(s scale - m) in place (one FFMA and one
  // ex2 a score), the row maxima (scaled, log2 domain) and sums advanced;
  // returns whether a row maximum of this warp moved. Masked scores are
  // -inf, so a row with no key yet keeps P = 0.
  auto softmax = [&](float (&s)[32], int t, float& corr_a, float& corr_b) {
    const int k0 = t * BN;
    if (k0 + BN - 1 > r0 || (W > 0 && k0 <= r0 + 63 - W)) {  // edge tile
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int qpos = (j & 2) ? row_b : row_a;
        const int kpos = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
        if (kpos > qpos || (W > 0 && qpos - kpos >= W)) s[j] = -INFINITY;
      }
    }
    float mx[8][2];  // tree maxima: [pair][row a, row b]
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mx[k][0] = fmaxf(s[4 * k], s[4 * k + 1]);
      mx[k][1] = fmaxf(s[4 * k + 2], s[4 * k + 3]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) {
        mx[k][0] = fmaxf(mx[k][0], mx[k + w][0]);
        mx[k][1] = fmaxf(mx[k][1], mx[k + w][1]);
      }
    float mx_a = mx[0][0], mx_b = mx[0][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * a.scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * a.scale_log2);
    const bool moved = __any_sync(0xffffffffu, mn_a != m_a || mn_b != m_b);
    corr_a = mn_a == m_a ? 1.f : ex2(m_a - mn_a);
    corr_b = mn_b == m_b ? 1.f : ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sm[8][2];  // tree sums
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * k + e] = ex2(fmaf(s[4 * k + e], a.scale_log2,
                                (e & 2) ? -mn_b : -mn_a));
      sm[k][0] = s[4 * k] + s[4 * k + 1];
      sm[k][1] = s[4 * k + 2] + s[4 * k + 3];
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) {
        sm[k][0] += sm[k + w][0];
        sm[k][1] += sm[k + w][1];
      }
    l_a = l_a * corr_a + sm[0][0];
    l_b = l_b * corr_b + sm[0][1];
    return moved;
  };
  // P as bf16 hi + lo parts in the A-operand layout of k-step kk (keys
  // 16kk .. 16kk + 15): register r holds accumulators 8kk + 2r, + 1
  auto split_p = [&](const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
        const uint32_t hi = cvt_bf16x2(p0, p1);
        p_hi[kk][r] = hi;
        p_lo[kk][r] = cvt_bf16x2(p0 - __uint_as_float(hi << 16),
                                 p1 - __uint_as_float(hi & 0xffff0000u));
      }
  };
  auto rescale = [&](float corr_a, float corr_b) {
#pragma unroll
    for (int j = 0; j < ND; ++j) o[j] *= (j & 2) ? corr_b : corr_a;
  };

  // Items: this consumer's tiles of an item are [lo, hi], the others it
  // only hands back. The two consumers take turns on the tensor cores
  // (named barriers 1 and 2): turn i of an item belongs to its key tile
  // t_first + i, and turn n to nothing; every consumer takes all n + 1
  // turns. In the turn of its tile t a consumer issues the scores of t and
  // the P V product of t - 1, then runs the softmax of t while those
  // products and the other's turn proceed. Each kind of turn is straight-
  // line code: ptxas serialises wgmma when branches hide which group is
  // pending.
  if (c == 1) named_arrive(1);  // consumer 0 takes the first turn
  for (int w = blockIdx.x, nit = 0; w < n_items; w += gridDim.x, ++nit) {
    const Item it = item_at(a, w);
    const bool final_item = w + (int)gridDim.x >= n_items;
    const int lo = c ? it.first[1] : it.first[0];  // no local array
    const int hi = c ? it.last[1] : it.last[0];
    const int n = it.t_last - it.t_first + 1;
    t_first = it.t_first;
    r0 = it.q0 + 64 * c;
    row_a = r0 + 16 * warp + lane / 4;  // accumulator rows of wgmma m64nN
    row_b = row_a + 8;
    s_qc = s_q + (2 * (nit & 1) + c) * SM::kTile;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[j] = 0.f;
    m_a = m_b = NEG;
    l_a = l_b = 0.f;

    auto turn_begin = [&](int i) {
      if (i < n) wait_full(t_first + i);
      named_sync(1 + c);
    };
    auto turn_end = [&](int i) {  // the very last turn has no successor
      if (c == 0 || !final_item || i < n) named_arrive(2 - c);
    };
    auto idle_turn = [&](int i) {
      turn_begin(i);
      turn_end(i);
      if (i < n) release(t_first + i);
    };

    mbar_wait(q_full + 8 * (nit & 1), (nit >> 1) & 1);
    int i = 0;
    if (lo <= hi) {
      float s[32], corr_a, corr_b;
      for (; i < lo - t_first; ++i) idle_turn(i);
      turn_begin(i);  // tile lo: scores only
      wgmma_fence();
      qk(s, lo);
      wgmma_commit();
      turn_end(i);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, lo, corr_a, corr_b);
      split_p(s);
      for (++i; i <= hi - t_first; ++i) {  // tile t: scores, P V of t-1
        const int t = t_first + i;
        turn_begin(i);
        wgmma_fence();
        qk(s, t);
        wgmma_commit();
        pv(t - 1);
        wgmma_commit();
        turn_end(i);
        wgmma_wait<1>();  // the scores; P V may still run
        fence_regs(s);
        const bool moved = softmax(s, t, corr_a, corr_b);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p_hi);
        fence_regs(p_lo);
        release(t - 1);
        if (moved) rescale(corr_a, corr_b);
        split_p(s);
      }
      turn_begin(i);  // P V of tile hi
      wgmma_fence();
      pv(hi);
      wgmma_commit();
      turn_end(i);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(hi);
      if (i < n) release(t_first + i);
      ++i;
    }
    for (; i <= n; ++i) idle_turn(i);
    // every score of the item is read: its Q buffer goes back
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * (nit & 1));
    kv0 += n;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    bf16* out = static_cast<bf16*>(a.out) + it.b * a.ob + it.h * a.oh;
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      const int row = (j & 2) ? row_b : row_a;
      if (row < a.S) {
        const int col = 8 * (j / 4) + 2 * (lane % 4);
        const float inv = (j & 2) ? inv_b : inv_a;
        *reinterpret_cast<__nv_bfloat162*>(out + row * a.os + col) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      }
    }
  }
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

// a map over the strided [B, heads, S, hd] view at `ptr` (element strides
// of batch, head, position), boxes of [64 positions x 64 columns]
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int heads, int S, int hd, long long sb, long long sh,
              long long ss) {
  // the stride of a dimension of size 1 is never used; keep it legal
  auto legal = [](long long st, int n) {
    return n == 1 && st == 0 ? 16ull : 2ull * (unsigned long long)st;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {legal(ss, S), legal(sh, heads),
                                 legal(sb, B)};
  const cuuint32_t box[4] = {64, BN, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, a.q, B, a.H, a.S, HD, a.qb, a.qh, a.qs) ||
      !make_map(enc, &tk, a.k, B, a.KV, a.S, HD, a.kb, a.kh, a.ks) ||
      !make_map(enc, &tv, a.v, B, a.KV, a.S, HD, a.vb, a.vh, a.vs))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::alloc);
  if (e != cudaSuccess) return e;
  const Params p{a.out, a.ob, a.oh, a.os, B, a.S, a.H, a.KV, a.window,
                 1.4426950408889634f * a.scale};
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long n_items = (long long)((a.S + BM - 1) / BM) * B * a.H;
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);  // persistent
  kern<<<grid, NT, Smem<HD>::alloc, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; H % KV == 0 (any
// group size). bf16 rows must be 16-byte aligned (strides multiples of 8,
// pointers 16-byte aligned); the caller checks.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int S, int H, int KV, int hd, int window, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q,  k,  v,  out, qb, qh, qs, kb, kh, ks, vb,     vh,
         vs, ob, oh, os,  S,  H,  KV, window, 1.0f / sqrtf((float)hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return (int)f32::launch<64>(a, B, st);
  if (dtype == 0 && hd == 128) return (int)f32::launch<128>(a, B, st);
  if (dtype == 1 && hd == 64) return (int)wg::launch<64>(a, B, st);
  if (dtype == 1 && hd == 128) return (int)wg::launch<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
