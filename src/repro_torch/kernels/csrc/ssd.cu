// Mamba2 SSD (state-space duality) kernels for Hopper (sm_90a): the O(1)
// recurrent decode step and the intra-chunk block of the chunked scan.
//
// ---------------------------------------------------------------- decode
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_decode_step_pallas (the
//   Pallas TPU kernel).
//   state [B,nh,hd,ds] float32; x [B,nh,hd]; dt [B,nh] float32 (softplus'd);
//   a_log [nh]; b, c [B,ds] ->
//     new[p,s] = state[p,s] * exp(dt * -exp(a_log)) + (dt * x[p]) * b[s]
//     y[p]     = sum_s new[p,s] * c[s]     (float32 product, as the Pallas
//                                           kernel; the plain version rounds
//                                           new to c's dtype first)
//   y in x's dtype, new state float32. An optional per-row `update` flag
//   (uint8 [B]) leaves a row's state untouched where it is 0, so the state
//   may be updated in place (new_state == state) under the serving
//   engine's emit mask.
//
// What bounds it: bytes. Per (slot, head) it reads and writes hd*ds float32
//   state once (16.8 MB per layer at 8 slots of either model) against ~5
//   flops per element: the floor is the state bytes over HBM bandwidth.
//
// What the design does about it: keep enough bytes in flight. The grid is
//   flat over (slot, head, group of DEC_RPT = 4 rows, float4 column): a
//   thread loads its 4 rows' float4s with 16-byte streaming loads, all
//   before any arithmetic, so at the serving shapes the whole state read
//   (8.4 MB, 131,072 threads of 64 bytes) is issued in one wave, ~64 KB a
//   SM (8 rows a thread was no faster). A row of ds floats is ds/4 consecutive lanes (one warp at ds 128,
//   half a warp at ds 64), so every warp access is whole 128-byte lines;
//   y[p] is a shuffle reduction within those lanes. b, c and x are read
//   straight from global memory (L1 / L2 hits), with no barrier. In place:
//   a thread reads each element before it writes it, and no other thread
//   touches it. One kernel for float32 and bf16 x/b/c.
//   What holds it back now: the fixed cost of a launch that moves 16.8
//   MB; chip_smoke.py times an in-place PyTorch pass over the same state
//   (`stream_ms`) beside it.
//
// ----------------------------------------------------------- intra-chunk
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_intra_chunk_pallas (the
//   Pallas TPU kernel).
//   xdt [B,S,nh,hd] float32 (x scaled by dt); la [B,S,nh] float32 (log decay
//   per step); b, c [B,S,ds] (rows may be strided); S = nc * L chunks of L
//   rows. Per (batch, chunk, head), with cum the in-chunk inclusive cumsum
//   of la (float32):
//     y[i]    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//     s_local = sum_j exp(cum_last - cum_j) xdt_j (x) B_j      [hd, ds]
//     cdec    = exp(cum_last)
//   all float32, as the TPU kernel writes them, and cum itself ([B,S,nh],
//   which the chunked scan needs for its inter-chunk term).
//
// What bounds it: bytes. At 8 rows x 256 x 32 heads x 64 it moves ~43 MB
//   (xdt and y in float32, s_local 8.4 MB), 0.013 ms at 3.35 TB/s, against
//   ~2.2 GFLOP; a 1-row chunk of 256 (the paged engine's launch) moves
//   ~5.4 MB, 0.0016 ms. What a kernel waits on at one row is latency: a
//   chunk's work for one head is a short causal walk of 256 keys.
//
// What the design does about it, bf16 b/c (the serving path; namespace tc):
//   - Tensor cores: mma.sync m16n8k16 bf16 with float32 accumulators.
//     C . B^T takes the bf16 operands as they are (exact products, float32
//     sums; odd k-steps in a second accumulator, two chains half as deep).
//     y = M xdt, with M_ij = C_i . B_j exp(cum_i - cum_j) masked by
//     select before exp, takes both float32 operands as bf16 hi + lo
//     (lo = bf16(x - hi)) in three products hi.hi + hi.lo + lo.hi (a
//     residual of ~2^-17 of each term); s_local = (w . xdt)^T B takes the
//     float32 side split, two products. The hi parts alone miss the 1e-4
//     tolerance (chip_smoke.py holds that reading). The decays take __expf
//     (ex2.approx), within ~2^-21 + |seg| 2^-24 relative of expf; the s
//     blocks turn cum into the weights w_j once, before their walk.
//   - Enough blocks at one row: one block of 4 warps per (chunk, head, y
//     tile of 32 rows) and per (chunk, head, slice of d_state) for s_local;
//     at mamba2's 1 x 256 that is 32 x (8 + 4) = 384 blocks of ~44 KB
//     shared memory and 128 registers a thread, 4 a SM: one wave. Heavy (late) y tiles come first in the grid.
//     C . B^T is recomputed per head (~8.4 MFLOP a head at L 256 on tensor
//     cores, cheaper than moving it between blocks).
//   - Short walks: a y tile's warps split as 2 row strips x 2 key halves,
//     so the last tile walks 128 keys a warp, and the halves are summed in
//     shared memory at the end; a strip skips key halves past its rows.
//   - Loads in flight: stages of 32 keys in a ring of RING; the next
//     stage's B and xdt rows arrive by 16-byte cp.async while the current
//     one is converted and multiplied (a deeper ring leaves fewer blocks a
//     SM and was slower); xdt goes to the hi / lo planes once per stage,
//     converted by the whole block.
//   - cum: each block scans la over the rows it needs (two rows a thread,
//     a warp scan and the warp totals); the first s block of a (chunk,
//     head) writes cdec and cum.
//   What holds it back now: at one row, the latency of each stage's chain
//   (two barriers, the conversion, dependent mma and exps) with ~3 warps a
//   scheduler, and the fixed cost of a launch of ~400 blocks on cold
//   data; at 8 rows, instruction issue (C . B^T again for each head, each
//   y tile converting its stages again). Not done: sharing C . B^T across
//   heads, one barrier a stage (the conversion a stage ahead).
// float32 b/c (namespace f32, the float32 serving phase and the tests): the
//   first design, float32 FMAs from shared memory (4 heads a block, row
//   tiles of 64 and state tiles walking keys in steps of 16). A declared
//   dispatch on dtype, as the float32 attention kernels keep theirs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL = 0xffffffffu;

// Each kernel's launch geometry has one owner, the plan functions below,
// which the launches use and the C plan entries export (kernel.py reads
// them; tests/test_torch_ssm.py checks its mirrors against them).
// Intra-chunk: threads, blocks, y tiles, s blocks, rows of a y tile, keys of
// a step, then the bf16 kernel's d_state columns of an s block and of a
// warp, or the float32 kernel's hd rows of a state tile and 0.
constexpr int INTRA_PLAN_LEN = 8;
// Decode: threads a block, blocks, threads in all, state rows a thread,
// lanes a row.
constexpr int DECODE_PLAN_LEN = 5;

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

// ------------------------------------------------------------------ decode
constexpr int DEC_NT = 128;  // threads per block
constexpr int DEC_RPT = 4;   // state rows per thread

// grid ceil(n_threads / DEC_NT); n_threads = B * nh * ceil(hd / DEC_RPT) *
// (DS / 4), a multiple of the DS / 4 lanes of one row.
template <typename T, int DS>
__global__ void __launch_bounds__(DEC_NT) ssd_decode_kernel(
    const float* state, const T* __restrict__ x, const float* __restrict__ dt,
    const void* __restrict__ a_log, int alog_bf16, const T* __restrict__ b,
    const T* __restrict__ c, const uint8_t* __restrict__ update,
    float* new_state, T* __restrict__ y, int n_threads, int nh, int hd,
    long long sxb, long long sbb, long long scb) {
  constexpr int LPR = DS / 4;  // lanes of one row: a float4 each
  static_assert(LPR >= 1 && LPR <= 32 && (32 % LPR) == 0, "ds");
  const int t = blockIdx.x * DEC_NT + threadIdx.x;
  if (t >= n_threads) return;  // whole rows leave: n_threads % LPR == 0
  const int per_pair = (hd + DEC_RPT - 1) / DEC_RPT * LPR;
  const int pair = t / per_pair, u = t % per_pair;
  const int p0 = u / LPR * DEC_RPT, q = u % LPR;
  const int bi = pair / nh, h = pair % nh;
  const unsigned lane = threadIdx.x & 31;
  const unsigned seg =  // the lanes of this thread's row
      (unsigned)(((1ull << LPR) - 1ull) << (lane & ~(unsigned)(LPR - 1)));

  const size_t base = (size_t)pair * hd * DS + (size_t)q * 4;
  float4 st[DEC_RPT];
#pragma unroll
  for (int r = 0; r < DEC_RPT; ++r)
    st[r] = p0 + r < hd ? __ldcs(reinterpret_cast<const float4*>(
                              state + base + (size_t)(p0 + r) * DS))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float d = dt[pair];
  const float al = alog_bf16
                       ? __bfloat162float(static_cast<const bf16*>(a_log)[h])
                       : static_cast<const float*>(a_log)[h];
  const float a = expf(d * -expf(al));
  float bv[4], cv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bv[k] = to_f(b[bi * sbb + q * 4 + k]);
    cv[k] = to_f(c[bi * scb + q * 4 + k]);
  }
  const T* xr = x + bi * sxb + (size_t)h * hd;
  const bool write = update == nullptr || update[bi] != 0;
  float acc[DEC_RPT];
#pragma unroll
  for (int r = 0; r < DEC_RPT; ++r) {
    const int p = p0 + r;
    const float uu = p < hd ? d * to_f(xr[p]) : 0.0f;
    float4 nw;
    nw.x = st[r].x * a + uu * bv[0];
    nw.y = st[r].y * a + uu * bv[1];
    nw.z = st[r].z * a + uu * bv[2];
    nw.w = st[r].w * a + uu * bv[3];
    if (write && p < hd)
      __stcs(reinterpret_cast<float4*>(new_state + base + (size_t)p * DS), nw);
    acc[r] = fmaf(nw.w, cv[3],
                  fmaf(nw.z, cv[2], fmaf(nw.y, cv[1], nw.x * cv[0])));
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < DEC_RPT; ++r)
      acc[r] += __shfl_xor_sync(seg, acc[r], o);
  if (q == 0)
#pragma unroll
    for (int r = 0; r < DEC_RPT; ++r)
      if (p0 + r < hd) y[(size_t)pair * hd + p0 + r] = from_f<T>(acc[r]);
}

cudaError_t decode_plan(int B, int nh, int hd, int ds, int* out) {
  if (B <= 0 || nh <= 0 || hd <= 0 ||
      (ds != 16 && ds != 32 && ds != 64 && ds != 128))
    return cudaErrorInvalidValue;
  const long long n_threads =
      (long long)B * nh * ((hd + DEC_RPT - 1) / DEC_RPT) * (ds / 4);
  if (n_threads > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int p[DECODE_PLAN_LEN] = {
      DEC_NT, (int)((n_threads + DEC_NT - 1) / DEC_NT), (int)n_threads,
      DEC_RPT, ds / 4};
  for (int i = 0; i < DECODE_PLAN_LEN; ++i) out[i] = p[i];
  return cudaSuccess;
}

template <typename T, int DS>
cudaError_t launch_decode(const void* state, const void* x, const void* dt,
                          const void* a_log, int alog_bf16, const void* b,
                          const void* c, const uint8_t* upd, void* new_state,
                          void* y, int n_threads, int n_blocks, int nh, int hd,
                          long long sxb, long long sbb, long long scb,
                          cudaStream_t st) {
  ssd_decode_kernel<T, DS><<<n_blocks, DEC_NT, 0, st>>>(
      static_cast<const float*>(state), static_cast<const T*>(x),
      static_cast<const float*>(dt), a_log, alog_bf16,
      static_cast<const T*>(b), static_cast<const T*>(c), upd,
      static_cast<float*>(new_state), static_cast<T*>(y), n_threads, nh, hd,
      sxb, sbb, scb);
  return cudaGetLastError();
}

// ------------------------------------------------------ intra-chunk, bf16
namespace tc {

constexpr int NT = 128;     // 4 warps
constexpr int TR = 32;      // rows of a y tile: 2 strips of 16
constexpr int KS = 32;      // keys of a stage: 2 halves of 16
constexpr int RING = 2;     // stages in flight: loads run RING - 1 ahead
constexpr int MAX_L = 256;  // longest chunk

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
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

// The launch plan (mirrored by kernel.py:intra_plan) and the shared memory
// layout of one block.
template <int HD, int DS>
struct Cfg {
  static constexpr int NSUB = 64 / HD;  // warps side by side over d_state
  static constexpr int SW = DS / NSUB < 32 ? DS / NSUB : 32;  // a warp's s
  static constexpr int SC = SW * NSUB;  // d_state columns of an s block
  static constexpr int NS = DS / SC;    // s blocks per (chunk, head)
  static constexpr int LDB = DS + 8;    // B / C rows (bf16), padded
  static constexpr int LDX = HD + 8;    // hi / lo rows (bf16), padded
  static constexpr int LDR = HD + 8;    // rows of the halves' sum (float)
  static constexpr int CUM = MAX_L * 4;
  static constexpr int CT = TR * LDB * 2;  // C rows of the y tile
  static constexpr int BT = KS * LDB * 2;  // a stage's B rows
  static constexpr int XF = KS * HD * 4;   // a stage's xdt rows, float32
  static constexpr int XP = KS * LDX * 2;  // the hi (and lo) plane
  static constexpr int WORK = RING * (BT + XF) + 2 * XP;
  static constexpr int SMEM = CUM + CT + WORK;
  static_assert(HD == 32 || HD == 64, "hd");
  static_assert(SW % 8 == 0 && SC * NS == DS, "d_state slices");
  static_assert(2 * 16 * LDR * 4 <= WORK, "the halves' sum fits");
  static_assert(SMEM <= 100 * 1024, "two blocks a SM at least");
};

// grid (n_y + NS) * B * nc * nh, NT threads. Block k: slot k / P, (chunk,
// head) pair k % P, P = B * nc * nh; slots 0 .. n_y - 1 are y tiles from
// the last (heaviest) down, slots n_y .. n_y + NS - 1 the s blocks.
template <int HD, int DS>
__global__ void __launch_bounds__(NT) intra_kernel(
    const float* __restrict__ xdt, const float* __restrict__ la,
    const bf16* __restrict__ b, const bf16* __restrict__ c,
    float* __restrict__ y, float* __restrict__ s_local,
    float* __restrict__ cdec, float* __restrict__ cum_out, int S, int nh,
    int L, int nc, int n_y, long long sb_b, long long sb_s, long long sc_b,
    long long sc_s) {
  using K = Cfg<HD, DS>;
  constexpr int LDB = K::LDB, LDX = K::LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_tot[NT / 32];
  float* cum_s = reinterpret_cast<float*>(smem);
  bf16* c_s = reinterpret_cast<bf16*>(smem + K::CUM);
  unsigned char* work = smem + K::CUM + K::CT;
  bf16* b_ring = reinterpret_cast<bf16*>(work);  // [RING][KS][LDB]
  float* xf_ring = reinterpret_cast<float*>(work + RING * K::BT);  // [RING][KS][HD]
  bf16* xhi = reinterpret_cast<bf16*>(work + RING * (K::BT + K::XF));  // [KS][LDX]
  bf16* xlo = xhi + KS * LDX;
  float* red = reinterpret_cast<float*>(work);  // [2][16][LDR], at the end

  const int P = gridDim.x / (n_y + K::NS);
  const int slot = blockIdx.x / P, pair = blockIdx.x % P;
  const int bc = pair / nh, h = pair % nh;  // bc = bi * nc + ci
  const int bi = bc / nc, ci = bc % nc;
  const bool is_y = slot < n_y;
  const int t = n_y - 1 - slot;  // y tile
  const int col0 = is_y ? 0 : (slot - n_y) * K::SC;  // B columns loaded
  // 16-byte chunks of a loaded B row: 1 << cpr_log
  const int cpr_log = is_y ? ilog2(DS / 8) : ilog2(K::SC / 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and its row
  const size_t row0 = (size_t)bi * S + (size_t)ci * L;  // chunk's first row
  const bf16* bb = b + bi * sb_b + (long long)ci * L * sb_s;
  const bf16* cc = c + bi * sc_b + (long long)ci * L * sc_s;
  const float* xh = xdt + (row0 * nh + h) * HD;  // row j at j * nh * HD
  const size_t xrow = (size_t)nh * HD;
  // keys (and cum rows) this block needs, in stages of KS
  const int n_keys = is_y ? min(L, (t + 1) * TR) : L;
  const int n_st = (n_keys + KS - 1) / KS;

  // stage st into ring slot st % RING; one commit group a stage
  auto load_stage = [&](int st) {
    const int j0 = st * KS;
    bf16* bd = b_ring + st % RING * KS * LDB;
    float* xf = xf_ring + st % RING * KS * HD;
    for (int e = tid; e < KS << cpr_log; e += NT) {
      const int jj = e >> cpr_log, ch = e & ((1 << cpr_log) - 1);
      const bool ok = j0 + jj < L;
      cp_async16(bd + jj * LDB + ch * 8,
                 ok ? bb + (long long)(j0 + jj) * sb_s + col0 + ch * 8 : bb,
                 ok ? 16 : 0);
    }
    constexpr int xpr = HD / 4;
    for (int e = tid; e < KS * xpr; e += NT) {
      const int jj = e / xpr, ch = e % xpr;
      const bool ok = j0 + jj < L;
      cp_async16(xf + jj * HD + ch * 4,
                 ok ? xh + (size_t)(j0 + jj) * xrow + ch * 4 : xh,
                 ok ? 16 : 0);
    }
  };
  // the stage's xdt rows (times w_j, which the s blocks keep in cum_s's
  // place) as bf16 hi and lo planes; rows past L are zero
  auto convert = [&](int st, bool weighted) {
    const int j0 = st * KS;
    const float* xf = xf_ring + st % RING * KS * HD;
    constexpr int xpr = HD / 4;
    for (int e = tid; e < KS * xpr; e += NT) {
      const int jj = e / xpr, p4 = e % xpr * 4;
      float4 v = *reinterpret_cast<const float4*>(xf + jj * HD + p4);
      if (weighted) {
        const float w = cum_s[j0 + jj];
        v.x *= w;
        v.y *= w;
        v.z *= w;
        v.w *= w;
      }
      uint32_t h0, l0, h1, l1;
      split2(v.x, v.y, h0, l0);
      split2(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(xhi + jj * LDX + p4) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(xlo + jj * LDX + p4) = make_uint2(l0, l1);
    }
  };

  // la of rows 2 tid, 2 tid + 1 first: the cum scan waits on these loads
  const int i0 = 2 * tid;
  const float a0 = i0 < n_keys ? la[(row0 + i0) * nh + h] : 0.0f;
  const float a1 = i0 + 1 < n_keys ? la[(row0 + i0 + 1) * nh + h] : 0.0f;
  if (is_y) {  // the tile's C rows, zero past L
    const int r0 = t * TR;
    constexpr int cpr = DS / 8;
    for (int e = tid; e < TR * cpr; e += NT) {
      const int i = e / cpr, ch = e % cpr;
      const bool ok = r0 + i < L;
      cp_async16(c_s + i * LDB + ch * 8,
                 ok ? cc + (long long)(r0 + i) * sc_s + ch * 8 : cc,
                 ok ? 16 : 0);
    }
  }
  // stages 0 .. RING - 2 (the first group carries the C rows too); a
  // group is committed for every stage index, empty past the last, so
  // that "stage st has landed" is always wait_group(RING - 2)
  for (int st = 0; st < RING - 1; ++st) {
    if (st < n_st) load_stage(st);
    cp_async_commit();
  }
  {  // cum over rows 0 .. n_keys - 1: a warp scan and the warp totals
    float v = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    float ex = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) ex = 0.0f;
    __syncthreads();
    for (int w = 0; w < warp; ++w) ex += warp_tot[w];
    cum_s[i0] = ex + a0;
    cum_s[i0 + 1] = (ex + a0) + a1;
  }
  cp_async_wait<RING - 2>();
  __syncthreads();  // cum, the C rows and stage 0 are in shared memory

  if (is_y) {
    // ------------------------------------------------ the y rows of tile t
    const int r0 = t * TR, rs = warp & 1, kh = warp >> 1;
    const int i0 = r0 + 16 * rs;  // the warp's first row
    const int ia = i0 + qr, ib = ia + 8;
    uint32_t ca[DS / 16][4];  // the strip's C rows: the A operand of C B^T
#pragma unroll
    for (int k = 0; k < DS / 16; ++k)
      ldsm_x4(ca[k], c_s + (16 * rs + (mi & 1) * 8 + mr) * LDB + k * 16 +
                         (mi >> 1) * 8);
    const float cum_a = cum_s[ia], cum_b = cum_s[ib];
    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    for (int st = 0; st < n_st; ++st) {
      if (st > 0) {
        cp_async_wait<RING - 2>();
        __syncthreads();  // stage st landed; stage st - 1 consumed
      }
      // into the slot of stage st - 1
      if (st + RING - 1 < n_st) load_stage(st + RING - 1);
      cp_async_commit();
      convert(st, false);
      __syncthreads();  // planes ready
      const int kb = 16 * kh, kj0 = st * KS + kb;  // the warp's 16 keys
      if (kj0 < n_keys && kj0 <= i0 + 15) {
        const bf16* bs = b_ring + st % RING * KS * LDB;
        // C B^T, the odd k-steps summed apart: two mma chains half as deep
        float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float s2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int k = 0; k < DS / 16; ++k) {
          uint32_t r[4];
          ldsm_x4(r, bs + (kb + (mi >> 1) * 8 + mr) * LDB + k * 16 +
                         (mi & 1) * 8);
          mma(k & 1 ? s2[0] : sc[0], ca[k], r[0], r[1]);
          mma(k & 1 ? s2[1] : sc[1], ca[k], r[2], r[3]);
        }
        // decay, masked by select before exp: exp(-inf) = 0, never inf * 0.
        // __expf: ex2.approx of seg * log2(e), within ~2^-21 + |seg| 2^-24
        // relative of expf (seg <= 0; below -88 both give ~0)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = kj0 + nb * 8 + 2 * tq + (e & 1);
            const bool live = j <= i && i < L;
            const float seg = live ? (e < 2 ? cum_a : cum_b) - cum_s[j]
                                   : -INFINITY;
            sc[nb][e] = (sc[nb][e] + s2[nb][e]) * __expf(seg);
          }
        uint32_t ah[4], al[4];
        split2(sc[0][0], sc[0][1], ah[0], al[0]);
        split2(sc[0][2], sc[0][3], ah[1], al[1]);
        split2(sc[1][0], sc[1][1], ah[2], al[2]);
        split2(sc[1][2], sc[1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t xh4[4], xl4[4];
          const int off =
              (kb + (mi & 1) * 8 + mr) * LDX + np * 16 + (mi >> 1) * 8;
          ldsm_x4_t(xh4, xhi + off);
          ldsm_x4_t(xl4, xlo + off);
          mma(acc[2 * np], ah, xh4[0], xh4[1]);
          mma(acc[2 * np + 1], ah, xh4[2], xh4[3]);
          mma(acc[2 * np], ah, xl4[0], xl4[1]);
          mma(acc[2 * np + 1], ah, xl4[2], xl4[3]);
          mma(acc[2 * np], al, xh4[0], xh4[1]);
          mma(acc[2 * np + 1], al, xh4[2], xh4[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage buffers
    float* rw = red + rs * 16 * K::LDR;
    if (kh == 1)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(rw + qr * K::LDR + n * 8 + 2 * tq) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(rw + (qr + 8) * K::LDR + n * 8 + 2 * tq) =
            make_float2(acc[n][2], acc[n][3]);
      }
    __syncthreads();
    if (kh == 0) {
      float* ya = y + ((row0 + ia) * nh + h) * HD;
      float* yb = y + ((row0 + ib) * nh + h) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int p = n * 8 + 2 * tq;
        const float2 u = *reinterpret_cast<const float2*>(rw + qr * K::LDR + p);
        const float2 v =
            *reinterpret_cast<const float2*>(rw + (qr + 8) * K::LDR + p);
        if (ia < L)
          *reinterpret_cast<float2*>(ya + p) =
              make_float2(acc[n][0] + u.x, acc[n][1] + u.y);
        if (ib < L)
          *reinterpret_cast<float2*>(yb + p) =
              make_float2(acc[n][2] + v.x, acc[n][3] + v.y);
      }
    }
    return;
  }

  // ----------------------------------- s_local [hd, col0 .. col0 + SC - 1]
  const float last = cum_s[L - 1];
  if (col0 == 0) {
    if (tid == 0) cdec[(size_t)bc * nh + h] = expf(last);
    for (int i = tid; i < L; i += NT) cum_out[(row0 + i) * nh + h] = cum_s[i];
  }
  __syncthreads();  // cum_s read; it becomes w_j = exp(cum_last - cum_j)
  for (int i = tid; i < MAX_L; i += NT)
    cum_s[i] = i < L ? __expf(last - cum_s[i]) : 0.0f;
  __syncthreads();
  const int p0 = warp % (HD / 16) * 16, scw = warp / (HD / 16) * K::SW;
  float acc[K::SW / 8][4];
#pragma unroll
  for (int n = 0; n < K::SW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  for (int st = 0; st < n_st; ++st) {
    if (st > 0) {
      cp_async_wait<RING - 2>();
      __syncthreads();
    }
    if (st + RING - 1 < n_st) load_stage(st + RING - 1);
    cp_async_commit();
    convert(st, true);
    __syncthreads();
    const bf16* bs = b_ring + st % RING * KS * LDB;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int kb = kk * 16;
      if (st * KS + kb >= L) break;  // the same for the whole block
      uint32_t ah[4], al[4];  // (w xdt)^T: rows p, columns the 16 keys
      const int off = (kb + (mi >> 1) * 8 + mr) * LDX + p0 + (mi & 1) * 8;
      ldsm_x4_t(ah, xhi + off);
      ldsm_x4_t(al, xlo + off);
      if constexpr (K::SW >= 16) {
#pragma unroll
        for (int np = 0; np < K::SW / 16; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, bs + (kb + (mi & 1) * 8 + mr) * LDB + scw + np * 16 +
                           (mi >> 1) * 8);
          mma(acc[2 * np], ah, r[0], r[1]);
          mma(acc[2 * np + 1], ah, r[2], r[3]);
          mma(acc[2 * np], al, r[0], r[1]);
          mma(acc[2 * np + 1], al, r[2], r[3]);
        }
      } else {
        uint32_t r[2];
        ldsm_x2_t(r, bs + (kb + (mi & 1) * 8 + mr) * LDB + scw);
        mma(acc[0], ah, r[0], r[1]);
        mma(acc[0], al, r[0], r[1]);
      }
    }
  }
  float* out = s_local + ((size_t)(bc * nh + h) * HD + p0) * DS + col0 + scw;
#pragma unroll
  for (int n = 0; n < K::SW / 8; ++n) {
    const int s = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(out + qr * DS + s) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (qr + 8) * DS + s) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// The launch plan (IntraPlan): one block per (chunk, head) and slot, n_y
// y tiles of TR rows then NS s blocks of SC d_state columns (SW a warp).
template <int HD, int DS>
cudaError_t plan(int B, int S, int nh, int L, int* out) {
  using K = Cfg<HD, DS>;
  const int n_y = (L + TR - 1) / TR;
  const long long blocks = (long long)B * (S / L) * nh * (n_y + K::NS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int p[INTRA_PLAN_LEN] = {NT, (int)blocks, n_y, K::NS, TR, KS, K::SC,
                                 K::SW};
  for (int i = 0; i < INTRA_PLAN_LEN; ++i) out[i] = p[i];
  return cudaSuccess;
}

template <int HD, int DS>
cudaError_t launch(const void* xdt, const void* la, const void* b,
                   const void* c, void* y, void* s_local, void* cdec,
                   void* cum, int B, int S, int nh, int L, long long sb_b,
                   long long sb_s, long long sc_b, long long sc_s,
                   cudaStream_t stream) {
  using K = Cfg<HD, DS>;
  auto kern = intra_kernel<HD, DS>;
  static bool attr_set = false;  // once per instantiation (benign race)
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  int p[INTRA_PLAN_LEN];
  cudaError_t err = plan<HD, DS>(B, S, nh, L, p);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)p[1], NT, K::SMEM, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(la),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c),
      static_cast<float*>(y), static_cast<float*>(s_local),
      static_cast<float*>(cdec), static_cast<float*>(cum), S, nh, L, S / L,
      p[2], sb_b, sb_s, sc_b, sc_s);
  return cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------- intra-chunk, float32
namespace f32 {

constexpr int NT = 256;
constexpr int HB = 4;       // heads per block
constexpr int TR = 64;      // query rows per row-tile block
constexpr int TJ = 16;      // key rows per step: (NT / TR) groups of 4
constexpr int MAX_L = 256;  // longest chunk
constexpr int RP = 8;       // rows of a head per thread (y and s_local)

static_assert(TR * (TJ / 4) == NT, "score tile: one (i, 4 j) per thread");
static_assert(HB * (TR / RP) * 8 == NT, "y tile: 8 column groups");

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// rows of hd one state-tile block covers
template <int DS>
__host__ __device__ constexpr int state_rows() {
  return (NT / DS) * RP;
}

// floats of dynamic shared memory: the larger of the two kinds of block
template <int HD, int DS>
__host__ __device__ constexpr int smem_floats() {
  // row tile: cum | C rows | B rows | xdt rows | decayed scores
  constexpr int row = up4(HB * MAX_L) + up4(TR * (DS + 1)) +
                      up4(TJ * (DS + 1)) + up4(TJ * HB * HD) +
                      HB * TR * (TJ + 1);
  // state tile: cum | weights | B rows | weighted xdt rows
  constexpr int state = 2 * up4(HB * MAX_L) + up4(TJ * DS) +
                        TJ * HB * state_rows<DS>();
  return row > state ? row : state;
}

// inclusive in-chunk cumsum of la for heads h0 .. h0 + HB - 1, one warp per
// head, into cum_s[HB][MAX_L]
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ la,
                                             float* cum_s, size_t row0,
                                             int nh, int h0, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= HB) return;
  float carry = 0.0f;
  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    float v = i < L ? la[(row0 + i) * nh + h0 + warp] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += n;
    }
    v += carry;
    if (i < L) cum_s[warp * MAX_L + i] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
}

// grid (nh / HB, B * nc, n_row_tiles + n_state_tiles), NT threads. A
// row-tile block takes TR query rows of HB heads and walks the key rows
// j <= its last row in steps of TJ: C_i . B_j once for the HB heads, their
// decayed scores (masked by select before exp) in shared memory, an
// 8 x (hd / 8) register tile of y per thread. A state-tile block takes a
// slice of hd rows of s_local for the same heads and walks all L key rows,
// each thread a column s of ds and 8 rows of each head in registers.
template <int HD, int DS>
__global__ void intra_kernel(const float* __restrict__ xdt,
                             const float* __restrict__ la,
                             const float* __restrict__ b,
                             const float* __restrict__ c,
                             float* __restrict__ y,
                             float* __restrict__ s_local,
                             float* __restrict__ cdec,
                             float* __restrict__ cum_out, int S, int nh,
                             int L, int nc, int n_row_tiles, long long sb_b,
                             long long sb_s, long long sc_b, long long sc_s) {
  extern __shared__ __align__(16) float sm[];
  const int h0 = blockIdx.x * HB;
  const int bi = blockIdx.y / nc, ci = blockIdx.y % nc;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)bi * S + (size_t)ci * L;  // chunk's first row
  float* cum_s = sm;  // [HB][MAX_L]
  chunk_cumsum(la, cum_s, row0, nh, h0, L);
  const float* bb = b + bi * sb_b + (long long)ci * L * sb_s;
  const float* cc = c + bi * sc_b + (long long)ci * L * sc_s;

  if ((int)blockIdx.z < n_row_tiles) {
    // ----------------------------------------------- y rows of this tile
    constexpr int CPT = HD / 8;  // y columns per thread
    float* cq_s = sm + up4(HB * MAX_L);        // [TR][DS + 1]
    float* bj_s = cq_s + up4(TR * (DS + 1));   // [TJ][DS + 1]
    float* xj_s = bj_s + up4(TJ * (DS + 1));   // [TJ][HB * HD]
    float* ms_s = xj_s + up4(TJ * HB * HD);    // [HB][TR][TJ + 1]
    const int r0 = blockIdx.z * TR;
    for (int e = tid; e < TR * DS; e += NT) {
      const int i = e / DS, s = e % DS;
      cq_s[i * (DS + 1) + s] =
          r0 + i < L ? cc[(long long)(r0 + i) * sc_s + s] : 0.0f;
    }
    // score-tile role: row si, key rows sj0 .. sj0 + 3 of each step
    const int si = tid % TR, sj0 = (tid / TR) * 4;
    // y-tile role: head yh, rows yr0 .. yr0 + 7, columns yc0 .. yc0 + CPT-1
    const int yh = tid / (NT / HB), yq = tid % (NT / HB);
    const int yr0 = (yq / 8) * RP, yc0 = (yq % 8) * CPT;
    float acc[RP][CPT];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[r][e] = 0.0f;

    const int j_end = min(L, r0 + TR);
    for (int j0 = 0; j0 < j_end; j0 += TJ) {
      __syncthreads();  // cum and C rows ready / last step's tiles consumed
      for (int e = tid; e < TJ * DS; e += NT) {
        const int jj = e / DS, s = e % DS;
        bj_s[jj * (DS + 1) + s] =
            j0 + jj < L ? bb[(long long)(j0 + jj) * sb_s + s] : 0.0f;
      }
      for (int e = tid * 4; e < TJ * HB * HD; e += NT * 4) {
        const int jj = e / (HB * HD), q = e % (HB * HD);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j0 + jj < L)
          v = *reinterpret_cast<const float4*>(
              xdt + ((row0 + j0 + jj) * nh + h0) * HD + q);
        *reinterpret_cast<float4*>(xj_s + jj * HB * HD + q) = v;
      }
      __syncthreads();
      // C_i . B_j once for every head, then each head's decayed score
      {
        float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* crow = cq_s + si * (DS + 1);
#pragma unroll 8
        for (int s = 0; s < DS; ++s) {
          const float cv = crow[s];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            cb[k] = fmaf(cv, bj_s[(sj0 + k) * (DS + 1) + s], cb[k]);
        }
        const int gi = r0 + si;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int gj = j0 + sj0 + k;
          const bool live = gi >= gj && gi < L;
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) {
            // masked by select before exp: exp(-inf) = 0, never inf * 0
            const float seg = live ? cum_s[hh * MAX_L + gi] -
                                         cum_s[hh * MAX_L + gj]
                                   : -INFINITY;
            ms_s[(hh * TR + si) * (TJ + 1) + sj0 + k] = cb[k] * expf(seg);
          }
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TJ; ++jj) {
        float xv[CPT];
#pragma unroll
        for (int e = 0; e < CPT; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              xj_s + jj * HB * HD + yh * HD + yc0 + e);
          xv[e] = v.x;
          xv[e + 1] = v.y;
          xv[e + 2] = v.z;
          xv[e + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float m = ms_s[(yh * TR + yr0 + r) * (TJ + 1) + jj];
#pragma unroll
          for (int e = 0; e < CPT; ++e) acc[r][e] = fmaf(m, xv[e], acc[r][e]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int gi = r0 + yr0 + r;
      if (gi < L) {
        float* out = y + ((row0 + gi) * nh + h0 + yh) * HD + yc0;
#pragma unroll
        for (int e = 0; e < CPT; e += 4)
          *reinterpret_cast<float4*>(out + e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                          acc[r][e + 3]);
      }
    }
    return;
  }

  // ------------------------------------------- s_local rows of this tile
  constexpr int PP = state_rows<DS>();  // hd rows per state tile
  float* w_s = sm + up4(HB * MAX_L);     // [HB][MAX_L] exp(cum_last - cum_j)
  float* bs_s = w_s + up4(HB * MAX_L);   // [TJ][DS]
  float* xw_s = bs_s + up4(TJ * DS);     // [TJ][HB][PP]
  const int p0 = (blockIdx.z - n_row_tiles) * PP;
  __syncthreads();
  for (int e = tid; e < HB * L; e += NT) {
    const int hh = e / L, j = e % L;
    w_s[hh * MAX_L + j] =
        expf(cum_s[hh * MAX_L + L - 1] - cum_s[hh * MAX_L + j]);
    if (p0 == 0)
      cum_out[(row0 + j) * nh + h0 + hh] = cum_s[hh * MAX_L + j];
  }
  if (p0 == 0 && tid < HB)
    cdec[((size_t)bi * nc + ci) * nh + h0 + tid] =
        expf(cum_s[tid * MAX_L + L - 1]);
  const int s = tid % DS, pg = (tid / DS) * RP;
  float acc[HB][RP];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[hh][r] = 0.0f;
  for (int j0 = 0; j0 < L; j0 += TJ) {
    __syncthreads();  // w ready / last step's tiles consumed
    for (int e = tid; e < TJ * DS; e += NT) {
      const int jj = e / DS, ss = e % DS;
      bs_s[e] = j0 + jj < L ? bb[(long long)(j0 + jj) * sb_s + ss] : 0.0f;
    }
    for (int e = tid; e < TJ * HB * PP; e += NT) {
      const int jj = e / (HB * PP), hh = (e / PP) % HB, q = e % PP;
      const int j = j0 + jj, p = p0 + q;
      xw_s[e] = (j < L && p < HD)
                    ? w_s[hh * MAX_L + j] *
                          xdt[((row0 + j) * nh + h0 + hh) * HD + p]
                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TJ; ++jj) {
      const float bv = bs_s[jj * DS + s];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh)
#pragma unroll
        for (int r = 0; r < RP; ++r)
          acc[hh][r] =
              fmaf(xw_s[(jj * HB + hh) * PP + pg + r], bv, acc[hh][r]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int p = p0 + pg + r;
      if (p < HD)
        s_local[((((size_t)bi * nc + ci) * nh + h0 + hh) * HD + p) * DS + s] =
            acc[hh][r];
    }
}

// The launch plan (IntraPlan): grid (nh / HB, B * nc, n_y + n_s), n_y row
// tiles of TR rows, n_s state tiles of state_rows<DS>() rows of hd.
template <int HD, int DS>
cudaError_t plan(int B, int S, int nh, int L, int* out) {
  const int n_y = (L + TR - 1) / TR;
  const int n_s = (HD + state_rows<DS>() - 1) / state_rows<DS>();
  const long long blocks = (long long)(nh / HB) * B * (S / L) * (n_y + n_s);
  if (nh % HB != 0 || (long long)B * (S / L) > 65535 ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int p[INTRA_PLAN_LEN] = {NT,  (int)blocks,        n_y, n_s,
                                 TR,  TJ, state_rows<DS>(), 0};
  for (int i = 0; i < INTRA_PLAN_LEN; ++i) out[i] = p[i];
  return cudaSuccess;
}

template <int HD, int DS>
cudaError_t launch(const void* xdt, const void* la, const void* b,
                   const void* c, void* y, void* s_local, void* cdec,
                   void* cum, int B, int S, int nh, int L, long long sb_b,
                   long long sb_s, long long sc_b, long long sc_s,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<HD, DS>() * (int)sizeof(float);
  auto kern = intra_kernel<HD, DS>;
  static bool attr_set = false;  // once per instantiation (benign race)
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  int p[INTRA_PLAN_LEN];
  cudaError_t err = plan<HD, DS>(B, S, nh, L, p);
  if (err != cudaSuccess) return err;
  dim3 grid(nh / HB, B * (S / L), p[2] + p[3]);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(la),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(s_local),
      static_cast<float*>(cdec), static_cast<float*>(cum), S, nh, L, S / L,
      p[2], sb_b, sb_s, sc_b, sc_s);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// The decode kernel's plan for state [B,nh,hd,ds] into out[DECODE_PLAN_LEN].
extern "C" int ssd_decode_plan(int B, int nh, int hd, int ds, int* out) {
  return (int)decode_plan(B, nh, hd, ds, out);
}

// dtype (of x, b, c): 0 = float32, 1 = bfloat16; alog_dtype likewise.
// state, new_state [B,nh,hd,ds] and y [B,nh,hd] contiguous and 16-byte
// aligned (new_state may be state); ds in {16, 32, 64, 128}; x rows at
// batch stride sxb with the nh*hd entries contiguous; b, c rows at batch
// strides sbb, scb, ds entries contiguous; dt [B,nh] contiguous; update
// null or uint8 [B].
extern "C" int ssd_decode_step(const void* state, const void* x,
                               const void* dt, const void* a_log,
                               const void* b, const void* c,
                               const void* update, void* new_state, void* y,
                               int B, int nh, int hd, int ds, long long sxb,
                               long long sbb, long long scb, int dtype,
                               int alog_dtype, void* stream) {
  int p[DECODE_PLAN_LEN];
  if ((dtype != 0 && dtype != 1) ||
      (reinterpret_cast<uintptr_t>(state) |
       reinterpret_cast<uintptr_t>(new_state)) % 16 != 0 ||
      decode_plan(B, nh, hd, ds, p) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* upd = static_cast<const uint8_t*>(update);
#define DECODE_LAUNCH(DS)                                                      \
  if (ds == DS)                                                                \
    return (int)(dtype == 0                                                    \
                     ? launch_decode<float, DS>(                               \
                           state, x, dt, a_log, alog_dtype, b, c, upd,         \
                           new_state, y, p[2], p[1], nh, hd, sxb, sbb, scb,    \
                           st)                                                 \
                     : launch_decode<bf16, DS>(                                \
                           state, x, dt, a_log, alog_dtype, b, c, upd,         \
                           new_state, y, p[2], p[1], nh, hd, sxb, sbb, scb,    \
                           st))
  DECODE_LAUNCH(16);
  DECODE_LAUNCH(32);
  DECODE_LAUNCH(64);
  DECODE_LAUNCH(128);
#undef DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Returns SPACE::FN<hd, ds>(...) for b/c dtype 0 (f32) or 1 (tc).
#define INTRA_CASE(SPACE, FN, HD, DS, ...) \
  if (hd == HD && ds == DS) return (int)SPACE::FN<HD, DS>(__VA_ARGS__)
#define INTRA_SPACE(SPACE, FN, ...)            \
  INTRA_CASE(SPACE, FN, 32, 16, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 32, 32, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 32, 64, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 32, 128, __VA_ARGS__); \
  INTRA_CASE(SPACE, FN, 64, 16, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 64, 32, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 64, 64, __VA_ARGS__);  \
  INTRA_CASE(SPACE, FN, 64, 128, __VA_ARGS__)
#define INTRA_DISPATCH(FN, ...)           \
  if (dtype == 0) {                       \
    INTRA_SPACE(f32, FN, __VA_ARGS__);    \
  } else if (dtype == 1) {                \
    INTRA_SPACE(tc, FN, __VA_ARGS__);     \
  }                                       \
  return (int)cudaErrorInvalidValue

static bool intra_shape_ok(int B, int S, int nh, int chunk) {
  return B > 0 && S > 0 && nh > 0 && chunk > 0 && chunk <= tc::MAX_L &&
         S % chunk == 0;
}

// The intra-chunk kernel's plan (dtype, hd, ds as below) for [B,S] rows of
// nh heads in chunks of `chunk` into out[INTRA_PLAN_LEN].
extern "C" int ssd_intra_chunk_plan(int dtype, int B, int S, int nh, int hd,
                                    int ds, int chunk, int* out) {
  if (!intra_shape_ok(B, S, nh, chunk)) return (int)cudaErrorInvalidValue;
  INTRA_DISPATCH(plan, B, S, nh, chunk, out);
}

// dtype (of b, c): 0 = float32 (f32), 1 = bfloat16 (tc); hd in {32, 64};
// ds in {16, 32, 64, 128}; chunk L <= 256 divides S; float32 needs nh % 4
// == 0; bf16 needs b, c and their row strides 16-byte aligned. xdt
// [B,S,nh,hd] (16-byte aligned) and la [B,S,nh] contiguous float32; b, c
// at (batch, row) strides with ds entries contiguous; outputs y
// [B,S,nh,hd], s_local [B,nc,nh,hd,ds], cdec [B,nc,nh] and cum [B,S,nh]
// (the in-chunk inclusive cumsum of la, which the chunked scan uses)
// contiguous float32.
extern "C" int ssd_intra_chunk(const void* xdt, const void* la, const void* b,
                               const void* c, void* y, void* s_local,
                               void* cdec, void* cum, int B, int S, int nh,
                               int hd, int ds, int chunk, long long sb_b,
                               long long sb_s, long long sc_b, long long sc_s,
                               int dtype, void* stream) {
  if (!intra_shape_ok(B, S, nh, chunk) || cum == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 &&
      ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)) %
               16 != 0 ||
       (sb_b | sb_s | sc_b | sc_s) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  INTRA_DISPATCH(launch, xdt, la, b, c, y, s_local, cdec, cum, B, S, nh,
                 chunk, sb_b, sb_s, sc_b, sc_s, st);
}
#undef INTRA_DISPATCH
#undef INTRA_SPACE
#undef INTRA_CASE
