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
//   state once (16.8 MB per layer at 8 slots of either model) against ~4
//   flops per element: the floor is the state bytes over HBM bandwidth.
//
// What the design does about it: one block per (slot, head); each warp
//   owns whole rows p of the state, its lanes walk the row's ds entries
//   (consecutive lanes on consecutive addresses, so every warp load and
//   store is one coalesced 128-byte line), the update happens in registers
//   and y[p] is a warp-shuffle reduction. b and c are staged once in
//   shared memory. Nothing else is read or written.
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
//   all float32, as the TPU kernel writes them.
//
// What bounds it: bytes. At 8 rows x 256 x 32 heads x 64 it moves ~43 MB
//   (xdt and y in float32, s_local 8.4 MB), 0.013 ms at 3.35 TB/s, against
//   ~2.2 GFLOP, 0.0045 ms at the tensor cores' TF32 rate; a 1-row chunk of
//   256 (the paged engine's launch) moves ~5.4 MB. This kernel does those
//   operations in float32 FMAs, whose 67 TFLOP/s alone take 0.033 ms at 8
//   rows: the design, not the function, keeps it above the bound.
//
// What the design does about it: a causal "linear attention" with a decay
//   mask and no softmax, in float32 FMAs (a bf16 tensor-core product of the
//   masked scores and xdt would round both to 2^-9 and miss a float32
//   tolerance). Two kinds of blocks over one grid (heads / HB, B * nc,
//   row tiles + state tiles):
//   - a row-tile block takes TR = 64 query rows of HB = 4 heads. The
//     [L, L] score matrix is never formed: it walks the key rows j <= its
//     last row in steps of TJ = 16, computes C_i . B_j once for the tile
//     (B and C are shared by every head, one group), turns it into the
//     HB heads' decayed scores in shared memory, masked by select before
//     exp (exp(cum_i - cum_j) overflows for j > i), and accumulates an
//     8 x (hd/8) register tile of y per thread.
//   - a state-tile block takes a slice of hd rows of s_local for the same
//     HB heads and walks all L key rows, each thread a column s of ds and
//     8 rows of each head in registers.
//   Not done yet (later work): tensor cores with split operands, keeping
//   C_i . B_j across head groups, fewer reloads of B.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ------------------------------------------------------------------ decode
// grid (nh, B), NT threads, 2 * ds floats of dynamic shared memory.
// state and new_state may alias: each thread reads an element before it
// writes the same element, and no other thread touches it.
template <typename T>
__global__ void ssd_decode_kernel(const float* state, const T* __restrict__ x,
                                  const float* __restrict__ dt,
                                  const void* __restrict__ a_log,
                                  int alog_bf16, const T* __restrict__ b,
                                  const T* __restrict__ c,
                                  const uint8_t* __restrict__ update,
                                  float* new_state, T* __restrict__ y, int nh,
                                  int hd, int ds, long long sxb, long long sbb,
                                  long long scb) {
  extern __shared__ float bc_s[];  // b [ds], c [ds]
  float* b_s = bc_s;
  float* c_s = bc_s + ds;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = tid; s < ds; s += NT) {
    b_s[s] = to_f(b[bi * sbb + s]);
    c_s[s] = to_f(c[bi * scb + s]);
  }
  __syncthreads();
  const float d = dt[(size_t)bi * nh + h];
  const float al = alog_bf16
                       ? __bfloat162float(static_cast<const bf16*>(a_log)[h])
                       : static_cast<const float*>(a_log)[h];
  const float a = expf(d * -expf(al));
  const bool write = update == nullptr || update[bi] != 0;
  const size_t base = ((size_t)bi * nh + h) * hd * ds;
  const T* xr = x + bi * sxb + (size_t)h * hd;
  for (int p = warp; p < hd; p += NW) {
    const float u = d * to_f(xr[p]);
    const float* srow = state + base + (size_t)p * ds;
    float* orow = new_state + base + (size_t)p * ds;
    float acc = 0.0f;
    for (int s = lane; s < ds; s += 32) {
      const float nw = srow[s] * a + u * b_s[s];
      if (write) orow[s] = nw;
      acc = fmaf(nw, c_s[s], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) y[((size_t)bi * nh + h) * hd + p] = from_f<T>(acc);
  }
}

// ------------------------------------------------------------- intra-chunk
constexpr int HB = 4;      // heads per block
constexpr int TR = 64;     // query rows per row-tile block
constexpr int TJ = 16;     // key rows per step: (NT / TR) groups of 4
constexpr int MAX_L = 256;  // longest chunk
constexpr int RP = 8;      // rows of a head per thread (y and s_local)

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
__host__ __device__ constexpr int intra_smem_floats() {
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

// grid (nh / HB, B * nc, n_row_tiles + n_state_tiles), NT threads.
template <typename T, int HD, int DS>
__global__ void ssd_intra_chunk_kernel(
    const float* __restrict__ xdt, const float* __restrict__ la,
    const T* __restrict__ b, const T* __restrict__ c, float* __restrict__ y,
    float* __restrict__ s_local, float* __restrict__ cdec, int S, int nh,
    int L, int nc, int n_row_tiles, long long sb_b, long long sb_s,
    long long sc_b, long long sc_s) {
  extern __shared__ __align__(16) float sm[];
  const int h0 = blockIdx.x * HB;
  const int bi = blockIdx.y / nc, ci = blockIdx.y % nc;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)bi * S + (size_t)ci * L;  // chunk's first row
  float* cum_s = sm;  // [HB][MAX_L]
  chunk_cumsum(la, cum_s, row0, nh, h0, L);
  const T* bb = b + bi * sb_b + (long long)ci * L * sb_s;
  const T* cc = c + bi * sc_b + (long long)ci * L * sc_s;

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
          r0 + i < L ? to_f(cc[(long long)(r0 + i) * sc_s + s]) : 0.0f;
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
            j0 + jj < L ? to_f(bb[(long long)(j0 + jj) * sb_s + s]) : 0.0f;
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
      bs_s[e] = j0 + jj < L ? to_f(bb[(long long)(j0 + jj) * sb_s + ss]) : 0.0f;
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

template <typename T, int HD, int DS>
cudaError_t launch_intra(const void* xdt, const void* la, const void* b,
                         const void* c, void* y, void* s_local, void* cdec,
                         int B, int S, int nh, int L, long long sb_b,
                         long long sb_s, long long sc_b, long long sc_s,
                         cudaStream_t stream) {
  constexpr int smem = intra_smem_floats<HD, DS>() * (int)sizeof(float);
  auto kern = ssd_intra_chunk_kernel<T, HD, DS>;
  static bool attr_set = false;  // once per instantiation (benign race)
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int nc = S / L;
  const int n_row = (L + TR - 1) / TR;
  const int n_state = (HD + state_rows<DS>() - 1) / state_rows<DS>();
  dim3 grid(nh / HB, B * nc, n_row + n_state);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(la),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<float*>(y), static_cast<float*>(s_local),
      static_cast<float*>(cdec), S, nh, L, nc, n_row, sb_b, sb_s, sc_b, sc_s);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c): 0 = float32, 1 = bfloat16; alog_dtype likewise.
// state, new_state [B,nh,hd,ds] and y [B,nh,hd] contiguous (new_state may be
// state); x rows at batch stride sxb with the nh*hd entries contiguous; b,
// c rows at batch strides sbb, scb, ds entries contiguous; dt [B,nh]
// contiguous; update null or uint8 [B].
extern "C" int ssd_decode_step(const void* state, const void* x,
                               const void* dt, const void* a_log,
                               const void* b, const void* c,
                               const void* update, void* new_state, void* y,
                               int B, int nh, int hd, int ds, long long sxb,
                               long long sbb, long long scb, int dtype,
                               int alog_dtype, void* stream) {
  if (B <= 0 || nh <= 0 || hd <= 0 || ds <= 0 || ds > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nh, B);
  const size_t smem = 2 * (size_t)ds * sizeof(float);
  const auto* upd = static_cast<const uint8_t*>(update);
  if (dtype == 0) {
    ssd_decode_kernel<float><<<grid, NT, smem, st>>>(
        static_cast<const float*>(state), static_cast<const float*>(x),
        static_cast<const float*>(dt), a_log, alog_dtype,
        static_cast<const float*>(b), static_cast<const float*>(c), upd,
        static_cast<float*>(new_state), static_cast<float*>(y), nh, hd, ds,
        sxb, sbb, scb);
  } else if (dtype == 1) {
    ssd_decode_kernel<bf16><<<grid, NT, smem, st>>>(
        static_cast<const float*>(state), static_cast<const bf16*>(x),
        static_cast<const float*>(dt), a_log, alog_dtype,
        static_cast<const bf16*>(b), static_cast<const bf16*>(c), upd,
        static_cast<float*>(new_state), static_cast<bf16*>(y), nh, hd, ds,
        sxb, sbb, scb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype (of b, c): 0 = float32, 1 = bfloat16; hd in {32, 64}; ds in {16,
// 32, 64, 128}; nh % 4 == 0; chunk L <= 256 divides S. xdt [B,S,nh,hd] and la
// [B,S,nh] contiguous float32; b, c at (batch, row) strides with ds
// entries contiguous; outputs y [B,S,nh,hd], s_local [B,nc,nh,hd,ds], cdec
// [B,nc,nh] contiguous float32.
extern "C" int ssd_intra_chunk(const void* xdt, const void* la, const void* b,
                               const void* c, void* y, void* s_local,
                               void* cdec, int B, int S, int nh, int hd,
                               int ds, int chunk, long long sb_b,
                               long long sb_s, long long sc_b, long long sc_s,
                               int dtype, void* stream) {
  if (B <= 0 || chunk <= 0 || chunk > MAX_L || S % chunk != 0 || S <= 0 ||
      nh % HB != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INTRA_LAUNCH(T, HD, DS)                                              \
  if (hd == HD && ds == DS)                                                  \
  return (int)launch_intra<T, HD, DS>(xdt, la, b, c, y, s_local, cdec, B, S, \
                                      nh, chunk, sb_b, sb_s, sc_b, sc_s, st)
#define INTRA_DS(T, HD)   \
  INTRA_LAUNCH(T, HD, 16); \
  INTRA_LAUNCH(T, HD, 32); \
  INTRA_LAUNCH(T, HD, 64); \
  INTRA_LAUNCH(T, HD, 128)
  if (dtype == 0) {
    INTRA_DS(float, 32);
    INTRA_DS(float, 64);
  } else if (dtype == 1) {
    INTRA_DS(bf16, 32);
    INTRA_DS(bf16, 64);
  }
#undef INTRA_DS
#undef INTRA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
