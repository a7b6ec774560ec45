// Adam(W) with the global-norm clip for Hopper (sm_90a): the clip's norm
// over every gradient in one read, and the update of every leaf in one pass.
//
// Replaces: no Pallas kernel. The JAX package's optimizer
//   (src/repro/training/optimizer.py, adam_update and global_norm) is plain
//   jnp that XLA fuses into the jitted step. Eager PyTorch ran it as a cast,
//   a square and a sum a leaf for the norm and ~20 float32 passes a leaf for
//   the update (training/optimizer.py, _leaf), each a trip through device
//   memory; these kernels keep the intermediates in registers.
//
// Norm (adam_global_norm): sqrt(sum over leaves of sum g^2), g bf16 or
//   float32 (a flag a leaf), squared and summed in float32 (without the
//   root, the sum of squares: a shard's part of a sharded norm). Two
//   launches:
//   `blocks` blocks walk the leaves' chunks (block b takes chunks b,
//   b + blocks, ...) and each writes one partial; one block sums the
//   partials in order and takes the root. The order of every sum depends
//   on the leaf sizes and `blocks` only, so a norm repeats bit for bit; no
//   float atomics.
//
// Update (adam_update), per element, in _leaf's order, each product, sum,
//   quotient and root rounded on its own (__f*_rn: no contraction into
//   FMA, IEEE division and sqrt), so it rounds as the eager sequence does:
//     scale = clamp(max_norm * (1 / (gnorm + tiny)), max=1)
//     c1 = 1 - powf(b1, t), c2 = 1 - powf(b2, t)     (t the new step count)
//     g = float(g) * scale
//     m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*(g*g)
//     step = (lr * (m / c1)) / (sqrt(v / c2) + eps)  [+ (lr*wd) * float(p)]
//     p' = round(float(p) - step) to p's dtype (bf16: nearest even)
//   p and p' share a dtype, g has its own (a float32 accumulated gradient
//   of bf16 weights). gnorm, t and the optional `apply` flag are read on
//   the device. Where
//   apply is false nothing of the state is written (p, m, v keep their
//   values); a separate output gets p's values. p' goes in place when
//   out == p.
//
// What bounds it: bytes. For bf16 weights the norm reads 2 B an element and
//   the update 12 B (p, g, m, v) and writes 10 B (p', m, v): 24 B, 37.1 GB
//   over Qwen2.5-1.5B's 1.544 B parameters, 11.1 ms at 3.35 TB/s. A few
//   dozen flops an element are far below the ridge.
//
// What the design does about it: one read of each operand and one write of
//   each result, 16-byte vector loads and stores (8 elements a thread a
//   step, two steps' loads issued before any arithmetic), one launch for
//   all leaves: their pointers and sizes travel in the kernel's parameter
//   block (a table of up to kMaxLeaves leaves by value; more leaves take
//   another launch), so nothing is uploaded and nothing waits for the host.
//   A leaf is cut into chunks of kChunk elements; a block of the update
//   takes one chunk, found by a binary search over the table's chunk
//   offsets. A leaf whose pointers are not 16-byte aligned runs the scalar
//   loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLeaves = 64;
constexpr int64_t kChunk = 1 << 16;  // elements a chunk (a multiple of kVec)
constexpr int kVec = 8;              // elements a thread takes a step
constexpr int kThreads = 256;        // the update's block
constexpr int kSteps = 2;            // vector steps loaded before arithmetic
constexpr int kNormThreads = 512;    // the norm's blocks
constexpr int kNormSteps = 4;

struct NormTable {
  const void* g[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int first[kMaxLeaves + 1];  // first chunk of each leaf; [n_leaves]: total
  unsigned char bf16[kMaxLeaves];
  int n_leaves;
};

struct UpdateTable {
  const void* p[kMaxLeaves];
  void* out[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  unsigned char bf16[kMaxLeaves];    // p and out
  unsigned char g_bf16[kMaxLeaves];  // g
  int n_leaves;
};

struct Hyper {
  float lr, b1, b1c, b2, b2c, eps, lr_wd, max_norm, tiny;  // b1c = 1 - b1
  int decay;                                               // wd != 0
};

// the leaf whose chunks hold chunk c: the last l with first[l] <= c
__device__ __forceinline__ int leaf_of(const int* first, int n_leaves,
                                       int c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int64_t chunk_len(int64_t n, int64_t start) {
  return n - start < kChunk ? n - start : kChunk;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements from / to a 16-byte aligned address
__device__ __forceinline__ void load8(const float* a, float (&x)[kVec]) {
  const float4 u = reinterpret_cast<const float4*>(a)[0];
  const float4 w = reinterpret_cast<const float4*>(a)[1];
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
}
__device__ __forceinline__ void load8(const bf16* a, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(a);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* a, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(a)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(a)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16* a, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(a) = u;
}

// ------------------------------------------------------------------ norm
// sum of g^2 over one chunk: each thread sums a step's kNormSteps vectors,
// then adds that to its chunk total (short float32 chains; the kernel adds
// the chunk totals in turn)
template <typename T>
__device__ __forceinline__ float sum_squares(const T* __restrict__ g,
                                             int64_t len) {
  float acc = 0.f;
  int64_t done = 0;
  if (aligned16(g)) {
    const int64_t nv = len / kVec;
    for (int64_t j0 = threadIdx.x; j0 < nv;
         j0 += (int64_t)kNormThreads * kNormSteps) {
      float x[kNormSteps][kVec];
#pragma unroll
      for (int s = 0; s < kNormSteps; ++s) {
        const int64_t j = j0 + (int64_t)s * kNormThreads;
        if (j < nv) load8(g + j * kVec, x[s]);
      }
      float step = 0.f;
#pragma unroll
      for (int s = 0; s < kNormSteps; ++s) {
        if (j0 + (int64_t)s * kNormThreads < nv) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) step = fmaf(x[s][k], x[s][k], step);
        }
      }
      acc += step;
    }
    done = nv * kVec;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kNormThreads) {
    const float x = to_f(g[i]);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

// the block's sum in a fixed order: a warp's xor tree, then warps in order
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float warp_sums[kNormThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  return total;  // thread 0's
}

__global__ void __launch_bounds__(kNormThreads)
    norm_partials_kernel(const __grid_constant__ NormTable tab,
                         float* __restrict__ partials) {
  float acc = 0.f;
  const int total = tab.first[tab.n_leaves];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int l = leaf_of(tab.first, tab.n_leaves, c);
    const int64_t start = (int64_t)(c - tab.first[l]) * kChunk;
    const int64_t len = chunk_len(tab.n[l], start);
    acc += tab.bf16[l]
               ? sum_squares(static_cast<const bf16*>(tab.g[l]) + start, len)
               : sum_squares(static_cast<const float*>(tab.g[l]) + start,
                             len);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kNormThreads)
    norm_finish_kernel(const float* __restrict__ partials, int n, int root,
                       float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kNormThreads) acc += partials[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) *out = root ? __fsqrt_rn(s) : s;
}

// ---------------------------------------------------------------- update
struct Coefs {
  float scale, c1, c2;
};

__device__ __forceinline__ Coefs coefs(const Hyper& h, float gnorm, int t) {
  const float r = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(gnorm, h.tiny)),
                            h.max_norm);
  const float tf = (float)t;
  return {isnan(r) ? r : fminf(r, 1.f), __fsub_rn(1.f, powf(h.b1, tf)),
          __fsub_rn(1.f, powf(h.b2, tf))};
}

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      const Hyper& h, const Coefs& k) {
  const float gs = __fmul_rn(g, k.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.b1c, gs));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.b2c, __fmul_rn(gs, gs)));
  const float num = __fmul_rn(h.lr, __fdiv_rn(m, k.c1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.c2)), h.eps);
  float step = __fdiv_rn(num, den);
  if (h.decay) step = __fadd_rn(step, __fmul_rn(h.lr_wd, p));
  p = __fsub_rn(p, step);
}

// one chunk of one leaf: len elements from the chunk's start
template <typename T, typename TG>
__device__ __forceinline__ void update_chunk(
    const T* p, T* out, const TG* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, int64_t len,
    const Hyper& h, const Coefs& k) {
  int64_t done = 0;
  if (aligned16(p) && aligned16(out) && aligned16(g) && aligned16(m) &&
      aligned16(v)) {
    const int64_t nv = len / kVec;
    for (int64_t j0 = threadIdx.x; j0 < nv;
         j0 += (int64_t)kThreads * kSteps) {
      float P[kSteps][kVec], G[kSteps][kVec], M[kSteps][kVec],
          V[kSteps][kVec];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int64_t j = j0 + (int64_t)s * kThreads;
        if (j < nv) {
          load8(p + j * kVec, P[s]);
          load8(g + j * kVec, G[s]);
          load8(m + j * kVec, M[s]);
          load8(v + j * kVec, V[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int64_t j = j0 + (int64_t)s * kThreads;
        if (j < nv) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            adam1(P[s][e], G[s][e], M[s][e], V[s][e], h, k);
          store8(m + j * kVec, M[s]);
          store8(v + j * kVec, V[s]);
          store8(out + j * kVec, P[s]);
        }
      }
    }
    done = nv * kVec;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    float pi = to_f(p[i]), mi = m[i], vi = v[i];
    adam1(pi, to_f(g[i]), mi, vi, h, k);
    m[i] = mi;
    v[i] = vi;
    out[i] = from_f<T>(pi);
  }
}

// the gate closed: a separate output takes the weights as they are
template <typename T>
__device__ __forceinline__ void copy_chunk(const T* p, T* out, int64_t len) {
  for (int64_t i = threadIdx.x; i < len; i += kThreads) out[i] = p[i];
}

// the chunk with the gradient's dtype
template <typename T>
__device__ __forceinline__ void update_leaf(const T* p, T* out,
                                            const UpdateTable& tab, int l,
                                            int64_t start, int64_t len,
                                            const Hyper& h, const Coefs& k) {
  if (tab.g_bf16[l])
    update_chunk(p, out, static_cast<const bf16*>(tab.g[l]) + start,
                 tab.m[l] + start, tab.v[l] + start, len, h, k);
  else
    update_chunk(p, out, static_cast<const float*>(tab.g[l]) + start,
                 tab.m[l] + start, tab.v[l] + start, len, h, k);
}

__global__ void __launch_bounds__(kThreads)
    update_kernel(const __grid_constant__ UpdateTable tab, const Hyper h,
                  const float* __restrict__ gnorm, const int* __restrict__ t,
                  const unsigned char* __restrict__ apply) {
  const int c = blockIdx.x;
  const int l = leaf_of(tab.first, tab.n_leaves, c);
  const int64_t start = (int64_t)(c - tab.first[l]) * kChunk;
  const int64_t len = chunk_len(tab.n[l], start);
  if (apply != nullptr && !*apply) {
    if (tab.out[l] == tab.p[l]) return;
    if (tab.bf16[l])
      copy_chunk(static_cast<const bf16*>(tab.p[l]) + start,
                 static_cast<bf16*>(tab.out[l]) + start, len);
    else
      copy_chunk(static_cast<const float*>(tab.p[l]) + start,
                 static_cast<float*>(tab.out[l]) + start, len);
    return;
  }
  const Coefs k = coefs(h, *gnorm, *t);
  if (tab.bf16[l])
    update_leaf(static_cast<const bf16*>(tab.p[l]) + start,
                static_cast<bf16*>(tab.out[l]) + start, tab, l, start, len,
                h, k);
  else
    update_leaf(static_cast<const float*>(tab.p[l]) + start,
                static_cast<float*>(tab.out[l]) + start, tab, l, start, len,
                h, k);
}

// chunk offsets of leaves [lo, hi) into first[]; false if they overflow int
bool chunk_offsets(const int64_t* n, int lo, int hi, int* first) {
  int64_t c = 0;
  for (int i = lo; i < hi; ++i) {
    first[i - lo] = (int)c;
    c += (n[i] + kChunk - 1) / kChunk;
    if (c > 0x7fffffff) return false;
  }
  first[hi - lo] = (int)c;
  return true;
}

}  // namespace

// Leaves a launch takes, and the norm's blocks a launch for an SM count:
// the wrapper sizes the partials buffer by them.
extern "C" int adam_max_leaves() { return kMaxLeaves; }
extern "C" int adam_norm_blocks(int n_sm) { return 2 * n_sm; }

// g[i]: n[i] elements, bf16 if is_bf16[i] else float32, 16-byte
// aligned for the vector loop; partials holds ceil(n_leaves / kMaxLeaves)
// * blocks floats; out one float: the norm, or with root 0 the sum of
// squares.
extern "C" int adam_global_norm(const void* const* g, const int64_t* n,
                                const int* is_bf16, int n_leaves, int blocks,
                                int root, void* partials, void* out,
                                void* stream) {
  if (n_leaves < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int launches = 0;
  for (int lo = 0; lo < n_leaves; lo += kMaxLeaves, ++launches) {
    const int hi = n_leaves - lo > kMaxLeaves ? lo + kMaxLeaves : n_leaves;
    NormTable tab;
    tab.n_leaves = hi - lo;
    if (!chunk_offsets(n, lo, hi, tab.first)) return (int)cudaErrorInvalidValue;
    for (int i = lo; i < hi; ++i) {
      tab.g[i - lo] = g[i];
      tab.n[i - lo] = n[i];
      tab.bf16[i - lo] = (unsigned char)(is_bf16[i] != 0);
    }
    norm_partials_kernel<<<blocks, kNormThreads, 0, st>>>(
        tab, (float*)partials + (int64_t)launches * blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  norm_finish_kernel<<<1, kNormThreads, 0, st>>>(
      (const float*)partials, launches * blocks, root, (float*)out);
  return (int)cudaGetLastError();
}

// One Adam step over n_leaves leaves (n[i] elements each; p and out of
// one dtype, bf16 if is_bf16[i] else float32; g bf16 if g_is_bf16[i] else
// float32; m, v float32; out[i] may be p[i]). gnorm: one float; t: one
// int32, the new step count; apply: one bool, or null for always.
extern "C" int adam_update(const void* const* p, void* const* out,
                           const void* const* g, void* const* m,
                           void* const* v, const int64_t* n,
                           const int* is_bf16, const int* g_is_bf16,
                           int n_leaves,
                           const void* gnorm, const void* t,
                           const void* apply, float lr, float b1, float b1c,
                           float b2, float b2c, float eps, float lr_wd,
                           int decay, float max_norm, float tiny,
                           void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, b1c, b2, b2c, eps, lr_wd, max_norm, tiny, decay};
  cudaStream_t st = (cudaStream_t)stream;
  for (int lo = 0; lo < n_leaves; lo += kMaxLeaves) {
    const int hi = n_leaves - lo > kMaxLeaves ? lo + kMaxLeaves : n_leaves;
    UpdateTable tab;
    tab.n_leaves = hi - lo;
    if (!chunk_offsets(n, lo, hi, tab.first)) return (int)cudaErrorInvalidValue;
    for (int i = lo; i < hi; ++i) {
      tab.p[i - lo] = p[i];
      tab.out[i - lo] = out[i];
      tab.g[i - lo] = g[i];
      tab.m[i - lo] = (float*)m[i];
      tab.v[i - lo] = (float*)v[i];
      tab.n[i - lo] = n[i];
      tab.bf16[i - lo] = (unsigned char)(is_bf16[i] != 0);
      tab.g_bf16[i - lo] = (unsigned char)(g_is_bf16[i] != 0);
    }
    if (tab.first[tab.n_leaves] == 0) continue;  // empty leaves only
    update_kernel<<<tab.first[tab.n_leaves], kThreads, 0, st>>>(
        tab, h, (const float*)gnorm, (const int*)t,
        (const unsigned char*)apply);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
