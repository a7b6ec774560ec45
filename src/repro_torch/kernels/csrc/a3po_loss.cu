// Fused A-3PO decoupled loss, forward and analytic backward, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/a3po_loss/kernel.py, a3po_loss_pallas (the
//   Pallas TPU kernel), and the analytic custom_vjp backward of
//   src/repro/kernels/a3po_loss/ops.py (_a3po_objective_bwd).
//   Forward: logp, behav, alpha, adv, mask float32 [T] ->
//     loss_tok, clip_tok, iw, ratio float32 [T], with
//     prox = alpha*behav + (1-alpha)*logp, iw = min(exp(prox-behav), cap),
//     ratio = exp(logp-prox), obj = min(ratio*adv, clip(ratio)*adv),
//     loss_tok = -iw*obj*mask, clip_tok = (ratio*adv > clip(ratio)*adv)*mask.
//   Backward: g, clip_tok, iw, ratio, adv, mask float32 [T] ->
//     g_logp = g * (-(iw*ratio*adv) * mask * (1 - [clip_tok > 0])).
//
// What bounds it: bytes, and below that the launch. The forward moves
//   9 x 4 B per token (5 read, 4 written), the backward 7 x 4 B; at the
//   training step's T = 2300 that is about 0.02 us at 3.35 TB/s, far under
//   the few microseconds a launch costs.
//
// What the design does about it: nothing beyond one pass. One thread per
//   token, float32 throughout, every product and sum rounded on its own
//   (__fmul_rn / __fadd_rn, no contraction into FMA) and expf without fast
//   math, so each value is rounded as PyTorch's elementwise ops round it
//   and the kernel agrees with its plain version bit for bit. Not tuned:
//   at this size only fewer launches would help (fusing into a neighbour).
#include <cuda_runtime.h>
#include <math.h>

namespace {

// NaN-propagating min / clamp, as torch.minimum and torch.clamp
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__global__ void a3po_forward_kernel(const float* __restrict__ logp,
                                    const float* __restrict__ behav,
                                    const float* __restrict__ alpha,
                                    const float* __restrict__ adv,
                                    const float* __restrict__ mask,
                                    float* __restrict__ loss,
                                    float* __restrict__ clip,
                                    float* __restrict__ iw_out,
                                    float* __restrict__ ratio_out, int T,
                                    float clip_lo, float clip_hi,
                                    float iw_cap) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  float l = logp[i], b = behav[i], a = alpha[i], g = adv[i], m = mask[i];
  float prox = __fadd_rn(__fmul_rn(a, b), __fmul_rn(__fsub_rn(1.0f, a), l));
  float iw = expf(__fsub_rn(prox, b));
  iw = isnan(iw) ? iw : fminf(iw, iw_cap);
  float ratio = expf(__fsub_rn(l, prox));
  float unclipped = __fmul_rn(ratio, g);
  float clipped = __fmul_rn(nan_clamp(ratio, clip_lo, clip_hi), g);
  float obj = nan_min(unclipped, clipped);
  loss[i] = __fmul_rn(__fmul_rn(-iw, obj), m);
  clip[i] = __fmul_rn(unclipped > clipped ? 1.0f : 0.0f, m);
  iw_out[i] = iw;
  ratio_out[i] = ratio;
}

__global__ void a3po_backward_kernel(const float* __restrict__ g_loss,
                                     const float* __restrict__ clip,
                                     const float* __restrict__ iw,
                                     const float* __restrict__ ratio,
                                     const float* __restrict__ adv,
                                     const float* __restrict__ mask,
                                     float* __restrict__ g_logp, int T) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  float live = __fsub_rn(1.0f, clip[i] > 0.0f ? 1.0f : 0.0f);
  float t = __fmul_rn(__fmul_rn(iw[i], ratio[i]), adv[i]);
  t = __fmul_rn(__fmul_rn(-t, mask[i]), live);
  g_logp[i] = __fmul_rn(g_loss[i], t);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int a3po_loss_forward(const void* logp, const void* behav,
                                 const void* alpha, const void* adv,
                                 const void* mask, void* loss, void* clip,
                                 void* iw, void* ratio, int T, float clip_lo,
                                 float clip_hi, float iw_cap, void* stream) {
  if (T <= 0) return 0;
  int blocks = (T + kThreads - 1) / kThreads;
  a3po_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)logp, (const float*)behav, (const float*)alpha,
      (const float*)adv, (const float*)mask, (float*)loss, (float*)clip,
      (float*)iw, (float*)ratio, T, clip_lo, clip_hi, iw_cap);
  return (int)cudaGetLastError();
}

extern "C" int a3po_loss_backward(const void* g_loss, const void* clip,
                                  const void* iw, const void* ratio,
                                  const void* adv, const void* mask,
                                  void* g_logp, int T, void* stream) {
  if (T <= 0) return 0;
  int blocks = (T + kThreads - 1) / kThreads;
  a3po_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g_loss, (const float*)clip, (const float*)iw,
      (const float*)ratio, (const float*)adv, (const float*)mask,
      (float*)g_logp, T);
  return (int)cudaGetLastError();
}
