// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn/paged_kernel.py,
//   paged_decode_attention_pallas (the Pallas TPU kernel).
//   q [S,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb] int32
//   (-1 = unmapped); lengths [S] int32 valid-token counts -> out [S,H,hd].
//
// What bounds it: bytes. Every decoded token reads each slot's resident K
//   and V once per layer (2 * len * KV * hd * elem bytes per slot) against
//   about 4 flops per element read, far below the card's ~295 flop/byte
//   balance point, so the floor is K/V bytes over HBM bandwidth.
//
// What the design does about it: one thread block per (slot, KV head)
//   serves all G = H/KV query heads of that KV head, so each K/V page is
//   read from device memory once per group rather than once per query head
//   (the TPU grid reads it once per head). The block loads its own row of
//   the block table and walks only the ceil(len/bs) pages the slot has
//   (the TPU kernel walks all mb pages and masks). Scores, softmax and the
//   accumulator stay in shared memory and registers in float32. Not yet
//   done (later work): split-KV across blocks for few long slots, cp.async
//   or TMA double buffering of pages, 16-byte vector loads.
#include "paged_attn_common.cuh"

extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v, const void* tables,
                                      const void* lengths, void* out, int S,
                                      int H, int KV, int hd, int bs, int mb,
                                      int dtype, void* stream) {
  return paged::dispatch<true>(q, pool_k, pool_v, tables, lengths, nullptr,
                               out, S, H, KV, hd, bs, mb, 1, dtype, stream);
}
