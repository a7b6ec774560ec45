// Chunked, segment-packed paged prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prefill_attn/kernel.py,
//   paged_prefill_attention_pallas (the Pallas TPU kernel).
//   q [C,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb] int32
//   (-1 = unmapped); seg_ids [C] int32 slot per row (-1 = padding);
//   q_pos [C] int32 absolute positions -> out [C,H,hd]. Row i attends its
//   own slot's keys at positions <= q_pos[i]; padding rows write zeros.
//
// What bounds it: bytes at serving chunk sizes. The chunk's rows of one
//   slot share that slot's K/V, so the unique traffic is each resident K/V
//   byte once plus q and out; the flops (4 * rows * keys * hd per head)
//   stay below the bf16 balance point for chunks of a few hundred rows.
//
// What the design does about it: one thread block per (tile of consecutive
//   chunk rows, KV head). A tile holds rows_per_block = 32 / G rows, so
//   its rows x the G query heads of the KV head share every page it reads.
//   The block walks each distinct segment of its tile once (packed chunks
//   are contiguous runs of one slot, so usually one), and only up to the
//   tile's largest q_pos. Each row still masks by its own q_pos. kv_lens
//   is not needed: q_pos bounds the walk. Not yet done (later work): larger
//   row tiles with wgmma for the products, TMA page loads, skipping pages
//   above a row's own position inside a tile.
#include "paged_attn_common.cuh"

extern "C" int paged_prefill_attention(const void* q, const void* pool_k,
                                       const void* pool_v, const void* tables,
                                       const void* seg_ids, const void* q_pos,
                                       void* out, int C, int H, int KV,
                                       int hd, int bs, int mb,
                                       int rows_per_block, int dtype,
                                       void* stream) {
  return paged::dispatch<false>(q, pool_k, pool_v, tables, seg_ids, q_pos,
                                out, C, H, KV, hd, bs, mb, rows_per_block,
                                dtype, stream);
}
