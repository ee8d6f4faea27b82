// Segment flash attention for Hopper (sm_90a): K2, block-diagonal attention
// over token-packed rows.
//
// Replaces: arkflow_tpu/ops/segment_attention.py:52, segment_flash_attention
// (pallas_call :81; Pallas kernel _segment_kernel + flash_softmax_loop).
// Same function: for row b, query i sees key j iff seg[b, i] == seg[b, j]
// and seg[b, i] > 0; the rows of dead queries (seg == 0) are written as 0.
// Not causal. Online softmax in f32 with the TPU kernel's constants: scale
// 1/sqrt(D) on the dot product, mask value -1e30, the normaliser floored at
// 1e-30.
//
// What bounds it on the H100: at the packed serving shapes (B <= 64 rows,
// H = 12, S = 256, D = 64, bf16) one call reads the live q, k and v rows
// once and writes o once (15 us at the stream's 32-row window, 3.35 TB/s);
// the work is 4 * len^2 * D flops per (segment, head), and packed segments
// are short, so it sits far below the 295 flop/byte ridge: the bytes bound
// it, then the latency of many small blocks.
//
// What the design does about it: it is K1's tile (mma_tile.cuh) under the
// segment mask policy; this file holds no kernel of its own:
// - bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation),
//   with K, V and the key tile's ids staged by cp.async into a two-stage
//   ring;
// - tile skipping that holds for ANY segment_ids: a block reduces its query
//   tile's live ids to a range [lo, hi] and loads a key tile only if the
//   range of its live ids meets [lo, hi]; a warp also skips the math of a
//   tile whose range misses its own rows'. pack_tokens numbers segments in
//   the examples' original order, not in position order, so nothing may
//   assume sorted ids; with contiguous segments the ranges are still tight
//   and most key tiles of a 256-wide row are skipped;
// - a query tile with no live query (bucket-padding rows, the dead tail of a
//   row) writes zeros and returns without reading q, k or v;
// - no layout copies: (batch, head, seq) strides read the model's
//   [B, S, H, D] projections in place;
// - the TPU kernel holds a row's whole K/V in VMEM and computes every tile
//   in grid order; here blocks run in parallel with no carried state and
//   each block loads its own segment ids.
// f32 and D = 8 run flash_tile.cuh's FMA body under the same policy.
// wgmma and TMA wait: the shapes are bound by bytes (mma_tile.cuh).
//
// C interface (bound with ctypes): arkflow_segment_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "mma_tile.cuh"

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// seg: [B, S] int32 on the device, contiguous. is_bf16: 1 for bfloat16, 0 for
// float32.
extern "C" int arkflow_segment_attention(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int* seg, int B, int H, int S,
                                         int D, int is_bf16, float scale,
                                         const long long* strides,
                                         void* stream) {
  return arkflow::launch_attention<arkflow::kMaskSegment>(
      q, k, v, o, seg, B, H, S, D, is_bf16, 0, scale, strides, stream);
}
