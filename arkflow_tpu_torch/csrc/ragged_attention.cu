// Ragged flash attention for Hopper (sm_90a): K1, per-row sequence lengths,
// no work on padding.
//
// Replaces: arkflow_tpu/ops/ragged_attention.py:95, ragged_flash_attention
// (pallas_call :118; Pallas kernel _ragged_kernel + flash_softmax_loop :27).
// Same function: for row b, key j is visible to query i iff j < lengths[b]
// (and j <= i when causal); query rows i >= lengths[b] are written as 0.
// Online softmax in f32 with the TPU kernel's constants: scale 1/sqrt(D)
// applied to the dot product, mask value -1e30, the normaliser floored at
// 1e-30.
//
// What bounds it on the H100: at the serving shapes (D = 64, S <= 512, bf16)
// one call reads the q, k and v rows inside the lengths once and writes o
// once (14.7 us at the padded BERT step's stream lengths, 3.35 TB/s), and
// does 4 * len^2 * D flops per (row, head): far below the 295 flop/byte
// ridge, so the bytes bound it, then the latency of many small blocks.
//
// What the design does about it (the tile is mma_tile.cuh's, under the
// ragged mask policy; its note has the details):
// - bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation, P
//   rounded to bf16 in registers), K and V staged as bf16 by cp.async into a
//   two-stage ring so the next tile loads while this one computes;
// - a block's K/V loop stops at its row's length (and at its tile's causal
//   bound), so padded keys are never loaded, and a block whose whole query
//   tile lies past the length writes zeros without reading; a warp whose
//   rows are all padding skips the math;
// - no layout copies: (batch, head, seq) strides read the model's
//   [B, S, H, D] projections in place;
// - the TPU kernel keeps a row's K/V in VMEM and runs its grid in order;
//   here blocks run in parallel with no carried state, and each reads its
//   row's length itself (the TPU kernel scalar-prefetches it).
// f32 and D = 8 run flash_tile.cuh's FMA body (the f32 contract rules out
// bf16 tensor cores; mma.sync needs D a multiple of 16). wgmma and TMA wait:
// the shapes are bound by bytes, not by mma.sync's rate (mma_tile.cuh).
//
// C interface (bound with ctypes): arkflow_ragged_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "mma_tile.cuh"

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// lengths: [B] int32 on the device. is_bf16: 1 for bfloat16, 0 for float32.
// variant: the body to launch (kVariantMma or kVariantFma, attention_common.cuh).
extern "C" int arkflow_ragged_attention(const void* q, const void* k,
                                        const void* v, void* o,
                                        const int* lengths, int B, int H,
                                        int S, int D, int is_bf16, int variant,
                                        int causal, float scale,
                                        const long long* strides, void* stream) {
  return arkflow::launch_attention<arkflow::kMaskRagged>(
      q, k, v, o, lengths, B, H, S, D, is_bf16, variant, causal, scale, strides,
      stream);
}
