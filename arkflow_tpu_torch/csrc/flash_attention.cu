// Dense flash attention for Hopper (sm_90a): K4, no lengths, optional causal
// mask.
//
// Replaces: arkflow_tpu/ops/flash_attention.py:70, flash_attention
// (pallas_call :80; Pallas kernel _flash_kernel). Same function: q/k/v
// [B, H, S, D], every key visible to every query (only j <= i when causal),
// online softmax in f32 with the TPU kernel's constants (scale 1/sqrt(D)
// applied to the dot product, mask value -1e30, the normaliser floored at
// 1e-30), the output in q's dtype. The TPU kernel's tile sizes (128 by
// default) are its wrapper's contract (S must divide by them) and not this
// kernel's tiling: here a block holds 64 queries.
//
// What bounds it on the H100: one call reads q, k and v once and writes o
// once, and does 4 * S^2 * D flops per (row, head), about half that when
// causal. At BERT-base's padded step ([64, 12, 256, 64] bf16) and a
// Llama-3-8B prefill of 512 ([16, 32, 512, 128]) the bytes bound it (30 and
// 80 us at 3.35 TB/s); at a 4096-token causal prefill the operations do
// (139 us at 989 TFLOP/s bf16 on the tensor cores).
//
// What the design does about it: it is K1's tile (mma_tile.cuh) under the
// dense mask policy, which reads no lengths:
// - bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation),
//   with K and V staged as bf16 by cp.async into a two-stage ring; D = 128
//   takes dynamic shared memory;
// - causal blocks stop their K/V loop at the query tile's last position, as
//   the TPU kernel's n_k_eff does, and a warp skips the key tiles wholly
//   after its rows;
// - no layout copies: (batch, head, seq) strides read [B, S, H, D] tensors
//   viewed as [B, H, S, D] in place.
// f32 and D = 8 run flash_tile.cuh's FMA body. mma.sync is not the card's
// full rate: the operations-bound 4096-token prefill wants wgmma with
// TMA-fed tiles, which wait until a serving path launches this kernel
// (mma_tile.cuh says why).
//
// C interface (bound with ctypes): arkflow_flash_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "mma_tile.cuh"

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// is_bf16: 1 for bfloat16, 0 for float32. variant: the body to launch
// (kVariantMma or kVariantFma, attention_common.cuh).
extern "C" int arkflow_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int S, int D, int is_bf16, int variant,
                                       int causal, float scale,
                                       const long long* strides, void* stream) {
  return arkflow::launch_attention<arkflow::kMaskDense>(
      q, k, v, o, nullptr, B, H, S, D, is_bf16, variant, causal, scale,
      strides, stream);
}
