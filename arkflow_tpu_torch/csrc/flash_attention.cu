// Dense flash attention for Hopper (sm_90a): K4, no lengths, optional causal
// mask.
//
// Replaces: arkflow_tpu/ops/flash_attention.py, flash_attention (Pallas
// kernel _flash_kernel). Same function: q/k/v [B, H, S, D], every key visible
// to every query (only j <= i when causal), online softmax in f32 with the
// TPU kernel's constants (scale 1/sqrt(D) applied to the dot product, mask
// value -1e30, the normaliser floored at 1e-30), the output in q's dtype.
// The TPU kernel's tile sizes (128 by default) are its wrapper's contract
// (S must divide by them) and not this kernel's tiling: here a block holds
// 64 queries and stages 32 keys at a time.
//
// What bounds it on the H100: one call reads q, k and v once and writes o
// once, and does 4 * S^2 * D flops per (row, head), about half that when
// causal. At BERT-base's padded step ([64, 12, 256, 64] bf16) and a
// Llama-3-8B prefill of 512 ([16, 32, 512, 128]) the bytes bound it (30 and
// 80 us at 3.35 TB/s); at a 4096-token causal prefill the operations do
// (139 us at 989 TFLOP/s bf16 on the tensor cores).
//
// What the design does about it:
// - Every input byte is read from device memory once per query tile: K and V
//   tiles are staged through shared memory (as f32) and shared by the
//   block's 64 queries, with 16-byte loads on neighbouring addresses.
// - Causal blocks stop their K/V loop at the query tile's last position, as
//   the TPU kernel's n_k_eff does, so about half the tiles are never loaded.
// - No layout copies: q, k, v and o are addressed through (batch, head, seq)
//   strides, so [B, S, H, D] tensors viewed as [B, H, S, D] are read in place.
// - The kernel is K1's (flash_tile.cuh) with the ragged bound compiled out
//   (kRagged = false): it reads no lengths.
// The math is f32 FMAs, not the tensor cores: at the operations-bound shapes
// that puts it far from the bf16 bound (67 TFLOP/s of f32 at best). mma/wgmma
// with TMA-fed tiles is the redesign's work.
//
// C interface (bound with ctypes): arkflow_flash_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "flash_tile.cuh"

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// is_bf16: 1 for bfloat16, 0 for float32.
extern "C" int arkflow_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int S, int D, int is_bf16, int causal,
                                       float scale, const long long* strides,
                                       void* stream) {
  return arkflow::launch_flash_tile_any<false>(q, k, v, o, nullptr, B, H, S,
                                               D, is_bf16, causal, scale,
                                               strides, stream);
}
