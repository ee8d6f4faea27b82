// Ragged flash attention for Hopper (sm_90a): per-row sequence lengths, no
// work on padding.
//
// Replaces: arkflow_tpu/ops/ragged_attention.py, ragged_flash_attention
// (Pallas kernel _ragged_kernel + flash_softmax_loop). Same function: for row
// b, key j is visible to query i iff j < lengths[b] (and j <= i when causal);
// query rows i >= lengths[b] are written as 0. Online softmax in f32 with the
// same constants as the TPU kernel: scale 1/sqrt(D) applied to the dot
// product, mask value -1e30, the normaliser l floored at 1e-30.
//
// What bounds it on the H100: at the serving shapes (D = 64, S <= 512, bf16)
// one call moves q, k, v and o once (~25 MB each at B=64, H=12, S=256) and
// does 4 * len^2 * D flops per (row, head) -- far below the 295 flop/byte
// ridge, so device memory bandwidth is the bound, then latency of the many
// small blocks.
//
// What the design does about it:
// - Every input byte is read from device memory once per query tile: K and V
//   tiles are staged through shared memory (as f32, 32 keys at a time) and
//   shared by the block's 64 queries. Loads are 16-byte vectors on
//   neighbouring addresses.
// - Ragged skipping: the K/V loop of a block stops at the row's length (and
//   at the tile's causal bound), so padded keys are never loaded; a block
//   whose whole query tile lies past the length writes zeros and returns
//   without reading anything. Bucket-padding rows (length 0) cost one store.
// - No layout copies: q, k, v and o are addressed through (batch, head, seq)
//   strides, so the [B, S, H, D] projections of the model are read in place.
// - The TPU kernel keeps the whole row's K/V in VMEM and runs its grid in
//   order; here blocks run in parallel with no carried state, each block
//   reads its row's length itself (the TPU kernel scalar-prefetches it).
// Tensor cores (mma/wgmma) and TMA are not used yet: the math is f32 FMAs.
//
// The kernel itself is flash_tile.cuh's, instantiated with kRagged = true;
// K4 (flash_attention.cu) instantiates it without the lengths.
//
// C interface (bound with ctypes): arkflow_ragged_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "flash_tile.cuh"

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// lengths: [B] int32 on the device. is_bf16: 1 for bfloat16, 0 for float32.
extern "C" int arkflow_ragged_attention(const void* q, const void* k,
                                        const void* v, void* o,
                                        const int* lengths, int B, int H,
                                        int S, int D, int is_bf16, int causal,
                                        float scale, const long long* strides,
                                        void* stream) {
  return arkflow::launch_flash_tile_any<true>(q, k, v, o, lengths, B, H, S, D,
                                              is_bf16, causal, scale, strides,
                                              stream);
}
