// Paged flash attention for Hopper (sm_90a): queries attend a KV context
// that lives in fixed-size pages of a shared pool, named by a page table.
//
// Replaces: arkflow_tpu/ops/ragged_attention.py, paged_flash_attention
// (Pallas kernel _paged_kernel). Same function: query i of row b sits at
// absolute position off[b] + i and attends keys 0 .. off[b] + i, where key j
// lives in page table[b][j / page] at slot j % page of the pool. The GQA group
// (H / kv_heads query heads sharing one KV head) is folded into the query
// tile: folded index f = (chunk position f / group, group member f % group),
// so K and V are read once per KV head and never repeated. Online softmax in
// f32 with the TPU kernel's constants: scale 1/sqrt(D), mask value -1e30, the
// normaliser floored at 1e-30.
//
// What bounds it on the H100: the live K/V pages (decode: every context key
// of every row and KV head, once; ~21 MB at 16 rows x 8 KV heads x 640 keys)
// against ~4*ctx*D flops per query -- far below the 295 flop/byte ridge, so
// device memory bandwidth is the bound (~6-13 us at the decode shapes).
//
// What the design does about it:
// - One block per (row, KV head, tile of up to BQ folded queries). The TPU
//   walks the pages as a sequential grid axis with accumulators in VMEM; here
//   a loop inside the block walks the context kBlockK keys at a time, staging
//   each tile of K and V through shared memory (as f32) for the block's
//   queries, with the accumulators in registers.
// - The block reads its row's offset and page ids itself (the TPU kernel
//   scalar-prefetches them). The loop stops at the tile's last admissible
//   key, min(off + last chunk position of the tile, P * page - 1): pages
//   past the bound are never read through the table (their entries may be
//   the scratch page 0 or stale), and the clamp to the table width P keeps
//   padded chunk queries (off + i past P * page) inside the table, as the TPU
//   grid never goes past P.
// - Inside the last tile the bound is per query: key j <= off + f / group.
// - Decode folds only `group` queries per (row, KV head), so a 16-query tile
//   (BQ = 16) is launched there and a 64-query tile for chunks.
// - q and out are addressed through (batch, position, head) strides: the
//   model's [B, C, H, D] projections are read in place and the output is
//   written straight into the [B, C, H, D] layout, with no reshape.
// Tensor cores (mma/wgmma) and TMA are not used yet: the math is f32 FMAs.
//
// C interface (bound with ctypes): arkflow_paged_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using arkflow::dot4;
using arkflow::fma4;
using arkflow::kBlockK;
using arkflow::kNeg;
using arkflow::Layout;
using arkflow::scale4;
using arkflow::Strides;
using arkflow::Vec4;

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(BQ * Layout<D>::kThreadsPerRow)
paged_attention_kernel(const T* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       T* __restrict__ o, const int* __restrict__ table,
                       const int* __restrict__ off, int C, int KVH, int group,
                       int P, int page, float scale, Strides qs, Strides os) {
  constexpr int TPR = Layout<D>::kThreadsPerRow;
  constexpr int NV = Layout<D>::kChunks;
  constexpr int D4 = Layout<D>::kD4;
  constexpr int NT = BQ * TPR;
  __shared__ float4 k_tile[kBlockK][D4];
  __shared__ float4 v_tile[kBlockK][D4];

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int f0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int nq = C * group;  // folded queries of this (row, KV head)
  const int f = f0 + row;
  const bool q_valid = f < nq;
  const int cpos = q_valid ? f / group : 0;
  const int h = g * group + (q_valid ? f % group : 0);
  int base_pos = off[b];
  base_pos = base_pos < 0 ? 0 : base_pos;
  const int qpos = base_pos + cpos;

  // the tile's last admissible key, clamped to the table's width
  const int f_last = (f0 + BQ < nq ? f0 + BQ : nq) - 1;
  const long long ctx = (long long)P * page;
  const long long tile_end = (long long)base_pos + f_last / group + 1;
  const int kv_end = (int)(tile_end < ctx ? tile_end : ctx);
  const int* row_table = table + (long long)b * P;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[NV];
  float4 acc[NV];
  const T* qrow = q + b * qs.b + (long long)cpos * qs.s + (long long)h * qs.h;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qv[i] = q_valid ? Vec4<T>::load(qrow + (part + i * TPR) * 4) : zero;
    acc[i] = zero;
  }
  float m = kNeg;
  float l = 0.f;

  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * D4; idx += NT) {
      const int jj = idx / D4;
      const int c = idx % D4;
      const int j = k0 + jj;
      float4 kx = zero, vx = zero;
      if (j < kv_end) {  // keys past the bound are never read
        const int pi = j / page;
        const long long cell =
            ((long long)row_table[pi] * page + (j - pi * page)) * KVH + g;
        kx = Vec4<__nv_bfloat16>::load(k_pages + cell * D + c * 4);
        vx = Vec4<__nv_bfloat16>::load(v_pages + cell * D + c * 4);
      }
      k_tile[jj][c] = kx;
      v_tile[jj][c] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNeg;
#pragma unroll
    for (int jj = 0; jj < kBlockK; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) dot += dot4(qv[i], k_tile[jj][part + i * TPR]);
#pragma unroll
      for (int sh = TPR / 2; sh > 0; sh >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, sh);
      const int j = k0 + jj;
      const bool ok = q_valid && j < kv_end && j <= qpos;
      s[jj] = ok ? dot * scale : kNeg;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = scale4(acc[i], corr);
#pragma unroll
    for (int jj = 0; jj < kBlockK; ++jj) {
      const float p = __expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = fma4(p, v_tile[jj][part + i * TPR], acc[i]);
    }
    m = m_new;
  }

  if (q_valid) {
    // key 0 is admissible for every query, so l > 0; the floor guards
    // underflow only, as in the TPU kernel
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + (long long)cpos * os.s + (long long)h * os.h;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      Vec4<T>::store(orow + (part + i * TPR) * 4,
                     make_float4(acc[i].x / denom, acc[i].y / denom,
                                 acc[i].z / denom, acc[i].w / denom));
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* o,
                   const int* table, const int* off, int B, int C, int KVH,
                   int group, int P, int page, float scale,
                   const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[2], st[1]}, os{st[3], st[5], st[4]};
  const dim3 grid((C * group + BQ - 1) / BQ, KVH, B);
  paged_attention_kernel<T, D, BQ>
      <<<grid, BQ * Layout<D>::kThreadsPerRow, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const __nv_bfloat16*>(kp),
          static_cast<const __nv_bfloat16*>(vp), static_cast<T*>(o), table,
          off, C, KVH, group, P, page, scale, qs, os);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_for_tile(const void* q, const void* kp, const void* vp,
                            void* o, const int* table, const int* off, int B,
                            int C, int KVH, int group, int P, int page,
                            float scale, const long long* st,
                            cudaStream_t stream) {
  if (C * group <= 16)
    return launch<T, D, 16>(q, kp, vp, o, table, off, B, C, KVH, group, P,
                            page, scale, st, stream);
  return launch<T, D, 64>(q, kp, vp, o, table, off, B, C, KVH, group, P, page,
                          scale, st, stream);
}

template <typename T>
cudaError_t launch_for_dim(int D, const void* q, const void* kp,
                           const void* vp, void* o, const int* table,
                           const int* off, int B, int C, int KVH, int group,
                           int P, int page, float scale, const long long* st,
                           cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_for_tile<T, 64>(q, kp, vp, o, table, off, B, C, KVH,
                                    group, P, page, scale, st, stream);
    case 128:
      return launch_for_tile<T, 128>(q, kp, vp, o, table, off, B, C, KVH,
                                     group, P, page, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, C, H, D] addressed through `strides` (6 element strides: batch,
// position, head for q, then for o; the head dim is contiguous). k_pages,
// v_pages: one layer's pool, [num_pages, page, KVH, D] contiguous bfloat16.
// table: [B, P] int32 page ids; off: [B] int32 absolute offsets; both on the
// device. is_bf16: 1 when q and o are bfloat16, 0 for float32.
extern "C" int arkflow_paged_attention(const void* q, const void* k_pages,
                                       const void* v_pages, void* o,
                                       const int* table, const int* off, int B,
                                       int C, int H, int KVH, int D, int P,
                                       int page, int is_bf16, float scale,
                                       const long long* strides, void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || P <= 0 || page <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  const int group = H / KVH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_for_dim<__nv_bfloat16>(D, q, k_pages, v_pages, o, table, off,
                                         B, C, KVH, group, P, page, scale,
                                         strides, s);
  return launch_for_dim<float>(D, q, k_pages, v_pages, o, table, off, B, C,
                               KVH, group, P, page, scale, strides, s);
}
