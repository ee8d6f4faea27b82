// Segment flash attention for Hopper (sm_90a): block-diagonal attention over
// token-packed rows.
//
// Replaces: arkflow_tpu/ops/segment_attention.py, segment_flash_attention
// (Pallas kernel _segment_kernel + flash_softmax_loop). Same function: for
// row b, query i sees key j iff seg[b, i] == seg[b, j] and seg[b, i] > 0; the
// rows of dead queries (seg == 0) are written as 0. Not causal. Online
// softmax in f32 with the TPU kernel's constants: scale 1/sqrt(D) on the dot
// product, mask value -1e30, the normaliser l floored at 1e-30.
//
// What bounds it on the H100: at the packed serving shapes (B <= 64 rows,
// H = 12, S = 256, D = 64, bf16) one call reads the live q, k and v rows
// once (~25 MB at B = 64) and writes o once; the work is 4 * len^2 * D
// flops per (segment, head), and packed segments are short (tens to a few
// hundred tokens), so it sits far below the 295 flop/byte ridge: device
// memory bandwidth is the bound, then the latency of many small blocks.
//
// What the design does about it:
// - K and V are staged through shared memory 32 keys at a time (as f32) and
//   shared by the block's 64 queries, so each block reads a key row once; m,
//   l and o stay in registers. Loads are 16-byte vectors on neighbouring
//   addresses.
// - Tile skipping that holds for ANY segment_ids: each block reduces its
//   query tile's live ids to a range [lo, hi]; a key tile is loaded only if
//   the range of its live ids meets [lo, hi]. A key that matches some live
//   query has an id inside both ranges, so no needed tile is ever skipped.
//   pack_tokens numbers segments in the examples' original order, not in
//   position order, so a test that assumed sorted ids would be wrong there;
//   with contiguous segments the ranges are still tight and most key tiles
//   of a 256-wide row are skipped.
// - A query tile with no live query (bucket-padding rows, the dead tail of
//   a row) writes zeros and returns without reading q, k or v.
// - No layout copies: q, k, v and o are addressed through (batch, head, seq)
//   strides, so the [B, S, H, D] projections of the model are read in place.
// - The TPU kernel holds a row's whole K/V in VMEM and computes every tile
//   in grid order; here blocks run in parallel with no carried state and
//   each block loads its own segment ids.
// Tensor cores (mma/wgmma) and TMA are not used yet: the math is f32 FMAs.
//
// C interface (bound with ctypes): arkflow_segment_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>

#include "attention_common.cuh"

namespace {

using arkflow::dot4;
using arkflow::fma4;
using arkflow::kBlockK;
using arkflow::kBlockQ;
using arkflow::kNeg;
using arkflow::Layout;
using arkflow::scale4;
using arkflow::Strides;
using arkflow::Vec4;

static_assert(kBlockK == 32, "one warp reduces a key tile's segment ids");

template <typename T, int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
segment_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         const int* __restrict__ seg, int S, float scale,
                         Strides qs, Strides ks, Strides vs, Strides os) {
  using L = Layout<D>;
  constexpr int TPR = L::kThreadsPerRow;
  constexpr int NV = L::kChunks;
  constexpr int D4 = L::kD4;
  __shared__ float4 k_tile[kBlockK][D4];
  __shared__ float4 v_tile[kBlockK][D4];
  __shared__ int k_seg[kBlockK];
  __shared__ int q_lo, q_hi, tile_live;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const int* seg_row = seg + (long long)b * S;
  const int my_seg = qi < S ? seg_row[qi] : 0;

  // the live id range of this query tile
  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = 0;
  }
  __syncthreads();
  if (part == 0 && my_seg > 0) {
    atomicMin(&q_lo, my_seg);
    atomicMax(&q_hi, my_seg);
  }
  __syncthreads();
  const int lo = q_lo;
  const int hi = q_hi;

  T* orow = o + b * os.b + h * os.h + (long long)qi * os.s;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (hi == 0) {  // no live query in the tile
    if (qi < S) {
#pragma unroll
      for (int i = 0; i < NV; ++i) Vec4<T>::store(orow + (part + i * TPR) * 4, zero);
    }
    return;
  }

  float4 qv[NV];
  float4 acc[NV];
  const T* qrow = q + b * qs.b + h * qs.h + (long long)qi * qs.s;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qv[i] = qi < S ? Vec4<T>::load(qrow + (part + i * TPR) * 4) : zero;
    acc[i] = zero;
  }
  float m = kNeg;
  float l = 0.f;
  const bool q_live = my_seg > 0;

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile (K, V, ids, flag) is consumed
    if (threadIdx.x < kBlockK) {  // warp 0: the key tile's ids and range
      const int j = k0 + threadIdx.x;
      const int id = j < S ? seg_row[j] : 0;
      k_seg[threadIdx.x] = id;
      const int k_lo = __reduce_min_sync(0xffffffffu, id > 0 ? id : INT_MAX);
      const int k_hi = __reduce_max_sync(0xffffffffu, id);
      if (threadIdx.x == 0) tile_live = k_hi > 0 && k_lo <= hi && k_hi >= lo;
    }
    __syncthreads();
    if (!tile_live) continue;  // block-uniform: no key here meets a live query
    for (int idx = threadIdx.x; idx < kBlockK * D4; idx += L::kThreads) {
      const int jj = idx / D4;
      const int c = idx % D4;
      const int j = k0 + jj;
      float4 kx = zero, vx = zero;
      if (j < S) {  // the ragged edge of the last tile is masked by hand
        kx = Vec4<T>::load(kbase + (long long)j * ks.s + c * 4);
        vx = Vec4<T>::load(vbase + (long long)j * vs.s + c * 4);
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
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool ok = q_live && k_seg[jj] == my_seg;  // dead keys have id 0
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

  if (qi < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float4 out = zero;
      if (q_live)  // dead queries emit zeros: a fully masked softmax is uniform
        out = make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                          acc[i].w / denom);
      Vec4<T>::store(orow + (part + i * TPR) * 4, out);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* seg, int B, int H, int S, float scale,
                   const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  segment_attention_kernel<T, D><<<grid, Layout<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seg, S, scale, qs, ks, vs,
      os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(int D, const void* q, const void* k, const void* v,
                           void* o, const int* seg, int B, int H, int S,
                           float scale, const long long* st,
                           cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, seg, B, H, S, scale, st, stream);
    case 16: return launch<T, 16>(q, k, v, o, seg, B, H, S, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, seg, B, H, S, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, seg, B, H, S, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, seg, B, H, S, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_for_dim<__nv_bfloat16>(D, q, k, v, o, seg, B, H, S, scale,
                                         strides, s);
  return launch_for_dim<float>(D, q, k, v, o, seg, B, H, S, scale, strides, s);
}
