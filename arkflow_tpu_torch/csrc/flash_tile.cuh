// The FMA flash tile: the f32 body of K1, K2 and K4, and their bf16 body at
// D = 8 (the tensor-core tile of mma_tile.cuh takes bf16 at D >= 16).
// [B, H, S, D] q/k/v/o addressed through (batch, head, seq) strides, one
// block per (64-query tile, head, batch row), K and V staged through shared
// memory 32 keys at a time as f32, the online softmax in registers with the
// TPU kernels' constants (scale 1/sqrt(D) applied to the dot product, mask
// value -1e30, the normaliser floored at 1e-30), f32 FMAs throughout: the
// f32 contract (1e-4 against the plain version, TF32 off) rules out bf16
// tensor cores.
//
// kMask selects what bounds a row at compile time (the same three policies
// as mma_tile.cuh):
// - kMaskRagged (K1): row b holds lengths[b] live tokens; keys past it are
//   never loaded, query rows past it are written as 0, and a block whose
//   whole query tile lies past it writes zeros and returns without reading.
// - kMaskDense (K4): every row holds S tokens; `aux` is never read.
// - kMaskSegment (K2): query i sees key j iff seg[b, i] == seg[b, j] > 0
//   (aux = seg, [B, S] int32); dead queries (id 0) are written as 0. The
//   block reduces its query tile's live ids to a range [lo, hi] and loads a
//   key tile only if the range of its live ids meets [lo, hi]: a key that
//   matches some live query has an id inside both ranges, so no needed tile
//   is skipped for ANY segment_ids. pack_tokens numbers segments in the
//   examples' original order, not in position order, so nothing may assume
//   sorted ids. A query tile with no live query writes zeros and returns.
// With `causal` (K1 and K4), key j is visible to query i only if j <= i, and
// a block's K/V loop stops at its query tile's last position.

#pragma once

#include <climits>

#include "attention_common.cuh"

namespace arkflow {

constexpr int kMaskDense = 0;
constexpr int kMaskRagged = 1;
constexpr int kMaskSegment = 2;

static_assert(kBlockK == 32, "one warp reduces a key tile's segment ids");

template <typename T, int D, int kMask>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ aux, int S, int causal, float scale,
                  Strides qs, Strides ks, Strides vs, Strides os) {
  using L = Layout<D>;
  constexpr int TPR = L::kThreadsPerRow;
  constexpr int NV = L::kChunks;
  constexpr int D4 = L::kD4;
  constexpr bool kSegment = kMask == kMaskSegment;
  __shared__ float4 k_tile[kBlockK][D4];
  __shared__ float4 v_tile[kBlockK][D4];
  __shared__ int k_seg[kSegment ? kBlockK : 1];
  __shared__ int q_lo, q_hi, tile_live;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + row;
  int len = S;
  if constexpr (kMask == kMaskRagged) {
    len = aux[b];
    len = len < 0 ? 0 : (len > S ? S : len);
  }
  const int* seg_row = kSegment ? aux + (long long)b * S : aux;  // kMaskSegment only
  int my_seg = 0, lo = 0, hi = 0;
  if constexpr (kSegment) {  // the live id range of this query tile
    my_seg = qi < S ? seg_row[qi] : 0;
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
    lo = q_lo;
    hi = q_hi;
  }

  T* orow = o + b * os.b + h * os.h + (long long)qi * os.s;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool tile_dead = kMask == kMaskRagged ? q0 >= len : (kSegment && hi == 0);
  if (tile_dead) {  // the whole query tile is padding or dead
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
  const bool q_valid = kSegment ? my_seg > 0 : qi < len;

  int kv_end = len;  // keys past the row's length are never loaded
  if (causal && q0 + kBlockQ < kv_end) kv_end = q0 + kBlockQ;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile (K, V, ids, flag) is consumed
    if constexpr (kSegment) {
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
    }
    for (int idx = threadIdx.x; idx < kBlockK * D4; idx += L::kThreads) {
      const int jj = idx / D4;
      const int c = idx % D4;
      const int j = k0 + jj;
      float4 kx = zero, vx = zero;
      if (j < kv_end) {  // the ragged edge of the last tile is masked by hand
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
      const int j = k0 + jj;
      bool ok;
      if constexpr (kSegment)
        ok = q_valid && k_seg[jj] == my_seg;  // dead keys have id 0
      else
        ok = q_valid && j < len && (!causal || j <= qi);
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
      if (q_valid)  // pad and dead queries emit zeros: a fully masked softmax is uniform
        out = make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                          acc[i].w / denom);
      Vec4<T>::store(orow + (part + i * TPR) * 4, out);
    }
  }
}

template <typename T, int D, int kMask>
cudaError_t launch_flash_tile(const void* q, const void* k, const void* v, void* o,
                              const int* aux, int B, int H, int S, int causal,
                              float scale, const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_tile_kernel<T, D, kMask><<<grid, Layout<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), aux, S, causal, scale, qs,
      ks, vs, os);
  return cudaGetLastError();
}

// The FMA body's instantiations: f32 at every head dim, bf16 at D = 8 only
// (bf16 at D >= 16 runs on the tensor-core tile).
template <int kMask>
cudaError_t launch_flash_tile_any(const void* q, const void* k, const void* v,
                                  void* o, const int* aux, int B, int H, int S,
                                  int D, int is_bf16, int causal, float scale,
                                  const long long* st, cudaStream_t stream) {
  if (is_bf16)
    return D == 8 ? launch_flash_tile<__nv_bfloat16, 8, kMask>(
                        q, k, v, o, aux, B, H, S, causal, scale, st, stream)
                  : cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch_flash_tile<float, 8, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 16: return launch_flash_tile<float, 16, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 32: return launch_flash_tile<float, 32, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 64: return launch_flash_tile<float, 64, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 128: return launch_flash_tile<float, 128, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace arkflow
