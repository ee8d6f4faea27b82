// The flash-attention tile kernel shared by K1 (ragged_attention.cu) and K4
// (flash_attention.cu): [B, H, S, D] q/k/v/o addressed through (batch, head,
// seq) strides, one block per (64-query tile, head, batch row), K and V
// staged through shared memory 32 keys at a time as f32, the online softmax
// in registers with the TPU kernels' constants (scale 1/sqrt(D) applied to
// the dot product, mask value -1e30, the normaliser floored at 1e-30).
//
// kRagged selects what bounds a row at compile time:
// - true (K1): row b holds lengths[b] live tokens; keys past it are never
//   loaded, query rows past it are written as 0, and a block whose whole
//   query tile lies past it writes zeros and returns without reading.
// - false (K4): every row holds S tokens; the lengths pointer is never read.
// With `causal`, key j is visible to query i only if j <= i, and a block's
// K/V loop stops at its query tile's last position.

#pragma once

#include "attention_common.cuh"

namespace arkflow {

template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ lengths, int S, int causal,
                  float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  using L = Layout<D>;
  constexpr int TPR = L::kThreadsPerRow;
  constexpr int NV = L::kChunks;
  constexpr int D4 = L::kD4;
  __shared__ float4 k_tile[kBlockK][D4];
  __shared__ float4 v_tile[kBlockK][D4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + row;
  int len = S;
  if constexpr (kRagged) {
    len = lengths[b];
    len = len < 0 ? 0 : (len > S ? S : len);
  }

  T* orow = o + b * os.b + h * os.h + (long long)qi * os.s;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kRagged && q0 >= len) {  // the whole query tile is padding
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
  const bool q_valid = qi < len;

  int kv_end = len;  // keys past the row's length are never loaded
  if (causal && q0 + kBlockQ < kv_end) kv_end = q0 + kBlockQ;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
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
      const bool ok = q_valid && j < len && (!causal || j <= qi);
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
      if (q_valid)  // pad queries emit zeros: a fully masked softmax is uniform
        out = make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                          acc[i].w / denom);
      Vec4<T>::store(orow + (part + i * TPR) * 4, out);
    }
  }
}

template <typename T, int D, bool kRagged>
cudaError_t launch_flash_tile(const void* q, const void* k, const void* v, void* o,
                              const int* lengths, int B, int H, int S, int causal,
                              float scale, const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_tile_kernel<T, D, kRagged><<<grid, Layout<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lengths, S, causal, scale,
      qs, ks, vs, os);
  return cudaGetLastError();
}

// q, k, v, o: [B, H, S, D] addressed through `st` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is
// contiguous). lengths: [B] int32 on the device when kRagged, else unused.
template <bool kRagged>
cudaError_t launch_flash_tile_any(const void* q, const void* k, const void* v,
                                  void* o, const int* lengths, int B, int H,
                                  int S, int D, int is_bf16, int causal,
                                  float scale, const long long* st,
                                  void* stream_ptr) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define ARKFLOW_FLASH_TILE_CASE(DIM)                                            \
  case DIM:                                                                     \
    return is_bf16 ? launch_flash_tile<__nv_bfloat16, DIM, kRagged>(           \
                         q, k, v, o, lengths, B, H, S, causal, scale, st, stream) \
                   : launch_flash_tile<float, DIM, kRagged>(                   \
                         q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
  switch (D) {
    ARKFLOW_FLASH_TILE_CASE(8)
    ARKFLOW_FLASH_TILE_CASE(16)
    ARKFLOW_FLASH_TILE_CASE(32)
    ARKFLOW_FLASH_TILE_CASE(64)
    ARKFLOW_FLASH_TILE_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef ARKFLOW_FLASH_TILE_CASE
}

}  // namespace arkflow
