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
// C interface (bound with ctypes): arkflow_ragged_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

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

template <typename T, int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ lengths, int S, int causal,
                        float scale, Strides qs, Strides ks, Strides vs,
                        Strides os) {
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
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  T* orow = o + b * os.b + h * os.h + (long long)qi * os.s;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q0 >= len) {  // the whole query tile is padding
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int H, int S, int causal,
                   float scale, const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  ragged_attention_kernel<T, D><<<grid, Layout<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lengths, S, causal, scale,
      qs, ks, vs, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(int D, const void* q, const void* k, const void* v,
                           void* o, const int* lengths, int B, int H, int S,
                           int causal, float scale, const long long* st,
                           cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
    case 16: return launch<T, 16>(q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, lengths, B, H, S, causal, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, H, S, D] addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is contiguous).
// lengths: [B] int32 on the device. is_bf16: 1 for bfloat16, 0 for float32.
extern "C" int arkflow_ragged_attention(const void* q, const void* k,
                                        const void* v, void* o,
                                        const int* lengths, int B, int H,
                                        int S, int D, int is_bf16, int causal,
                                        float scale, const long long* strides,
                                        void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_for_dim<__nv_bfloat16>(D, q, k, v, o, lengths, B, H, S,
                                         causal, scale, strides, s);
  return launch_for_dim<float>(D, q, k, v, o, lengths, B, H, S, causal, scale,
                               strides, s);
}
