// Pieces shared by the attention kernels of csrc/ (flash_tile.cuh, the FMA
// body of K1, K2 and K4, and paged_attention.cu, K3): their tile sizes and
// thread layout, 4-wide loads and stores of f32 or bf16 operands as float4,
// the (batch, head, seq) strides they address q/k/v/o with (mma_tile.cuh
// too), and the float4 arithmetic of their online softmax.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace arkflow {

// the mask value of the online softmax: the TPU kernels' _NEG
constexpr float kNeg = -1e30f;
constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 32;  // keys per shared-memory tile

template <int D>
struct Layout {
  // threads cooperating on one query row; each owns NV float4 chunks of the
  // head dim, interleaved so the row's threads read neighbouring addresses
  static constexpr int kThreadsPerRow = D >= 32 ? D / 16 : 1;
  static constexpr int kChunks = D / (4 * kThreadsPerRow);
  static constexpr int kThreads = kBlockQ * kThreadsPerRow;
  static constexpr int kD4 = D / 4;
};

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 scale4(float4 a, float c) {
  return make_float4(a.x * c, a.y * c, a.z * c, a.w * c);
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 acc) {
  return make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y),
                     fmaf(p, v.z, acc.z), fmaf(p, v.w, acc.w));
}

}  // namespace arkflow
