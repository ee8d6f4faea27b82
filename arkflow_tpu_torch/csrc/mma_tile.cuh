// The tensor-core flash tile for Hopper (sm_90a): the bf16 body of K1, K2
// and K4, written once and instantiated with three mask policies.
//
// Replaces (with the FMA body of flash_tile.cuh for f32 and D = 8):
// - K1 arkflow_tpu/ops/ragged_attention.py:95 ragged_flash_attention
//   (pallas_call :118, loop flash_softmax_loop :27): kMaskRagged;
// - K2 arkflow_tpu/ops/segment_attention.py:52 segment_flash_attention
//   (pallas_call :81): kMaskSegment;
// - K4 arkflow_tpu/ops/flash_attention.py:70 flash_attention
//   (pallas_call :80): kMaskDense.
// The policies are flash_tile.cuh's, with the same skipping rules: ragged
// rows load no key past lengths[b] and a query tile wholly past it writes
// zeros without reading; causal blocks stop at the tile's last position;
// the segment policy loads a key tile only if its live-id range meets the
// query tile's (correct for any segment_ids: pack_tokens numbers segments in
// the examples' order, not in position order), and a query tile with no
// live query writes zeros. Pad and dead queries are written as 0.
//
// What bounds it on the H100: at every main-path shape the bytes. K1's
// padded BERT step ([64, 12, 256, 64] bf16, stream lengths) needs 14.7 us
// at 3.35 TB/s, K2's 32-row packed window 15 us; a block walks 1-8 key
// tiles, so its work is a few small products, latency more than rate. The
// FMA body (flash_tile.cuh) runs both products as f32 FMAs (67 TFLOP/s at
// best), stages K and V as f32 (twice the bf16 bytes in shared memory) and
// overlaps no copy with math.
//
// What this design does about it:
// - Both products on the tensor cores: mma.sync.m16n8k16 with bf16 operands
//   and f32 accumulation. A block holds 64 queries as 4 warps of 16 rows;
//   each warp loads its Q fragment once (ldmatrix) and keeps S = Q K^T, the
//   online softmax and O in registers. A row's scores sit in one quad of
//   threads, so its max and sum take two shuffles each.
// - P is rounded to bf16 in registers and reused as the A operand of
//   O += P V (the normaliser sums the rounded P, so O stays a convex
//   combination of V rows); V's B operand comes from ldmatrix.trans. The
//   TPU kernels' f32 dots run at the MXU's default precision, in bf16
//   passes, so this rounding is the TPU's own.
// - K and V tiles are staged as bf16 by 16-byte cp.async copies into a
//   two-stage ring: tile t+1 loads while tile t computes. Staged rows are
//   padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8 distinct
//   16-byte bank groups (no bank conflict).
// - Above 48 KB of shared memory (D = 128) the block takes dynamic shared
//   memory after cudaFuncSetAttribute.
// - A warp whose 16 rows are all padding, dead, or causally before a key
//   tile skips that tile's math (its rows see no key there).
// - The TPU kernel's constants: scale 1/sqrt(D) on the dot product, masked
//   scores -1e30, the normaliser floored at 1e-30, __expf.
// - q/k/v/o are addressed through the 12 (batch, head, seq) strides, so the
//   model's [B, S, H, D] projections are read in place (each row D * 2
//   contiguous bytes: 16-byte copies). The output is staged through the
//   warp's own Q rows and written as 16-byte stores.
//
// Why mma.sync and not wgmma/TMA yet: the main-path shapes are bound by
// bytes and a block walks at most a few key tiles, so mma.sync at a few
// hundred TFLOP/s is not the limit; wgmma needs shared-memory descriptors
// and swizzled layouts, TMA a cuTensorMapEncode map per strided view, and
// neither can be rehearsed without the card. They pay for K4's
// operations-bound long causal prefill, once a serving path launches it.

#pragma once

#include <map>
#include <mutex>

#include "flash_tile.cuh"

namespace arkflow {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBlockQ = 16 * kMmaWarps;  // queries per block
constexpr int kMmaStages = 2;               // the K/V ring
constexpr int kMmaPad = 8;                  // bf16 padding per staged row
// Keys per staged tile, chosen by timing both widths on the H100 (PERF.md):
// at D <= 64 the two tie on K1 and K2, and 64 halves the barriers; at
// D = 128, 32 keys take 52 KB of shared memory a block against 87, so more
// blocks fit on an SM, and K4's causal prefills run 12-16% faster.
template <int D>
constexpr int kMmaBlockK = D == 128 ? 32 : 64;

// Byte offsets into the block's dynamic shared memory.
template <int D>
struct MmaSmem {
  static constexpr int kBK = kMmaBlockK<D>;
  static constexpr int kRow = D + kMmaPad;  // elements per staged row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kMmaBlockQ * kRow * 2;
  static constexpr int kV = kK + kMmaStages * kBK * kRow * 2;
  static constexpr int kIds = kV + kMmaStages * kBK * kRow * 2;  // segment ids ring
  static constexpr int kRanges = kIds + kMmaStages * kBK * 4;    // per-tile id range
  static size_t bytes(int mask, int key_tiles) {
    return mask == kMaskSegment ? kRanges + (size_t)key_tiles * sizeof(int2) : kIds;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with full == false nothing is read and the
// 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v;
  memcpy(&v, &x, sizeof(v));
  return __bfloat1622float2(v);
}

template <int D, int kMask>
__global__ void __launch_bounds__(kMmaThreads)
mma_tile_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                const int* __restrict__ aux, int S, int causal, float scale,
                Strides qs, Strides ks, Strides vs, Strides os) {
  static_assert(D % 16 == 0, "mma.sync takes k = 16");
  using Smem = MmaSmem<D>;
  constexpr int kBK = Smem::kBK;
  constexpr int kRow = Smem::kRow;
  constexpr int kChunks = D / 8;          // 16-byte chunks of a row
  constexpr int kNS = kBK / 8;     // 8-key column tiles of S
  constexpr int kND = D / 8;              // 8-wide column tiles of O
  constexpr bool kSegment = kMask == kMaskSegment;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kQ);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kK);
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV);
  int* s_ids = reinterpret_cast<int*>(smem + Smem::kIds);
  int2* s_range = reinterpret_cast<int2*>(smem + Smem::kRanges);
  __shared__ int s_lo[2], s_hi[2];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // the fragment row (and row + 8) of this thread
  const int tig = lane & 3;  // its column pair within an 8-wide tile
  const int* seg_row = kSegment ? aux + (long long)b * S : aux;  // kMaskSegment only

  int len = S;
  if constexpr (kMask == kMaskRagged) {
    len = aux[b];
    len = len < 0 ? 0 : (len > S ? S : len);
  }
  int lo = 0, hi = 0;  // the query tile's live id range
  if constexpr (kSegment) {
    static_assert(kMmaBlockQ == 64, "warps 0 and 1 hold one query id each");
    if (tid < kMmaBlockQ) {
      const int qi = q0 + tid;
      const int id = qi < S ? seg_row[qi] : 0;
      const int wlo = __reduce_min_sync(0xffffffffu, id > 0 ? id : INT_MAX);
      const int whi = __reduce_max_sync(0xffffffffu, id);
      if (lane == 0) {
        s_lo[warp] = wlo;
        s_hi[warp] = whi;
      }
    }
    __syncthreads();
    lo = min(s_lo[0], s_lo[1]);
    hi = max(s_hi[0], s_hi[1]);
  }

  __nv_bfloat16* obase = o + b * os.b + h * os.h;
  const bool tile_dead = kMask == kMaskRagged ? q0 >= len : (kSegment && hi == 0);
  if (tile_dead) {  // the whole query tile is padding or dead: zeros, no read
    for (int idx = tid; idx < kMmaBlockQ * kChunks; idx += kMmaThreads) {
      const int qi = q0 + idx / kChunks;
      if (qi < S)
        *reinterpret_cast<uint4*>(obase + (long long)qi * os.s + (idx % kChunks) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  int kv_end = len;  // keys past the row's length are never loaded
  if (causal && q0 + kMmaBlockQ < kv_end) kv_end = q0 + kMmaBlockQ;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  // Q's copies go first, so they land while the key tiles are chosen
  const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
  for (int idx = tid; idx < kMmaBlockQ * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = q0 + r < S;
    cp_async16(smem_addr(s_q + r * kRow + c * 8),
               qbase + (long long)(in ? q0 + r : 0) * qs.s + c * 8, in);
  }
  if constexpr (kSegment) {  // every key tile's live id range, one warp a tile
    for (int t = warp; t < n_tiles; t += kMmaWarps) {
      int tlo = INT_MAX, thi = 0;
      for (int jj = lane; jj < kBK; jj += 32) {
        const int j = t * kBK + jj;
        const int id = j < S ? seg_row[j] : 0;
        if (id > 0) {
          tlo = min(tlo, id);
          thi = max(thi, id);
        }
      }
      tlo = __reduce_min_sync(0xffffffffu, tlo);
      thi = __reduce_max_sync(0xffffffffu, thi);
      if (lane == 0) s_range[t] = make_int2(tlo, thi);
    }
    __syncthreads();
  }
  // the next key tile at or after t that the block must load
  auto next_tile = [&](int t) {
    if constexpr (kSegment) {
      while (t < n_tiles) {
        const int2 r = s_range[t];
        if (r.y > 0 && r.x <= hi && r.y >= lo) break;
        ++t;
      }
    }
    return t;
  };

  // this thread's two query rows, and the warp's
  const int warp_q0 = q0 + 16 * warp;
  int q_row[2], q_seg[2] = {0, 0};
  bool q_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_row[i] = warp_q0 + g + 8 * i;
    if constexpr (kSegment) {
      q_seg[i] = q_row[i] < S ? seg_row[q_row[i]] : 0;
      q_ok[i] = q_seg[i] > 0;
    } else {
      q_ok[i] = q_row[i] < len;
    }
  }
  int w_lo = 0, w_hi = 0;
  if constexpr (kSegment) {
    const int a = q_ok[0] ? q_seg[0] : INT_MAX, c = q_ok[1] ? q_seg[1] : INT_MAX;
    w_lo = __reduce_min_sync(0xffffffffu, min(a, c));
    w_hi = __reduce_max_sync(0xffffffffu, max(q_seg[0], q_seg[1]));
  }
  const bool warp_live = kSegment ? w_hi > 0 : warp_q0 < len;

  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * kBK;
    __nv_bfloat16* dk = s_k + stage * kBK * kRow;
    __nv_bfloat16* dv = s_v + stage * kBK * kRow;
    for (int idx = tid; idx < kBK * kChunks; idx += kMmaThreads) {
      const int jj = idx / kChunks;
      const int c = idx % kChunks;
      const int j = k0 + jj;
      const bool in = j < kv_end;  // past it: zero-filled, never read
      const long long row = in ? j : 0;
      cp_async16(smem_addr(dk + jj * kRow + c * 8), kbase + row * ks.s + c * 8, in);
      cp_async16(smem_addr(dv + jj * kRow + c * 8), vbase + row * vs.s + c * 8, in);
    }
    if constexpr (kSegment) {
      for (int jj = tid; jj < kBK; jj += kMmaThreads) {
        const int j = k0 + jj;
        cp_async4(smem_addr(s_ids + stage * kBK + jj), seg_row + (j < S ? j : 0),
                  j < S);
      }
    }
  };

  float acc[kND][4];
#pragma unroll
  for (int dt = 0; dt < kND; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
  uint32_t qf[D / 16][4];
  bool have_q = false;

  int t = next_tile(0);
  if (t < n_tiles) load_tile(t, 0);
  cp_async_commit();  // with Q's copies, issued above
  int stage = 0;
  while (t < n_tiles) {
    const int nxt = next_tile(t + 1);
    __syncthreads();  // every warp is done with the stage the next tile overwrites
    if (nxt < n_tiles) load_tile(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and, the first time, Q) has landed
    __syncthreads();
    if (!have_q) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qf[kk], smem_addr(s_q + r * kRow + kk * 16 + (lane >> 4) * 8));
      }
      have_q = true;
    }
    const int k0 = t * kBK;
    bool skip = !warp_live || (causal && k0 > warp_q0 + 15);
    if constexpr (kSegment) {
      const int2 r = s_range[t];
      skip = skip || r.x > w_hi || r.y < w_lo;
    }
    if (!skip) {
      const __nv_bfloat16* tk = s_k + stage * kBK * kRow;
      const __nv_bfloat16* tv = s_v + stage * kBK * kRow;
      const int* tids = s_ids + stage * kBK;
      float s[kNS][4];
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < kNS; nt += 2) {  // two 8-key tiles per ldmatrix
          const int key = nt * 8 + (lane & 7) + (lane >> 4) * 8;
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_addr(tk + key * kRow + col));
          mma_bf16(s[nt], qf[kk], kb[0], kb[1]);
          mma_bf16(s[nt + 1], qf[kk], kb[2], kb[3]);
        }
      }
      // mask, scale and the online softmax on the accumulator fragments:
      // s[nt][0..1] are row g's keys nt*8 + 2*tig + {0, 1}, s[nt][2..3] row g+8's
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int jj = nt * 8 + 2 * tig + (e & 1);
          const int j = k0 + jj;
          bool ok;
          if constexpr (kSegment)
            ok = q_ok[i] && tids[jj] == q_seg[i];  // dead and absent keys have id 0
          else
            ok = q_ok[i] && j < len && (!causal || j <= q_row[i]);
          s[nt][e] = ok ? s[nt][e] * scale : kNeg;
          mx[i] = fmaxf(mx[i], s[nt][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int dt = 0; dt < kND; ++dt) {
        acc[dt][0] *= corr[0];
        acc[dt][1] *= corr[0];
        acc[dt][2] *= corr[1];
        acc[dt][3] *= corr[1];
      }
      // P in bf16, laid out as the A operand of P V: 16 keys per k-step
      uint32_t pa[kNS / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
        const uint32_t lo_row = pack_bf16(__expf(s[nt][0] - m[0]), __expf(s[nt][1] - m[0]));
        const uint32_t hi_row = pack_bf16(__expf(s[nt][2] - m[1]), __expf(s[nt][3] - m[1]));
        const float2 pl = unpack_bf16(lo_row), ph = unpack_bf16(hi_row);
        l[0] += pl.x + pl.y;
        l[1] += ph.x + ph.y;
        pa[nt >> 1][(nt & 1) * 2] = lo_row;
        pa[nt >> 1][(nt & 1) * 2 + 1] = hi_row;
      }
#pragma unroll
      for (int kk = 0; kk < kNS / 2; ++kk) {
#pragma unroll
        for (int dt = 0; dt < kND; dt += 2) {  // two 8-wide O tiles per ldmatrix
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = dt * 8 + (lane >> 4) * 8;
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_addr(tv + key * kRow + col));
          mma_bf16(acc[dt], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[dt + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    stage ^= 1;
    t = nxt;
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy into Q's rows is in flight

  // the warp's 16 rows, staged through its own Q rows, then 16-byte stores
  __nv_bfloat16* wq = s_q + 16 * warp * kRow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < kND; ++dt) {
      // pad and dead queries emit zeros: a fully masked softmax is uniform
      const float x = q_ok[i] ? acc[dt][2 * i] / denom : 0.f;
      const float y = q_ok[i] ? acc[dt][2 * i + 1] / denom : 0.f;
      *reinterpret_cast<uint32_t*>(wq + (g + 8 * i) * kRow + dt * 8 + 2 * tig) = pack_bf16(x, y);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int qi = warp_q0 + r;
    if (qi < S)
      *reinterpret_cast<uint4*>(obase + (long long)qi * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(wq + r * kRow + c * 8);
  }
}

// static: its lock and grants stay this library's own (a function-local
// static of a template with external linkage is one object in the whole
// process, shared by every library built from this header). The caller
// makes q's device current: the attribute is set per device.
template <int D, int kMask>
static cudaError_t launch_mma_tile(const void* q, const void* k, const void* v, void* o,
                                   const int* aux, int B, int H, int S, int causal,
                                   float scale, const long long* st, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const size_t smem = MmaSmem<D>::bytes(kMask, (S + kMmaBlockK<D> - 1) / kMmaBlockK<D>);
  auto kernel = mma_tile_kernel<D, kMask>;
  if (smem > 48 * 1024) {
    // raised only, per device and under a lock: launches from several host
    // threads never see the limit fall below what they need
    static std::mutex lock;
    static std::map<int, size_t> granted;  // device -> dynamic bytes allowed
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> guard(lock);
    auto it = granted.try_emplace(device, 48 * 1024).first;
    if (smem > it->second) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      it->second = smem;
    }
  }
  const dim3 grid((S + kMmaBlockQ - 1) / kMmaBlockQ, H, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), aux, S,
      causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

// The variant a launch takes, from its dtype and head dim alone: bf16 at
// D in {16, 32, 64, 128} runs this tile, f32 and D = 8 the FMA body.
// ops/ragged_attention.py's kernel_variant applies the same rule before the
// launch and counts it.
inline bool takes_mma_tile(int is_bf16, int D) {
  return is_bf16 && (D == 16 || D == 32 || D == 64 || D == 128);
}

// q, k, v, o: [B, H, S, D] addressed through `st` (12 element strides:
// batch, head, seq for q, k, v, o in that order; the head dim is
// contiguous). aux: lengths [B] (kMaskRagged), segment ids [B, S]
// (kMaskSegment), or unused (kMaskDense); int32 on the device.
template <int kMask>
cudaError_t launch_attention(const void* q, const void* k, const void* v, void* o,
                             const int* aux, int B, int H, int S, int D, int is_bf16,
                             int causal, float scale, const long long* st,
                             void* stream_ptr) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!takes_mma_tile(is_bf16, D))
    return launch_flash_tile_any<kMask>(q, k, v, o, aux, B, H, S, D, is_bf16, causal,
                                        scale, st, stream);
  switch (D) {
    case 16: return launch_mma_tile<16, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 32: return launch_mma_tile<32, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    case 64: return launch_mma_tile<64, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
    default: return launch_mma_tile<128, kMask>(q, k, v, o, aux, B, H, S, causal, scale, st, stream);
  }
}

}  // namespace arkflow
