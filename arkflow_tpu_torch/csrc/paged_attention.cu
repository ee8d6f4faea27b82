// Paged flash attention for Hopper (sm_90a): K3, queries attending a KV
// context that lives in fixed-size pages of a shared pool, named by a page
// table.
//
// Replaces: arkflow_tpu/ops/ragged_attention.py:193, paged_flash_attention
// (pallas_call :250, Pallas kernel _paged_kernel :143). Same function: query
// i of row b sits at absolute position off[b] + i and attends keys
// 0 .. off[b] + i, clamped to the table's P * page keys, where key j lives in
// page table[b][j / page] at slot j % page of the pool. The GQA group (H /
// kv_heads query heads sharing one KV head) is folded into the query tile:
// folded index f = (chunk position f / group, group member f % group), so K
// and V are read once per KV head and never repeated. The TPU kernel's
// constants: scale 1/sqrt(D) on the dot product, mask value -1e30, the
// normaliser floored at 1e-30, __expf.
//
// What bounds it on the H100: the bytes, at every shape the generate path
// gives it. A call reads each live K/V page once (every key up to the last
// admissible one of each row and KV head) and q, and writes the output;
// it does 4 * D flops per (query, head, admissible key), far below the 295
// flop/byte ridge. The lockstep decode over 16 slots of contexts 1..639
// (8 KV heads, D = 128) needs 5.1 us at 3.35 TB/s; a 128-token chunk at
// offset 256 or 384 1.1 or 1.3 us. The first design (one block per row, KV
// head and query tile, each walking its row's whole context alone) ran at the
// latency of the longest row's walk: 128 blocks for 132 SMs at decode, up to
// 20 serial tiles each, ~114 GB/s.
//
// What the design does about it (flash-decoding on the tensor cores):
// - The context is split over blocks. A block takes one split of kSplitK = 64
//   keys (4 pages of 16) of one (row, KV head, query tile) and writes that
//   split's partial result -- the row max m, the normaliser l and the
//   unnormalised O, in f32 -- to a scratch buffer the wrapper allocates; a
//   second kernel (paged_combine_kernel) merges a row's splits in a fixed
//   order: M = max m_s, O = sum exp(m_s - M) O_s / max(sum exp(m_s - M) l_s,
//   1e-30). At the decode shape that is 10 x 8 x 16 = 1280 blocks, 560 of
//   them holding keys, none walking more than 64 keys. The grid is sized
//   from the table's width P, never from `off`, so the host reads nothing
//   back (no sync; a CUDA graph can capture the call); a block whose split
//   starts past its tile's last admissible key returns before it reads the
//   table. The combine reads only the splits that hold one of its row's
//   keys, so a split in which a row sees no key (m = -1e30, O a sum of V
//   rows) never reaches it; the weights exp(m_s - M) would zero it anyway.
//   No float atomics: the output is the same bit for bit from run to run.
//   Why a second kernel and not the last block of each row finishing behind
//   an integer counter: the counters would need zeroing, which is a launch
//   too (or a buffer kept per stream); both kernels are launched from the one
//   C entry, so a call costs the host one ctypes call, and the combine
//   (~2.7 MB of partials at decode) is a few microseconds of device time.
// - Both products on the tensor cores: mma.sync.m16n8k16, bf16 operands and
//   f32 accumulation, with mma_tile.cuh's fragments (ldmatrix for Q and K,
//   ldmatrix.trans for V). P is rounded to bf16 in registers and the
//   normaliser sums the rounded P: the rounding of the TPU kernel's
//   default-precision dots, as in mma_tile.cuh.
// - Two forms of the query fold, by the folded queries C * group:
//   * decode (<= 16, BQ = 16): one m16 tile holds every folded query (4 live
//     rows at group 4). The kernel is bound by bytes, so the dead rows cost
//     nothing that matters; but the 4 warps split the split's keys, 16 each
//     (one page of 16), not the rows, and merge their partials through
//     shared memory at the end (fixed order, warps 0..3).
//   * chunk (> 16, BQ = 64): mma_tile's form, 4 warps x 16 folded rows, each
//     warp scoring all 64 keys of the split; the causal bound is per folded
//     row, key j <= off + f / group, and a warp whose rows all precede the
//     split skips its math (the combine never reads those rows' partials).
//   Either way a softmax tile (16 or 64 keys) takes its own row max: the
//   merges carry the rest.
// - Staging: Q's folded rows and the split's K rows by 16-byte cp.async in
//   one group, V's rows in a second, so V lands while S = Q K^T and the
//   softmax run. One page-table lookup per staged row, once for K and V;
//   a page's rows for one KV head are D * 2 contiguous bytes at a stride of
//   KVH * D * 2 bytes in the [pages, page, KVH, D] pool. Keys past the
//   tile's bound are zero-filled (cp.async src-size 0) and never read
//   through the table, so stale or scratch pages past a row's bound cannot
//   change the output. Staged rows are padded by 16 bytes (no ldmatrix bank
//   conflicts). The chunk form at D = 128 takes 51 KB of dynamic shared
//   memory (granted per device), the decode form 38 KB.
// - Queries and the output are addressed through (batch, position, head)
//   strides: the model's [B, C, H, D] projections are read in place and the
//   combine writes straight into the [B, C, H, D] layout, with no reshape.
//   Padded chunk queries (off + i past P * page) see the whole table and
//   nothing outside it.
// - Scratch (not in the bound): B * KVH * ceil(P * page / 64) * C * group
//   rows of D + 2 floats: 2.7 MB at the decode shape, 21 MB for a 128-token
//   chunk of one row (about half of it written and read at offset 256).
//
// f32 q runs the FMA kernel below (paged_attention_kernel: one block per
// (row, KV head, query tile) walking the context 32 keys at a time through
// shared memory as f32): its 1e-4 contract rules out bf16 products. The
// wrapper chooses the body and passes it in (`variant`).
//
// C interface (bound with ctypes): arkflow_paged_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>

#include "mma_tile.cuh"

namespace {

using arkflow::cp_async16;
using arkflow::cp_async_commit;
using arkflow::cp_async_wait;
using arkflow::dot4;
using arkflow::fma4;
using arkflow::grant_dynamic_smem;
using arkflow::kBlockK;
using arkflow::kNeg;
using arkflow::kVariantFma;
using arkflow::kVariantMma;
using arkflow::Layout;
using arkflow::ldmatrix_x4;
using arkflow::ldmatrix_x4_trans;
using arkflow::mma_bf16;
using arkflow::pack_bf16;
using arkflow::scale4;
using arkflow::smem_addr;
using arkflow::Strides;
using arkflow::unpack_bf16;
using arkflow::Vec4;

// ---- the tensor-core body (bf16) ----

constexpr int kSplitK = 64;  // keys a split holds: 4 pages of 16
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kDecodeRows = 16;               // folded queries of a decode block
constexpr int kChunkRows = 16 * kSplitWarps;  // of a chunk block: 16 a warp
constexpr int kSplitPad = 8;                  // bf16 padding per staged row

// Byte offsets into a split block's dynamic shared memory.
template <int D, int kRows>
struct SplitSmem {
  static constexpr bool kDecode = kRows == kDecodeRows;
  static constexpr int kRow = D + kSplitPad;  // elements per staged row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kRow * 2;
  static constexpr int kV = kK + kSplitK * kRow * 2;
  static constexpr int kBytes = kV + kSplitK * kRow * 2;
  // decode: the warps' partials (O rows of D + 4 floats, then m and l), over
  // the staged tiles once every warp has consumed them
  static constexpr int kORow = D + 4;
  static constexpr int kML = kSplitWarps * 16 * kORow * 4;
  static_assert(!kDecode || kML + kSplitWarps * 16 * 2 * 4 <= kBytes,
                "the warps' partials fit over the staged tiles");
};

// One split of kSplitK keys for one (row, KV head, tile of kRows folded
// queries): grid (query tiles, splits, B * KVH). Writes the split's m, l
// and unnormalised O for the tile's live folded queries into the partials:
// o_part [B * KVH, n_splits, nq, D], then m and l [B * KVH, n_splits, nq]
// each, `rows` = B * KVH * n_splits * nq apart.
template <int D, int kRows>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pages,
                   const __nv_bfloat16* __restrict__ v_pages,
                   const int* __restrict__ table, const int* __restrict__ off,
                   float* __restrict__ o_part, float* __restrict__ ml_part,
                   int C, int KVH, int group, int P, int page, int n_splits,
                   long long rows, float scale, Strides qs) {
  static_assert(D % 16 == 0, "mma.sync takes k = 16");
  using Smem = SplitSmem<D, kRows>;
  constexpr bool kDecode = Smem::kDecode;
  constexpr int kRow = Smem::kRow;
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  constexpr int kND = D / 8;      // 8-wide column tiles of O
  constexpr int kKeys = kDecode ? kSplitK / kSplitWarps : kSplitK;  // a warp's keys
  constexpr int kNS = kKeys / 8;  // 8-key column tiles of S
  constexpr int kLoads = kSplitK * kChunks / kSplitThreads;  // K (or V) copies a thread
  static_assert(kLoads * kSplitThreads == kSplitK * kChunks, "whole copies");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kQ);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kK);
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV);

  const int f0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int b = blockIdx.z / KVH;
  const int g = blockIdx.z - b * KVH;
  const int nq = C * group;  // folded queries of this (row, KV head)
  const int base = max(off[b], 0);
  // the tile's last admissible key + 1, clamped to the table's width
  const long long ctx = (long long)P * page;
  const int f_last = min(f0 + kRows, nq) - 1;
  const int kv_end = (int)min((long long)base + f_last / group + 1, ctx);
  const int k0 = split * kSplitK;
  if (k0 >= kv_end) return;  // no key of the tile here: the table is not read

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // the fragment row (and row + 8) of this thread
  const int tig = lane & 3;  // its column pair within an 8-wide tile

  // Q's folded rows (rows past nq zero-filled), then the split's K rows:
  // one group; V's rows: a second, landing while S is computed
  for (int idx = tid; idx < kRows * kChunks; idx += kSplitThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int f = f0 + r;
    const bool in = f < nq;
    const int cpos = in ? f / group : 0;
    const int h = g * group + (in ? f - cpos * group : 0);
    cp_async16(smem_addr(s_q + r * kRow + c * 8),
               q + b * qs.b + (long long)cpos * qs.s + (long long)h * qs.h + c * 8, in);
  }
  const int* row_table = table + (long long)b * P;
  long long src[kLoads];  // each copy's element offset in a pool; -1: zero-filled
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + i * kSplitThreads;
    const int j = k0 + idx / kChunks;
    src[i] = -1;
    if (j < kv_end) {  // keys past the bound are never read through the table
      const int pi = j / page;
      src[i] = (((long long)row_table[pi] * page + (j - pi * page)) * KVH + g) * D +
               (idx % kChunks) * 8;
    }
  }
  auto stage = [&](const __nv_bfloat16* pool, __nv_bfloat16* dst) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kSplitThreads;
      cp_async16(smem_addr(dst + (idx / kChunks) * kRow + (idx % kChunks) * 8),
                 pool + (src[i] < 0 ? 0 : src[i]), src[i] >= 0);
    }
    cp_async_commit();
  };
  stage(k_pages, s_k);
  stage(v_pages, s_v);

  // this warp's rows and keys
  const int row0 = kDecode ? 0 : 16 * warp;
  const int key0 = kDecode ? kKeys * warp : 0;
  int q_pos[2];
  bool q_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + row0 + gr + 8 * i;
    q_ok[i] = f < nq;
    q_pos[i] = base + (q_ok[i] ? f / group : 0);
  }
  // a chunk warp whose rows all precede the split skips its math
  const int w_last = min(f0 + row0 + 15, nq - 1);
  const bool skip = !kDecode && (f0 + row0 >= nq || k0 > base + w_last / group);

  float acc[kND][4];
#pragma unroll
  for (int dt = 0; dt < kND; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
  uint32_t pa[kNS / 2][4];  // P in bf16, the A operand of P V

  cp_async_wait<1>();  // Q and K have landed
  __syncthreads();
  if (!skip) {
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(qf[kk], smem_addr(s_q + r * kRow + kk * 16 + (lane >> 4) * 8));
    }
    float s[kNS][4];
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNS; nt += 2) {  // two 8-key tiles per ldmatrix
        const int key = key0 + nt * 8 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(s_k + key * kRow + col));
        mma_bf16(s[nt], qf[kk], kb[0], kb[1]);
        mma_bf16(s[nt + 1], qf[kk], kb[2], kb[3]);
      }
    }
    // mask and scale: s[nt][0..1] are row gr's keys nt*8 + 2*tig + {0, 1},
    // s[nt][2..3] row gr+8's; then the tile's row max over the quad
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int j = k0 + key0 + nt * 8 + 2 * tig + (e & 1);
        const bool ok = q_ok[i] && j < kv_end && j <= q_pos[i];
        s[nt][e] = ok ? s[nt][e] * scale : kNeg;
        m[i] = fmaxf(m[i], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
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
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();
  if (!skip) {
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kND; dt += 2) {  // two 8-wide O tiles per ldmatrix
        const int key = key0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dt * 8 + (lane >> 4) * 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(s_v + key * kRow + col));
        mma_bf16(acc[dt], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[dt + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  const long long part0 = ((long long)blockIdx.z * n_splits + split) * nq;  // folded row 0
  if constexpr (!kDecode) {
    if (skip) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + row0 + gr + 8 * i;
      if (f >= nq) continue;
      float* orow = o_part + (part0 + f) * D;
#pragma unroll
      for (int dt = 0; dt < kND; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * tig) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      if (tig == 0) {
        ml_part[part0 + f] = m[i];
        ml_part[rows + part0 + f] = l[i];
      }
    }
  } else {
    // merge the four warps' partials (each over its 16 keys) into the split's
    constexpr int kORow = Smem::kORow;
    float* s_o = reinterpret_cast<float*>(smem);
    float* s_ml = reinterpret_cast<float*>(smem + Smem::kML);  // [warp][row]: m, l
    __syncthreads();  // every warp is done with the staged tiles
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gr + 8 * i;
#pragma unroll
      for (int dt = 0; dt < kND; ++dt)
        *reinterpret_cast<float2*>(s_o + r * kORow + dt * 8 + 2 * tig) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      if (tig == 0) {
        s_ml[2 * r] = m[i];
        s_ml[2 * r + 1] = l[i];
      }
    }
    __syncthreads();
    constexpr int kVec = D / 4;  // float4 chunks of a row
    const int live = min(kRows, nq - f0);
    for (int idx = tid; idx < live * kVec; idx += kSplitThreads) {
      const int r = idx / kVec;
      const int c = idx % kVec;
      float mw[kSplitWarps];
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        mw[w] = s_ml[2 * (w * 16 + r)];
        mx = fmaxf(mx, mw[w]);
      }
      float lsum = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float wt = __expf(mw[w] - mx);
        lsum = fmaf(wt, s_ml[2 * (w * 16 + r) + 1], lsum);
        o = fma4(wt, *reinterpret_cast<const float4*>(s_o + (w * 16 + r) * kORow + c * 4), o);
      }
      *reinterpret_cast<float4*>(o_part + (part0 + f0 + r) * D + c * 4) = o;
      if (c == 0) {
        ml_part[part0 + f0 + r] = mx;
        ml_part[rows + part0 + f0 + r] = lsum;
      }
    }
  }
}

// Merges each folded query's splits, in order, into the output: grid
// (ceil(nq / rows a block), KVH, B), one thread per 4 values of a row. Only
// the splits that hold one of the row's keys are read.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                     __nv_bfloat16* __restrict__ o, const int* __restrict__ off, int C,
                     int KVH, int group, int P, int page, int n_splits, long long rows,
                     Strides os) {
  constexpr int kVec = D / 4;  // float4 chunks of a row
  constexpr int kRowsPerBlock = kSplitThreads / kVec;
  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int nq = C * group;
  const int f = blockIdx.x * kRowsPerBlock + threadIdx.x / kVec;
  const int c = threadIdx.x % kVec;
  if (f >= nq) return;
  const int cpos = f / group;
  const long long last = min((long long)max(off[b], 0) + cpos, (long long)P * page - 1);
  const int n = (int)(last / kSplitK) + 1;  // key 0 lies in split 0: M is finite
  const long long row = ((long long)(b * KVH + g) * n_splits) * nq + f;  // split 0's
  float mx = kNeg;
#pragma unroll 4
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml_part[row + (long long)s * nq]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4  // the loads of four splits in flight at once
  for (int s = 0; s < n; ++s) {
    const long long at = row + (long long)s * nq;
    const float w = __expf(ml_part[at] - mx);
    lsum = fmaf(w, ml_part[rows + at], lsum);
    acc = fma4(w, *reinterpret_cast<const float4*>(o_part + at * D + c * 4), acc);
  }
  const float denom = fmaxf(lsum, 1e-30f);
  const int h = g * group + (f - cpos * group);
  Vec4<__nv_bfloat16>::store(o + b * os.b + (long long)cpos * os.s + (long long)h * os.h + c * 4,
                             make_float4(acc.x / denom, acc.y / denom, acc.z / denom,
                                         acc.w / denom));
}

template <int D, int kRows>
cudaError_t launch_split(const void* q, const void* kp, const void* vp, void* o,
                         const int* table, const int* off, int B, int C, int KVH,
                         int group, int P, int page, int n_splits, float scale,
                         const long long* st, float* scratch, cudaStream_t stream) {
  const Strides qs{st[0], st[2], st[1]}, os{st[3], st[5], st[4]};
  const int nq = C * group;
  const long long rows = (long long)B * KVH * n_splits * nq;
  float* o_part = scratch;
  float* ml_part = scratch + rows * D;
  const size_t smem = SplitSmem<D, kRows>::kBytes;
  auto split = paged_split_kernel<D, kRows>;
  cudaError_t err = grant_dynamic_smem(reinterpret_cast<const void*>(split), smem);
  if (err != cudaSuccess) return err;
  split<<<dim3((nq + kRows - 1) / kRows, n_splits, B * KVH), kSplitThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), table, off, o_part, ml_part, C, KVH, group, P,
      page, n_splits, rows, scale, qs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kRowsPerBlock = kSplitThreads / (D / 4);
  paged_combine_kernel<D>
      <<<dim3((nq + kRowsPerBlock - 1) / kRowsPerBlock, KVH, B), kSplitThreads, 0, stream>>>(
          o_part, ml_part, static_cast<__nv_bfloat16*>(o), off, C, KVH, group, P, page,
          n_splits, rows, os);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split_for_tile(const void* q, const void* kp, const void* vp, void* o,
                                  const int* table, const int* off, int B, int C, int KVH,
                                  int group, int P, int page, int n_splits, float scale,
                                  const long long* st, float* scratch, cudaStream_t stream) {
  if (C * group <= kDecodeRows)
    return launch_split<D, kDecodeRows>(q, kp, vp, o, table, off, B, C, KVH, group, P, page,
                                        n_splits, scale, st, scratch, stream);
  return launch_split<D, kChunkRows>(q, kp, vp, o, table, off, B, C, KVH, group, P, page,
                                     n_splits, scale, st, scratch, stream);
}

// ---- the FMA body (f32) ----

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
// device. is_bf16: 1 when q and o are bfloat16, 0 for float32. variant: the
// body to launch -- kVariantMma (bf16 q, D 64 or 128: the split kernel and
// its combine, with `scratch` holding at least B * KVH * ceil(P * page / 64)
// * C * (H / KVH) * (D + 2) floats on the device) or kVariantFma (f32 q, D 64
// or 128; scratch unused); anything else returns cudaErrorInvalidValue.
extern "C" int arkflow_paged_attention(const void* q, const void* k_pages,
                                       const void* v_pages, void* o,
                                       const int* table, const int* off, int B,
                                       int C, int H, int KVH, int D, int P,
                                       int page, int is_bf16, int variant,
                                       float scale, const long long* strides,
                                       float* scratch, long long scratch_floats,
                                       void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || P <= 0 || page <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  const int group = H / KVH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kVariantFma) {
    if (is_bf16) return cudaErrorInvalidValue;
    return launch_for_dim<float>(D, q, k_pages, v_pages, o, table, off, B, C,
                                 KVH, group, P, page, scale, strides, s);
  }
  if (variant != kVariantMma || !is_bf16) return cudaErrorInvalidValue;
  const long long n_splits = ((long long)P * page + kSplitK - 1) / kSplitK;
  const long long nq = (long long)C * group;
  if (n_splits > 65535 || (long long)B * KVH > 65535 || nq > INT_MAX / 2 ||
      scratch_floats < (long long)B * KVH * n_splits * nq * (D + 2))
    return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_split_for_tile<64>(q, k_pages, v_pages, o, table, off, B, C, KVH,
                                       group, P, page, (int)n_splits, scale, strides,
                                       scratch, s);
    case 128:
      return launch_split_for_tile<128>(q, k_pages, v_pages, o, table, off, B, C, KVH,
                                        group, P, page, (int)n_splits, scale, strides,
                                        scratch, s);
    default:
      return cudaErrorInvalidValue;
  }
}
