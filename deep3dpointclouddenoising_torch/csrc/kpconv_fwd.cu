// KPConv (pseudo-grid) aggregation, forward, for Hopper (sm_90a).
//
//   out[b,m,c] = sum_k sum_p infl(|rel[b,m,k] - kp[p]|) * mask[b,m,k]
//                            * kw[p,c] * feat[b, idx[b,m,k], c]
//
// Replaces the two Pallas TPU forward kernels of
// deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py, both launched by
// _fwd_pallas: _fwd_kernel_onehot (:142), which gathers the neighbours as a
// one-hot matmul for supports of up to 2048 points, and _fwd_kernel (:98),
// which reads neighbours pre-gathered by XLA for larger supports.  Here one
// kernel reads each neighbour's row by index and covers every N.
//
// The sum is reassociated per query m as
//   acc[p,c] = sum_k W[p,k] G[k,c],  W[p,k] = w[m,k,p],  G[k,c] = feat[idx[m,k], c]
//   out[c]   = sum_p kw[p,c] acc[p,c]
// a (16 x K) by (K x C) product per query, P padded to 16.
//
// What bounds it on this card.  Counted as chip_smoke.kpconv_bound counts
// it (every input byte read once from HBM), the bound is the float32
// operation rate: 2 P operations per (b, m, k, c).  Two things the formula
// does not count set the time in practice: the gather moves B*M*K*C*4 bytes
// from L2 into the SMs (120 MB at the stem, whose features all sit in L2),
// one row picked by idx at a time; and at the deep levels (M = 3..31) the
// work is small and the number of blocks and the latency of each dependent
// step decide.  On the H100 the stem-level calls still sit far above the
// bound: their gather, contraction, weights and per-block staging each
// take a similar share and overlap little at 5 blocks of 4 warps per SM
// (shared memory sets that); PERF.md, section 6, has the numbers.
// The design, part by part:
//
// 1. Channel split.  The grid is (channel tiles, ceil(M / kTileM), B).  A
//    tile is 8 * ng channels (ng <= kMaxGroups), chosen at launch so that the
//    grid has at least kMinBlocks blocks where C allows it, with as few tiles
//    as that needs (each tile recomputes its queries' influence weights) and
//    tiles of equal width: C = 72 runs as one tile of 72, C = 1152 at M = 3 as
//    36 tiles of 32.  Every flagship call gets 576 to 2000 blocks; the deep
//    levels, one block per 8 queries before, got 16-64.  A block stages only
//    its own slice kw[:, c0:c0+tc] (at most 4.6 KB).
// 2. Asynchronous gather.  Each warp owns one query of the block and runs
//    its own pipeline: it copies its neighbours' rows, cut to the block's
//    channel slice, chunk by chunk (8 neighbours, the mma's k) into its part
//    of a ring of kStages shared-memory stages with cp.async (16 bytes a
//    copy where C % 4 == 0 and features and kw are 16-byte aligned, 4 bytes
//    otherwise; slots past K or C are filled with zeros), so chunks j+1 and
//    j+2 are in flight while chunk j is computed.  Only __syncwarp orders
//    the ring; no barrier spans the block after the first staging of the
//    tile's idx, rel, mask, kw slice and kernel points (one cp.async group).
//    TMA does not fit: a tensor map copies boxes of a tensor, and these are
//    rows picked one by one by idx.  cp.async.ca keeps rows in L1 for the
//    other queries of the SM that share them.
// 3. Tensor cores for the neighbour contraction.  Each warp owns one query;
//    per chunk and 8-channel group it issues mma.sync.m16n8k8 in TF32 with
//    W's 16 x 8 chunk as A (P padded to 16: the 16th row, and the rows past P,
//    are zero) and G's 8 x 8 block as B.  Accuracy stays at float32's level
//    by 3xTF32: each operand x = hi + lo with hi, lo TF32 (hi = x with the
//    13 low mantissa bits cleared, lo the same of x - hi: |x - hi - lo| <
//    2^-20 |x|), and acc += lo_a hi_b + hi_a lo_b + hi_a hi_b in float32
//    accumulators (what is lost is < 2^-19 of a product).  wgmma does not fit: it
//    needs 64-row A tiles sharing one B, and here each query has 16 rows and
//    its own gathered B.  The B fragment's shared-memory reads are free of
//    bank conflicts (row stride 8 * (ng | 1) floats, an odd multiple of 8).
// 4. Influence weights on the CUDA cores in full float32, with exact
//    subtract-square distances as the plain version (a multiply by the
//    reciprocal where it divides): computed once per block into shared
//    memory, each warp those of its query, chunk by chunk inside the
//    pipeline (chunk j+2's beside its copies), straight into the A
//    fragment's register order (one 16-byte load per lane and chunk), in a
//    ring of kStages slots per warp.
// 5. Epilogue in registers: out[c] = sum_p kw[p,c] acc[p,c] on the fragment
//    (rows g and g+8 of a lane), summed over the eight row groups by warp
//    shuffles; then lanes 0..31 hold 64 consecutive channels and store them
//    as float2, coalesced.  Query rows past M (the ragged edge of the last
//    tile) are skipped.
//
// 6. bfloat16 features (kpconv_fwd_bf16, the JAX package's
//    compute_dtype: bfloat16, where the Pallas kernels take features.dtype).
//    The same kernel with the feature element type T as a template
//    parameter: rows come in as bf16, a 16-byte cp.async carries 8 channels
//    instead of 4 and the ring holds half the bytes.  The contraction stays
//    float32-accurate: a bf16 value is exact in TF32 (8 significant bits
//    against 11), so the gathered operand G needs no low part and 3xTF32
//    becomes 2xTF32, acc += lo_W G + hi_W G (kpconv_common.cuh mma_rows).
//    kw, rel, mask, the weights and every sum stay float32, and the output
//    is rounded to bf16 once, after the whole K-sum and the sum over kernel
//    points.  (The Pallas kernels add their K-chunks in the output dtype,
//    out_ref[0] + acc.astype(out_ref.dtype) at pallas_kpconv.py:135-136 and
//    181-182, so in bf16 they round once per chunk; this kernel rounds once.)
//
// Registers and spills are printed by the build (-Xptxas -v).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "kpconv_common.cuh"

namespace {

using namespace kpconv;

constexpr int kTileM = 4;            // queries per block, one per warp
constexpr int kThreads = 32 * kTileM;
constexpr int kStages = 3;           // depth of the cp.async ring
constexpr int kMaxGroups = 9;        // 8-channel groups per block (<= 16)
// 16-byte copy slots of a lane per chunk: 8 rows of up to 8 kMaxGroups
// channels, kVec<T> to a copy
template <typename T>
constexpr int kVecSlots = (kChunk * 8 * kMaxGroups / kVec<T> + 31) / 32;
constexpr int kMinBlocks = 4 * 132;  // grid size the channel split aims at
constexpr size_t kMaxSmem = 227 * 1024;

// Shared-memory carve-up of a block, in 4-byte words (the stages in
// elements of T, tcp * sizeof(T) a multiple of 16 bytes):
//   stages [kStages][kTileM][kChunk][tcp]  gathered rows (16-byte aligned)
//   wf     [kTileM][kStages][32][4]        weights in A-fragment order
//   kw     [kPPad][tc]                     the block's kw slice
//   kp     [kPPad][3]
//   rel    [kTileM][K][3]
//   mask   [kTileM][K]
//   idx    [kTileM][K]
template <typename T>
struct Tile {
  int tc, tcp, nchunk, K;
  __host__ __device__ Tile(int ng, int k)
      : tc(8 * ng), tcp(8 * (ng | 1)), nchunk((k + kChunk - 1) / kChunk),
        K(k) {}
  __host__ __device__ int stage_elems() const {
    return kTileM * kChunk * tcp;
  }
  __host__ __device__ int stage_words() const {
    return stage_elems() * static_cast<int>(sizeof(T)) / 4;
  }
  __host__ __device__ int wf_offset() const {
    return kStages * stage_words();
  }
  __host__ __device__ int kw_offset() const {
    return wf_offset() + kTileM * kStages * 128;
  }
  __host__ __device__ int kp_offset() const {
    return kw_offset() + kPPad * tc;
  }
  __host__ __device__ int rel_offset() const {
    return kp_offset() + kPPad * 3;
  }
  __host__ __device__ int mask_offset() const {
    return rel_offset() + kTileM * K * 3;
  }
  __host__ __device__ int idx_offset() const {
    return mask_offset() + kTileM * K;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (static_cast<size_t>(idx_offset()) + kTileM * K);
  }
};

template <typename T, int INFL>
__global__ void __launch_bounds__(kThreads)
kpconv_fwd_kernel(const T* __restrict__ feat, const int* __restrict__ idx,
                  const float* __restrict__ rel,
                  const float* __restrict__ mask,
                  const float* __restrict__ kp, const float* __restrict__ kw,
                  T* __restrict__ out, int N, int M, int K, int C, int P,
                  int ng, int vec, float inv_extent, float inv_denom) {
  extern __shared__ __align__(16) float smem[];
  const Tile<T> tl(ng, K);
  const int tc = tl.tc, tcp = tl.tcp, nchunk = tl.nchunk;
  T* stage_s = reinterpret_cast<T*>(smem);
  float* wf_s = smem + tl.wf_offset();
  float* kw_s = smem + tl.kw_offset();
  float* kp_s = smem + tl.kp_offset();
  float* rel_s = smem + tl.rel_offset();
  float* mask_s = smem + tl.mask_offset();
  int* idx_s = reinterpret_cast<int*>(smem + tl.idx_offset());

  const int c0 = blockIdx.x * tc;
  const int m0 = blockIdx.y * kTileM;
  const int b = blockIdx.z;
  const int tm = min(kTileM, M - m0);
  const int cw = min(tc, C - c0);  // channels of this tile inside C
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (static_cast<size_t>(b) * M + m0) * K;
  const T* fb = feat + static_cast<size_t>(b) * N * C + c0;

  // the tile's indices, positions, masks, kw slice and kernel points: one
  // group of copies, all in flight together (zeros past P and past C)
  for (int i = tid; i < tm * K; i += kThreads) {
    cp_async<4>(idx_s + i, idx + row0 + i, 4);
    cp_async<4>(mask_s + i, mask + row0 + i, 4);
  }
  for (int i = tid; i < tm * K * 3; i += kThreads)
    cp_async<4>(rel_s + i, rel + row0 * 3 + i, 4);
  if (vec) {  // C % kVec<T> == 0, so the slice's rows are 16-byte aligned
    for (int i = 4 * tid; i < kPPad * tc; i += 4 * kThreads) {
      const int p = i / tc;
      const int c = i - p * tc;
      const bool ok = p < P && c < cw;
      cp_async<16>(kw_s + i, ok ? kw + p * C + c0 + c : kw, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kPPad * tc; i += kThreads) {
      const int p = i / tc;
      const int c = i - p * tc;
      const bool ok = p < P && c < cw;
      cp_async<4>(kw_s + i, ok ? kw + p * C + c0 + c : kw, ok ? 4 : 0);
    }
  }
  for (int i = tid; i < kPPad * 3; i += kThreads)
    cp_async<4>(kp_s + i, i < P * 3 ? kp + i : kp, i < P * 3 ? 4 : 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // From here on each warp is its own pipeline: it copies, weighs and
  // contracts the rows of its query only, so no barrier spans the block.
  const int m = warp;  // this warp's query
  if (m >= tm) return;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* im = idx_s + m * K;
  T* stage_m = stage_s + m * kChunk * tcp;

  // the lane's 16-byte copy slots, the same in every chunk: (row kk,
  // column c) of the 8 x tc tile
  constexpr int kV = kVec<T>;
  constexpr int kSlots = kVecSlots<T>;
  const int per_row = tc / kV;
  int slot_row[kSlots], slot_col[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int e = lane + 32 * i;
    const int r = e / per_row;
    slot_row[i] = e < kChunk * per_row ? r : -1;
    slot_col[i] = kV * (e - r * per_row);
  }

  // chunk j's rows (neighbours 8j .. 8j+7) into stage j % kStages; zeros
  // past K and past C
  auto load_chunk = [&](int j) {
    T* dst = stage_m + (j % kStages) * tl.stage_elems();
    if (vec) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (slot_row[i] < 0) break;
        const int k = j * kChunk + slot_row[i];
        const int c = slot_col[i];
        const bool ok = k < K && c < cw;
        const T* src = ok ? fb + static_cast<size_t>(im[k]) * C + c : feat;
        cp_async<16>(dst + slot_row[i] * tcp + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kChunk * tc; e += 32) {
        const int r = e / tc;
        const int c = e - r * tc;
        const int k = j * kChunk + r;
        const bool ok = k < K && c < cw;
        const T* src = ok ? fb + static_cast<size_t>(im[k]) * C + c : feat;
        copy_elem(dst + r * tcp + c, src, ok);
      }
    }
  };
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nchunk) load_chunk(j);
    cp_async_commit();
  }

  // chunk j's influence weights in A-fragment order into ring slot
  // j % kStages: lane (g, t) holds W[p][kk] = w[m, 8j + kk, p] for
  // (p, kk) = (g, t), (g+8, t), (g, t+4), (g+8, t+4); zero past P and K.
  // Each lane reads back only what it wrote.
  float4* wf = reinterpret_cast<float4*>(wf_s) + m * kStages * 32 + lane;
  const float3 q0 = make_float3(kp_s[g * 3], kp_s[g * 3 + 1], kp_s[g * 3 + 2]);
  const float3 q1 = make_float3(kp_s[g * 3 + 24], kp_s[g * 3 + 25],
                                kp_s[g * 3 + 26]);
  const float* rel_m = rel_s + m * K * 3;
  const float* mask_m = mask_s + m * K;
  auto weigh_chunk = [&](int j) {
    float w[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = j * kChunk + t + 4 * h;
      w[h][0] = w[h][1] = 0.f;
      if (k < K) {
        const float msk = mask_m[k];
        const float3 r =
            make_float3(rel_m[k * 3], rel_m[k * 3 + 1], rel_m[k * 3 + 2]);
        if (g < P)
          w[h][0] = influence<INFL>(r, q0, inv_extent, inv_denom) * msk;
        if (g + 8 < P)
          w[h][1] = influence<INFL>(r, q1, inv_extent, inv_denom) * msk;
      }
    }
    wf[(j % kStages) * 32] = make_float4(w[0][0], w[0][1], w[1][0], w[1][1]);
  };
  for (int j = 0; j < kStages - 1 && j < nchunk; ++j) weigh_chunk(j);

  float acc[kMaxGroups][4];
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < nchunk; ++j) {
    cp_async_wait<kStages - 2>();  // this lane's copies of chunk j landed
    __syncwarp();                  // the warp's, and chunk j-1 is consumed
    if (j + kStages - 1 < nchunk) {
      load_chunk(j + kStages - 1);
      weigh_chunk(j + kStages - 1);
    }
    cp_async_commit();
    const float4 a4 = wf[(j % kStages) * 32];
    uint32_t ahi[4], alo[4];
    split_tf32(a4.x, ahi[0], alo[0]);
    split_tf32(a4.y, ahi[1], alo[1]);
    split_tf32(a4.z, ahi[2], alo[2]);
    split_tf32(a4.w, ahi[3], alo[3]);
    const T* bs = stage_s + (j % kStages) * tl.stage_elems() +
                  m * kChunk * tcp + t * tcp + g;
#pragma unroll
    for (int grp = 0; grp < kMaxGroups; ++grp) {
      if (grp < ng)
        mma_rows(acc[grp], ahi, alo, bs[grp * 8], bs[4 * tcp + grp * 8]);
    }
  }
  cp_async_wait<0>();

  // out[c] = sum_p kw[p,c] acc[p,c]: rows g and g+8 here, then the eight
  // row groups by shuffles; lane (g, t) keeps group 8h + g's channels 2t, 2t+1
  float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int grp = 0; grp < kMaxGroups; ++grp) {
    if (grp < ng) {
      const int c = grp * 8 + 2 * t;
      float o0 = fmaf(kw_s[(g + 8) * tc + c], acc[grp][2],
                      kw_s[g * tc + c] * acc[grp][0]);
      float o1 = fmaf(kw_s[(g + 8) * tc + c + 1], acc[grp][3],
                      kw_s[g * tc + c + 1] * acc[grp][1]);
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        o0 += __shfl_xor_sync(0xffffffffu, o0, s);
        o1 += __shfl_xor_sync(0xffffffffu, o1, s);
      }
      if ((grp & 7) == g) {
        v[grp >> 3][0] = o0;
        v[grp >> 3][1] = o1;
      }
    }
  }
  // the output's one rounding to T
  T* orow = out + (static_cast<size_t>(b) * M + m0 + m) * C + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (8 * h + g) * 8 + 2 * t;
    if (c >= cw) continue;
    if (c + 1 < cw && (C & 1) == 0) {
      store2(orow + c, v[h][0], v[h][1]);
    } else {
      orow[c] = from_float<T>(v[h][0]);
      if (c + 1 < cw) orow[c + 1] = from_float<T>(v[h][1]);
    }
  }
}

// Groups of 8 channels per block: as many channel tiles as it takes for
// kMinBlocks blocks (and at least ceil(C / (8 kMaxGroups))), of equal width.
int pick_groups(int B, int M, int C) {
  const long n8 = (C + 7) / 8;
  const long qb = static_cast<long>((M + kTileM - 1) / kTileM) * B;
  const long want = std::min(n8, (kMinBlocks + qb - 1) / qb);
  const long tiles0 =
      std::max((n8 + kMaxGroups - 1) / kMaxGroups, std::max(want, 1L));
  const long ng = std::max(1L, n8 / tiles0);
  const long tiles = (n8 + ng - 1) / ng;
  return static_cast<int>((n8 + tiles - 1) / tiles);
}

template <typename T, int INFL>
cudaError_t launch(const T* feat, const int* idx, const float* rel,
                   const float* mask, const float* kp, const float* kw,
                   T* out, int B, int N, int M, int K, int C, int P,
                   float extent, float gauss_denom, cudaStream_t stream) {
  const int ng = pick_groups(B, M, C);
  const Tile<T> tl(ng, K);
  const size_t smem = tl.bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kpconv_fwd_kernel<T, INFL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec = C % kVec<T> == 0 &&
                  reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kw) % 16 == 0;
  const dim3 grid((C + tl.tc - 1) / tl.tc, (M + kTileM - 1) / kTileM, B);
  kpconv_fwd_kernel<T, INFL><<<grid, kThreads, smem, stream>>>(
      feat, idx, rel, mask, kp, kw, out, N, M, K, C, P, ng, vec,
      1.f / extent, 1.f / gauss_denom);
  return cudaGetLastError();
}

template <typename T>
int forward(const void* feat, const void* idx, const void* rel,
            const void* mask, const void* kp, const void* kw, void* out,
            int B, int N, int M, int K, int C, int P, int influence,
            float extent, float gauss_denom, int device, void* stream) {
  if (P < 1 || P > kPPad || influence < 0 || influence > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const T*>(feat);
  const auto* i = static_cast<const int*>(idx);
  const auto* r = static_cast<const float*>(rel);
  const auto* m = static_cast<const float*>(mask);
  const auto* p = static_cast<const float*>(kp);
  const auto* w = static_cast<const float*>(kw);
  auto* o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (influence) {
    case kConstant:
      err = launch<T, kConstant>(f, i, r, m, p, w, o, B, N, M, K, C, P,
                                 extent, gauss_denom, s);
      break;
    case kLinear:
      err = launch<T, kLinear>(f, i, r, m, p, w, o, B, N, M, K, C, P, extent,
                               gauss_denom, s);
      break;
    default:
      err = launch<T, kGaussian>(f, i, r, m, p, w, o, B, N, M, K, C, P,
                                 extent, gauss_denom, s);
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns the CUDA error
// code of the launch (0 on success).  influence: 0 constant, 1 linear,
// 2 gaussian.  All tensors are contiguous float32 (idx int32) on `device`.
extern "C" int kpconv_fwd(const void* feat, const void* idx, const void* rel,
                          const void* mask, const void* kp, const void* kw,
                          void* out, int B, int N, int M, int K, int C, int P,
                          int influence, float extent, float gauss_denom,
                          int device, void* stream) {
  return forward<float>(feat, idx, rel, mask, kp, kw, out, B, N, M, K, C, P,
                        influence, extent, gauss_denom, device, stream);
}

// kpconv_fwd with bfloat16 feat and out (the rest as there): float32 sums,
// the output rounded to bf16 once.
extern "C" int kpconv_fwd_bf16(const void* feat, const void* idx,
                               const void* rel, const void* mask,
                               const void* kp, const void* kw, void* out,
                               int B, int N, int M, int K, int C, int P,
                               int influence, float extent,
                               float gauss_denom, int device, void* stream) {
  return forward<bf16>(feat, idx, rel, mask, kp, kw, out, B, N, M, K, C, P,
                       influence, extent, gauss_denom, device, stream);
}
