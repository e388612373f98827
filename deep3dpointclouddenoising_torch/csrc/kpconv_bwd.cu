// KPConv (pseudo-grid) aggregation, backward, for Hopper (sm_90a).
//
// With w[b,m,k,p] = infl(|rel[b,m,k] - kp[p]|) * mask[b,m,k] and the
// upstream gradient g (B, M, C) of the forward's output:
//
//   d_feat[b,n,c] = sum_{m,k: idx[b,m,k] = n} (sum_p w[b,m,k,p] kw[p,c])
//                                             * g[b,m,c]
//   d_kw[p,c]     = sum_{b,m,k} w[b,m,k,p] feat[b, idx[b,m,k], c] g[b,m,c]
//
// Replaces the Pallas TPU kernel _bwd_kernel_onehot
// (deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:361), launched by
// _bwd_pallas_onehot (:459) from the custom VJP's _vjp_bwd (:530), and the
// jnp sort + segment-sum path _vjp_bwd takes for constant influence and
// supports above 2048 points (:545-572).  Those limits were the TPU's VMEM
// and one-hot matmul limits; these kernels read rows by index and cover
// every N and all three influences.
//
// The identity.  Grouping the sums by support n instead of by query m,
//
//   H[b,n,p,c]    = sum_{(m,k): idx[b,m,k] = n} w[b,m,k,p] g[b,m,c]
//   d_feat[b,n,c] = sum_p kw[p,c] H[b,n,p,c]
//   d_kw[p,c]     = sum_{b,n} feat[b,n,c] H[b,n,p,c]
//
// H is the forward's per-query contraction acc[p,c] = sum_k W[p,k] G[k,c]
// (kpconv_fwd.cu) over inverted neighbourhoods (the edges (m,k) that name
// n), gathering rows of g instead of rows of feat; feat[b,n,:] is one
// contiguous row.  An edge with mask 0 has w = 0 exactly, so the inversion
// drops it.  So one gather and one 16 x E by E x C contraction per support
// serve both gradients, and neither needs an atomic: every output element
// has one writer and every sum a fixed order, so d_feat and d_kw are
// bitwise reproducible.
//
// Three kernels, launched in order on one stream:
//
// 1. kpconv_bwd_invert: per cloud, the live edges grouped by support, as
//    flat edge ids m*K + k.  The cloud's edge ids are cut into slices of
//    kInvSlice; block (r, j, b) counting-sorts slice j by support for the
//    supports of range r (one range while N <= 1536, so that its 32
//    per-warp histograms fit in shared memory; ranges are how every N is
//    covered, the JAX package's N > 2048 fallback included).  Warp w owns a
//    contiguous part of the slice: per-warp histograms (integer adds), an
//    exclusive scan over (support, warp), and a fill in which each warp
//    walks its part again in order and ranks equal keys among its lanes
//    with __match_any_sync.  So each slice's segment of a support ascends by
//    edge id whatever the schedule, and offsets (B, slices, N + 1) give its
//    first position per slice.  Slices replace two slower designs timed
//    on the H100: one block for a whole cloud, whose fill (some 26 steps of
//    a dependent chain per warp at the stem) took most of its time, and one
//    block per support range reading every edge of the cloud.
// 2. kpconv_bwd_kernel: H per support and both epilogues.  Grid (channel
//    tiles, ceil(N / kTileN), B), the forward's grid with supports in place
//    of queries.  A support's segment is its slices' segments in slice
//    order, so ascending by edge id: the block tabulates them (warp 0), and
//    each lane keeps a cursor into them, since it walks positions in order.
//    - Load balance: the block's supports cut their segments into chunks of
//      8 edges (the mma's k; a chunk never spans two supports), and the
//      block's Q chunks are split into kWarps contiguous ranges of
//      floor(Q / kWarps) or one more.  A support with thousands of edges
//      is shared by the block's warps instead of serialising one, and a
//      degree-0 support costs nothing.  Each warp keeps H of the support it
//      is on in mma fragments and flushes it at the support's last chunk in
//      its range.  A support inside one warp's range is written by that
//      warp; the pieces of a support split across warps go to shared slots
//      (slot s + w is unique along the staircase of (support, warp) pairs)
//      and are summed in warp order after a barrier, which also writes the
//      zero rows of degree-0 supports (so no zero fill is launched).
//    - Gather: each warp runs its own ring of kStages cp.async stages, one
//      chunk a stage: the 8 rows g[b, m_e, c0:c0+tc] (16-byte copies where
//      C % 4 == 0 and feat, g, kw are 16-byte aligned, else 4-byte), each
//      edge's rel and mask (4-byte copies), and, at the chunk that completes
//      a support's H in this warp, the support's feat row.  Copies past the
//      segment's end or past C are zero fills, so a partial chunk has zero
//      rows in B and zero weights in A (a stale NaN times a zero weight
//      would still be NaN).  The chunk's edge ids are loaded one chunk ahead
//      of its copies.
//    - Weights: each lane computes its four A-fragment entries from the
//      staged rel and mask, in full float32 with exact subtract-square
//      distances, as the forward and the plain version (no TF32 there).
//    - Contraction: mma.sync.m16n8k8 TF32 as 3xTF32 (float32 accuracy),
//      W (16 x 8, P padded to 16) as A and the gathered 8 x 8 block as B.
//      Each chunk's product goes into a zeroed accumulator and is added to
//      H by float32 adds: chained in the mma's accumulator over a sink's
//      hundreds of chunks (15,000-slot patches, in-degree 3,573), H
//      drifted far past a float32 sum's error, and train-mode BatchNorm
//      scale gradients, which cancel, failed chip_smoke.py's whole-model
//      check (PERF.md section 6; tests/test_torch_cuda.py holds the sum).
//      wgmma does not fit for the forward's reason: each support has 16
//      rows and its own gathered B.
//    - Epilogue (a), d_feat[n,c] = sum_p kw[p,c] H[p,c], on the fragments:
//      rows g and g+8 of a lane, written to row g of the chunk's stage, the
//      8 rows summed per channel by one lane each (fewer instructions than
//      shuffles), stored coalesced.  Epilogue (b): feat[b,n,c] H[p,c] is
//      added to the warp's (P, tc) sums in shared memory; the block sums
//      its warps in order into one slot of a partial buffer
//      (B * ceil(N / kTileN) slots).
//    - Channel tiles: the widest of equal width, at most 72 channels.  The
//      forward's finer split for more blocks at the deep levels made these
//      calls slower: each block pays the edge ids, rel, mask and weights
//      again.
//    Packing two supports into one chunk does not pay: H's rows are the
//    kernel points, so edges of two supports cannot share an mma, and the
//    gathered bytes are per edge anyway; it would save mma issue slots only
//    (at most a third at the strided calls, mean in-degree ~10).
// 3. kpconv_bwd_reduce: d_kw = sum over slots, in a fixed order.
//
// bfloat16 (kpconv_bwd_bf16, for the forward's kpconv_fwd_bf16).  The
// Pallas kernel writes d_features in features.dtype and d_kw in float32
// (pallas_kpconv.py:495-496).  kpconv_bwd_kernel is templated on the
// element type T of feat, g and d_feat: it gathers bf16 rows of g (8
// channels a 16-byte copy) and reads bf16 feat rows, both exact in TF32, so
// neither needs a low part and the contraction is 2xTF32 (kpconv_common.cuh
// mma_rows); H, the d_feat pieces of split supports and the d_kw sums stay
// float32, d_feat is rounded to bf16 once per element, and d_kw goes
// through the same fixed-order reduction in float32.  So the bf16 form is
// bitwise reproducible and free of float atomics too.  (The Pallas kernel
// adds its grid steps' d_features in bf16, dfeat_ref[0] + dfeat.astype(...)
// at :445-446, a rounding per step; this kernel rounds once.)  There is no
// bf16 form of kpconv_bwd_drel: only the GAN asks for d_rel, and
// kpconv_bwd_bf16 refuses want_drel.
//
// The gradient in rel (need_rel; the GAN's G-step asks for it at the
// discriminator's level-0 calls) comes from kpconv_bwd_drel, a fourth
// kernel built from the forward's parts: one warp per query gathers its
// neighbours' rows by cp.async and contracts them with kw * g on the
// tensor cores (3xTF32), each edge's sum over the channels taken in one
// fixed order and stored once, so d_rel is bitwise reproducible and free
// of float atomics too (its own note, below).  d_feat and d_kw come from
// the kernels above on that route too.
//
// What bounds it on this card.  Counted as chip_smoke.kpconv_bwd_bound
// counts it (every input byte read once), the float32 operation rate, and
// a few times lower at the 3xTF32 rate (kpconv_bwd_bound_tf32).  What
// sets the time is occupancy: each chunk is a chain of dependent steps
// (edge ids, copies, weights, three dependent mma per 8 channels) and only
// the number of warps per SM hides it.  Variants timed side by side on the
// H100 (PERF.md, section 6): the gather itself costs nothing measurable
// (zero-filled copies instead of reads changed nothing), while d_kw's sums
// in registers (36 more, 161 in all, 12 warps per SM) cost much of the
// stem's time; they now sit in shared memory, which with two stages
// keeps the block at 48.7 KB and 128 registers, 4 blocks (16 warps) per SM.
// A third stage (3 blocks per SM) and computing the weights a chunk ahead
// (153 registers) were both slower.  Registers and spills are printed by
// the build (-Xptxas -v): on the H100 machine (CUDA 12.8) kpconv_bwd_kernel
// uses 128 registers for each influence (held there by its launch bounds
// of 4 blocks per SM, which the per-chunk adds need; 124 for constant
// influence), kpconv_bwd_invert 52, kpconv_bwd_reduce 32, kpconv_bwd_drel
// 118 (13 for constant influence), none spills.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "kpconv_common.cuh"

namespace {

using namespace kpconv;

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------- inversion

constexpr int kInvWarps = 32;       // at most; a slice of E edges takes
constexpr int kInvThreads = 32 * kInvWarps;  // ceil(E / 128), 4 steps a warp
constexpr int kInvUnroll = 8;        // loads in flight per lane
constexpr int kInvSlice = 4096;      // edge ids per slice: 4 steps a warp
constexpr int kInvMaxRange = 1536;   // supports per block: 33 x 1536 words

size_t invert_smem_bytes(int range, int warps) {
  return sizeof(int) * (static_cast<size_t>(warps) * range + range + 1);
}

int num_slices(int E) { return std::max(1, (E + kInvSlice - 1) / kInvSlice); }

int invert_warps(int E) {
  return std::max(1, std::min(kInvWarps, (std::min(E, kInvSlice) + 127) / 128));
}

// keys of edges base + 32 u + lane: the support, or -1 for an edge that is
// masked, out of the warp's range or names no support
__device__ __forceinline__ void edge_keys(const int* ib, const float* mb,
                                          int base, int e1, int N, int lane,
                                          int (&key)[kInvUnroll]) {
  int n[kInvUnroll];
  float mk[kInvUnroll];
#pragma unroll
  for (int u = 0; u < kInvUnroll; ++u) {
    const int e = base + 32 * u + lane;
    n[u] = e < e1 ? __ldg(ib + e) : -1;
    mk[u] = e < e1 ? __ldg(mb + e) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kInvUnroll; ++u)
    key[u] = mk[u] != 0.f && n[u] >= 0 && n[u] < N ? n[u] : -1;
}

// Block (r, j, b) sorts slice j of cloud b's edge ids, [j kInvSlice,
// (j + 1) kInvSlice), by support, for the supports of its range r,
// [r range, (r + 1) range) (one range up to 1536 supports): it counts the
// slice's live edges below its range, and ranks and writes those inside it
// into the slice's part of edges.  offsets (B, slices, N + 1) holds each
// support's first position in edges, per slice.
__global__ void __launch_bounds__(kInvThreads)
kpconv_bwd_invert(const int* __restrict__ idx, const float* __restrict__ mask,
                  int* __restrict__ offsets, int* __restrict__ edges, int N,
                  int E, int range) {
  extern __shared__ int ismem[];
  __shared__ int warp_sum[kInvWarps];
  __shared__ int warp_below[kInvWarps];
  const int b = blockIdx.z;
  const int j = blockIdx.y;
  const int n_lo = blockIdx.x * range;
  const int rn = min(N, n_lo + range) - n_lo;  // supports of this block
  const int s_lo = j * kInvSlice;              // the slice's edge ids
  const int s_hi = min(E, s_lo + kInvSlice);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nw = nthreads >> 5;
  int* hist = ismem;                        // [warp][rn]
  int* offs = ismem + nw * rn;              // [rn + 1]
  int* ob = offsets + (static_cast<size_t>(b) * gridDim.y + j) * (N + 1) +
            n_lo;
  const int* ib = idx + static_cast<size_t>(b) * E;
  const float* mb = mask + static_cast<size_t>(b) * E;
  int* eb = edges + static_cast<size_t>(b) * E;

  for (int i = tid; i < nw * rn; i += nthreads) hist[i] = 0;
  __syncthreads();

  // 1. per-warp histograms of the range over the warp's contiguous part of
  //    the slice, and the count of live edges below the range
  const int per = (s_hi - s_lo + nw - 1) / nw;
  const int e0 = min(s_hi, s_lo + warp * per);
  const int e1 = min(s_hi, e0 + per);
  int* hw = hist + warp * rn;
  int below = 0;
  for (int base = e0; base < e1; base += 32 * kInvUnroll) {
    int key[kInvUnroll];
    edge_keys(ib, mb, base, e1, N, lane, key);
#pragma unroll
    for (int u = 0; u < kInvUnroll; ++u) {
      const int k = key[u] - n_lo;
      if (k >= rn) continue;
      if (k >= 0) atomicAdd(hw + k, 1);  // integer counts
      else if (key[u] >= 0) ++below;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (lane == 0) warp_below[warp] = below;
  __syncthreads();

  // 2. for each support, the exclusive prefix over warps in place and its
  //    degree; then the exclusive scan of the degrees over the block (each
  //    thread a contiguous run of supports), from the slice's first position
  //    and the edges below the range
  const int run_len = (rn + nthreads - 1) / nthreads;
  const int n0 = min(rn, tid * run_len);
  const int n1 = min(rn, n0 + run_len);
  int run = 0;
  for (int n = n0; n < n1; ++n) {
    int d = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = hist[w * rn + n];
      hist[w * rn + n] = d;
      d += c;
    }
    offs[n] = d;
    run += d;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nw ? warp_sum[lane] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += x;
    }
    int base = lane < nw ? warp_below[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) base += __shfl_xor_sync(kFull, base, o);
    warp_sum[lane] = s_lo + base + s - v;
  }
  __syncthreads();
  int acc = warp_sum[warp] + incl - run;
  for (int n = n0; n < n1; ++n) {
    const int d = offs[n];
    offs[n] = acc;
    acc += d;
  }
  if (tid == nthreads - 1) offs[rn] = acc;
  __syncthreads();
  // offsets[n_lo + rn] is the next block's first; the last block writes N's
  const int nout = rn + (n_lo + rn == N ? 1 : 0);
  for (int i = tid; i < nout; i += nthreads) ob[i] = offs[i];

  // 3. the fill: each warp walks its part of the slice again in order;
  //    equal keys among the lanes of one step are ranked by lane, so each
  //    segment ascends by edge id
  for (int base = e0; base < e1; base += 32 * kInvUnroll) {
    int key[kInvUnroll];
    edge_keys(ib, mb, base, e1, N, lane, key);
#pragma unroll
    for (int u = 0; u < kInvUnroll; ++u) {
      int k = key[u] - n_lo;
      k = key[u] >= 0 && k >= 0 && k < rn ? k : -1;
      const unsigned live = __ballot_sync(kFull, k >= 0);
      const unsigned peers = __match_any_sync(kFull, k) & live;
      const unsigned before = peers & ((1u << lane) - 1u);
      int pos = 0;
      if (k >= 0) pos = offs[k] + hw[k] + __popc(before);
      __syncwarp();
      if (k >= 0 && before == 0) hw[k] += __popc(peers);
      __syncwarp();
      if (k >= 0) eb[pos] = base + 32 * u + lane;
    }
  }
}

// -------------------------------------------------- H per support, epilogues

constexpr int kWarps = 4;             // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 8;             // supports per block (<= 31)
constexpr int kStages = 2;            // depth of each warp's cp.async ring
constexpr int kMaxGroups = 9;         // 8-channel groups per block (<= 16)
// 16-byte copy slots of a lane per chunk: 8 rows of up to 8 kMaxGroups
// channels, kVec<T> to a copy
template <typename T>
constexpr int kVecSlots = (kChunk * 8 * kMaxGroups / kVec<T> + 31) / 32;
constexpr int kMeta = 4;              // rel x, y, z and mask of an edge
constexpr int kSlots = kTileN + kWarps - 1;

// Shared-memory carve-up of a block, in 4-byte words:
//   stages [kStages][kWarps][warp_words]     per warp: kChunk gathered rows
//                                            of g (tcp elements of T each;
//                                            reused as kChunk float32 rows
//                                            by the d_feat epilogue), then
//                                            at word kChunk * tcp the feat
//                                            row (T) of the support whose H
//                                            the chunk completes
//   meta   [kStages][kWarps][kChunk][kMeta]  rel and mask of those edges
//   kw     [kPPad][tc]                       the block's kw slice
//   kp     [kPPad][3]
//   slots  [kSlots][tc]                      d_feat pieces of split supports
//   dkw    [kWarps][kPPad][tc]               each warp's d_kw sums
//   chunks [kTileN + 1] (int)                first chunk of each support
//   starts [kTileN][S] (int)                 first position of each support's
//                                            edges in each of the S slices
//   cum    [kTileN][S + 1] (int)             their running counts
template <typename T>
struct Tile {
  int tc, tcp, S;
  __host__ __device__ Tile(int ng, int slices)
      : tc(8 * ng), tcp(8 * (ng | 1)), S(slices) {}
  // a warp's part of a stage: kChunk float32 rows (the g rows in T fit
  // there), then one row of T (a multiple of 16 bytes: tcp is of 8)
  __host__ __device__ int warp_words() const {
    return kChunk * tcp + tcp * static_cast<int>(sizeof(T)) / 4;
  }
  __host__ __device__ int stage_words() const {
    return kWarps * warp_words();
  }
  __host__ __device__ int meta_offset() const {
    return kStages * stage_words();
  }
  __host__ __device__ int kw_offset() const {
    return meta_offset() + kStages * kWarps * kChunk * kMeta;
  }
  __host__ __device__ int kp_offset() const { return kw_offset() + kPPad * tc; }
  __host__ __device__ int slot_offset() const {
    return kp_offset() + kPPad * 3;
  }
  __host__ __device__ int dkw_offset() const {
    return slot_offset() + kSlots * tc;
  }
  __host__ __device__ int chunk_offset() const {
    return dkw_offset() + kWarps * kPPad * tc;
  }
  __host__ __device__ int start_offset() const {
    return chunk_offset() + kTileN + 1;
  }
  __host__ __device__ int cum_offset() const {
    return start_offset() + kTileN * S;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) *
           (static_cast<size_t>(cum_offset()) + kTileN * (S + 1));
  }
};

// first chunk of warp w's range of the block's Q chunks
__device__ __forceinline__ int range_start(int w, int Q) {
  return static_cast<int>(static_cast<long long>(w) * Q / kWarps);
}

template <typename T, int INFL>
__global__ void __launch_bounds__(kThreads, 4)
kpconv_bwd_kernel(const T* __restrict__ feat,
                  const float* __restrict__ rel,
                  const float* __restrict__ mask,
                  const float* __restrict__ kp, const float* __restrict__ kw,
                  const T* __restrict__ gout,
                  const int* __restrict__ offsets,
                  const int* __restrict__ edges, T* __restrict__ dfeat,
                  float* __restrict__ dkw_part, int N, int M, int K, int C,
                  int P, int ng, int slices, int vec, float inv_extent,
                  float inv_denom, int want_dfeat, int want_dkw) {
  extern __shared__ __align__(16) float smem[];
  const Tile<T> tl(ng, slices);
  const int S = slices;
  const int tc = tl.tc, tcp = tl.tcp;
  float* stage_s = smem;
  float* meta_s = smem + tl.meta_offset();
  float* kw_s = smem + tl.kw_offset();
  float* kp_s = smem + tl.kp_offset();
  float* slot_s = smem + tl.slot_offset();
  int* chunk_s = reinterpret_cast<int*>(smem + tl.chunk_offset());
  int* start_s = reinterpret_cast<int*>(smem + tl.start_offset());
  int* cum_s = reinterpret_cast<int*>(smem + tl.cum_offset());

  const int c0 = blockIdx.x * tc;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int tn = min(kTileN, N - n0);
  const int cw = min(tc, C - c0);  // channels of this tile inside C
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t E = static_cast<size_t>(M) * K;
  float* dkw_s = smem + tl.dkw_offset();
  float* dkw_w = dkw_s + warp * kPPad * tc;  // this warp's d_kw sums

  // the block's kw slice and kernel points (zeros past P and past C)
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

  // each support's segment is its sub-segments in the S slices of edge ids,
  // in slice order (so ascending by edge id): warp 0 tabulates their first
  // positions and running counts, lane s for support n0 + s
  if (warp == 0) {
    const int* ob = offsets + static_cast<size_t>(b) * S * (N + 1) + n0;
    int run = 0;
    for (int j = 0; j < S; ++j) {
      const int first = lane <= tn ? __ldg(ob + j * (N + 1) + lane) : 0;
      const int next = __shfl_down_sync(kFull, first, 1);
      if (lane < tn) {
        start_s[lane * S + j] = first;
        cum_s[lane * (S + 1) + j] = run;
        run += next - first;
      }
    }
    if (lane < tn) cum_s[lane * (S + 1) + S] = run;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile's segments, in every warp's registers: lane s < tn holds
  // support n0 + s's degree, chunk count and the inclusive prefix of the
  // chunk counts; Q chunks in all
  const int deg_l = lane < tn ? cum_s[lane * (S + 1) + S] : 0;
  const int nch_l = (deg_l + kChunk - 1) / kChunk;
  int qincl = nch_l;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, qincl, o);
    if (lane >= o) qincl += v;
  }
  const int Q = __shfl_sync(kFull, qincl, 31);
  if (warp == 0 && lane <= kTileN) chunk_s[lane] = qincl - nch_l;
  if (want_dkw)  // each warp zeroes its own d_kw sums
    for (int i = lane; i < kPPad * tc; i += 32) dkw_w[i] = 0.f;

  const int lo = range_start(warp, Q);
  const int hi = range_start(warp + 1, Q);
  const int g = lane >> 2;
  const int t = lane & 3;
  const T* gb = gout + static_cast<size_t>(b) * M * C + c0;
  const float* relb = rel + static_cast<size_t>(b) * E * 3;
  const float* maskb = mask + static_cast<size_t>(b) * E;
  const int* eb = edges + static_cast<size_t>(b) * E;

  // support s of chunk q (the number of supports that end at or before it)
  auto support_of = [&](int q) {
    return __popc(__ballot_sync(kFull, lane < tn && qincl <= q));
  };
  // lane kk < 8: edge id kk of chunk q, -1 past its segment (all lanes
  // call, for q = lo, lo + 1, ... in turn).  Position p of the segment is
  // in the last slice j with cum[j] <= p; p only grows within a support, so
  // each lane keeps its slice (j, its end cum[j + 1] and start - cum[j]) and
  // moves it forward
  int cur_s = -1, cur_j = 0, cur_end = 0, cur_base = 0;
  auto fetch_ids = [&](int q) {
    if (q >= hi) return -1;
    const int s = support_of(q);
    const int first = __shfl_sync(kFull, qincl - nch_l, s);
    const int deg = __shfl_sync(kFull, deg_l, s);
    const int p = (q - first) * kChunk + lane;
    if (lane >= kChunk || p >= deg) return -1;
    const int* cum = cum_s + s * (S + 1);
    if (s != cur_s) {
      cur_s = s;
      cur_j = -1;
      cur_end = 0;
    }
    while (p >= cur_end) {
      ++cur_j;
      cur_end = cum[cur_j + 1];
      cur_base = start_s[s * S + cur_j] - cum[cur_j];
    }
    return __ldg(eb + cur_base + p);
  };

  // the lane's 16-byte copy slots, the same in every chunk: (row kk,
  // column c) of the 8 x tc tile
  constexpr int kV = kVec<T>;
  constexpr int kSlotsV = kVecSlots<T>;
  const int per_row = tc / kV;
  int slot_row[kSlotsV], slot_col[kSlotsV];
#pragma unroll
  for (int i = 0; i < kSlotsV; ++i) {
    const int e = lane + 32 * i;
    const int r = e / per_row;
    slot_row[i] = e < kChunk * per_row ? r : -1;
    slot_col[i] = kV * (e - r * per_row);
  }
  // a warp's rows of g in stage st, and the feat row after them
  auto g_rows = [&](int st) {
    return reinterpret_cast<T*>(stage_s + st * tl.stage_words() +
                                warp * tl.warp_words());
  };
  auto feat_row = [&](int st) {
    return reinterpret_cast<T*>(stage_s + st * tl.stage_words() +
                                warp * tl.warp_words() + kChunk * tcp);
  };

  // chunk q's rows g[b, m_e, c0:] and its edges' rel and mask into stage
  // q % kStages, and the support's feat row if H is flushed at chunk q;
  // zeros past the segment and past C.  ids: the chunk's edge ids on lanes
  // 0..7 (fetch_ids)
  auto load_chunk = [&](int q, int ids) {
    const int st = q % kStages;
    T* dst = g_rows(st);
    float* mdst = meta_s + ((st * kWarps + warp) * kChunk) * kMeta;
    const int m = ids >= 0 ? ids / K : -1;
    {
      const int ek = __shfl_sync(kFull, ids, lane >> 2);
      const int comp = lane & 3;
      const float* src = ek < 0 ? mask
                         : comp < 3 ? relb + static_cast<size_t>(ek) * 3 + comp
                                    : maskb + ek;
      cp_async<4>(mdst + lane, src, ek < 0 ? 0 : 4);
    }
    if (vec) {
#pragma unroll
      for (int i = 0; i < kSlotsV; ++i) {
        const int mr = __shfl_sync(kFull, m, max(slot_row[i], 0));
        if (slot_row[i] < 0) continue;
        const int c = slot_col[i];
        const bool ok = mr >= 0 && c < cw;
        const T* src = ok ? gb + static_cast<size_t>(mr) * C + c : gout;
        cp_async<16>(dst + slot_row[i] * tcp + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kChunk * tc; e += 32) {  // same trips per lane
        const int r = e / tc;
        const int c = e - r * tc;
        const int mr = __shfl_sync(kFull, m, r);
        const bool ok = mr >= 0 && c < cw;
        const T* src = ok ? gb + static_cast<size_t>(mr) * C + c : gout;
        copy_elem(dst + r * tcp + c, src, ok);
      }
    }
    const int s = support_of(q);
    const int last = __shfl_sync(kFull, qincl, s);
    if (want_dkw && (q + 1 == last || q + 1 == hi)) {
      const T* frow = feat + (static_cast<size_t>(b) * N + n0 + s) * C + c0;
      T* fdst = feat_row(st);
      if (vec) {
        for (int c = kV * lane; c < tc; c += 32 * kV) {
          const bool ok = c < cw;
          cp_async<16>(fdst + c, ok ? frow + c : feat, ok ? 16 : 0);
        }
      } else {
        for (int c = lane; c < tc; c += 32) {
          const bool ok = c < cw;
          copy_elem(fdst + c, ok ? frow + c : feat, ok);
        }
      }
    }
  };

  int ids = fetch_ids(lo);
  for (int j = 0; j < kStages - 1; ++j) {
    if (lo + j < hi) {
      const int cur = ids;
      ids = fetch_ids(lo + j + 1);
      load_chunk(lo + j, cur);
    }
    cp_async_commit();
  }

  const float3 q0 = make_float3(kp_s[g * 3], kp_s[g * 3 + 1], kp_s[g * 3 + 2]);
  const float3 q1 = make_float3(kp_s[g * 3 + 24], kp_s[g * 3 + 25],
                                kp_s[g * 3 + 26]);
  float acc[kMaxGroups][4];
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int q = lo; q < hi; ++q) {
    cp_async_wait<kStages - 2>();  // this lane's copies of chunk q landed
    __syncwarp();                  // the warp's, and chunk q-1 is consumed
    if (q + kStages - 1 < hi) {
      const int cur = ids;
      ids = fetch_ids(q + kStages);
      load_chunk(q + kStages - 1, cur);
    }
    cp_async_commit();
    const int st = q % kStages;

    // A = W (16 x 8): lane (g, t) holds w[p][kk] for (p, kk) = (g, t),
    // (g+8, t), (g, t+4), (g+8, t+4); zero past P, and zero past the
    // segment through the zero-filled mask
    const float4* m4 = reinterpret_cast<const float4*>(
        meta_s + ((st * kWarps + warp) * kChunk) * kMeta);
    const float4 r0 = m4[t];
    const float4 r1 = m4[t + 4];
    const float3 p0 = make_float3(r0.x, r0.y, r0.z);
    const float3 p1 = make_float3(r1.x, r1.y, r1.z);
    float a[4];
    a[0] = g < P ? influence<INFL>(p0, q0, inv_extent, inv_denom) * r0.w : 0.f;
    a[1] = g + 8 < P ? influence<INFL>(p0, q1, inv_extent, inv_denom) * r0.w
                     : 0.f;
    a[2] = g < P ? influence<INFL>(p1, q0, inv_extent, inv_denom) * r1.w : 0.f;
    a[3] = g + 8 < P ? influence<INFL>(p1, q1, inv_extent, inv_denom) * r1.w
                     : 0.f;
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
    const T* bs = g_rows(st) + t * tcp + g;
    // each chunk's product starts from zero in the tensor core and is added
    // to H by a float32 add: the mma's own accumulation, chained over the
    // hundreds of chunks of a sink support, drifts; per chunk it spans 8
    // edges
#pragma unroll
    for (int grp = 0; grp < kMaxGroups; ++grp) {
      if (grp < ng) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows(part, ahi, alo, bs[grp * 8], bs[4 * tcp + grp * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[grp][i] += part[i];
      }
    }

    // flush H at the last chunk of its support in this warp's range
    const int s = support_of(q);
    const int last = __shfl_sync(kFull, qincl, s);
    if (q + 1 != last && q + 1 != hi) continue;
    const int first = __shfl_sync(kFull, qincl - nch_l, s);
    const int n = n0 + s;
    if (want_dfeat) {
      // d_feat[n,c] = sum_p kw[p,c] H[p,c]: rows g and g+8 here, written to
      // float32 row g of this chunk's stage (its rows of g are consumed),
      // then each lane sums the eight rows of its channels in order
      float* red = stage_s + st * tl.stage_words() + warp * tl.warp_words();
      __syncwarp();  // every lane's B reads of the chunk are done
#pragma unroll
      for (int grp = 0; grp < kMaxGroups; ++grp) {
        if (grp < ng) {
          const int c = grp * 8 + 2 * t;
          *reinterpret_cast<float2*>(red + g * tcp + c) = make_float2(
              fmaf(kw_s[(g + 8) * tc + c], acc[grp][2],
                   kw_s[g * tc + c] * acc[grp][0]),
              fmaf(kw_s[(g + 8) * tc + c + 1], acc[grp][3],
                   kw_s[g * tc + c + 1] * acc[grp][1]));
        }
      }
      __syncwarp();
      const bool whole = first >= lo && last <= hi;
      // the whole support: its row of d_feat (rounded to T once); a
      // piece: float32 slot s + warp, summed after the loop
      T* drow = dfeat + (static_cast<size_t>(b) * N + n) * C + c0;
      float* piece = slot_s + (s + warp) * tc;
      for (int c = lane; c < cw; c += 32) {
        float sum = red[c];
#pragma unroll
        for (int r = 1; r < kChunk; ++r) sum += red[r * tcp + c];
        if (whole)
          drow[c] = from_float<T>(sum);
        else
          piece[c] = sum;
      }
    }
    if (want_dkw) {  // d_kw[p,c] += feat[b,n,c] H[p,c], feat staged
      const T* fs = feat_row(st);
#pragma unroll
      for (int grp = 0; grp < kMaxGroups; ++grp) {
        if (grp < ng) {
          const int c = grp * 8 + 2 * t;
          const float2 f = load2(fs + c);
          float2* d0 = reinterpret_cast<float2*>(dkw_w + g * tc + c);
          float2* d1 = reinterpret_cast<float2*>(dkw_w + (g + 8) * tc + c);
          float2 v0 = *d0, v1 = *d1;
          v0.x = fmaf(f.x, acc[grp][0], v0.x);
          v0.y = fmaf(f.y, acc[grp][1], v0.y);
          v1.x = fmaf(f.x, acc[grp][2], v1.x);
          v1.y = fmaf(f.y, acc[grp][3], v1.y);
          *d0 = v0;
          *d1 = v1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's slots and d_kw sums are written

  if (want_dfeat) {
    // rows no single warp wrote: degree 0 (zeros), or split between warps
    // (their pieces summed in warp order)
    for (int i = tid; i < tn * tc; i += kThreads) {
      const int s = i / tc;
      const int c = i - s * tc;
      if (c >= cw) continue;
      const int first = chunk_s[s];
      const int last = chunk_s[s + 1];
      float sum = 0.f;
      int pieces = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (max(range_start(w, Q), first) < min(range_start(w + 1, Q), last)) {
          sum += slot_s[(s + w) * tc + c];
          ++pieces;
        }
      }
      if (pieces != 1)
        dfeat[(static_cast<size_t>(b) * N + n0 + s) * C + c0 + c] =
            from_float<T>(pieces ? sum : 0.f);
    }
  }
  if (!want_dkw) return;  // uniform over the block
  // the block's (P, tc) partial of d_kw: warps summed in a fixed order
  float* part = dkw_part +
      (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * P * C + c0;
  for (int i = tid; i < P * tc; i += kThreads) {
    const int p = i / tc;
    const int c = i - p * tc;
    if (c >= cw) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += dkw_s[(w * kPPad + p) * tc + c];
    part[p * C + c] = sum;
  }
}

// d_kw[e] = sum over slots i (in order) of part[i][e], e over P * C.  Threads
// of a row take consecutive e (coalesced); the rows (blockDim.y: 32 for
// many slots, 8 for a few) take slots i = row, row + rows, ... and are
// summed in a fixed order.  The loop is unrolled so that a thread's loads
// are in flight together (the adds keep their order): at the stem, 1008
// slots, it was latency-bound.
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 32;  // at most

int reduce_rows(int slots) {
  return slots >= 8 * kReduceRows ? kReduceRows : 8;
}

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
kpconv_bwd_reduce(const float* __restrict__ part, float* __restrict__ dkw,
                  int slots, int PC) {
  __shared__ float red_s[kReduceRows][kReduceCols + 1];
  const int rows = blockDim.y;
  const int e = blockIdx.x * kReduceCols + threadIdx.x;
  float s = 0.f;
  if (e < PC) {
#pragma unroll 8
    for (int i = threadIdx.y; i < slots; i += rows)
      s += part[static_cast<size_t>(i) * PC + e];
  }
  red_s[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < PC) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) t += red_s[r][threadIdx.x];
    dkw[e] = t;
  }
}

// ------------------------------------------------------- the gradient in rel
//
//   d_rel[b,m,k] = sum_p dw[b,m,k,p] (rel[b,m,k] - kp[p]) S[b,m,p,k]
//   S[b,m,p,k]   = sum_c kw[p,c] g[b,m,c] feat[b, idx[b,m,k], c]
//
// with dw = mask * (d infl / d rel) / (rel - kp): -1 / (extent d) for linear
// influence where 0 < d and 1 - d / extent > 0 (0 where the influence is
// clamped, and 0 at d = 0, the where-guarded sqrt's subgradient),
// -2 infl / gauss_denom for gaussian, 0 for constant.
//
// Replaces the gradient in rel of _vjp_bwd's jnp path
// (deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:545-572: jax.grad
// through kpconv_aggregate_reference; the Pallas VJP itself returns zeros
// for rel, :539-541).
//
// What bounds it.  Counted as chip_smoke.kpconv_drel_bound_tf32 counts it
// (every input byte read once; S's 2 operations per (live edge, p, c) at
// the 3xTF32 rate, kw * g and the slopes at the float32 rate): ~0.016 ms
// for the GAN's three level-0 calls, the stems bound by operations and T1
// by bytes (0.032 ms with S at the float32 FMA rate, kpconv_drel_bound).
// What the formula does not count is
// the forward's cost: each live edge reads its neighbour's row by index
// (the same B*M*K*C*4 bytes from L2 as the forward's gather), and S is a
// (16 x C) by (C x K) product per query.
//
// The design is the forward's (kpconv_fwd.cu) with A and B swapped in role:
// 1. Grid (ceil(M / kRelTileM), B), one warp per query.  Each edge's sum
//    over all C channels stays in one warp and is taken in one fixed order;
//    channels are not split across blocks (an earlier design did, and
//    needed float atomics).
// 2. Gather: each warp runs its own ring of kRelStages cp.async stages; a
//    stage is its query's 8 neighbour rows (a chunk, the mma's n) cut to a
//    channel tile of at most 72 (pick_groups), 16-byte copies where
//    C % 4 == 0 and feat is 16-byte aligned, else 4-byte copies.  Slots
//    past K, past C, and of masked edges (dw = 0 there) are zero fills, so
//    a masked edge reads nothing.  Steps run channel tile by tile and chunk
//    by chunk within a tile, so the ring flows on across tiles.  Rows are
//    tc + 4 floats apart, so the B fragment's reads (8 rows, 4 channels a
//    read) are free of bank conflicts.  TMA does not fit, as in the
//    forward: the rows are picked one by one by idx.
// 3. Tensor cores for S: mma.sync.m16n8k8 TF32 as 3xTF32 (float32
//    accuracy), A = kw[p, c..c+8] * g[m, c..c+8] (16 rows, P padded to 16,
//    the product rounded once in float32 as the plain version rounds it,
//    kept in registers for the tile and split hi/lo at each use), B = the
//    staged chunk read as (channel, edge).  Each 8-channel group's product
//    starts from zero in the tensor core and the groups are added by
//    float32 adds in order, then to the earlier tiles' S (kept per lane in
//    shared memory when C spans several tiles): no chain in the mma's
//    accumulator spans more than one group's three steps (a long chain
//    drifts, kpconv_bwd_kernel's note), and the groups' mma are
//    independent, so they overlap.
// 4. Epilogue on the CUDA cores in full float32, per chunk at the last
//    tile: each lane holds S at rows p = g, g + 8 and edges 2t, 2t + 1,
//    computes dw (exact subtract-square distances, the plain version's
//    roundings: weight_slope) times S times (rel - kp), and the eight row
//    groups are
//    summed by a fixed butterfly (xor 4, 8, 16).  24 lanes store the
//    chunk's 8 x 3 values once, with plain stores: no float atomics, so
//    d_rel is bitwise reproducible.  Constant influence writes zeros.
// The kernel is query-major, so a sink support costs it nothing extra.
// On the H100 (PERF.md, section 6) the GAN's stem call takes 94-100 us,
// ~14x its bound and a fifth of the design before it, against the
// forward's ~68 us at the same shape.  Measured against variants: an
// epilogue cut to one add and a store takes 18.5 us off the stem's 94;
// splitting A once a tile instead of at every chunk needs 128-137
// registers and was slower (99.5 us at 4 blocks per SM with a spill,
// 131.3 at 3), as were a fourth stage and 5 blocks per SM (96 registers).
// Of the two costs suspected, the epilogue is a fifth of the stem's time;
// hoisting the A splits does not pay for its registers.
// Registers (-Xptxas -v on the H100 machine, CUDA 12.8): 118 for linear
// and gaussian influence (launch bounds of 4 blocks per SM allow 128), 13
// for constant; no spills.  A block of 4 queries at C = 72, K = 52 holds
// 32.8 KB of shared memory (the ring 29.2 KB).

constexpr int kRelTileM = 4;  // queries per block, one per warp
constexpr int kRelThreads = 32 * kRelTileM;
constexpr int kRelStages = 3;  // depth of each warp's cp.async ring

// Shared-memory carve-up of a d_rel block, in 4-byte words:
//   stages [kRelStages][kRelTileM][kChunk][tcp]  gathered rows, tcp = tc + 4
//   part   [kRelTileM][nchunk][32][4]            each lane's S over the
//                                                tiles so far (only when C
//                                                spans several tiles)
//   kp     [kPPad][3]
//   rel    [kRelTileM][K][3]
//   mask   [kRelTileM][K]
//   idx    [kRelTileM][K]
struct RelTile {
  int tc, tcp, nchunk, ntiles, K;
  __host__ __device__ RelTile(int ng, int C, int k)
      : tc(8 * ng), tcp(8 * ng + 4), nchunk((k + kChunk - 1) / kChunk),
        ntiles((C + 8 * ng - 1) / (8 * ng)), K(k) {}
  __host__ __device__ int stage_words() const {
    return kRelTileM * kChunk * tcp;
  }
  __host__ __device__ int part_offset() const {
    return kRelStages * stage_words();
  }
  __host__ __device__ int kp_offset() const {
    return part_offset() + (ntiles > 1 ? kRelTileM * nchunk * 128 : 0);
  }
  __host__ __device__ int rel_offset() const { return kp_offset() + kPPad * 3; }
  __host__ __device__ int mask_offset() const {
    return rel_offset() + kRelTileM * K * 3;
  }
  __host__ __device__ int idx_offset() const {
    return mask_offset() + kRelTileM * K;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) *
           (static_cast<size_t>(idx_offset()) + kRelTileM * K);
  }
};

// dw of one (edge, kernel point), diff = rel - kp, as
// kpconv_aggregate_backward_plain's _weight_slopes computes it.  Linear:
// its test 1 - d / extent > 0 holds exactly when d < extent (for floats
// d < extent, d / extent rounds to at most 1 - 2^-24), and __frcp_rn is
// the correctly rounded 1 / x that its division gives; both cost less
// than a division (4% of the GAN's stem call on the H100).
template <int INFL>
__device__ __forceinline__ float weight_slope(const float3& diff, float msk,
                                              float extent,
                                              float gauss_denom) {
  const float sq = diff.x * diff.x + diff.y * diff.y + diff.z * diff.z;
  if (INFL == kLinear) {
    if (!(sq > 0.f)) return 0.f;
    const float d = sqrtf(sq);
    return d < extent ? -__frcp_rn(extent * d) * msk : 0.f;
  }
  return -2.f * expf(-sq / gauss_denom) / gauss_denom * msk;
}

template <int INFL>
__global__ void __launch_bounds__(kRelThreads, 4)
kpconv_bwd_drel(const float* __restrict__ feat, const int* __restrict__ idx,
                const float* __restrict__ rel, const float* __restrict__ mask,
                const float* __restrict__ kp, const float* __restrict__ kw,
                const float* __restrict__ gout, float* __restrict__ drel,
                int N, int M, int K, int C, int P, int ng, int vec,
                float extent, float gauss_denom) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * kRelTileM;
  const int b = blockIdx.y;
  const int tm = min(kRelTileM, M - m0);
  const int tid = threadIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * M + m0) * K;
  if (INFL == kConstant) {  // d infl / d rel = 0
    for (int i = tid; i < tm * K * 3; i += kRelThreads)
      drel[row0 * 3 + i] = 0.f;
    return;
  }
  const RelTile tl(ng, C, K);
  const int tc = tl.tc, tcp = tl.tcp, nchunk = tl.nchunk;
  float* stage_s = smem;
  float4* part_s = reinterpret_cast<float4*>(smem + tl.part_offset());
  float* kp_s = smem + tl.kp_offset();
  float* rel_s = smem + tl.rel_offset();
  float* mask_s = smem + tl.mask_offset();
  int* idx_s = reinterpret_cast<int*>(smem + tl.idx_offset());

  // the tile's indices, positions, masks and kernel points: one group of
  // copies (zeros past P)
  for (int i = tid; i < tm * K; i += kRelThreads) {
    cp_async<4>(idx_s + i, idx + row0 + i, 4);
    cp_async<4>(mask_s + i, mask + row0 + i, 4);
  }
  for (int i = tid; i < tm * K * 3; i += kRelThreads)
    cp_async<4>(rel_s + i, rel + row0 * 3 + i, 4);
  for (int i = tid; i < kPPad * 3; i += kRelThreads)
    cp_async<4>(kp_s + i, i < P * 3 ? kp + i : kp, i < P * 3 ? 4 : 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // From here on each warp is its own pipeline over its query's rows.
  const int lane = tid & 31;
  const int m = tid >> 5;
  if (m >= tm) return;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* im = idx_s + m * K;
  const float* mask_m = mask_s + m * K;
  const float* rel_m = rel_s + m * K * 3;
  float* stage_m = stage_s + m * kChunk * tcp;
  const float* fb = feat + static_cast<size_t>(b) * N * C;
  const float* gq = gout + (static_cast<size_t>(b) * M + m0 + m) * C;
  float* out_m = drel + (row0 + static_cast<size_t>(m) * K) * 3;

  // the lane's 16-byte copy slots, the same in every chunk: (row r,
  // column c) of the 8 x tc stage
  constexpr int kSlots = kVecSlots<float>;
  const int per_row = tc / 4;
  int slot_row[kSlots], slot_col[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int e = lane + 32 * i;
    const int r = e / per_row;
    slot_row[i] = e < kChunk * per_row ? r : -1;
    slot_col[i] = 4 * (e - r * per_row);
  }

  // step s: chunk j = s % nchunk (edges 8j .. 8j+7) of channel tile
  // s / nchunk into stage s % kRelStages; zeros past K, past C and for
  // masked edges
  const int steps = tl.ntiles * nchunk;
  auto load_step = [&](int s) {
    const int tile = s / nchunk;
    const int j = s - tile * nchunk;
    const int c0 = tile * tc;
    const int cw = min(tc, C - c0);
    float* dst = stage_m + (s % kRelStages) * tl.stage_words();
    if (vec) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (slot_row[i] < 0) break;
        const int k = j * kChunk + slot_row[i];
        const int c = slot_col[i];
        const bool ok = k < K && c < cw && mask_m[k] != 0.f;
        const float* src =
            ok ? fb + static_cast<size_t>(im[k]) * C + c0 + c : feat;
        cp_async<16>(dst + slot_row[i] * tcp + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kChunk * tc; e += 32) {
        const int r = e / tc;
        const int c = e - r * tc;
        const int k = j * kChunk + r;
        const bool ok = k < K && c < cw && mask_m[k] != 0.f;
        const float* src =
            ok ? fb + static_cast<size_t>(im[k]) * C + c0 + c : feat;
        cp_async<4>(dst + r * tcp + c, src, ok ? 4 : 0);
      }
    }
  };
  for (int s = 0; s < kRelStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  float3 q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    q[h] = make_float3(kp_s[(g + 8 * h) * 3], kp_s[(g + 8 * h) * 3 + 1],
                       kp_s[(g + 8 * h) * 3 + 2]);
  // A of the current tile: lane (g, t) holds A[p][c] = kw[p,c] g[m,c] for
  // (p, c) = (g, t), (g+8, t), (g, t+4), (g+8, t+4) of each group; zero
  // past P and C
  float a[kMaxGroups][4];

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRelStages - 2>();  // this lane's copies of step s landed
    __syncwarp();                     // the warp's, and step s-1 is consumed
    if (s + kRelStages - 1 < steps) load_step(s + kRelStages - 1);
    cp_async_commit();
    const int tile = s / nchunk;
    const int j = s - tile * nchunk;
    if (j == 0) {
      const int c0 = tile * tc;
#pragma unroll
      for (int grp = 0; grp < kMaxGroups; ++grp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = g + 8 * (i & 1);
          const int c = c0 + grp * 8 + t + 4 * (i >> 1);
          a[grp][i] = grp < ng && p < P && c < C
                          ? __ldg(kw + p * C + c) * __ldg(gq + c)
                          : 0.f;
        }
      }
    }
    // S of this chunk and tile: lane (g, t) gets rows g, g+8 at edges 2t,
    // 2t+1; B[c][e] = stage[e][c] at bs[e * tcp + c]
    const float* bs =
        stage_m + (s % kRelStages) * tl.stage_words() + g * tcp + t;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int grp = 0; grp < kMaxGroups; ++grp) {
      if (grp < ng) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[grp][i], ahi[i], alo[i]);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(d, ahi, alo, bs[grp * 8], bs[grp * 8 + 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += d[i];
      }
    }
    if (tl.ntiles > 1) {
      float4* part = part_s + (m * nchunk + j) * 32 + lane;
      if (tile > 0) {
        const float4 prev = *part;
        sum[0] = prev.x + sum[0];
        sum[1] = prev.y + sum[1];
        sum[2] = prev.z + sum[2];
        sum[3] = prev.w + sum[3];
      }
      if (tile + 1 < tl.ntiles) {
        *part = make_float4(sum[0], sum[1], sum[2], sum[3]);
        continue;
      }
    }

    // the epilogue of chunk j: z[h] = sum over this lane's p of
    // dw[k,p] S[p,k] (rel[k] - kp[p]) at edge k = 8j + 2t + h, then over
    // the eight row groups
    float z[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z[h][0] = z[h][1] = z[h][2] = 0.f;
      const int k = j * kChunk + 2 * t + h;
      if (k >= K) continue;
      const float msk = mask_m[k];
      const float3 r =
          make_float3(rel_m[k * 3], rel_m[k * 3 + 1], rel_m[k * 3 + 2]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (g + 8 * i >= P) continue;
        const float3 diff =
            make_float3(r.x - q[i].x, r.y - q[i].y, r.z - q[i].z);
        const float v =
            weight_slope<INFL>(diff, msk, extent, gauss_denom) * sum[2 * i + h];
        z[h][0] += v * diff.x;
        z[h][1] += v * diff.y;
        z[h][2] += v * diff.z;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < 3; ++x)
          z[h][x] += __shfl_xor_sync(kFull, z[h][x], o);
      }
    }
    // lane (g, t), g < 6: component g % 3 of edge 8j + 2t + g / 3
    if (g < 6) {
      const int h = g >= 3;
      const int x = g - 3 * h;
      const int k = j * kChunk + 2 * t + h;
      const float v0 = h ? z[1][0] : z[0][0];
      const float v1 = h ? z[1][1] : z[0][1];
      const float v2 = h ? z[1][2] : z[0][2];
      if (k < K) out_m[k * 3 + x] = x == 0 ? v0 : (x == 1 ? v1 : v2);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ launches

int num_slots(int B, int N) { return B * ((N + kTileN - 1) / kTileN); }

// words of the int scratch: offsets B slices (N + 1) and edges B M K
size_t scratch_ints(int B, int N, int M, int K) {
  return static_cast<size_t>(B) * num_slices(M * K) * (N + 1) +
         static_cast<size_t>(B) * M * K;
}

// Groups of 8 channels per block: the widest tiles of equal width, at most
// kMaxGroups groups.  Splitting channels further (for more blocks at the
// deep levels, as the forward does) made those calls slower: each block pays
// the fetch of edge ids, their rel and mask, and the weights again.
int pick_groups(int C) {
  const int n8 = (C + 7) / 8;
  const int tiles = (n8 + kMaxGroups - 1) / kMaxGroups;
  return (n8 + tiles - 1) / tiles;
}

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int INFL>
cudaError_t launch(const T* feat, const int* idx, const float* rel,
                   const float* mask, const float* kp, const float* kw,
                   const T* g, T* dfeat, float* dkw, float* dkw_part,
                   float* drel, int* scratch, int B, int N, int M, int K,
                   int C, int P, float extent, float gauss_denom,
                   int want_dfeat, int want_dkw, int want_drel,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (want_dfeat || want_dkw) {
    const int E = M * K;
    const int slices = num_slices(E);
    int* offsets = scratch;
    int* edges = offsets + static_cast<size_t>(B) * slices * (N + 1);
    const int ranges = (N + kInvMaxRange - 1) / kInvMaxRange;
    const int range = (N + ranges - 1) / ranges;
    const int warps = invert_warps(E);
    const size_t ismem = invert_smem_bytes(range, warps);
    err = set_smem(kpconv_bwd_invert, ismem);
    if (err != cudaSuccess) return err;
    kpconv_bwd_invert<<<dim3(ranges, slices, B), 32 * warps, ismem,
                        stream>>>(idx, mask, offsets, edges, N, E, range);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const int ng = pick_groups(C);
    const Tile<T> tl(ng, slices);
    const size_t smem = tl.bytes();
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = set_smem(kpconv_bwd_kernel<T, INFL>, smem);
    if (err != cudaSuccess) return err;
    const int vec = C % kVec<T> == 0 &&
                    reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(kw) % 16 == 0;
    const dim3 grid((C + tl.tc - 1) / tl.tc, (N + kTileN - 1) / kTileN, B);
    kpconv_bwd_kernel<T, INFL><<<grid, kThreads, smem, stream>>>(
        feat, rel, mask, kp, kw, g, offsets, edges, dfeat, dkw_part, N, M, K,
        C, P, ng, slices, vec, 1.f / extent, 1.f / gauss_denom, want_dfeat,
        want_dkw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (want_dkw) {
      const int PC = P * C;
      const int slots = num_slots(B, N);
      kpconv_bwd_reduce<<<(PC + kReduceCols - 1) / kReduceCols,
                          dim3(kReduceCols, reduce_rows(slots)), 0, stream>>>(
          dkw_part, dkw, slots, PC);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  // bf16 has no d_rel (refused by backward); constant influence writes
  // zeros
  if constexpr (sizeof(T) == sizeof(float)) {
    if (want_drel) {
      const int ng = pick_groups(C);
      const size_t smem = INFL == kConstant ? 0 : RelTile(ng, C, K).bytes();
      if (smem > kMaxSmem) return cudaErrorInvalidValue;
      err = set_smem(kpconv_bwd_drel<INFL>, smem);
      if (err != cudaSuccess) return err;
      const int vec =
          C % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
      const dim3 grid((M + kRelTileM - 1) / kRelTileM, B);
      kpconv_bwd_drel<INFL><<<grid, kRelThreads, smem, stream>>>(
          feat, idx, rel, mask, kp, kw, g, drel, N, M, K, C, P, ng, vec,
          extent, gauss_denom);
      err = cudaGetLastError();
    }
  }
  return err;
}

template <typename T>
int backward(const void* feat, const void* idx, const void* rel,
             const void* mask, const void* kp, const void* kw, const void* g,
             void* dfeat, void* dkw, void* dkw_part, void* drel,
             void* scratch, int B, int N, int M, int K, int C, int P,
             int influence, float extent, float gauss_denom, int want_dfeat,
             int want_dkw, int want_drel, int device, void* stream) {
  if (P < 1 || P > kPPad || influence < 0 || influence > 2 ||
      (want_dfeat && dfeat == nullptr) ||
      (want_dkw && (dkw == nullptr || dkw_part == nullptr)) ||
      ((want_dfeat || want_dkw) && scratch == nullptr) ||
      (want_drel && (drel == nullptr || sizeof(T) != sizeof(float))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!want_dfeat && !want_dkw && !want_drel) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const T*>(feat);
  const auto* i = static_cast<const int*>(idx);
  const auto* r = static_cast<const float*>(rel);
  const auto* m = static_cast<const float*>(mask);
  const auto* p = static_cast<const float*>(kp);
  const auto* w = static_cast<const float*>(kw);
  const auto* gr = static_cast<const T*>(g);
  auto* df = static_cast<T*>(dfeat);
  auto* dw = static_cast<float*>(dkw);
  auto* part = static_cast<float*>(dkw_part);
  auto* dr = static_cast<float*>(drel);
  auto* sc = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (influence) {
    case kConstant:
      err = launch<T, kConstant>(f, i, r, m, p, w, gr, df, dw, part, dr, sc,
                                 B, N, M, K, C, P, extent, gauss_denom,
                                 want_dfeat, want_dkw, want_drel, s);
      break;
    case kLinear:
      err = launch<T, kLinear>(f, i, r, m, p, w, gr, df, dw, part, dr, sc, B,
                               N, M, K, C, P, extent, gauss_denom,
                               want_dfeat, want_dkw, want_drel, s);
      break;
    default:
      err = launch<T, kGaussian>(f, i, r, m, p, w, gr, df, dw, part, dr, sc,
                                 B, N, M, K, C, P, extent, gauss_denom,
                                 want_dfeat, want_dkw, want_drel, s);
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// Slots of the d_kw partial buffer the wrapper allocates: (slots, P, C).
extern "C" int kpconv_bwd_num_slots(int B, int N) { return num_slots(B, N); }

// int32 words of the scratch the wrapper allocates for the inversion.
extern "C" long long kpconv_bwd_scratch_ints(int B, int N, int M, int K) {
  return static_cast<long long>(scratch_ints(B, N, M, K));
}

// Launches on `stream` and does not synchronise.  Returns the CUDA error
// code of the launches (0 on success).  influence: 0 constant, 1 linear,
// 2 gaussian.  All tensors are contiguous float32 (idx int32) on `device`,
// with 0 <= idx < N (an index outside is dropped).  With want_dfeat, dfeat
// (B, N, C) is written whole; with want_dkw, dkw is (P, C) and dkw_part
// (kpconv_bwd_num_slots(B, N), P, C) scratch; with either, scratch holds
// kpconv_bwd_scratch_ints(B, N, M, K) int32; with want_drel, drel
// (B, M, K, 3) is written whole.  A pointer that is not wanted may be null.
extern "C" int kpconv_bwd(const void* feat, const void* idx, const void* rel,
                          const void* mask, const void* kp, const void* kw,
                          const void* g, void* dfeat, void* dkw,
                          void* dkw_part, void* drel, void* scratch, int B,
                          int N, int M, int K, int C, int P, int influence,
                          float extent, float gauss_denom, int want_dfeat,
                          int want_dkw, int want_drel, int device,
                          void* stream) {
  return backward<float>(feat, idx, rel, mask, kp, kw, g, dfeat, dkw,
                         dkw_part, drel, scratch, B, N, M, K, C, P, influence,
                         extent, gauss_denom, want_dfeat, want_dkw, want_drel,
                         device, stream);
}

// kpconv_bwd with bfloat16 feat, g and dfeat (the rest as there, dkw
// float32): float32 sums, d_feat rounded to bf16 once per element.  There is
// no bf16 d_rel: want_drel returns cudaErrorInvalidValue.
extern "C" int kpconv_bwd_bf16(const void* feat, const void* idx,
                               const void* rel, const void* mask,
                               const void* kp, const void* kw, const void* g,
                               void* dfeat, void* dkw, void* dkw_part,
                               void* drel, void* scratch, int B, int N, int M,
                               int K, int C, int P, int influence,
                               float extent, float gauss_denom,
                               int want_dfeat, int want_dkw, int want_drel,
                               int device, void* stream) {
  return backward<bf16>(feat, idx, rel, mask, kp, kw, g, dfeat, dkw,
                        dkw_part, drel, scratch, B, N, M, K, C, P, influence,
                        extent, gauss_denom, want_dfeat, want_dkw, want_drel,
                        device, stream);
}
