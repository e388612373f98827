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
//      block's T chunks are split into kWarps contiguous ranges of
//      floor(T / kWarps) or one more.  A support with thousands of edges
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
// The gradient in rel (need_rel; training never asks for it) keeps the
// previous design in kpconv_bwd_drel: one thread per channel, one query
// tile per block, the warp's channels summed by shuffles and the 3-vector
// added to d_rel by float32 atomics across channel tiles (so d_rel alone is
// not bitwise reproducible), into a buffer the wrapper zeroes.  d_feat and
// d_kw come from the kernels above on that route too.
//
// What bounds it on this card.  Counted as chip_smoke.kpconv_bwd_bound
// counts it (every input byte read once), the float32 operation rate, and
// a few times lower at the 3xTF32 rate (kpconv_bwd_bound_3xtf32).  What
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
// uses 128 registers for each influence, kpconv_bwd_invert 64,
// kpconv_bwd_reduce 30, kpconv_bwd_drel 55, none spills.

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
constexpr int kRows = kChunk + 1;     // a stage's rows: 8 edges' g, one feat
constexpr int kMaxGroups = 9;         // 8-channel groups per block (<= 16)
// 16-byte copy slots of a lane per chunk: 8 rows of up to 2 kMaxGroups
constexpr int kVecSlots = (kChunk * 2 * kMaxGroups + 31) / 32;
constexpr int kMeta = 4;              // rel x, y, z and mask of an edge
constexpr int kSlots = kTileN + kWarps - 1;

// Shared-memory carve-up of a block, in 4-byte words:
//   stages [kStages][kWarps][kRows][tcp]     gathered rows of g, then the
//                                            feat row of the support whose
//                                            H the chunk completes
//   meta   [kStages][kWarps][kChunk][kMeta]  rel and mask of those edges
//   kw     [kPPad][tc]                       the block's kw slice
//   kp     [kPPad][3]
//   slots  [kSlots][tc]                      d_feat pieces of split supports
//   dkw    [kWarps][kPPad][tc]               each warp's d_kw sums
//   chunks [kTileN + 1] (int)                first chunk of each support
//   starts [kTileN][S] (int)                 first position of each support's
//                                            edges in each of the S slices
//   cum    [kTileN][S + 1] (int)             their running counts
struct Tile {
  int tc, tcp, S;
  __host__ __device__ Tile(int ng, int slices)
      : tc(8 * ng), tcp(8 * (ng | 1)), S(slices) {}
  __host__ __device__ int stage_words() const {
    return kWarps * kRows * tcp;
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

// first chunk of warp w's range of the block's T chunks
__device__ __forceinline__ int range_start(int w, int T) {
  return static_cast<int>(static_cast<long long>(w) * T / kWarps);
}

template <int INFL>
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_kernel(const float* __restrict__ feat,
                  const float* __restrict__ rel,
                  const float* __restrict__ mask,
                  const float* __restrict__ kp, const float* __restrict__ kw,
                  const float* __restrict__ gout,
                  const int* __restrict__ offsets,
                  const int* __restrict__ edges, float* __restrict__ dfeat,
                  float* __restrict__ dkw_part, int N, int M, int K, int C,
                  int P, int ng, int slices, int vec4, float inv_extent,
                  float inv_denom, int want_dfeat, int want_dkw) {
  extern __shared__ __align__(16) float smem[];
  const Tile tl(ng, slices);
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
  if (vec4) {  // C % 4 == 0, so the slice's rows are 16-byte aligned
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
  // chunk counts; T chunks in all
  const int deg_l = lane < tn ? cum_s[lane * (S + 1) + S] : 0;
  const int nch_l = (deg_l + kChunk - 1) / kChunk;
  int qincl = nch_l;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, qincl, o);
    if (lane >= o) qincl += v;
  }
  const int T = __shfl_sync(kFull, qincl, 31);
  if (warp == 0 && lane <= kTileN) chunk_s[lane] = qincl - nch_l;
  if (want_dkw)  // each warp zeroes its own d_kw sums
    for (int i = lane; i < kPPad * tc; i += 32) dkw_w[i] = 0.f;

  const int lo = range_start(warp, T);
  const int hi = range_start(warp + 1, T);
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* gb = gout + static_cast<size_t>(b) * M * C + c0;
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
  const int per_row = tc / 4;
  int slot_row[kVecSlots], slot_col[kVecSlots];
#pragma unroll
  for (int i = 0; i < kVecSlots; ++i) {
    const int e = lane + 32 * i;
    const int r = e / per_row;
    slot_row[i] = e < kChunk * per_row ? r : -1;
    slot_col[i] = 4 * (e - r * per_row);
  }

  // chunk q's rows g[b, m_e, c0:] and its edges' rel and mask into stage
  // q % kStages, and the support's feat row if H is flushed at chunk q;
  // zeros past the segment and past C.  ids: the chunk's edge ids on lanes
  // 0..7 (fetch_ids)
  auto load_chunk = [&](int q, int ids) {
    const int st = q % kStages;
    float* dst = stage_s + st * tl.stage_words() + warp * kRows * tcp;
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
    if (vec4) {
#pragma unroll
      for (int i = 0; i < kVecSlots; ++i) {
        const int mr = __shfl_sync(kFull, m, max(slot_row[i], 0));
        if (slot_row[i] < 0) continue;
        const int c = slot_col[i];
        const bool ok = mr >= 0 && c < cw;
        const float* src = ok ? gb + static_cast<size_t>(mr) * C + c : gout;
        cp_async<16>(dst + slot_row[i] * tcp + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kChunk * tc; e += 32) {  // same trips per lane
        const int r = e / tc;
        const int c = e - r * tc;
        const int mr = __shfl_sync(kFull, m, r);
        const bool ok = mr >= 0 && c < cw;
        const float* src = ok ? gb + static_cast<size_t>(mr) * C + c : gout;
        cp_async<4>(dst + r * tcp + c, src, ok ? 4 : 0);
      }
    }
    const int s = support_of(q);
    const int last = __shfl_sync(kFull, qincl, s);
    if (want_dkw && (q + 1 == last || q + 1 == hi)) {
      const float* frow =
          feat + (static_cast<size_t>(b) * N + n0 + s) * C + c0;
      float* fdst = dst + kChunk * tcp;
      if (vec4) {
        for (int c = 4 * lane; c < tc; c += 128) {
          const bool ok = c < cw;
          cp_async<16>(fdst + c, ok ? frow + c : feat, ok ? 16 : 0);
        }
      } else {
        for (int c = lane; c < tc; c += 32) {
          const bool ok = c < cw;
          cp_async<4>(fdst + c, ok ? frow + c : feat, ok ? 4 : 0);
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
    const float* stage_w =
        stage_s + st * tl.stage_words() + warp * kRows * tcp;
    const float* bs = stage_w + t * tcp + g;
#pragma unroll
    for (int grp = 0; grp < kMaxGroups; ++grp) {
      if (grp < ng)
        mma_3xtf32(acc[grp], ahi, alo, bs[grp * 8], bs[4 * tcp + grp * 8]);
    }

    // flush H at the last chunk of its support in this warp's range
    const int s = support_of(q);
    const int last = __shfl_sync(kFull, qincl, s);
    if (q + 1 != last && q + 1 != hi) continue;
    const int first = __shfl_sync(kFull, qincl - nch_l, s);
    const int n = n0 + s;
    if (want_dfeat) {
      // d_feat[n,c] = sum_p kw[p,c] H[p,c]: rows g and g+8 here, written to
      // row g of this chunk's stage (its rows are consumed), then each lane
      // sums the eight rows of its channels in order
      float* red = stage_s + st * tl.stage_words() + warp * kRows * tcp;
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
      // the whole support: its row of d_feat; a piece: slot s + warp,
      // summed after the loop
      float* dst = whole ? dfeat + (static_cast<size_t>(b) * N + n) * C + c0
                         : slot_s + (s + warp) * tc;
      for (int c = lane; c < cw; c += 32) {
        float sum = red[c];
#pragma unroll
        for (int r = 1; r < kChunk; ++r) sum += red[r * tcp + c];
        dst[c] = sum;
      }
    }
    if (want_dkw) {  // d_kw[p,c] += feat[b,n,c] H[p,c], feat staged
      const float* fs = stage_w + kChunk * tcp;
#pragma unroll
      for (int grp = 0; grp < kMaxGroups; ++grp) {
        if (grp < ng) {
          const int c = grp * 8 + 2 * t;
          const float2 f = *reinterpret_cast<const float2*>(fs + c);
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
        if (max(range_start(w, T), first) < min(range_start(w + 1, T), last)) {
          sum += slot_s[(s + w) * tc + c];
          ++pieces;
        }
      }
      if (pieces != 1)
        dfeat[(static_cast<size_t>(b) * N + n0 + s) * C + c0 + c] =
            pieces ? sum : 0.f;
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
//   d_rel[b,m,k] = sum_p dw[b,m,k,p] (rel[b,m,k] - kp[p])
//                        * sum_c kw[p,c] g[b,m,c] feat[b, idx[b,m,k], c]
//
// with dw = mask * (d infl / d rel) / (rel - kp): -1 / (extent d) for linear
// influence where 0 < d < extent (0 where the influence is clamped, and 0
// at d = 0, the where-guarded sqrt's subgradient), -2 infl / gauss_denom
// for gaussian.  A block owns kRelTileM queries and kRelTileC channels, one
// per thread of a row; each thread reduces its channel's share for one
// neighbour, the warp sums its 32 channels by shuffles and lane 0 adds the
// 3-vector to d_rel with float32 atomics (one per channel tile).

constexpr int kRelTileM = 8;
constexpr int kRelTileC = 32;
constexpr int kRelRows = 4;
constexpr int kRelThreads = kRelTileC * kRelRows;

template <int INFL>
__global__ void __launch_bounds__(kRelThreads)
kpconv_bwd_drel(const float* __restrict__ feat, const int* __restrict__ idx,
                const float* __restrict__ rel, const float* __restrict__ mask,
                const float* __restrict__ kp, const float* __restrict__ kw,
                const float* __restrict__ gout, float* __restrict__ drel,
                int N, int M, int K, int C, int P, float extent,
                float gauss_denom) {
  extern __shared__ float4 rsmem4[];
  float* dw_s = reinterpret_cast<float*>(rsmem4);  // [kRelTileM][K][kPPad]
  int* idx_s = reinterpret_cast<int*>(dw_s + kRelTileM * K * kPPad);
  float* kp_s = reinterpret_cast<float*>(idx_s + kRelTileM * K);  // [kPPad][3]

  const int c0 = blockIdx.x * kRelTileC;
  const int m0 = blockIdx.y * kRelTileM;
  const int b = blockIdx.z;
  const int tm = min(kRelTileM, M - m0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kRelTileC + tx;
  const size_t row0 = (static_cast<size_t>(b) * M + m0) * K;

  for (int i = tid; i < kPPad * 3; i += kRelThreads)
    kp_s[i] = i < P * 3 ? kp[i] : 0.f;
  for (int i = tid; i < tm * K; i += kRelThreads) idx_s[i] = idx[row0 + i];
  __syncthreads();

  for (int e = tid; e < tm * K * kPPad; e += kRelThreads) {
    const int p = e % kPPad;
    const size_t row = row0 + e / kPPad;
    float dw = 0.f;
    if (p < P) {
      const float msk = mask[row];
      const float dx = rel[row * 3 + 0] - kp_s[p * 3 + 0];
      const float dy = rel[row * 3 + 1] - kp_s[p * 3 + 1];
      const float dz = rel[row * 3 + 2] - kp_s[p * 3 + 2];
      const float sq = dx * dx + dy * dy + dz * dz;
      if (INFL == kLinear) {
        const float d = sq > 0.f ? sqrtf(sq) : 0.f;
        const float infl = fmaxf(1.f - d / extent, 0.f);
        if (d > 0.f && infl > 0.f) dw = -msk / (extent * d);
      } else {
        dw = -2.f * expf(-sq / gauss_denom) * msk / gauss_denom;
      }
    }
    dw_s[e] = dw;
  }
  __syncthreads();

  const int c = c0 + tx;
  const bool c_ok = c < C;
  float kw_r[kPPad];
#pragma unroll
  for (int p = 0; p < kPPad; ++p)
    kw_r[p] = (c_ok && p < P) ? kw[p * C + c] : 0.f;
  const float* fb = feat + static_cast<size_t>(b) * N * C;
  // every lane walks the queries (its shuffles need the whole warp); a lane
  // past C adds zeros
  for (int m = ty; m < tm; m += kRelRows) {
    const float gv =
        c_ok ? gout[(static_cast<size_t>(b) * M + m0 + m) * C + c] : 0.f;
    const int* im = idx_s + m * K;
    for (int k = 0; k < K; ++k) {
      const float f =
          c_ok ? __ldg(fb + static_cast<size_t>(im[k]) * C + c) : 0.f;
      const size_t row = row0 + static_cast<size_t>(m) * K + k;
      const float4* dwm =
          reinterpret_cast<const float4*>(dw_s) + (m * K + k) * (kPPad / 4);
      const float rx = __ldg(rel + row * 3 + 0);
      const float ry = __ldg(rel + row * 3 + 1);
      const float rz = __ldg(rel + row * 3 + 2);
      float zx = 0.f, zy = 0.f, zz = 0.f;
#pragma unroll
      for (int q = 0; q < kPPad / 4; ++q) {
        const float4 d4 = dwm[q];
        const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * q + i;
          const float a = dq[i] * kw_r[p];
          zx = fmaf(a, rx - kp_s[p * 3 + 0], zx);
          zy = fmaf(a, ry - kp_s[p * 3 + 1], zy);
          zz = fmaf(a, rz - kp_s[p * 3 + 2], zz);
        }
      }
      const float s = gv * f;
      zx *= s;
      zy *= s;
      zz *= s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        zx += __shfl_xor_sync(kFull, zx, o);
        zy += __shfl_xor_sync(kFull, zy, o);
        zz += __shfl_xor_sync(kFull, zz, o);
      }
      if (tx == 0) {
        atomicAdd(drel + row * 3 + 0, zx);
        atomicAdd(drel + row * 3 + 1, zy);
        atomicAdd(drel + row * 3 + 2, zz);
      }
    }
  }
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

template <int INFL>
cudaError_t launch(const float* feat, const int* idx, const float* rel,
                   const float* mask, const float* kp, const float* kw,
                   const float* g, float* dfeat, float* dkw, float* dkw_part,
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
    const Tile tl(ng, slices);
    const size_t smem = tl.bytes();
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = set_smem(kpconv_bwd_kernel<INFL>, smem);
    if (err != cudaSuccess) return err;
    const int vec4 = C % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kw) % 16 == 0;
    const dim3 grid((C + tl.tc - 1) / tl.tc, (N + kTileN - 1) / kTileN, B);
    kpconv_bwd_kernel<INFL><<<grid, kThreads, smem, stream>>>(
        feat, rel, mask, kp, kw, g, offsets, edges, dfeat, dkw_part, N, M, K,
        C, P, ng, slices, vec4, 1.f / extent, 1.f / gauss_denom, want_dfeat,
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
  if (want_drel && INFL != kConstant) {  // constant: d_rel stays zero
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(kRelTileM) * K * kPPad + kRelTileM * K +
         kPPad * 3);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = set_smem(kpconv_bwd_drel<INFL>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((C + kRelTileC - 1) / kRelTileC,
                    (M + kRelTileM - 1) / kRelTileM, B);
    kpconv_bwd_drel<INFL><<<grid, dim3(kRelTileC, kRelRows), smem, stream>>>(
        feat, idx, rel, mask, kp, kw, g, drel, N, M, K, C, P, extent,
        gauss_denom);
    err = cudaGetLastError();
  }
  return err;
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
// (B, M, K, 3) must hold zeros.  A pointer that is not wanted may be null.
extern "C" int kpconv_bwd(const void* feat, const void* idx, const void* rel,
                          const void* mask, const void* kp, const void* kw,
                          const void* g, void* dfeat, void* dkw,
                          void* dkw_part, void* drel, void* scratch, int B,
                          int N, int M, int K, int C, int P, int influence,
                          float extent, float gauss_denom, int want_dfeat,
                          int want_dkw, int want_drel, int device,
                          void* stream) {
  if (P < 1 || P > kPPad || influence < 0 || influence > 2 ||
      (want_dfeat && dfeat == nullptr) ||
      (want_dkw && (dkw == nullptr || dkw_part == nullptr)) ||
      ((want_dfeat || want_dkw) && scratch == nullptr) ||
      (want_drel && drel == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!want_dfeat && !want_dkw && !want_drel) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const float*>(feat);
  const auto* i = static_cast<const int*>(idx);
  const auto* r = static_cast<const float*>(rel);
  const auto* m = static_cast<const float*>(mask);
  const auto* p = static_cast<const float*>(kp);
  const auto* w = static_cast<const float*>(kw);
  const auto* gr = static_cast<const float*>(g);
  auto* df = static_cast<float*>(dfeat);
  auto* dw = static_cast<float*>(dkw);
  auto* part = static_cast<float*>(dkw_part);
  auto* dr = static_cast<float*>(drel);
  auto* sc = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (influence) {
    case kConstant:
      err = launch<kConstant>(f, i, r, m, p, w, gr, df, dw, part, dr, sc, B,
                              N, M, K, C, P, extent, gauss_denom, want_dfeat,
                              want_dkw, want_drel, s);
      break;
    case kLinear:
      err = launch<kLinear>(f, i, r, m, p, w, gr, df, dw, part, dr, sc, B, N,
                            M, K, C, P, extent, gauss_denom, want_dfeat,
                            want_dkw, want_drel, s);
      break;
    default:
      err = launch<kGaussian>(f, i, r, m, p, w, gr, df, dw, part, dr, sc, B,
                              N, M, K, C, P, extent, gauss_denom, want_dfeat,
                              want_dkw, want_drel, s);
      break;
  }
  return static_cast<int>(err);
}
