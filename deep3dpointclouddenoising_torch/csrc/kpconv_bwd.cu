// KPConv (pseudo-grid) aggregation, backward, for Hopper (sm_90a).
//
// With w[b,m,k,p] = infl(|rel[b,m,k] - kp[p]|) * mask[b,m,k] and the
// upstream gradient g (B, M, C) of the forward's output:
//
//   d_feat[b,n,c] = sum_{m,k: idx[b,m,k] = n} (sum_p w[b,m,k,p] kw[p,c])
//                                             * g[b,m,c]
//   d_kw[p,c]     = sum_{b,m} g[b,m,c] * per_kp[b,m,p,c],
//   per_kp[b,m,p,c] = sum_k w[b,m,k,p] * feat[b, idx[b,m,k], c]
//
// and, only when asked (the DREL template flag; the training path does not
// ask, so its code and launches are those without it), the gradient in the
// relative positions:
//
//   d_rel[b,m,k] = sum_p dw[b,m,k,p] (rel[b,m,k] - kp[p])
//                        * sum_c kw[p,c] g[b,m,c] feat[b, idx[b,m,k], c]
//
// where w = mask * infl(sq) and dw = mask * (d infl / d rel) / (rel - kp):
// -1 / (extent d) for linear influence where 0 < d < extent (0 where the
// influence is clamped, and 0 at d = 0, the where-guarded sqrt's
// subgradient), -2 infl / gauss_denom for gaussian, 0 for constant.
//
// Replaces the Pallas TPU kernel _bwd_kernel_onehot
// (deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:361), launched by
// _bwd_pallas_onehot (:459) from the custom VJP's _vjp_bwd (:530), and the
// jnp segment-sum fallback _vjp_bwd takes for supports above 2048 points and
// for constant influence (:535-572).  Those limits were the TPU's VMEM and
// one-hot matmul limits; this kernel reads neighbours by index and covers
// every N and all three influences.
//
// Design.  Per_kp is exactly the set of register partials the forward
// kernel builds for one (m, c), so the backward keeps the forward's shape:
// a block owns one cloud b, a tile of kTileM queries and a tile of kTileC
// channels.  It computes the tile's influence weights once into shared
// memory (float32, exact subtract-square distances, as the forward and the
// plain version do), then each thread owns one channel c, holds kw[:, c] in
// registers, and walks its queries.  For each neighbour (m, k) it loads
// feat[idx, c] once (coalesced across the warp's channels) and spends P FMAs
// on per_kp and P FMAs on wc = sum_p w kw[p,c]; wc * g[m,c] goes to
// d_feat[b, idx, c] by one float32 atomicAdd (a RED, coalesced across the
// warp).  Splitting channels over blocks gives the deep levels (M = 3..31,
// C = 576..1152) hundreds of blocks instead of a handful.
//
// Reductions.  d_feat: float32 atomics into a buffer the wrapper zeroes.
// Their order changes from run to run, so d_feat is not bitwise
// reproducible; each element is a sum of at most a few hundred terms and
// differs between runs by a few float32 ulps of its terms, far inside the
// rtol 3e-4 held against the plain version.  d_kw: deterministic.  Each
// block reduces its threads' (P, kTileC) partials in shared memory in a
// fixed order and writes them to its own slot of a partial buffer
// (B * ceil(M / kTileM), P, C); a second kernel sums the slots in a fixed
// order.  Query rows past M (the ragged edge of the last tile) are skipped,
// which is what the TPU kernel's row zeroing (:398-408) achieves; padded
// query rows inside M have mask all ones and contribute, as in JAX.
//
// d_rel (DREL): each thread reduces its channel's share of the sum over c
// for one neighbour, sum_p dw_p kw[p,c] (rel - kp_p) times g[m,c] f[c],
// the warp sums its 32 channels by shuffles and lane 0 adds the 3-vector to
// d_rel with float32 atomics (one per channel tile), into a buffer the
// wrapper zeroes.  dw is computed beside w into shared memory.
//
// What bounds it on this card: about twice the forward's float32
// operations (2 P FMAs per (b, m, k, c) instead of P, plus the influence
// weights and P per (b, m, c)), some hundreds per byte of input, so the
// FMA rate and not HBM is the bound; chip_smoke.py computes it per call.
// Register use and spills are printed by the build (-Xptxas -v) and kept in
// PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 8;    // queries per block
constexpr int kTileC = 32;   // channels per block, one per thread of a row
constexpr int kRows = 4;     // thread rows, each walking kTileM / kRows queries
constexpr int kThreads = kTileC * kRows;
constexpr int kPPad = 16;    // kernel points, padded to four float4
constexpr int kReduceRows = 8;

enum Influence { kConstant = 0, kLinear = 1, kGaussian = 2 };

template <int INFL, bool DREL>
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                  const float* __restrict__ rel,
                  const float* __restrict__ mask,
                  const float* __restrict__ kp, const float* __restrict__ kw,
                  const float* __restrict__ g, float* __restrict__ dfeat,
                  float* __restrict__ dkw_part, float* __restrict__ drel,
                  int N, int M, int K, int C, int P, float extent,
                  float gauss_denom, int want_dfeat, int want_dkw) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);        // [kTileM][K][kPPad]
  int* idx_s = reinterpret_cast<int*>(w_s + kTileM * K * kPPad);  // [kTileM][K]
  float* kp_s = reinterpret_cast<float*>(idx_s + kTileM * K);     // [kPPad][3]
  float* red_s = kp_s + kPPad * 3;                  // [kRows][kPPad][kTileC]
  float* dw_s = red_s + kRows * kPPad * kTileC;   // DREL: [kTileM][K][kPPad]

  const int c0 = blockIdx.x * kTileC;
  const int mt = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = mt * kTileM;
  const int tm = min(kTileM, M - m0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileC + tx;
  const size_t row0 = (static_cast<size_t>(b) * M + m0) * K;

  for (int i = tid; i < kPPad * 3; i += kThreads)
    kp_s[i] = i < P * 3 ? kp[i] : 0.f;
  for (int i = tid; i < tm * K; i += kThreads) idx_s[i] = idx[row0 + i];
  __syncthreads();

  // influence weights of the tile, the forward kernel's arithmetic
  for (int e = tid; e < tm * K * kPPad; e += kThreads) {
    const int p = e % kPPad;
    const size_t row = row0 + e / kPPad;
    float w = 0.f;
    float dw = 0.f;
    if (p < P) {
      const float msk = mask[row];
      if (INFL == kConstant) {
        w = msk;
      } else {
        const float dx = rel[row * 3 + 0] - kp_s[p * 3 + 0];
        const float dy = rel[row * 3 + 1] - kp_s[p * 3 + 1];
        const float dz = rel[row * 3 + 2] - kp_s[p * 3 + 2];
        const float sq = dx * dx + dy * dy + dz * dz;
        float infl;
        if (INFL == kLinear) {
          const float d = sq > 0.f ? sqrtf(sq) : 0.f;
          infl = fmaxf(1.f - d / extent, 0.f);
          if (DREL && d > 0.f && infl > 0.f) dw = -msk / (extent * d);
        } else {
          infl = expf(-sq / gauss_denom);
          if (DREL) dw = -2.f * infl * msk / gauss_denom;
        }
        w = infl * msk;
      }
    }
    w_s[e] = w;
    if (DREL) dw_s[e] = dw;
  }
  __syncthreads();

  const int c = c0 + tx;
  const bool c_ok = c < C;
  float kw_r[kPPad];
  float dkw_acc[kPPad];
#pragma unroll
  for (int p = 0; p < kPPad; ++p) {
    kw_r[p] = (c_ok && p < P) ? kw[p * C + c] : 0.f;
    dkw_acc[p] = 0.f;
  }
  const float* fb = feat + static_cast<size_t>(b) * N * C;
  float* db = dfeat + static_cast<size_t>(b) * N * C;
  // with DREL every lane walks the queries (its shuffles need the whole
  // warp); a lane past C adds zeros
  if (DREL || c_ok) {
    for (int m = ty; m < tm; m += kRows) {
      const float gv = !DREL || c_ok
          ? g[(static_cast<size_t>(b) * M + m0 + m) * C + c] : 0.f;
      const float4* wm = smem4 + static_cast<size_t>(m) * K * (kPPad / 4);
      const int* im = idx_s + m * K;
      float acc[kPPad];
#pragma unroll
      for (int p = 0; p < kPPad; ++p) acc[p] = 0.f;
      for (int k = 0; k < K; ++k) {
        const size_t off = static_cast<size_t>(im[k]) * C + c;
        float w[kPPad];
#pragma unroll
        for (int q = 0; q < kPPad / 4; ++q) {
          const float4 w4 = wm[k * (kPPad / 4) + q];
          w[4 * q + 0] = w4.x;
          w[4 * q + 1] = w4.y;
          w[4 * q + 2] = w4.z;
          w[4 * q + 3] = w4.w;
        }
        if (want_dkw && (!DREL || c_ok)) {
          const float f = __ldg(fb + off);
#pragma unroll
          for (int p = 0; p < kPPad; ++p) acc[p] = fmaf(w[p], f, acc[p]);
        }
        if (want_dfeat && (!DREL || c_ok)) {
          float wc = 0.f;
#pragma unroll
          for (int p = 0; p < kPPad; ++p) wc = fmaf(w[p], kw_r[p], wc);
          atomicAdd(db + off, wc * gv);
        }
        if (DREL) {
          const float f = c_ok ? __ldg(fb + off) : 0.f;
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
            zx += __shfl_xor_sync(0xffffffffu, zx, o);
            zy += __shfl_xor_sync(0xffffffffu, zy, o);
            zz += __shfl_xor_sync(0xffffffffu, zz, o);
          }
          if (tx == 0) {
            atomicAdd(drel + row * 3 + 0, zx);
            atomicAdd(drel + row * 3 + 1, zy);
            atomicAdd(drel + row * 3 + 2, zz);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kPPad; ++p) dkw_acc[p] = fmaf(acc[p], gv, dkw_acc[p]);
    }
  }
  if (!want_dkw) return;  // uniform over the block

  // the block's (P, kTileC) partial of d_kw: rows summed in a fixed order
#pragma unroll
  for (int p = 0; p < kPPad; ++p)
    red_s[(ty * kPPad + p) * kTileC + tx] = dkw_acc[p];
  __syncthreads();
  float* part = dkw_part + static_cast<size_t>(b * gridDim.y + mt) * P * C;
  for (int e = tid; e < P * kTileC; e += kThreads) {
    const int p = e / kTileC;
    const int x = e - p * kTileC;
    if (c0 + x >= C) continue;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += red_s[(r * kPPad + p) * kTileC + x];
    part[p * C + c0 + x] = s;
  }
}

// d_kw[e] = sum over slots i (in order) of part[i][e], e over P * C.  Threads
// of a row take consecutive e (coalesced); the kReduceRows rows take slots
// i = row, row + kReduceRows, ... and are summed in a fixed order.
__global__ void __launch_bounds__(kTileC * kReduceRows)
kpconv_bwd_reduce(const float* __restrict__ part, float* __restrict__ dkw,
                  int slots, int PC) {
  __shared__ float red_s[kReduceRows][kTileC];
  const int e = blockIdx.x * kTileC + threadIdx.x;
  float s = 0.f;
  if (e < PC) {
    for (int i = threadIdx.y; i < slots; i += kReduceRows)
      s += part[static_cast<size_t>(i) * PC + e];
  }
  red_s[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < PC) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) t += red_s[r][threadIdx.x];
    dkw[e] = t;
  }
}

int num_slots(int B, int M) { return B * ((M + kTileM - 1) / kTileM); }

template <int INFL, bool DREL>
cudaError_t launch(const float* feat, const int* idx, const float* rel,
                   const float* mask, const float* kp, const float* kw,
                   const float* g, float* dfeat, float* dkw, float* dkw_part,
                   float* drel, int B, int N, int M, int K, int C, int P,
                   float extent, float gauss_denom, int want_dfeat,
                   int want_dkw, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kTileM) * K * kPPad * (DREL ? 2 : 1) +
       kTileM * K + kPPad * 3 + kRows * kPPad * kTileC);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kpconv_bwd_kernel<INFL, DREL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + kTileC - 1) / kTileC, (M + kTileM - 1) / kTileM, B);
  kpconv_bwd_kernel<INFL, DREL><<<grid, dim3(kTileC, kRows), smem, stream>>>(
      feat, idx, rel, mask, kp, kw, g, dfeat, dkw_part, drel, N, M, K, C, P,
      extent, gauss_denom, want_dfeat, want_dkw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_dkw) return err;
  const int PC = P * C;
  kpconv_bwd_reduce<<<(PC + kTileC - 1) / kTileC, dim3(kTileC, kReduceRows),
                      0, stream>>>(dkw_part, dkw, num_slots(B, M), PC);
  return cudaGetLastError();
}

template <int INFL>
cudaError_t launch_influence(const float* feat, const int* idx,
                             const float* rel, const float* mask,
                             const float* kp, const float* kw, const float* g,
                             float* dfeat, float* dkw, float* dkw_part,
                             float* drel, int B, int N, int M, int K, int C,
                             int P, float extent, float gauss_denom,
                             int want_dfeat, int want_dkw, int want_drel,
                             cudaStream_t stream) {
  if (want_drel)
    return launch<INFL, true>(feat, idx, rel, mask, kp, kw, g, dfeat, dkw,
                              dkw_part, drel, B, N, M, K, C, P, extent,
                              gauss_denom, want_dfeat, want_dkw, stream);
  return launch<INFL, false>(feat, idx, rel, mask, kp, kw, g, dfeat, dkw,
                             dkw_part, drel, B, N, M, K, C, P, extent,
                             gauss_denom, want_dfeat, want_dkw, stream);
}

}  // namespace

// Slots of the d_kw partial buffer the wrapper allocates: (slots, P, C).
extern "C" int kpconv_bwd_num_slots(int B, int M) { return num_slots(B, M); }

// Launches on `stream` and does not synchronise.  Returns the CUDA error
// code of the launches (0 on success).  influence: 0 constant, 1 linear,
// 2 gaussian.  All tensors are contiguous float32 (idx int32) on `device`.
// With want_dfeat, dfeat (B, N, C) must hold zeros; with want_dkw, dkw is
// (P, C) and dkw_part (kpconv_bwd_num_slots(B, M), P, C) scratch; with
// want_drel, drel (B, M, K, 3) must hold zeros.  A pointer that is not
// wanted may be null.
extern "C" int kpconv_bwd(const void* feat, const void* idx, const void* rel,
                          const void* mask, const void* kp, const void* kw,
                          const void* g, void* dfeat, void* dkw,
                          void* dkw_part, void* drel, int B, int N, int M,
                          int K, int C, int P, int influence, float extent,
                          float gauss_denom, int want_dfeat, int want_dkw,
                          int want_drel, int device, void* stream) {
  if (P < 1 || P > kPPad || influence < 0 || influence > 2 ||
      (want_dfeat && dfeat == nullptr) ||
      (want_dkw && (dkw == nullptr || dkw_part == nullptr)) ||
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
  auto s = static_cast<cudaStream_t>(stream);
  switch (influence) {
    case kConstant:
      err = launch_influence<kConstant>(f, i, r, m, p, w, gr, df, dw, part,
                                        dr, B, N, M, K, C, P, extent,
                                        gauss_denom, want_dfeat, want_dkw,
                                        want_drel, s);
      break;
    case kLinear:
      err = launch_influence<kLinear>(f, i, r, m, p, w, gr, df, dw, part, dr,
                                      B, N, M, K, C, P, extent, gauss_denom,
                                      want_dfeat, want_dkw, want_drel, s);
      break;
    default:
      err = launch_influence<kGaussian>(f, i, r, m, p, w, gr, df, dw, part,
                                        dr, B, N, M, K, C, P, extent,
                                        gauss_denom, want_dfeat, want_dkw,
                                        want_drel, s);
      break;
  }
  return static_cast<int>(err);
}
