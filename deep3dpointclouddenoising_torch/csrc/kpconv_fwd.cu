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
// kernel with direct indexed loads covers both: a neighbour's feature row is
// read straight from the support table, which at the flagship sizes
// (N * C * 4 <= 144 KB per cloud) stays in L1/L2.
//
// What bounds it on this card: per (b, m, k, c) it does P multiply-adds, and
// the inputs are read once, so at P = 15 and K = 26..52 the work is some
// hundreds of float32 operations per byte of input: the float32 FMA rate
// (not memory) is the limit.  The design keeps that arithmetic on registers
// and off shared-memory traffic: the sum is reassociated as
//   out[c] = sum_p kw[p,c] * (sum_k w[k,p] * feat[idx[k], c]),
// so each thread holds the P partial sums of one (m, c) in registers and the
// inner loop over k is one coalesced load of the neighbour's feature (threads
// run across c) plus P FMAs whose weights arrive as four broadcast float4
// loads from shared memory.  The influence weights of a tile of kTileM
// queries are computed once per block (float32, exact subtract-square
// distances, as the plain version does) and shared by every channel; kw and
// the kernel points sit in shared memory.  Query rows past M (the ragged
// edge of the last tile) are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 8;    // queries per block
constexpr int kPPad = 16;    // kernel points, padded to four float4
constexpr int kThreads = 128;

enum Influence { kConstant = 0, kLinear = 1, kGaussian = 2 };

template <int INFL>
__global__ void __launch_bounds__(kThreads)
kpconv_fwd_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                  const float* __restrict__ rel,
                  const float* __restrict__ mask,
                  const float* __restrict__ kp, const float* __restrict__ kw,
                  float* __restrict__ out, int N, int M, int K, int C, int P,
                  float extent, float gauss_denom) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);        // [kTileM][K][kPPad]
  int* idx_s = reinterpret_cast<int*>(w_s + kTileM * K * kPPad);  // [kTileM][K]
  float* kw_s = reinterpret_cast<float*>(idx_s + kTileM * K);     // [P][C]
  float* kp_s = kw_s + P * C;                                     // [P][3]

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTileM;
  const int tm = min(kTileM, M - m0);
  const int tid = threadIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * M + m0) * K;

  for (int i = tid; i < P * C; i += kThreads) kw_s[i] = kw[i];
  for (int i = tid; i < P * 3; i += kThreads) kp_s[i] = kp[i];
  for (int i = tid; i < tm * K; i += kThreads) idx_s[i] = idx[row0 + i];
  __syncthreads();

  for (int e = tid; e < tm * K * kPPad; e += kThreads) {
    const int p = e % kPPad;
    const size_t row = row0 + e / kPPad;
    float w = 0.f;
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
        } else {
          infl = expf(-sq / gauss_denom);
        }
        w = infl * msk;
      }
    }
    w_s[e] = w;
  }
  __syncthreads();

  const float* fb = feat + static_cast<size_t>(b) * N * C;
  for (int mc = tid; mc < tm * C; mc += kThreads) {
    const int m = mc / C;
    const int c = mc - m * C;
    const float4* wm = smem4 + static_cast<size_t>(m) * K * (kPPad / 4);
    const int* im = idx_s + m * K;
    float acc[kPPad];
#pragma unroll
    for (int p = 0; p < kPPad; ++p) acc[p] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float f = __ldg(fb + static_cast<size_t>(im[k]) * C + c);
#pragma unroll
      for (int q = 0; q < kPPad / 4; ++q) {
        const float4 w4 = wm[k * (kPPad / 4) + q];
        acc[4 * q + 0] = fmaf(w4.x, f, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(w4.y, f, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w4.z, f, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w4.w, f, acc[4 * q + 3]);
      }
    }
    float o = 0.f;
#pragma unroll
    for (int p = 0; p < kPPad; ++p) {
      if (p < P) o = fmaf(kw_s[p * C + c], acc[p], o);
    }
    out[(static_cast<size_t>(b) * M + m0 + m) * C + c] = o;
  }
}

template <int INFL>
cudaError_t launch(const float* feat, const int* idx, const float* rel,
                   const float* mask, const float* kp, const float* kw,
                   float* out, int B, int N, int M, int K, int C, int P,
                   float extent, float gauss_denom, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kTileM) * K * kPPad + kTileM * K +
       static_cast<size_t>(P) * C + P * 3);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kpconv_fwd_kernel<INFL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + kTileM - 1) / kTileM, B);
  kpconv_fwd_kernel<INFL><<<grid, kThreads, smem, stream>>>(
      feat, idx, rel, mask, kp, kw, out, N, M, K, C, P, extent, gauss_denom);
  return cudaGetLastError();
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
  if (P < 1 || P > kPPad || influence < 0 || influence > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const float*>(feat);
  const auto* i = static_cast<const int*>(idx);
  const auto* r = static_cast<const float*>(rel);
  const auto* m = static_cast<const float*>(mask);
  const auto* p = static_cast<const float*>(kp);
  const auto* w = static_cast<const float*>(kw);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (influence) {
    case kConstant:
      err = launch<kConstant>(f, i, r, m, p, w, o, B, N, M, K, C, P, extent,
                              gauss_denom, s);
      break;
    case kLinear:
      err = launch<kLinear>(f, i, r, m, p, w, o, B, N, M, K, C, P, extent,
                            gauss_denom, s);
      break;
    default:
      err = launch<kGaussian>(f, i, r, m, p, w, o, B, N, M, K, C, P, extent,
                              gauss_denom, s);
      break;
  }
  return static_cast<int>(err);
}
