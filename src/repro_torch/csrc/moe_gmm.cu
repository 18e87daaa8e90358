// Grouped expert FFN (SwiGLU) over MoE capacity buffers.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, function `moe_ffn_gmm`
// (Pallas body `_gmm_kernel`).
//
// Computes  out[e] = (silu(buf[e] @ wg[e]) * (buf[e] @ wi[e])) @ wo[e]
// for buf (E, C, D), wi/wg (E, D, F), wo (E, F, D), all f32 or all bf16.
// All math f32; the output is written in buf's dtype. Rows of zeros (the
// capacity padding) give rows of zeros.
//
// What bounds it on the H100: operations. At the moonshot-v1-16b-a3b
// prefill shape (E 64, C 960, D 2048, F 1408, bf16) the call does 1.06 TFLOP
// and moves 1.61 GB: 1.07 ms at the 989 TFLOP/s bf16 tensor-core rate, 15.9
// ms at the 67 TFLOP/s f32 rate.
//
// What the design does about it: this first version keeps the reference's
// f32 math on the CUDA cores (no tensor cores yet) and runs in two passes.
// Pass 1 (`swiglu_kernel`) computes both up-projections of a 64 x 64 tile
// of (C, F) at once from one shared A tile, applies silu(g) * u, and writes
// the f32 intermediate H (E, C, F) to a scratch in device memory; pass 2
// (`down_kernel`) computes H @ wo. Unlike the reference, which keeps (C, F)
// out of device memory by accumulating over F in one grid step, this writes
// and reads the scratch once: E*C*F*4 bytes each way (346 MB at the main
// shape), which costs about 0.2 ms of memory time against the kernel's
// compute. Both passes share one tiled GEMM body: 256 threads own a 4 x 4
// register block of a 64 x 64 output tile (rows ty + 16 i, columns
// tx + 16 j), walking the contraction in steps of 16 through shared memory;
// ragged edges of C, D and F load zeros and store nothing.
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BM = 64, BN = 64, BKD = 16;  // output tile and contraction step
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // A tile stored k-major, padded

// Adds A[m0:m0+BM, :] @ Bs[:, n0:n0+BN] to acc[s] for each of the NB
// right-hand matrices (A row-major (M, K), each B row-major (K, N)).
template <typename TA, typename TB, int NB>
__device__ __forceinline__ void gemm_tile(const TA* __restrict__ A,
                                          const TB* const* Bs, int64_t M, int64_t N,
                                          int64_t K, int64_t m0, int64_t n0,
                                          float (&acc)[NB][4][4], float* sA, float* sB) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int64_t k0 = 0; k0 < K; k0 += BKD) {
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < BM * BKD; e += THREADS) {
      const int r = e / BKD, kk = e % BKD;
      const int64_t gm = m0 + r, gk = k0 + kk;
      sA[kk * LDA + r] = (gm < M && gk < K) ? to_f32(A[gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      for (int e = tid; e < BKD * BN; e += THREADS) {
        const int kk = e / BN, c = e % BN;
        const int64_t gk = k0 + kk, gn = n0 + c;
        sB[(s * BKD + kk) * BN + c] = (gk < K && gn < N) ? to_f32(Bs[s][gk * N + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKD; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(s * BKD + kk) * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][i][j] = fmaf(a[i], bv[j], acc[s][i][j]);
      }
    }
  }
}

// Pass 1: h[e] = silu(buf[e] @ wg[e]) * (buf[e] @ wi[e]), (C, F) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_kernel(const T* __restrict__ buf, const T* __restrict__ wi,
                  const T* __restrict__ wg, float* __restrict__ h, int64_t C, int64_t D,
                  int64_t F) {
  __shared__ float sA[BKD * LDA];
  __shared__ float sB[2 * BKD * BN];
  const int64_t e = blockIdx.z, m0 = blockIdx.y * int64_t(BM), n0 = blockIdx.x * int64_t(BN);
  const T* Bs[2] = {wg + e * D * F, wi + e * D * F};
  float acc[2][4][4] = {};
  gemm_tile<T, T, 2>(buf + e * C * D, Bs, C, F, D, m0, n0, acc, sA, sB);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c >= F) continue;
      const float g = acc[0][i][j];
      h[(e * C + r) * F + c] = g / (1.f + expf(-g)) * acc[1][i][j];
    }
  }
}

// Pass 2: out[e] = h[e] @ wo[e], (C, D) in T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    down_kernel(const float* __restrict__ h, const T* __restrict__ wo, T* __restrict__ out,
                int64_t C, int64_t D, int64_t F) {
  __shared__ float sA[BKD * LDA];
  __shared__ float sB[BKD * BN];
  const int64_t e = blockIdx.z, m0 = blockIdx.y * int64_t(BM), n0 = blockIdx.x * int64_t(BN);
  const T* Bs[1] = {wo + e * F * D};
  float acc[1][4][4] = {};
  gemm_tile<float, T, 1>(h + e * C * F, Bs, C, D, F, m0, n0, acc, sA, sB);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c < D) out[(e * C + r) * D + c] = from_f32<T>(acc[0][i][j]);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* wi, const void* wg, const void* wo, void* h,
           void* out, int64_t E, int64_t C, int64_t D, int64_t F, cudaStream_t stream) {
  const unsigned tiles_c = static_cast<unsigned>((C + BM - 1) / BM);
  const dim3 grid1(static_cast<unsigned>((F + BN - 1) / BN), tiles_c, static_cast<unsigned>(E));
  swiglu_kernel<T><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(wi), static_cast<const T*>(wg),
      static_cast<float*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(static_cast<unsigned>((D + BN - 1) / BN), tiles_c, static_cast<unsigned>(E));
  down_kernel<T><<<grid2, THREADS, 0, stream>>>(static_cast<const float*>(h),
                                                static_cast<const T*>(wo),
                                                static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" int moe_ffn_gmm(const void* buf, const void* wi, const void* wg, const void* wo,
                           void* h, void* out, int64_t E, int64_t C, int64_t D, int64_t F,
                           int64_t dtype, void* stream) {
  using namespace repro_torch;
  if (E * C * D == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(buf, wi, wg, wo, h, out, E, C, D, F, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(buf, wi, wg, wo, h, out, E, C, D, F, s);
  return cudaErrorInvalidValue;
}
