// Forward attention with an online softmax, grouped-query native.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
// `flash_attention` (Pallas body `_flash_kernel`).
//
// Computes  o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / rep] * hd^-0.5
// over the allowed j) . v[b, j, h / rep]  for q (B, Sq, Hq, hd) and k, v
// (B, Skv, Hkv, hd), rep = Hq / Hkv. Allowed: j < Skv, and j <= i when
// causal, and i - j < window when window > 0. All math in f32; the output
// is written in q's dtype (f32 or bf16). A row with no allowed key gives 0.
//
// What bounds it on the H100: operations. At the llama3.2-1b prefill shape
// (q (2,4096,32,64), k/v (2,4096,8,64) bf16, causal) the call does about
// 137 GFLOP (half the square) and moves 84 MB: 0.139 ms at the 989 TFLOP/s
// bf16 tensor-core rate, 2.05 ms at the 67 TFLOP/s f32 rate.
//
// What the design does about it: this first version keeps the reference's
// f32 math on the CUDA cores (no tensor cores; a later version moves the two
// products to wgmma). One block per (q tile of 64 rows, q head, batch); the
// TPU's sequential KV grid axis becomes a loop inside the block, so the
// running max, sum and accumulator never leave the block. KV tiles the
// causal or window mask makes unreachable are never loaded. K and V are read
// from KV head h / rep in place: nothing is repeated in memory. 256 threads
// each own a 4 x 4 block of the 64 x 64 score tile and a 4 x (hd/16) block
// of the output accumulator, both in registers; the tiles of Q, K, V and P
// sit in shared memory with padded rows so column reads hit distinct banks.
// q tiles are issued heaviest first (last rows of a causal square).
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile of the inner loop
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDP = BK + 1;   // padded row stride of the P tile

template <int HD>
constexpr size_t smem_bytes() {
  // sQ, sK (BQ/BK x HD+1), sV (BK x HD), sP (BQ x LDP), m, l, corr (BQ each)
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LDP + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int64_t Sq,
                     int64_t Skv, int64_t Hq, int64_t Hkv, int causal,
                     int64_t window, float scale) {
  constexpr int LD = HD + 1;  // padded row stride: column reads conflict-free
  constexpr int NJ = HD / 16; // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * HD;
  float* sM = sP + BQ * LDP;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t n_qt = (Sq + BQ - 1) / BQ;
  const int64_t q0 = (n_qt - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (Hq / Hkv);

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int64_t s = q0 + r;
    sQ[r * LD + d] = s < Sq ? to_f32(q[((b * Sq + s) * Hq + h) * HD + d]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  // reachable keys: j < q0 + BQ (causal), j > q0 - window (window)
  int64_t kv_end = Skv;
  if (causal) kv_end = min64(kv_end, q0 + BQ);
  int64_t kv_begin = 0;
  if (window > 0) kv_begin = max64(0, q0 - window + 1);
  const int64_t t_begin = kv_begin / BK;
  const int64_t t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const int64_t s = k0 + r;
      const bool ok = s < Skv;
      const int64_t off = ((b * Skv + s) * Hkv + hk) * HD + d;
      sK[r * LD + d] = ok ? to_f32(k[off]) : 0.f;
      sV[r * HD + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int64_t qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int64_t kp = k0 + c;
        bool allow = kp < Skv;
        if (causal) allow = allow && qp >= kp;
        if (window > 0) allow = allow && qp - kp < window;
        sP[r * LDP + c] = allow ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sP + r * LDP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float x = row[c];
        const float p = x == -INFINITY ? 0.f : expf(x - m_safe);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
      if (part == 0) {
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int64_t s = q0 + r;
    if (s >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* out = o + ((b * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t causal,
           int64_t window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ), static_cast<unsigned>(Hq),
                  static_cast<unsigned>(B));
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq, Hkv, causal ? 1 : 0, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int64_t B,
                int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t hd,
                int64_t causal, int64_t window, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                               int64_t Hkv, int64_t hd, int64_t causal,
                               int64_t window, int64_t dtype, void* stream) {
  using namespace repro_torch;
  if (B * Sq * Hq == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal, window, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal,
                                      window, s);
  return cudaErrorInvalidValue;
}
