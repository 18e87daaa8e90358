// Algorithm 2's weighted model merge, with the global-momentum term fused.
//
// Replaces: src/repro/kernels/weighted_merge/weighted_merge.py, function
// `weighted_merge` (Pallas bodies `_merge_kernel` and
// `_merge_momentum_kernel`).
//
// Computes  out[i] = sum_r alpha[r] * rep[r, i]  (+ gamma * (g[i] - gp[i]))
// over replicas (R, N), accumulated in f32 and written in the replicas'
// dtype (f32 or bf16). The momentum variant runs when the caller asks for
// it (g given and gamma != 0, decided by the wrapper as in the reference).
//
// What bounds it on the H100: device-memory bytes. It reads every replica
// once and writes the result once ((R+1)*N*elt bytes, plus 2*N*elt for
// g/gp) and does 2 flops per element read.
//
// What the design does about it: one pass, no intermediate in device
// memory. A grid-stride loop walks N; each thread takes VEC consecutive
// elements with one 16-byte load per replica row (VEC = 4 for f32, 8 for
// bf16), so each warp streams 512 contiguous bytes of a row. The R weights
// sit in shared memory, read once per block. Vector access needs every
// replica row to start 16-byte aligned, i.e. N a multiple of VEC and
// aligned base pointers; any other N (a ragged leaf such as a bias of odd
// length) runs the scalar variant over the whole leaf.
#include "common.cuh"

namespace repro_torch {
namespace {

template <typename T, int VEC, bool MOMENTUM>
__global__ void merge_kernel(const T* __restrict__ reps,
                             const float* __restrict__ alphas,
                             const T* __restrict__ g, const T* __restrict__ gp,
                             float gamma, T* __restrict__ out, int64_t R,
                             int64_t N) {
  extern __shared__ float s_alpha[];
  for (int64_t r = threadIdx.x; r < R; r += blockDim.x) s_alpha[r] = alphas[r];
  __syncthreads();

  const int64_t n_packs = N / VEC;  // exact: VEC > 1 only when VEC divides N
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_packs; i += stride) {
    const int64_t off = i * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int64_t r = 0; r < R; ++r) {
      const Pack<T, VEC> p = load_pack<T, VEC>(reps + r * N + off);
      const float a = s_alpha[r];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += a * to_f32(p.v[j]);
    }
    if (MOMENTUM) {
      const Pack<T, VEC> pg = load_pack<T, VEC>(g + off);
      const Pack<T, VEC> pp = load_pack<T, VEC>(gp + off);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] += gamma * (to_f32(pg.v[j]) - to_f32(pp.v[j]));
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
    store_pack<T, VEC>(out + off, o);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2048;  // ~2 waves of 8 blocks on 132 SMs

template <typename T, int VEC>
cudaError_t launch(const void* reps, const void* alphas, const void* g,
                   const void* gp, float gamma, void* out, int64_t R,
                   int64_t N, bool momentum, cudaStream_t stream) {
  const int64_t n_packs = N / VEC;
  const int64_t want = (n_packs + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = static_cast<size_t>(R) * sizeof(float);
  const auto* rp = static_cast<const T*>(reps);
  const auto* ap = static_cast<const float*>(alphas);
  const auto* gq = static_cast<const T*>(g);
  const auto* gpq = static_cast<const T*>(gp);
  auto* op = static_cast<T*>(out);
  if (momentum)
    merge_kernel<T, VEC, true><<<blocks, kThreads, smem, stream>>>(rp, ap, gq, gpq, gamma, op, R, N);
  else
    merge_kernel<T, VEC, false><<<blocks, kThreads, smem, stream>>>(rp, ap, gq, gpq, gamma, op, R, N);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch(const void* reps, const void* alphas, const void* g,
                     const void* gp, float gamma, void* out, int64_t R,
                     int64_t N, bool momentum, cudaStream_t stream) {
  constexpr uintptr_t bytes = sizeof(T) * VEC;
  const bool vec = N % VEC == 0 && aligned_to(reps, bytes) && aligned_to(out, bytes) &&
                   (!momentum || (aligned_to(g, bytes) && aligned_to(gp, bytes)));
  if (vec) return launch<T, VEC>(reps, alphas, g, gp, gamma, out, R, N, momentum, stream);
  return launch<T, 1>(reps, alphas, g, gp, gamma, out, R, N, momentum, stream);
}

}  // namespace
}  // namespace repro_torch

// reps (R,N) and out (N,) in `dtype`, alphas (R,) f32, g/gp (N,) in
// `dtype` (read only when `momentum` != 0); all contiguous on the device
// of `stream`. Returns the cudaError_t of the launch (0 = launched).
extern "C" int weighted_merge(const void* reps, const void* alphas,
                              const void* g, const void* gp, float gamma,
                              void* out, int64_t R, int64_t N, int64_t dtype,
                              int64_t momentum, void* stream) {
  using namespace repro_torch;
  if (N == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float, 4>(reps, alphas, g, gp, gamma, out, R, N, momentum != 0, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, 8>(reps, alphas, g, gp, gamma, out, R, N, momentum != 0, s);
  return cudaErrorInvalidValue;
}
