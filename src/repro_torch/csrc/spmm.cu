// Padded-COO batch SpMM: the sparse input layer of the XML MLP.
//
// Replaces: src/repro/kernels/spmm/spmm.py, function `spmm` (Pallas body
// `_make_kblocked_kernel`), which gathers W rows into VMEM by
// scalar-prefetched indices and accumulates them in f32.
//
// Computes, for every replica r and batch row b,
//   out[r, b, :] = sum_k val[r,b,k] * mask[r,b,k] * W[r, idx[r,b,k], :]
// accumulated in f32 and written in W's dtype (f32 or bf16). Masked slots
// are multiplied in (scale 0), not skipped, as in the reference; their idx
// must still be a valid row.
//
// What bounds it on the H100: device-memory bytes. The function needs each
// distinct W row that an unmasked slot names (H elements, read once), plus
// idx/val/mask and the output, at 2 flops per needed element, far below
// the card's flop-per-byte ridge. This kernel gathers a row for every slot:
// padding slots name row 0, which stays in cache, and a row that several
// slots name is read again unless it is still in L2.
//
// What the design does about it: one block per (replica, batch row), so
// even a single-replica call of B rows spreads over every SM; each thread
// owns VEC consecutive columns and reads them with one vector load per
// slot (16 bytes for f32, 8 for bf16), so a warp reads a whole W row of
// H = 128 in one coalesced pass. idx/val/mask of a row are
// the same address across its threads (a broadcast load). The K loop is
// unrolled so several row gathers are in flight per thread. The TPU
// kernel's K padding and H padding are not needed: K is a plain loop bound,
// and an H that is not a multiple of VEC runs the scalar variant, whose
// threads past H return early.
#include "common.cuh"

namespace repro_torch {
namespace {

template <typename T, int VEC>
__global__ void spmm_rows_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ val,
                                 const uint8_t* __restrict__ mask,
                                 const T* __restrict__ w, T* __restrict__ out,
                                 int64_t B, int64_t K, int64_t NF, int64_t H) {
  const int64_t row = blockIdx.x;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= H) return;

  const T* wr = w + (row / B) * NF * H + col;  // this replica's W, this column
  const int32_t* ir = idx + row * K;
  const float* vr = val + row * K;
  const uint8_t* mr = mask + row * K;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

#pragma unroll 4
  for (int64_t k = 0; k < K; ++k) {
    const float s = vr[k] * static_cast<float>(mr[k]);
    const Pack<T, VEC> p = load_pack<T, VEC>(wr + static_cast<int64_t>(ir[k]) * H);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += s * to_f32(p.v[j]);
  }

  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
  store_pack<T, VEC>(out + row * H + col, o);
}

template <typename T, int VEC>
cudaError_t launch(const void* idx, const void* val, const void* mask,
                   const void* w, void* out, int64_t R, int64_t B, int64_t K,
                   int64_t NF, int64_t H, cudaStream_t stream) {
  const int64_t cols = (H + VEC - 1) / VEC;
  // threads across columns: a multiple of the warp, at most 128 (wider H
  // takes more blocks along y)
  const int threads = cols >= 128 ? 128 : static_cast<int>((cols + 31) / 32 * 32);
  const dim3 grid(static_cast<unsigned>(R * B),
                  static_cast<unsigned>((cols + threads - 1) / threads));
  spmm_rows_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(w),
      static_cast<T*>(out), B, K, NF, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// idx (R,B,K) int32, val (R,B,K) f32, mask (R,B,K) bool, w (R,NF,H) and
// out (R,B,H) in `dtype`; all contiguous on the device of `stream`.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int spmm_forward(const void* idx, const void* val, const void* mask,
                            const void* w, void* out, int64_t R, int64_t B,
                            int64_t K, int64_t NF, int64_t H, int64_t dtype,
                            void* stream) {
  using namespace repro_torch;
  if (R * B == 0 || H == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (H % 4 == 0 && aligned_to(w, 16) && aligned_to(out, 16))
      return launch<float, 4>(idx, val, mask, w, out, R, B, K, NF, H, s);
    return launch<float, 1>(idx, val, mask, w, out, R, B, K, NF, H, s);
  }
  if (dtype == kBFloat16) {
    if (H % 4 == 0 && aligned_to(w, 8) && aligned_to(out, 8))
      return launch<__nv_bfloat16, 4>(idx, val, mask, w, out, R, B, K, NF, H, s);
    return launch<__nv_bfloat16, 1>(idx, val, mask, w, out, R, B, K, NF, H, s);
  }
  return cudaErrorInvalidValue;
}
