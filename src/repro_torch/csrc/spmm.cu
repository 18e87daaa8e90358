// Padded-COO batch SpMM: the sparse input layer of the XML MLP.
//
// Replaces: src/repro/kernels/spmm/spmm.py, function `spmm` (Pallas body
// `_make_kblocked_kernel`), which gathers W rows into VMEM by
// scalar-prefetched indices and accumulates them in f32.
//
// Computes, for every replica r and batch row b,
//   out[r, b, :] = sum_k val[r,b,k] * mask[r,b,k] * W[r, idx[r,b,k], :]
// accumulated in f32 and written in W's dtype (f32 or bf16). Masked slots
// are multiplied in with a scale of exactly 0 (the reference's `val * mask`
// is a select, whatever val holds): a non-finite value in the W row a
// masked slot names reaches the output as NaN. Their idx must still be a
// valid row.
//
// What bounds it on the H100: device-memory bytes. The function needs each
// distinct W row that an unmasked slot names (H elements, read once), plus
// idx/val/mask and the output, at 2 flops per needed element, far below
// the card's flop-per-byte ridge. The gathers are short (512 bytes for an
// f32 row at H = 128) and scattered, so the time is latency: the bytes a SM
// has in flight set the rate (Little's law: about 20 KB a SM at 3.35 TB/s).
//
// What the design does about it: one block of 128 threads per (replica,
// batch row). The block first stages the row's slots (idx, scale) in shared
// memory and compacts them, in slot order, dropping every zero-scale slot
// whose previous slot names the same row with a zero scale too: such a slot
// adds 0 * W[row] again, which is +-0 where the row is finite and NaN where
// an earlier kept slot already put NaN, so the sum is unchanged. The padding
// of a sample (a run of masked slots naming row 0) thus costs one gather,
// not one per slot. The kept slots are then dealt round-robin to the
// block's slot groups (4 warps at H = 128), each thread owning VEC
// consecutive columns; a thread issues 8 row gathers on the read-only path
// before their multiply-adds, so a block has up to 16 KB in flight. The
// groups' partial sums are added through shared memory in group order, so
// two launches give bitwise-equal output (no atomics). An H that is not a
// multiple of VEC runs the scalar variant, whose threads past H gather
// column 0 and store nothing; H wider than 128 threads x VEC takes more
// blocks along y.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;                       // threads a block, at most
constexpr int kSlotsPerThread = 4;                  // consecutive slots a thread stages
constexpr int kTile = kThreads * kSlotsPerThread;   // slots staged at a time, at most
constexpr int kInFlight = 8;                        // W rows a thread gathers at once

// blockDim.x threads across columns (a multiple of 32) x blockDim.y slot
// groups; blockIdx.x is the (replica, batch row), blockIdx.y the column block
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_rows_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                 const uint8_t* __restrict__ mask, const T* __restrict__ w,
                 T* __restrict__ out, int64_t B, int64_t K, int64_t NF, int64_t H) {
  __shared__ int32_t s_row[kTile];
  __shared__ float s_scale[kTile];
  __shared__ int s_scan[kThreads / 32];
  __shared__ float s_part[kThreads * VEC];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int groups = blockDim.y;
  const int64_t row = blockIdx.x;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  const bool has_col = col < H;
  const T* wr = w + (row / B) * NF * H + (has_col ? col : 0);  // this replica's W
  const int32_t* ir = idx + row * K;
  const float* vr = val + row * K;
  const uint8_t* mr = mask + row * K;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += n_threads * kSlotsPerThread) {
    // stage: this thread's consecutive slots, and the one before them
    const int64_t first = k0 + static_cast<int64_t>(tid) * kSlotsPerThread;
    int32_t prev_row = -1;
    bool prev_zero = false;
    if (first > 0 && first <= K) {
      prev_row = ir[first - 1];
      prev_zero = !mr[first - 1] || vr[first - 1] == 0.f;
    }
    int32_t rows[kSlotsPerThread];
    float scales[kSlotsPerThread];
    unsigned keep = 0;
    int n_keep = 0;
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int64_t k = first + j;
      if (k < K) {
        rows[j] = ir[k];
        scales[j] = mr[k] ? vr[k] : 0.f;
        const bool zero = scales[j] == 0.f;
        if (!(zero && prev_zero && rows[j] == prev_row)) {
          keep |= 1u << j;
          ++n_keep;
        }
        prev_row = rows[j];
        prev_zero = zero;
      }
    }
    int n_kept;
    int at = block_exclusive_scan(n_keep, s_scan, n_kept);
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      if (keep >> j & 1u) {
        s_row[at] = rows[j];
        s_scale[at] = scales[j];
        ++at;
      }
    }
    __syncthreads();

    // gather: slot group g takes kept slots g, g + groups, ... in order
    for (int e0 = threadIdx.y; e0 < n_kept; e0 += groups * kInFlight) {
      Pack<T, VEC> p[kInFlight];
      float c[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int e = e0 + i * groups;
        if (e < n_kept) {
          c[i] = s_scale[e];
          p[i] = ldg_pack<T, VEC>(wr + static_cast<int64_t>(s_row[e]) * H);
        }
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        if (e0 + i * groups < n_kept) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += c[i] * to_f32(p[i].v[j]);
        }
      }
    }
    __syncthreads();  // the next tile restages s_row / s_scale
  }

  // the groups' partial sums, added in group order
  if (groups > 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s_part[tid * VEC + j] = acc[j];
    __syncthreads();
    if (threadIdx.y == 0) {
      for (int g = 1; g < groups; ++g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += s_part[(g * blockDim.x + threadIdx.x) * VEC + j];
      }
    }
  }
  if (threadIdx.y == 0 && has_col) {
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
    store_pack<T, VEC>(out + row * H + col, o);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* idx, const void* val, const void* mask,
                   const void* w, void* out, int64_t R, int64_t B, int64_t K,
                   int64_t NF, int64_t H, cudaStream_t stream) {
  const int64_t cols = (H + VEC - 1) / VEC;
  // threads across columns: a multiple of the warp, at most 128; the rest
  // of the block's 128 threads are slot groups
  const int col_threads = cols >= kThreads ? kThreads : static_cast<int>((cols + 31) / 32 * 32);
  const dim3 block(col_threads, kThreads / col_threads);
  const dim3 grid(static_cast<unsigned>(R * B),
                  static_cast<unsigned>((cols + col_threads - 1) / col_threads));
  spmm_rows_kernel<T, VEC><<<grid, block, 0, stream>>>(
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
