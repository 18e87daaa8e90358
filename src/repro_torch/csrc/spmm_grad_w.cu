// Transpose SpMM: the gradient of the sparse input layer with respect to W.
//
// Replaces: src/repro/kernels/spmm/spmm.py, function `spmm_grad_w` (Pallas
// body `_grad_w_kernel`), which walks the row-sorted slots one grid step at
// a time and keeps the output row in VMEM for the whole run of equal rows.
//
// Computes, for every replica r and row n of W,
//   out[r, n, :] = sum over the slots s of replica r with rows[r, s] = n of
//                  scale[r, s] * dh[r, samp[r, s], :]
// in f32, from the slots sorted by row id (stable) in the wrapper
// (`kernels/spmm/ops.py::spmm_grad_w_cuda`): rows, samp = slot // K and
// scale = val * mask, all in sorted order. The wrapper zeroes `out`; rows
// that no slot names stay 0. Zero-scale (masked) slots are multiplied in,
// not skipped, as in the reference: a NaN in dh[b] reaches row idx[b, k].
//
// Deterministic: each output row is the sum of its run of sorted slots,
// added in sorted order, with no atomics. Two launches on the same inputs
// give bitwise-equal output.
//
// What bounds it on the H100: device-memory bytes. The function must write
// the dense (R, NF, H) f32 output (the wrapper's zero fill does most of
// that) and read the slots and one dh row per distinct (replica, sample);
// it does one multiply-add per slot and column.
//
// What the design does about it: the sorted slots are cut into fixed
// chunks of `chunk` slots, one block per (replica, chunk), so a run as long
// as the padding's (row 0 takes about two thirds of every replica's slots)
// spreads over many blocks instead of one serial walk. Pass 1: each block
// walks its chunk in order, each thread owning VEC consecutive columns; a
// run that starts and ends inside the chunk is written to `out` directly; the
// part of a run that entered from the previous chunk goes to head[chunk],
// and the start of a run that leaves into the next chunk to tail[chunk].
// Pass 2: the block of the chunk where a run starts adds its tail and the
// heads of the chunks the run covers, in chunk order, and writes the row.
// A warp reads a dh row of H = 128 as one 16-byte load per lane; the slot
// metadata of a step is one broadcast load.
#include "common.cuh"

namespace repro_torch {
namespace {

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&acc)[VEC]) {
  Pack<float, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = acc[j];
  store_pack<float, VEC>(p, o);
}

template <int VEC>
__global__ void grad_w_chunks_kernel(const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ samp,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ dh,
                                     float* __restrict__ out,
                                     float* __restrict__ head,
                                     float* __restrict__ tail, int64_t S,
                                     int64_t B, int64_t NF, int64_t H,
                                     int64_t chunk, int64_t n_chunks) {
  const int64_t block = blockIdx.x;  // (replica, chunk) flattened
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= H) return;
  const int64_t r = block / n_chunks;
  const int64_t lo = (block % n_chunks) * chunk;
  const int64_t hi = lo + chunk < S ? lo + chunk : S;

  const int32_t* rr = rows + r * S;
  const int32_t* sr = samp + r * S;
  const float* cr = scale + r * S;
  const float* dr = dh + r * B * H + col;
  float* outr = out + r * NF * H + col;

  // the run at lo entered from the previous chunk: its part here is a head
  bool in_head = lo > 0 && rr[lo - 1] == rr[lo];
  int32_t cur = rr[lo];
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

#pragma unroll 4
  for (int64_t s = lo; s < hi; ++s) {
    const int32_t row = rr[s];
    if (row != cur) {  // the run of `cur` ended at s - 1, inside this chunk
      if (in_head) {
        store_vec<VEC>(head + block * H + col, acc);
        in_head = false;
      } else if (cur >= 0 && cur < NF) {
        store_vec<VEC>(outr + static_cast<int64_t>(cur) * H, acc);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
      cur = row;
    }
    const float c = cr[s];
    const Pack<float, VEC> d = load_pack<float, VEC>(dr + static_cast<int64_t>(sr[s]) * H);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += c * d.v[j];
  }
  // the last run of the chunk
  if (in_head) {
    store_vec<VEC>(head + block * H + col, acc);
  } else if (hi < S && rr[hi] == cur) {
    store_vec<VEC>(tail + block * H + col, acc);
  } else if (cur >= 0 && cur < NF) {
    store_vec<VEC>(outr + static_cast<int64_t>(cur) * H, acc);
  }
}

template <int VEC>
__global__ void grad_w_carry_kernel(const int32_t* __restrict__ rows,
                                    const float* __restrict__ head,
                                    const float* __restrict__ tail,
                                    float* __restrict__ out, int64_t S,
                                    int64_t NF, int64_t H, int64_t chunk,
                                    int64_t n_chunks) {
  const int64_t block = blockIdx.x;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= H) return;
  const int64_t r = block / n_chunks;
  const int64_t c = block % n_chunks;
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk;
  if (hi >= S) return;  // the replica's last chunk: nothing leaves it
  const int32_t* rr = rows + r * S;
  const int32_t row = rr[hi - 1];
  // only a run that starts in this chunk and leaves it is this block's
  if (rr[hi] != row || (lo > 0 && rr[lo - 1] == row)) return;

  // the run ends at `end` (exclusive): the first slot past it with a
  // larger row, by binary search over the sorted rows after hi
  int64_t a = hi, b = S;
  while (a < b) {
    const int64_t m = a + (b - a) / 2;
    if (rr[m] == row) a = m + 1; else b = m;
  }
  const int64_t last = (a - 1) / chunk;  // the chunk holding the run's end

  float acc[VEC];
  const Pack<float, VEC> t = load_pack<float, VEC>(tail + block * H + col);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = t.v[j];
  const float* hr = head + (r * n_chunks) * H + col;
#pragma unroll 8
  for (int64_t k = c + 1; k <= last; ++k) {
    const Pack<float, VEC> p = load_pack<float, VEC>(hr + k * H);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += p.v[j];
  }
  if (row >= 0 && row < NF) store_vec<VEC>(out + (r * NF + row) * H + col, acc);
}

template <int VEC>
cudaError_t launch(const void* rows, const void* samp, const void* scale,
                   const void* dh, void* out, void* head, void* tail,
                   int64_t R, int64_t S, int64_t B, int64_t NF, int64_t H,
                   int64_t chunk, cudaStream_t stream) {
  const int64_t n_chunks = (S + chunk - 1) / chunk;
  const int64_t cols = (H + VEC - 1) / VEC;
  // threads across columns: a multiple of the warp, at most 128 (wider H
  // takes more blocks along y)
  const int threads = cols >= 128 ? 128 : static_cast<int>((cols + 31) / 32 * 32);
  const dim3 grid(static_cast<unsigned>(R * n_chunks),
                  static_cast<unsigned>((cols + threads - 1) / threads));
  const auto* rows_p = static_cast<const int32_t*>(rows);
  grad_w_chunks_kernel<VEC><<<grid, threads, 0, stream>>>(
      rows_p, static_cast<const int32_t*>(samp), static_cast<const float*>(scale),
      static_cast<const float*>(dh), static_cast<float*>(out),
      static_cast<float*>(head), static_cast<float*>(tail), S, B, NF, H, chunk,
      n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks < 2) return err;
  grad_w_carry_kernel<VEC><<<grid, threads, 0, stream>>>(
      rows_p, static_cast<const float*>(head), static_cast<const float*>(tail),
      static_cast<float*>(out), S, NF, H, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// rows/samp (R,S) int32 and scale (R,S) f32: the slots of each replica
// sorted by row; dh (R,B,H) f32; out (R,NF,H) f32, zeroed by the caller;
// head/tail (R*ceil(S/chunk), H) f32 scratch. All contiguous on the device
// of `stream`. Returns the cudaError_t of the launches (0 = launched).
extern "C" int spmm_grad_w(const void* rows, const void* samp, const void* scale,
                           const void* dh, void* out, void* head, void* tail,
                           int64_t R, int64_t S, int64_t B, int64_t NF, int64_t H,
                           int64_t chunk, void* stream) {
  using namespace repro_torch;
  if (R * S == 0 || H == 0) return cudaSuccess;
  if (chunk <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (H % 4 == 0 && aligned_to(dh, 16) && aligned_to(out, 16) &&
      aligned_to(head, 16) && aligned_to(tail, 16))
    return launch<4>(rows, samp, scale, dh, out, head, tail, R, S, B, NF, H, chunk, s);
  return launch<1>(rows, samp, scale, dh, out, head, tail, R, S, B, NF, H, chunk, s);
}
