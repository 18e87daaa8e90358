// Mamba2 SSD (state-space duality) chunked scan with the state carried
// across chunks.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, function `ssd_scan`
// (Pallas body `_ssd_kernel`).
//
// For each (batch b, head h) and each chunk of `chunk` positions, with
// a = inclusive cumsum of dA over the chunk:
//   y[i]   = sum_{j<=i} (C[i] . B[j]) exp(a[i] - a[j]) x[j]      (intra-chunk)
//          + exp(a[i]) C[i] . state                              (carry-in)
//   state <- state exp(a[c-1]) + sum_j x[j] (B[j] exp(a[c-1] - a[j]))
// x (B,L,H,P), dA (B,L,H) f32, B/C (B,L,H,N) -> y (B,L,H,P) f32 and the
// final state (B,H,P,N) f32. All math f32; x and B/C may be bf16.
//
// What bounds it on the H100: at the mamba2-780m prefill shape (x
// (2,4096,48,64) f32, N 128, chunk 256) the lower-triangular work it needs
// is about 32 GFLOP (51.5 with the whole c x c square counted). It reads
// B/C through a head stride of 0 (the model passes the un-broadcast (B,L,N)
// tensor as a stride-0 view) instead of the f32 per-head broadcast copy the
// model's plain path materializes (about 400 MB more), so it moves about
// 210 MB: x and y in f32 dominate. Its f32 math runs on the CUDA cores: at
// the 67 TFLOP/s f32 rate the operations take about 0.48 ms against 0.06 ms
// for the bytes, so the bound it is held to is operations.
//
// What the design does about it: one block per (b, h) walks the chunks in
// order, so the (P, N) state stays in shared memory from one chunk to the
// next (the TPU's sequential chunk grid axis becomes this loop). A whole
// chunk's B and C rows (256 x 128 f32 = 128 KB each) do not fit beside the
// state, so the chunk is cut into row tiles of 64: for each tile of output
// rows the kernel starts from the carry-in term and adds the lower-
// triangular tiles of (C B^T) * L times x, one 64-row tile of B and x at a
// time. exp(a[i] - a[j]) is computed only where i >= j (for i < j it can
// overflow). The state update runs after all output tiles of the chunk, as
// the reference emits the state entering each chunk. Rows in shared memory
// are padded by one float so the column walks hit distinct banks.
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // rows of a chunk handled at a time

struct Layout {
  int64_t P, N, chunk;
  int64_t ldn;  // padded row stride of the N-wide tiles (N + 1)
  float *state, *c_rows, *b_rows, *x_rows, *scores, *y_acc, *a_cs;
};

inline size_t smem_floats(int64_t P, int64_t N, int64_t chunk) {
  const int64_t ldn = N + 1;
  return static_cast<size_t>(P * ldn + 2 * TILE * ldn + TILE * P + TILE * (TILE + 1) +
                             TILE * P + chunk);
}

__device__ inline Layout carve(float* smem, int64_t P, int64_t N, int64_t chunk) {
  Layout s;
  s.P = P;
  s.N = N;
  s.chunk = chunk;
  s.ldn = N + 1;
  s.state = smem;
  s.c_rows = s.state + P * s.ldn;
  s.b_rows = s.c_rows + TILE * s.ldn;
  s.x_rows = s.b_rows + TILE * s.ldn;
  s.scores = s.x_rows + TILE * P;
  s.y_acc = s.scores + TILE * (TILE + 1);
  s.a_cs = s.y_acc + TILE * P;
  return s;
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                    const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ final_state, int64_t L,
                    int64_t H, int64_t P, int64_t N, int64_t chunk, int64_t bc_sb,
                    int64_t bc_sl, int64_t bc_sh) {
  extern __shared__ float smem[];
  const Layout s = carve(smem, P, N, chunk);
  const int tid = threadIdx.x;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t ldn = s.ldn;

  for (int64_t e = tid; e < P * N; e += THREADS) s.state[(e / N) * ldn + e % N] = 0.f;

  const TBC* b_base = Bm + b * bc_sb + h * bc_sh;
  const TBC* c_base = Cm + b * bc_sb + h * bc_sh;
  auto x_at = [&](int64_t l, int64_t p) { return to_f32(x[((b * L + l) * H + h) * P + p]); };

  for (int64_t l0 = 0; l0 < L; l0 += chunk) {
    __syncthreads();  // the previous chunk's state update is done
    // inclusive cumsum of dA over the chunk: warp 0, 32 positions a step
    if (tid < 32) {
      float carry = 0.f;
      for (int64_t base = 0; base < chunk; base += 32) {
        const int64_t i = base + tid;
        float val = i < chunk ? dA[(b * L + l0 + i) * H + h] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, val, off);
          if (tid >= off) val += up;
        }
        val += carry;
        if (i < chunk) s.a_cs[i] = val;
        carry = __shfl_sync(0xffffffffu, val, 31);
      }
    }
    __syncthreads();
    const float total = s.a_cs[chunk - 1];

    for (int64_t i0 = 0; i0 < chunk; i0 += TILE) {
      const int64_t ti = min64(TILE, chunk - i0);
      __syncthreads();  // the previous tile's reads of c_rows and y_acc are done
      for (int64_t e = tid; e < ti * N; e += THREADS) {
        const int64_t i = e / N, n = e % N;
        s.c_rows[i * ldn + n] = to_f32(c_base[(l0 + i0 + i) * bc_sl + n]);
      }
      __syncthreads();
      // carry-in: y[i, p] = exp(a[i]) * C[i] . state[p]
      for (int64_t e = tid; e < ti * P; e += THREADS) {
        const int64_t i = e / P, p = e % P;
        float dot = 0.f;
        for (int64_t n = 0; n < N; ++n) dot = fmaf(s.c_rows[i * ldn + n], s.state[p * ldn + n], dot);
        s.y_acc[i * P + p] = dot * expf(s.a_cs[i0 + i]);
      }
      // intra-chunk: lower-triangular tiles j0 <= i0
      for (int64_t j0 = 0; j0 <= i0; j0 += TILE) {
        const int64_t tj = min64(TILE, chunk - j0);
        __syncthreads();  // the previous tile's reads of b_rows, x_rows, scores are done
        for (int64_t e = tid; e < tj * N; e += THREADS) {
          const int64_t j = e / N, n = e % N;
          s.b_rows[j * ldn + n] = to_f32(b_base[(l0 + j0 + j) * bc_sl + n]);
        }
        for (int64_t e = tid; e < tj * P; e += THREADS) {
          const int64_t j = e / P, p = e % P;
          s.x_rows[j * P + p] = x_at(l0 + j0 + j, p);
        }
        __syncthreads();
        for (int64_t e = tid; e < ti * TILE; e += THREADS) {
          const int64_t i = e / TILE, j = e % TILE;
          const int64_t gi = i0 + i, gj = j0 + j;
          float val = 0.f;
          if (j < tj && gi >= gj) {  // exp only where i >= j
            float dot = 0.f;
            for (int64_t n = 0; n < N; ++n)
              dot = fmaf(s.c_rows[i * ldn + n], s.b_rows[j * ldn + n], dot);
            val = dot * expf(s.a_cs[gi] - s.a_cs[gj]);
          }
          s.scores[i * (TILE + 1) + j] = val;
        }
        __syncthreads();
        for (int64_t e = tid; e < ti * P; e += THREADS) {
          const int64_t i = e / P, p = e % P;
          float acc = s.y_acc[i * P + p];
          for (int64_t j = 0; j < tj; ++j)
            acc = fmaf(s.scores[i * (TILE + 1) + j], s.x_rows[j * P + p], acc);
          s.y_acc[i * P + p] = acc;
        }
      }
      __syncthreads();
      for (int64_t e = tid; e < ti * P; e += THREADS) {
        const int64_t i = e / P, p = e % P;
        y[((b * L + l0 + i0 + i) * H + h) * P + p] = s.y_acc[i * P + p];
      }
    }

    // state <- state * exp(total) + sum_j x[j] (B[j] exp(total - a[j]))
    const float chunk_decay = expf(total);
    for (int64_t e = tid; e < P * N; e += THREADS) s.state[(e / N) * ldn + e % N] *= chunk_decay;
    for (int64_t j0 = 0; j0 < chunk; j0 += TILE) {
      const int64_t tj = min64(TILE, chunk - j0);
      __syncthreads();  // the previous reads of b_rows and x_rows are done
      for (int64_t e = tid; e < tj * N; e += THREADS) {
        const int64_t j = e / N, n = e % N;
        s.b_rows[j * ldn + n] = to_f32(b_base[(l0 + j0 + j) * bc_sl + n]);
      }
      for (int64_t e = tid; e < tj * P; e += THREADS) {
        const int64_t j = e / P, p = e % P;
        s.x_rows[j * P + p] = x_at(l0 + j0 + j, p) * expf(total - s.a_cs[j0 + j]);
      }
      __syncthreads();
      for (int64_t e = tid; e < P * N; e += THREADS) {
        const int64_t p = e / N, n = e % N;
        float acc = 0.f;
        for (int64_t j = 0; j < tj; ++j)
          acc = fmaf(s.x_rows[j * P + p], s.b_rows[j * ldn + n], acc);
        s.state[p * ldn + n] += acc;
      }
    }
  }
  __syncthreads();
  for (int64_t e = tid; e < P * N; e += THREADS)
    final_state[((b * H + h) * P) * N + e] = s.state[(e / N) * ldn + e % N];
}

template <typename TX, typename TBC>
int launch(const void* x, const void* dA, const void* Bm, const void* Cm, void* y,
           void* fin, int64_t Bsz, int64_t L, int64_t H, int64_t P, int64_t N,
           int64_t chunk, int64_t sb, int64_t sl, int64_t sh, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<TX, TBC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(Bsz));
  ssd_scan_kernel<TX, TBC><<<grid, THREADS, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const TBC*>(Bm), static_cast<const TBC*>(Cm), static_cast<float*>(y),
      static_cast<float*>(fin), L, H, P, N, chunk, sb, sl, sh);
  return cudaGetLastError();
}

template <typename TX>
int dispatch_bc(int64_t bc_dtype, const void* x, const void* dA, const void* Bm,
                const void* Cm, void* y, void* fin, int64_t Bsz, int64_t L, int64_t H,
                int64_t P, int64_t N, int64_t chunk, int64_t sb, int64_t sl, int64_t sh,
                cudaStream_t s) {
  if (bc_dtype == kFloat32)
    return launch<TX, float>(x, dA, Bm, Cm, y, fin, Bsz, L, H, P, N, chunk, sb, sl, sh, s);
  if (bc_dtype == kBFloat16)
    return launch<TX, __nv_bfloat16>(x, dA, Bm, Cm, y, fin, Bsz, L, H, P, N, chunk, sb,
                                     sl, sh, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

extern "C" int ssd_scan(const void* x, const void* dA, const void* Bm, const void* Cm,
                        void* y, void* fin, int64_t Bsz, int64_t L, int64_t H, int64_t P,
                        int64_t N, int64_t chunk, int64_t bc_sb, int64_t bc_sl,
                        int64_t bc_sh, int64_t x_dtype, int64_t bc_dtype, void* stream) {
  using namespace repro_torch;
  if (Bsz * H == 0) return cudaSuccess;
  if (chunk <= 0 || L % chunk) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32)
    return dispatch_bc<float>(bc_dtype, x, dA, Bm, Cm, y, fin, Bsz, L, H, P, N, chunk,
                              bc_sb, bc_sl, bc_sh, s);
  if (x_dtype == kBFloat16)
    return dispatch_bc<__nv_bfloat16>(bc_dtype, x, dA, Bm, Cm, y, fin, Bsz, L, H, P, N,
                                      chunk, bc_sb, bc_sl, bc_sh, s);
  return cudaErrorInvalidValue;
}
