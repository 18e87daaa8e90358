// The XML head's backward product dh = dlogits . W2^T, split along K.
//
// Replaces no TPU kernel: the reference leaves this product to XLA (the
// autograd of `jnp.matmul(h, w2)` in src/repro/models/xml_mlp.py). It was
// added because cuBLAS runs it as a batched GEMM on a 32x32 tile with no
// split of K: at the main shape, R = 4 outputs of 256 x 128 with
// K = NC = 670,091, that kernel reads about 11% of the card's f32 rate and
// took 44% of a training mega-batch's device time.
//
// Computes  out[r, b, n] = sum_k g[r, b, k] * w[r, n, k]  over g (R, B, NC)
// and w (R, H, NC), both f32 and contiguous (K-major), into out (R, B, H).
// f32 FFMA on the CUDA cores with f32 accumulators: no TF32 of any kind,
// since the configuration trains in f32 with TF32 off.
//
// What bounds it on the H100: operations. 2.R.B.H.NC = 175.7 GFLOP at the
// main shape is 2.62 ms at 67 TFLOP/s; its 4.1 GB of inputs are 1.23 ms at
// 3.35 TB/s.
//
// What the design does about it:
// - 256 x 128 output tiles (b by n), 256 threads, a 16 x 8 register tile a
//   thread: four 4-row groups 64 apart and two 4-column groups 64 apart, a
//   warp 4 threads tall and 8 wide, so each of its six 16-byte shared reads
//   a K-step is one conflict-free wavefront, for 128 FFMAs. The next K-step's
//   values are read while this one's FFMAs issue (229 registers, one block
//   an SM).
// - K-steps of 8 staged through a 6-stage cp.async ring, stored transposed
//   (k-major rows of 256 + 4 and 128 + 4 floats: 16-byte aligned for the
//   vector reads; one warp's copies, 4 rows by 8 k, hit 32 banks).
// - 4-byte copies along K: NC is odd, so no row after the first is 16-byte
//   aligned. That is one copy for 85 FFMAs a thread; the copies go through
//   L1 (.ca), where the neighbouring K-step finds a row's straddled sector.
// - K split into S chunks (the wrapper picks S from the shapes and the SM
//   count so that the blocks fill the card in about one wave: at the main
//   shape 4 output tiles x 33, the 2-D call 1 x 132). Each block writes its
//   partial tile to an f32 workspace; a second kernel adds the S partials
//   of each element in split order, so two calls give the same bits. No
//   atomics. With S = 1 the tile goes straight to the output.
// - Blocks are numbered with the b tile fastest: tiles that share one
//   replica's slice of w run side by side and find it in L2.
// Rows past B or H and columns past NC are zero-filled in shared memory
// and never stored. Of the tile shapes, K-steps, stage counts and register
// prefetch tried on an H100 (PERF.md §6), this one was fastest at both main
// shapes; the card runs it at its 700 W power limit.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 256;                 // rows of g (b) a block
constexpr int kBN = 128;                 // rows of w (n) a block
constexpr int kTM = 16, kTN = 8;         // a thread's register tile
constexpr int kBK = 8;                   // K a stage
constexpr int kStages = 6;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kLdG = kBM + 4, kLdW = kBN + 4;  // a staged k-row, padded
constexpr int kTileG = kBK * kLdG, kTileW = kBK * kLdW;
constexpr size_t kSmemBytes = sizeof(float) * kStages * (kTileG + kTileW);
constexpr int kCopyRows = kThreads / 8;  // rows one pass of copies covers
static_assert(kThreads == 256 && kBK == 8, "the copy and thread layouts assume these");

// 4 bytes global -> shared, zero-filled when !pred (nothing is read then)
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    xml_dh_gemm_kernel(const float* __restrict__ g, const float* __restrict__ w,
                       float* __restrict__ part, int64_t R, int64_t B, int64_t H, int64_t NC,
                       int64_t kchunk, int tiles_m, int tiles_n) {
  extern __shared__ __align__(16) float smem[];
  int64_t bid = blockIdx.x;
  const int tm = static_cast<int>(bid % tiles_m);
  bid /= tiles_m;
  const int tn = static_cast<int>(bid % tiles_n);
  bid /= tiles_n;
  const int64_t r = bid % R, s = bid / R;
  const int64_t k_begin = s * kchunk;
  const int64_t k_len = min64(kchunk, NC - k_begin);
  const int n_steps = static_cast<int>((k_len + kBK - 1) / kBK);

  // copies: k = lk and rows lrow + 32 j of each operand's tile
  const int tid = threadIdx.x;
  const int lrow = tid >> 3, lk = tid & 7;
  const int64_t m_row = static_cast<int64_t>(tm) * kBM + lrow;
  const int64_t n_row = static_cast<int64_t>(tn) * kBN + lrow;
  const float* g_src = g + (r * B + m_row) * NC + k_begin + lk;
  const float* w_src = w + (r * H + n_row) * NC + k_begin + lk;
  const int64_t pass = kCopyRows * NC;
  unsigned g_ok = 0, w_ok = 0;
#pragma unroll
  for (int j = 0; j < kBM / kCopyRows; ++j)
    g_ok |= static_cast<unsigned>(m_row + kCopyRows * j < B) << j;
#pragma unroll
  for (int j = 0; j < kBN / kCopyRows; ++j)
    w_ok |= static_cast<unsigned>(n_row + kCopyRows * j < H) << j;

  auto stage = [&](int step, int slot) {
    float* gs = smem + slot * (kTileG + kTileW);
    float* ws = gs + kTileG;
    const int64_t k0 = static_cast<int64_t>(step) * kBK;
    const bool k_ok = k0 + lk < k_len;
#pragma unroll
    for (int j = 0; j < kBM / kCopyRows; ++j) {
      const bool p = k_ok && ((g_ok >> j) & 1u);
      cp_async_f32(gs + lk * kLdG + lrow + kCopyRows * j, p ? g_src + j * pass + k0 : g, p);
    }
#pragma unroll
    for (int j = 0; j < kBN / kCopyRows; ++j) {
      const bool p = k_ok && ((w_ok >> j) & 1u);
      cp_async_f32(ws + lk * kLdW + lrow + kCopyRows * j, p ? w_src + j * pass + k0 : w, p);
    }
  };

  // compute: rows q*64 + ty*4 + {0..3} (q < 4), columns q*64 + tx*4 + {0..3}
  // (q < 2); a warp is 8 tx wide and 4 ty tall
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) stage(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step's tile is in; every thread is done with step - 1's slot
    const int next = step + kStages - 1;
    if (next < n_steps) stage(next, next % kStages);
    cp_async_commit();
    const float* gs = smem + (step % kStages) * (kTileG + kTileW);
    const float* ws = gs + kTileG;
    float a[2][kTM], b[2][kTN];
    auto fragments = [&](int kk, int buf) {
#pragma unroll
      for (int q = 0; q < kTM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(gs + kk * kLdG + q * 64 + ty * 4);
        a[buf][4 * q] = v.x, a[buf][4 * q + 1] = v.y, a[buf][4 * q + 2] = v.z,
        a[buf][4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kTN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ws + kk * kLdW + q * 64 + tx * 4);
        b[buf][4 * q] = v.x, b[buf][4 * q + 1] = v.y, b[buf][4 * q + 2] = v.z,
        b[buf][4 * q + 3] = v.w;
      }
    };
    fragments(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk + 1 < kBK) fragments(kk + 1, (kk + 1) & 1);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = part + (s * R + r) * B * H;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = static_cast<int64_t>(tm) * kBM + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t col = static_cast<int64_t>(tn) * kBN + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (col < H) out[row * H + col] = acc[i][j];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... + part[S-1][i], in that order
__global__ void xml_dh_gemm_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                          int64_t n, int64_t splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = part[i];
    for (int64_t s = 1; s < splits; ++s) acc += part[s * n + i];
    out[i] = acc;
  }
}

}  // namespace
}  // namespace repro_torch

// g (R, B, NC), w (R, H, NC), out (R, B, H): f32, contiguous, on the device
// of `stream`. `splits` chunks of `kchunk` columns of K (a multiple of 8;
// the last chunk may be shorter, none empty); with splits > 1, `part` holds
// splits * R * B * H floats of workspace. Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int xml_dh_gemm(const void* g, const void* w, void* part, void* out, int64_t R,
                           int64_t B, int64_t H, int64_t NC, int64_t splits, int64_t kchunk,
                           void* stream) {
  using namespace repro_torch;
  const int64_t n = R * B * H;
  if (n == 0) return cudaSuccess;
  if (splits < 1 || (splits > 1 && part == nullptr) || kchunk % kBK != 0 ||
      (NC > 0 && (splits - 1) * kchunk >= NC))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(xml_dh_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int tiles_m = static_cast<int>((B + kBM - 1) / kBM);
  const int tiles_n = static_cast<int>((H + kBN - 1) / kBN);
  const int64_t blocks = static_cast<int64_t>(tiles_m) * tiles_n * R * splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto* dst = static_cast<float*>(splits > 1 ? part : out);
  xml_dh_gemm_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), dst, R, B, H, NC, kchunk,
      tiles_m, tiles_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t want = (n + 255) / 256;
  const unsigned red_blocks = static_cast<unsigned>(want < 2048 ? want : 2048);
  xml_dh_gemm_reduce_kernel<<<red_blocks, 256, 0, st>>>(dst, static_cast<float*>(out), n, splits);
  return cudaGetLastError();
}
