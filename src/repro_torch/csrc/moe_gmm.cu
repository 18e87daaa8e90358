// Grouped expert FFN (SwiGLU) over MoE capacity buffers.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, function `moe_ffn_gmm`
// (Pallas body `_gmm_kernel`).
//
// Computes  out[e] = (silu(buf[e] @ wg[e]) * (buf[e] @ wi[e])) @ wo[e]
// for buf (E, C, D), wi/wg (E, D, F), wo (E, F, D), all f32 or all bf16,
// and writes the output in buf's dtype. Rows of zeros (the capacity
// padding) give rows of zeros.
//
// What bounds it on the H100: operations. At the moonshot-v1-16b-a3b
// prefill shape (E 64, C 960, D 2048, F 1408, bf16) the call does 1.06 TFLOP
// and moves 1.61 GB: 1.07 ms at the 989 TFLOP/s bf16 tensor-core rate, 15.9
// ms at the 67 TFLOP/s f32 rate.
//
// Two paths, chosen by dtype (kernels/moe_gmm/ops.py says the same); each
// returns an error for what it does not take, and nothing falls back:
//
// * bf16: the tensor cores, through `wgmma` fed by TMA. Two passes of one
//   warp-specialised GEMM kernel (`tc::gemm_kernel`). A block computes a
//   128 x 128 output tile of one expert: one producer warp issues TMA loads
//   of 64-deep K slices into a ring of shared-memory stages (A 128 x 64,
//   each B 64 x 128 as two 64-column boxes, all 128-byte swizzled) and
//   signals an mbarrier per stage; two consumer warpgroups each own 64 rows
//   and run `wgmma.m64n128k16` (f32 accumulators) on the stages that have
//   arrived, keeping one K slice of products in flight while they release
//   the stage before it. Pass 1 reads wg and wi (two accumulators, g and u)
//   and writes silu(g) * u, rounded once to bf16, to a bf16 (E, C, F)
//   scratch H (173 MB at the main shape); pass 2 computes H @ wo. Tensor
//   maps are 3-D (E, rows, cols), so a tile at an expert's ragged C edge
//   reads zeros, not the next expert's rows; ragged K and N edges read
//   zeros too. The weights are (K, N) with N contiguous: they are the
//   MN-major B operand through wgmma's transpose bit, in place. TMA needs
//   16-byte row strides, so the wrapper pads D and F to multiples of 8.
// * f32: the CUDA cores, the reference's f32 math. Pass 1 (`swiglu_kernel`)
//   computes both up-projections of a 64 x 64 tile of (C, F) from one shared
//   A tile and writes silu(g) * u to an f32 scratch; pass 2 (`down_kernel`)
//   computes H @ wo. 256 threads own a 4 x 4 register block of the tile each
//   (rows ty + 16 i, columns tx + 16 j), walking the contraction in steps of
//   16 through shared memory; ragged edges load zeros and store nothing.
//   Products of bf16 or TF32 inputs cannot meet the reference's f32
//   tolerance (2e-4), so f32 stays here.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <math.h>

#include <initializer_list>

#include "common.cuh"

namespace repro_torch {
namespace {

// ---- f32: the CUDA cores -------------------------------------------------

constexpr int BM = 64, BN = 64, BKD = 16;  // output tile and contraction step
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // A tile stored k-major, padded

// Adds A[m0:m0+BM, :] @ Bs[:, n0:n0+BN] to acc[s] for each of the NB
// right-hand matrices (A row-major (M, K), each B row-major (K, N)).
template <int NB>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* const* Bs, int64_t M, int64_t N,
                                          int64_t K, int64_t m0, int64_t n0,
                                          float (&acc)[NB][4][4], float* sA, float* sB) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int64_t k0 = 0; k0 < K; k0 += BKD) {
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < BM * BKD; e += THREADS) {
      const int r = e / BKD, kk = e % BKD;
      const int64_t gm = m0 + r, gk = k0 + kk;
      sA[kk * LDA + r] = (gm < M && gk < K) ? A[gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      for (int e = tid; e < BKD * BN; e += THREADS) {
        const int kk = e / BN, c = e % BN;
        const int64_t gk = k0 + kk, gn = n0 + c;
        sB[(s * BKD + kk) * BN + c] = (gk < K && gn < N) ? Bs[s][gk * N + gn] : 0.f;
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
__global__ void __launch_bounds__(THREADS)
    swiglu_kernel(const float* __restrict__ buf, const float* __restrict__ wi,
                  const float* __restrict__ wg, float* __restrict__ h, int64_t C, int64_t D,
                  int64_t F) {
  __shared__ float sA[BKD * LDA];
  __shared__ float sB[2 * BKD * BN];
  const int64_t e = blockIdx.z, m0 = blockIdx.y * int64_t(BM), n0 = blockIdx.x * int64_t(BN);
  const float* Bs[2] = {wg + e * D * F, wi + e * D * F};
  float acc[2][4][4] = {};
  gemm_tile<2>(buf + e * C * D, Bs, C, F, D, m0, n0, acc, sA, sB);
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

// Pass 2: out[e] = h[e] @ wo[e], (C, D) f32.
__global__ void __launch_bounds__(THREADS)
    down_kernel(const float* __restrict__ h, const float* __restrict__ wo,
                float* __restrict__ out, int64_t C, int64_t D, int64_t F) {
  __shared__ float sA[BKD * LDA];
  __shared__ float sB[BKD * BN];
  const int64_t e = blockIdx.z, m0 = blockIdx.y * int64_t(BM), n0 = blockIdx.x * int64_t(BN);
  const float* Bs[1] = {wo + e * F * D};
  float acc[1][4][4] = {};
  gemm_tile<1>(h + e * C * F, Bs, C, D, F, m0, n0, acc, sA, sB);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c < D) out[(e * C + r) * D + c] = acc[0][i][j];
    }
  }
}

int launch_f32(const float* buf, const float* wi, const float* wg, const float* wo, float* h,
               float* out, int64_t E, int64_t C, int64_t D, int64_t F, cudaStream_t stream) {
  const unsigned tiles_c = static_cast<unsigned>((C + BM - 1) / BM);
  const dim3 grid1(static_cast<unsigned>((F + BN - 1) / BN), tiles_c, static_cast<unsigned>(E));
  swiglu_kernel<<<grid1, THREADS, 0, stream>>>(buf, wi, wg, h, C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(static_cast<unsigned>((D + BN - 1) / BN), tiles_c, static_cast<unsigned>(E));
  down_kernel<<<grid2, THREADS, 0, stream>>>(h, wo, out, C, D, F);
  return cudaGetLastError();
}

// ---- bf16: the tensor cores (wgmma fed by TMA) ------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64;     // output tile, K slice
constexpr int CONSUMERS = 2;                   // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;         // one 64-column box of B: 8 KB
constexpr int B_BYTES = 2 * BOX_BYTES;         // a 64 x 128 B tile
// ring depth: pass 1 (two B tiles) 4 x 48 KB, pass 2 (one) 6 x 32 KB
template <int NB>
__host__ __device__ constexpr int stages() { return NB == 2 ? 4 : 6; }
template <int NB>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + NB * B_BYTES; }
template <int NB>
constexpr size_t smem_bytes() {
  // the ring, its full and empty barriers, and slack to align the ring to
  // the 1024 bytes the 128-byte swizzle repeats over
  return size_t(stages<NB>()) * stage_bytes<NB>() + 2 * stages<NB>() * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 f32, this warpgroup's fragment) += A (64 x 16, K-major) . B
// (16 x 128, MN-major: transposed through imm-trans-b = 1).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
#define REPRO_R8(i)                                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : REPRO_R8(0), REPRO_R8(8), REPRO_R8(16), REPRO_R8(24), REPRO_R8(32), REPRO_R8(40),
        REPRO_R8(48), REPRO_R8(56)
      : "l"(da), "l"(db), "r"(1));
#undef REPRO_R8
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One 128 x 128 tile of expert blockIdx.z: rows blockIdx.y, columns
// blockIdx.x. NB == 2: out = silu(A @ B0) * (A @ B1) (pass 1, into H);
// NB == 1: out = A @ B0 (pass 2). `out` is (E, M, N) bf16, row stride N;
// K is the contraction length the tensor maps cover.
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b0,
                const __grid_constant__ CUtensorMap map_b1, bf16* __restrict__ out,
                int M, int N, int K) {
  constexpr int S = stages<NB>(), STAGE = stage_bytes<NB>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + S * STAGE, empty = full + S * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const CUtensorMap* maps[2] = {&map_b0, &map_b1};
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(empty + 8 * s, (kt / S - 1) & 1);
        const uint32_t bar = full + 8 * s, st = ring + s * STAGE;
        mbar_expect_tx(bar, STAGE);
        tma_load(st, &map_a, bar, kt * BK, m0, e);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t b = st + A_BYTES + j * B_BYTES;
          tma_load(b, maps[j], bar, n0, kt * BK, e);
          tma_load(b + BOX_BYTES, maps[j], bar, n0 + 64, kt * BK, e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[NB][64];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(full + 8 * s, (kt / S) & 1);
    const uint32_t st = ring + s * STAGE;
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: K-major, 128-byte rows; 16 K values are 32 bytes along the row
      const uint64_t da = sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // B: MN-major; 16 K rows of 128 bytes; the second 64 columns one box on
        const uint64_t db = sw128_desc(st + A_BYTES + j * B_BYTES + kk * 16 * 128, BOX_BYTES,
                                       1024);
        wgmma_128(acc[j], da, db);
      }
    }
    wgmma_commit();
    // keep this slice's products in flight; release the slice before it
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((kt - 1) % S));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_acc(acc[j]);

  // accumulator fragment: register 4 c + 2 h + i holds row 16 (warp % 4) +
  // lane / 4 + 8 h, column 8 c + 2 (lane % 4) + i of the warpgroup's 64 x 128
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  bf16* base = out + static_cast<int64_t>(e) * M * N;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = col0 + 8 * c;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      float x0 = acc[0][4 * c + 2 * hh], x1 = acc[0][4 * c + 2 * hh + 1];
      if constexpr (NB == 2) {
        x0 = x0 / (1.f + __expf(-x0)) * acc[1][4 * c + 2 * hh];
        x1 = x1 / (1.f + __expf(-x1)) * acc[1][4 * c + 2 * hh + 1];
      }
      // N is a multiple of 8, so a column pair is all in or all out
      if (row < M && col < N)
        *reinterpret_cast<__nv_bfloat162*>(base + static_cast<int64_t>(row) * N + col) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda) looked up through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 (E, rows, cols) row-major tensor as a 3-D map read in boxes of
// 64 columns x box_rows rows, 128-byte swizzled; outside the tensor reads 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t E, int64_t rows, int64_t cols,
                uint32_t box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(E)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2, cuuint64_t(rows * cols) * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
cudaError_t launch_pass(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1,
                        bf16* out, int64_t E, int64_t M, int64_t N, int64_t K,
                        cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NB>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN), static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(E));
  gemm_kernel<NB><<<grid, THREADS, bytes, stream>>>(a, b0, b1, out, static_cast<int>(M),
                                                    static_cast<int>(N), static_cast<int>(K));
  return cudaGetLastError();
}

// buf (E, C, D), wi/wg (E, D, F), wo (E, F, D), h (E, C, F), out (E, C, D),
// all bf16 with D and F multiples of 8 and 16-byte-aligned bases.
int launch(const void* buf, const void* wi, const void* wg, const void* wo, void* h, void* out,
           int64_t E, int64_t C, int64_t D, int64_t F, cudaStream_t stream) {
  if (D % 8 || F % 8 || E > 65535 || C > INT32_MAX || !encode_tiled())
    return cudaErrorInvalidValue;
  for (const void* p : {buf, wi, wg, wo, static_cast<const void*>(h), static_cast<const void*>(out)})
    if (!aligned_to(p, 16)) return cudaErrorInvalidValue;
  CUtensorMap m_buf, m_wg, m_wi, m_h, m_wo;
  if (!tensor_map(&m_buf, buf, E, C, D, BM) || !tensor_map(&m_wg, wg, E, D, F, BK) ||
      !tensor_map(&m_wi, wi, E, D, F, BK) || !tensor_map(&m_h, h, E, C, F, BM) ||
      !tensor_map(&m_wo, wo, E, F, D, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_pass<2>(m_buf, m_wg, m_wi, static_cast<bf16*>(h), E, C, F, D, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<1>(m_h, m_wo, m_wo, static_cast<bf16*>(out), E, C, D, F, stream);
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

extern "C" int moe_ffn_gmm(const void* buf, const void* wi, const void* wg, const void* wo,
                           void* h, void* out, int64_t E, int64_t C, int64_t D, int64_t F,
                           int64_t dtype, void* stream) {
  using namespace repro_torch;
  if (E * C * D == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32(static_cast<const float*>(buf), static_cast<const float*>(wi),
                      static_cast<const float*>(wg), static_cast<const float*>(wo),
                      static_cast<float*>(h), static_cast<float*>(out), E, C, D, F, s);
  if (dtype == kBFloat16) return tc::launch(buf, wi, wg, wo, h, out, E, C, D, F, s);
  return cudaErrorInvalidValue;
}
