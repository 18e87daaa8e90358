// Forward attention with an online softmax, grouped-query native.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
// `flash_attention` (Pallas body `_flash_kernel`).
//
// Computes  o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / rep] * hd^-0.5
// over the allowed j) . v[b, j, h / rep]  for q (B, Sq, Hq, hd) and k, v
// (B, Skv, Hkv, hd), rep = Hq / Hkv, hd any multiple of 16 from 16 to 128.
// Allowed: j < Skv, and j <= i when causal, and i - j < window when
// window > 0. The softmax and the sums are f32; the output is written in
// q's dtype (f32 or bf16). A row with no allowed key gives 0.
//
// What bounds it on the H100: operations. At the llama3.2-1b prefill shape
// (q (2,4096,32,64), k/v (2,4096,8,64) bf16, causal) the call does about
// 137 GFLOP (half the square) and moves 84 MB: 0.139 ms at the 989 TFLOP/s
// bf16 tensor-core rate, 2.05 ms at the 67 TFLOP/s f32 rate.
//
// Shared by both paths: one block per (q tile, q head, batch); the TPU's
// sequential KV grid axis becomes a loop inside the block over
// 64-key tiles, so the running max, sum and accumulator never leave the
// block. KV tiles the causal or window mask makes unreachable are never
// loaded; K and V are read from KV head h / rep in place (nothing is
// repeated in memory); q tiles are issued heaviest first (the last rows of
// a causal square); ragged Sq and Skv are masked in the kernel, not padded.
//
// Two paths, chosen by dtype (kernels/flash_attention/ops.py says the
// same); each returns an error for a head dim it does not take, and nothing
// falls back:
//
// * bf16 (`mma_fwd_kernel`): FlashAttention-2 on the tensor cores through
//   `mma.sync.m16n8k16` (bf16 inputs, f32 sums). 4 warps own 32 query rows
//   each up to head dim 64 (two 16-row m-tiles share every K and V fragment a
//   warp reads from shared memory), 16 above; each warp loads its Q fragments
//   once with `ldmatrix` and keeps them in registers. K and V tiles are
//   double-buffered in shared memory through 16-byte `cp.async`, rows padded
//   by 16 bytes so `ldmatrix` meets no bank conflict. S = Q K^T is exact
//   products of bf16 inputs summed in f32. The online softmax runs on S's
//   accumulator fragments in registers (row max and sum across the 4 lanes of
//   a quad, the reference's m_safe and corr), and masks only the tiles that
//   the causal diagonal, the window edge or the ragged Skv cut. S's
//   accumulator layout is the A fragment layout of the next m16n8k16, so P
//   never leaves registers: it goes in as a bf16 pair, hi = bf16(p), lo =
//   bf16(p - hi), O += hi V + lo V, V read with `ldmatrix.trans`. One bf16
//   rounding of P fails the S = 4096 check of chip_smoke.py (an output row
//   averages up to 4096 values, each off by up to 2^-8 of p); the pair keeps P
//   to 2^-16 of itself. That doubles the P V products: 1.5x the operations the
//   bound counts.
// * f32 (`f32_fwd_kernel`): the CUDA cores, the reference's f32 math, since
//   products of bf16 or TF32 inputs cannot meet its f32 tolerance (2e-4).
//   Blocks of 64 query rows; 256 threads each own a 4 x 4 block of the 64 x 64
//   score tile and a 4 x (hd/16) block of the output accumulator, in
//   registers; the tiles of Q, K, V and P sit in shared memory with padded
//   rows so column reads hit distinct banks.
#include <math.h>

#include <initializer_list>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;  // keys per tile of the inner loop

// The KV tiles [t_begin, t_end) that rows q0 .. q0 + rows - 1 can reach:
// keys j < q0 + rows (causal), j > q0 - window (window).
struct TileRange {
  int64_t begin, end;
};

__device__ __forceinline__ TileRange reachable_tiles(int64_t q0, int rows, int64_t Skv,
                                                     int causal, int64_t window) {
  int64_t kv_end = Skv;
  if (causal) kv_end = min64(kv_end, q0 + rows);
  int64_t kv_begin = 0;
  if (window > 0) kv_begin = max64(0, q0 - window + 1);
  const int64_t t_begin = kv_begin / BK;
  return {t_begin, kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin};
}

// ---- f32: the CUDA cores ----------------------------------------------------

namespace f32 {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDP = BK + 1;   // padded row stride of the P tile

template <int HD>
constexpr size_t smem_bytes() {
  // sQ, sK (BQ/BK x HD+1), sV (BK x HD), sP (BQ x LDP), m, l, corr (BQ each)
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LDP + 3 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int64_t Sq,
                   int64_t Skv, int64_t Hq, int64_t Hkv, int causal, int64_t window,
                   float scale) {
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
    sQ[r * LD + d] = s < Sq ? q[((b * Sq + s) * Hq + h) * HD + d] : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  const TileRange tiles = reachable_tiles(q0, BQ, Skv, causal, window);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int64_t t = tiles.begin; t < tiles.end; ++t) {
    const int64_t k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const int64_t s = k0 + r;
      const bool ok = s < Skv;
      const int64_t off = ((b * Skv + s) * Hkv + hk) * HD + d;
      sK[r * LD + d] = ok ? k[off] : 0.f;
      sV[r * HD + d] = ok ? v[off] : 0.f;
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
    float* out = o + ((b * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Skv, int64_t Hq, int64_t Hkv, int64_t causal, int64_t window,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(f32_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ), static_cast<unsigned>(Hq),
                  static_cast<unsigned>(B));
  f32_fwd_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, causal ? 1 : 0, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16: the tensor cores (mma.sync) ----------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;  // a block
constexpr int THREADS = WARPS * 32;

template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }  // elements: 16 bytes of padding

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where `ok` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows row0 .. row0 + ROWS - 1 of a (rows, HD) matrix whose rows are
// `stride` elements apart, into shared memory at `dst` (padded rows); rows
// at or past `n_rows` read as zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int64_t row0,
                                          int64_t n_rows, int64_t stride) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = row0 + r < n_rows;
    const bf16* g = src + (ok ? (row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + (r * row_stride<HD>() + c * 8) * 2, g, ok);
  }
}

// Query m-tiles of 16 rows each warp owns: two up to head dim 64, so each
// K or V fragment read from shared memory feeds twice the products; one
// above, where the accumulators of two would not fit in the registers.
template <int HD>
__host__ __device__ constexpr int m_tiles() { return HD <= 64 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int block_rows() { return WARPS * 16 * m_tiles<HD>(); }

template <int HD>
__global__ void __launch_bounds__(THREADS)
    mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int64_t Sq, int64_t Skv,
                   int64_t Hq, int64_t Hkv, int causal, int64_t window, float scale_log2) {
  constexpr int LDS = row_stride<HD>();
  constexpr int KC = HD / 16;        // 16-wide chunks of the head dim
  constexpr int MT = m_tiles<HD>();      // 16-row m-tiles a warp
  constexpr int ROWS = block_rows<HD>();  // query rows a block
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sK = sQ + ROWS * LDS * 2;  // two buffers of BK rows
  const uint32_t sV = sK + 2 * BK * LDS * 2;
  constexpr uint32_t TILE = BK * LDS * 2;   // bytes of one K or V buffer

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column pair
  const int64_t n_qt = (Sq + ROWS - 1) / ROWS;
  const int64_t q0 = (n_qt - 1 - blockIdx.x) * ROWS;  // heaviest tiles first
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (Hq / Hkv);
  const TileRange tiles = reachable_tiles(q0, ROWS, Skv, causal, window);
  const bf16* kbase = k + (b * Skv * Hkv + hk) * HD;
  const bf16* vbase = v + (b * Skv * Hkv + hk) * HD;

  // m-tile mt of this warp holds block rows 16 (MT warp + mt) .. + 15; this
  // thread's rows of it are r0 + 16 mt and r0 + 16 mt + 8
  const int64_t r0 = q0 + 16 * MT * warp + g;
  float m[MT][2], l[MT][2];  // running max (log2 units); this thread's part of the sum
  float acc[MT][HD / 8][4];  // O: 16 x HD an m-tile, n-blocks of 8 columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = -INFINITY;
      l[mt][hh] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  }

  if (tiles.begin < tiles.end) {
    load_rows<HD, ROWS>(sQ, q + (b * Sq * Hq + h) * HD, q0, Sq, Hq * HD);
    load_rows<HD, BK>(sK, kbase, tiles.begin * BK, Skv, Hkv * HD);
    load_rows<HD, BK>(sV, vbase, tiles.begin * BK, Skv, Hkv * HD);
    cp_async_commit();
  }
  uint32_t qf[MT][KC][4];  // Q fragments, loaded once

  for (int64_t t = tiles.begin; t < tiles.end; ++t) {
    const int buf = static_cast<int>((t - tiles.begin) & 1);
    if (t + 1 < tiles.end) {
      // the buffer written here was last read in the previous iteration,
      // which ended with a barrier
      load_rows<HD, BK>(sK + (buf ^ 1) * TILE, kbase, (t + 1) * BK, Skv, Hkv * HD);
      load_rows<HD, BK>(sV + (buf ^ 1) * TILE, vbase, (t + 1) * BK, Skv, Hkv * HD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == tiles.begin) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldsm_x4(qf[mt][kc], sQ + ((16 * (MT * warp + mt) + lane % 16) * LDS + kc * 16 +
                                    (lane / 16) * 8) * 2);
    }
    const uint32_t kt = sK + buf * TILE, vt = sV + buf * TILE;
    const int64_t k0 = t * BK;

    // S = Q K^T: 16 x 64 an m-tile, n-blocks of 8 keys
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // keys 16 np .. +15, dims 16 kc .. +15: b0/b1 of n-blocks 2 np, 2 np + 1
        uint32_t kb[4];
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int dim = kc * 16 + ((lane / 8) % 2) * 8;
        ldsm_x4(kb, kt + (key * LDS + dim) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][kc], kb[0], kb[1]);
          mma(s[mt][2 * np + 1], qf[mt][kc], kb[2], kb[3]);
        }
      }
    }

    // mask where the tile is cut
    const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || q0 + ROWS - 1 - k0 < window);
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int64_t qp = r0 + 16 * mt + 8 * (i / 2), kp = k0 + 8 * j + 2 * t4 + i % 2;
            bool allow = kp < Skv;
            if (causal) allow = allow && qp >= kp;
            if (window > 0) allow = allow && qp - kp < window;
            if (!allow) s[mt][j][i] = -INFINITY;
          }
    }

    // online softmax on the fragments, in log2 units (the scale goes into
    // the exponent's multiply-add): a row's 64 values sit in a quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hh], mx * scale_log2);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
        // 2^-inf is 0: a masked key, and corr for a row masked so far
        const float corr = ex2(m[mt][hh] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 2 * hh; i < 2 * hh + 2; ++i) {
            s[mt][j][i] = ex2(fmaf(s[mt][j][i], scale_log2, -m_safe));
            sum += s[mt][j][i];
          }
        l[mt][hh] = l[mt][hh] * corr + sum;
        m[mt][hh] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[mt][j][2 * hh] *= corr;
          acc[mt][j][2 * hh + 1] *= corr;
        }
      }

    // O += P V, P as hi + lo bf16 A fragments straight from S's registers
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // keys 16 kc .. +15
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a0: row g, keys 2 t4 (+1) of n-block 2 kc; a1: row g + 8; a2, a3:
          // the same of n-block 2 kc + 1
          const float p0 = s[mt][2 * kc + i / 2][2 * (i % 2)];
          const float p1 = s[mt][2 * kc + i / 2][2 * (i % 2) + 1];
          const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
          hi[mt][i] = pack(ph);
          lo[mt][i] = pack(__floats2bfloat162_rn(p0 - __low2float(ph), p1 - __high2float(ph)));
        }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        // keys 16 kc .. +15, dims 16 np .. +15: b0/b1 of n-blocks 2 np, 2 np + 1
        uint32_t vb[4];
        const int key = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dim = np * 16 + (lane / 16) * 8;
        ldsm_x4_t(vb, vt + (key * LDS + dim) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], hi[mt], vb[0], vb[1]);
          mma(acc[mt][2 * np], lo[mt], vb[0], vb[1]);
          mma(acc[mt][2 * np + 1], hi[mt], vb[2], vb[3]);
          mma(acc[mt][2 * np + 1], lo[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[mt][hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int64_t row = r0 + 16 * mt + 8 * hh;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      bf16* out = o + ((b * Sq + row) * Hq + h) * HD + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[mt][j][2 * hh] * inv, acc[mt][j][2 * hh + 1] * inv);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Skv, int64_t Hq, int64_t Hkv, int64_t causal, int64_t window,
           cudaStream_t stream) {
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (!aligned_to(p, 16)) return cudaErrorInvalidValue;
  constexpr int ROWS = block_rows<HD>();
  constexpr size_t bytes = sizeof(bf16) * row_stride<HD>() * (ROWS + 4 * BK);
  cudaError_t err = cudaFuncSetAttribute(mma_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + ROWS - 1) / ROWS), static_cast<unsigned>(Hq),
                  static_cast<unsigned>(B));
  mma_fwd_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, Hq, Hkv, causal ? 1 : 0, window,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace tc

// Every head dim that is a multiple of 16 from 16 to 128, on either path.
#define REPRO_HEAD_DIMS(NS)                                                        \
  switch (hd) {                                                                    \
    case 16: return NS::launch<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 32: return NS::launch<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 48: return NS::launch<48>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 64: return NS::launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 80: return NS::launch<80>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 96: return NS::launch<96>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s);   \
    case 112: return NS::launch<112>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s); \
    case 128: return NS::launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, s); \
    default: return cudaErrorInvalidValue;                                         \
  }

int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
             int64_t Skv, int64_t Hq, int64_t Hkv, int64_t hd, int64_t causal, int64_t window,
             int64_t dtype, cudaStream_t s) {
  if (dtype == kFloat32) REPRO_HEAD_DIMS(f32)
  if (dtype == kBFloat16) REPRO_HEAD_DIMS(tc)
  return cudaErrorInvalidValue;
}
#undef REPRO_HEAD_DIMS

}  // namespace
}  // namespace repro_torch

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                               int64_t Hkv, int64_t hd, int64_t causal,
                               int64_t window, int64_t dtype, void* stream) {
  using namespace repro_torch;
  if (B * Sq * Hq == 0) return cudaSuccess;
  return dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal, window, dtype,
                  static_cast<cudaStream_t>(stream));
}
