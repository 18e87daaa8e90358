// Mamba2 SSD (state-space duality) chunked scan, chunks in parallel, its
// products on the tensor cores.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, function `ssd_scan`
// (Pallas body `_ssd_kernel`).
//
// For each (batch b, head h) and each chunk c of `chunk` positions, with
// a = inclusive cumsum of dA over the chunk and a_last = a[chunk - 1]:
//   S_c     = x^T (B * exp(a_last - a))                 the chunk's own state
//   S_in[c] = S_in[c-1] exp(a_last[c-1]) + S_{c-1}      S_in[0] = 0
//   y[i]    = sum_{j<=i} (C[i] . B[j]) exp(a[i] - a[j]) x[j]
//           + exp(a[i]) C[i] . S_in[c]
// x (B,L,H,P), dA (B,L,H) f32, B/C (B,L,H,N) -> y (B,L,H,P) f32 and the
// final state (B,H,P,N) f32. x and B/C may be f32 or bf16; B/C are read in
// place through any strides with a contiguous last dim (the model passes a
// (B,L,N) tensor broadcast over heads with a head stride of 0).
//
// What bounds it on the H100: at the mamba2-780m prefill shape (x
// (2,4096,48,64) f32, B/C bf16 (2,4096,128) at head stride 0, chunk 256)
// the function moves 210 MB (x and y in f32 dominate): 0.063 ms at 3.35
// TB/s. Its lower-triangular products, each counted once, take less: C B^T
// once per (b, chunk), as the heads share B/C (0.27 GFLOP, bf16 at 989
// TFLOP/s), and the 19.4 GFLOP with an f32 operand at the 495 TFLOP/s TF32
// rate, 0.039 ms together. So bytes. (This kernel computes C B^T for each
// head, 12.9 GFLOP: its own cost, like the split's extra passes.)
//
// The TPU kernel walks the chunks in order and carries the state in VMEM;
// on the GPU that leaves one block per (b, h), 96 at the main shape, on 132
// SMs. Here the chunks run in parallel, in three kernels on one stream,
// with nothing carried between blocks and no atomics (the result does not
// vary from run to run). Three scratch buffers, which the wrapper
// allocates, pass between them: a (B,H,L) f32, the chunk states
// (B,H,nc,P,N) f32 and the states entering each chunk (B,H,nc,3,P,N) bf16;
// 1.6, 50.3 and 75.5 MB at the main shape, about 300 MB of traffic
// (0.09 ms) that the function itself does not need.
//
// (a) `chunk_states_kernel`, a block per (chunk, P tile of 64, N tile of
//     128, head, batch), 1,536 at the main shape: a, 256 positions at a
//     time (dA loaded by all threads at once, scanned by one warp; a longer
//     chunk is scanned again, segment by segment, as the steps reach it),
//     then S_c as a 64 x 128 GEMM over the chunk's rows, 64 at a step, the
//     next step's rows copied (`cp.async`) while this one's are multiplied.
//     The decay goes onto x, as in the reference.
// (b) `state_passing_kernel`, a thread per 4 (b, h, p, n) lanes (196k at the
//     main shape): the recurrence over the chunks, elementwise, its loads
//     of 8 chunks in flight at once. It writes the state entering each
//     chunk as three bf16 planes s1 + s2 + s3 (each the bf16 rounding of
//     what the ones before leave; together within 2^-27 of the f32 state),
//     and the final state in f32.
// (c) `chunk_outputs_kernel`, a block of 8 warps per (128-row tile of a
//     chunk, chunk, P tile of 64, head, batch), 3,072 at the main shape,
//     the row tiles of a chunk side by side, heaviest first; N is taken 128
//     columns at a time (C's tile stays for the whole block where N <= 128,
//     else it is copied again with each of B's); a warp owns 16 rows: the
//     carry-in C S_in^T, then C B^T over the lower-triangular
//     16 x 64 blocks only (a warp skips the 8-column blocks past its last
//     row), exp(a[i] - a[j]) taken only where i >= j (above the diagonal it
//     can overflow), and (C B^T * L) x with the scores straight from the
//     accumulator registers. Each 64-row step of B and x is copied and x
//     split once for all 8 warps; two blocks fit an SM.
//
// The products, on the tensor cores through `mma.sync`:
// * bf16 operands as m16n8k16 bf16, summed in f32: C B^T at the main shape
//   (two bf16 operands: exact products in one pass) and the carry-in C
//   S_in^T, C against S_in's three planes (three passes; an f32 C is split
//   into three bf16 pieces as well, and takes six);
// * the products with an f32 operand, (x w)^T B in (a) and scores . x in
//   (c), as m16n8k8 TF32 in a 3xTF32 split: a b ~ a_hi b_hi + a_hi b_lo +
//   a_lo b_hi, a_hi = tf32(a) and a_lo = tf32(a - a_hi), rounded to nearest
//   even. A bf16 value is a TF32 value, so a bf16 operand has no lo part
//   and its product takes two passes. x is split once per tile in shared
//   memory. One TF32 rounding keeps about three decimal digits: rounding x
//   and the scores once fails the f32 tolerances this kernel is held to
//   (tests/test_torch_lm_kernels.py emulates both on the CPU).
// The decay exp(a[i] - a[j]) and exp(a[i]) use the special-function unit's
// 2^x (`ex2.approx`, about 2^-22 relative error). Ragged P, N and chunk are
// zero-padded in shared memory. Tiles in shared memory are padded so each
// fragment load hits 32 distinct banks. A block's shared memory does not
// grow with P, N or the chunk, so every shape the wrapper takes launches.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

// ---- tensor-core helpers -----------------------------------------------------

// The TF32 value nearest x, ties to even (finite x): the low 13 mantissa
// bits rounded away.
__device__ __forceinline__ uint32_t tf32(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
}

// An operand fragment of R registers as TF32 hi and lo parts. EXACT: the
// values come from bf16 storage, are TF32 values already, and keep no lo.
template <int R, bool EXACT>
struct Frag {
  uint32_t hi[R], lo[R];
  __device__ __forceinline__ void set(int r, float v) {
    if (EXACT) {
      hi[r] = __float_as_uint(v);
    } else {
      hi[r] = tf32(v);
      lo[r] = tf32(v - __uint_as_float(hi[r]));
    }
  }
};

// d (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in the 3xTF32 split (lo . lo dropped); an exact operand's lo
// term is skipped. The small terms go in first.
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4, AX>& a, const Frag<2, BX>& b) {
  if (!AX) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if (!BX) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x as three bf16 pieces, each the rounding of what the ones before leave
__device__ __forceinline__ void split3(float x, bf16 (&s)[3]) {
  s[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(s[0]);
  s[1] = __float2bfloat16_rn(r);
  s[2] = __float2bfloat16_rn(r - __bfloat162float(s[1]));
}

// e^x on the special-function unit (x <= 0 here)
__device__ __forceinline__ float exp_sfu(float x) { return ex2(x * 1.4426950408889634f); }

// ---- shared-memory tiles -----------------------------------------------------

// 4 elements global -> shared without passing through registers; zeros
// where `ok` is false (src is then only a valid address, not read)
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool ok) {
  constexpr int BYTES = 4 * sizeof(T);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_u32(dst)), "l"(src),
               "n"(BYTES), "r"(ok ? BYTES : 0)
               : "memory");
}

// rows x cols of a row-strided matrix (columns contiguous) into shared
// memory (row stride ld) in its storage type: zero where r >= n_rows or
// c >= n_cols. vec (n_cols, the row stride and src aligned to 4 elements;
// cols and ld multiples of 4): asynchronous 4-element copies, all in flight
// at once, which the caller commits and waits for; else plain loads.
template <typename T, int THREADS>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src, int64_t stride,
                                          int rows, int cols, int64_t n_rows, int64_t n_cols,
                                          bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
      const int r = e / per_row, c = (e % per_row) * 4;
      const bool ok = r < n_rows && c < n_cols;
      cp_async4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] = r < n_rows && c < n_cols ? src[r * stride + c] : from_f32<T>(0.f);
    }
  }
}

// ---- (a) chunk states ---------------------------------------------------------

namespace states {

constexpr int THREADS = 256;  // 8 warps: 4 along P x 2 along N
constexpr int PT = 64;        // P rows of S_c a block
constexpr int NT = 128;       // N columns of S_c a block
constexpr int KT = 64;        // chunk rows a step
constexpr int LDX = PT + 8;   // xs[j][p]: A loads at (t4 LDX + g) hit distinct banks
constexpr int LDB = NT + 8;   // bs[j][n]: B loads likewise
constexpr int SEG = THREADS;  // positions of a scanned at a time (a multiple of KT)

// two buffers of a step's x and B rows; a over one segment of the chunk,
// and its decay weights
template <typename TX, typename TBC>
constexpr size_t smem_bytes() {
  return 2 * (sizeof(TX) * KT * LDX + sizeof(TBC) * KT * LDB) + 2 * sizeof(float) * SEG;
}

// S_c[p][n] = sum_j x[j][p] w[j] B[j][n], w = exp(a_last - a): A = (x w)^T
// from xs, B from bs, M = P, N = N, K = the chunk's rows. The blocks of P
// and N tile 0 also write a to a_cs (B,H,L).
template <typename TX, typename TBC>
__global__ void __launch_bounds__(THREADS)
    chunk_states_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                        const TBC* __restrict__ Bm, float* __restrict__ st,
                        float* __restrict__ a_cs, int64_t L, int64_t H, int64_t P, int64_t N,
                        int64_t chunk, int64_t n_pt, int64_t n_nt, int64_t bc_sb, int64_t bc_sl,
                        int64_t bc_sh, int x_vec, int bc_vec) {
  constexpr bool BX = std::is_same<TBC, bf16>::value;
  constexpr int X_TILE = KT * LDX, B_TILE = KT * LDB;
  extern __shared__ __align__(16) uint8_t smem[];
  TX* xs = reinterpret_cast<TX*>(smem);                 // 2 x (KT x LDX)
  TBC* bs = reinterpret_cast<TBC*>(xs + 2 * X_TILE);    // 2 x (KT x LDB)
  float* seg = reinterpret_cast<float*>(bs + 2 * B_TILE);  // a over a segment
  float* w = seg + SEG;                                  // its weights; 0 past the chunk

  const int64_t nc = L / chunk;
  int64_t t = blockIdx.x;
  const int64_t n0 = (t % n_nt) * NT;
  t /= n_nt;
  const int64_t p0 = (t % n_pt) * PT;
  const int64_t c = t / n_pt;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t l0 = c * chunk;
  const int64_t steps = (chunk + KT - 1) / KT;
  const int64_t n_seg = (chunk + SEG - 1) / SEG;

  const TX* xb = x + ((b * L + l0) * H + h) * P + p0;
  const TBC* bb = Bm + b * bc_sb + l0 * bc_sl + h * bc_sh + n0;
  auto copy_step = [&](int64_t step, int buf) {
    const int64_t k0 = step * KT, kr = min64(KT, chunk - k0);
    copy_tile<TX, THREADS>(xs + buf * X_TILE, LDX, xb + k0 * H * P, H * P, KT, PT, kr, P - p0,
                           x_vec);
    copy_tile<TBC, THREADS>(bs + buf * B_TILE, LDB, bb + k0 * bc_sl, bc_sl, KT, NT, kr, N - n0,
                            bc_vec);
    cp_async_commit();
  };
  copy_step(0, 0);

  // a over positions q0 .. q0 + SEG - 1 into seg, from a before them
  // (carry): the segment's dA loaded at once, scanned by warp 0, 32
  // positions a step. Returns a at the segment's last position in the chunk.
  auto scan_segment = [&](int64_t q0, float carry) {
    __syncthreads();  // seg's previous reads are done
    const int64_t i = q0 + threadIdx.x;
    seg[threadIdx.x] = i < chunk ? dA[(b * L + l0 + i) * H + h] : 0.f;
    __syncthreads();
    const int len = static_cast<int>(min64(SEG, chunk - q0));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int base = 0; base < len; base += 32) {
        float v = seg[base + lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += up;
        }
        v += carry;
        seg[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    return seg[len - 1];
  };
  // a_last: the segments in order (blocks of P and N tile 0 write a out)
  float total = 0.f;
  for (int64_t sg = 0; sg < n_seg; ++sg) {
    const int64_t q0 = sg * SEG;
    const float last = scan_segment(q0, total);
    if (p0 == 0 && n0 == 0)
      for (int64_t i = threadIdx.x; i < min64(SEG, chunk - q0); i += THREADS)
        a_cs[(b * H + h) * L + l0 + q0 + i] = seg[i];
    total = last;
  }
  auto set_weights = [&](int64_t q0) {
    for (int i = threadIdx.x; i < SEG; i += THREADS)
      w[i] = q0 + i < chunk ? expf(total - seg[i]) : 0.f;
  };
  set_weights((n_seg - 1) * SEG);
  // a chunk longer than SEG has its segments scanned again, in order, from
  // the same carries: the same a, bit for bit
  int64_t in_w = n_seg - 1;  // the segment whose weights w holds
  float carry = 0.f;         // a before the next segment scanned again

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column
  const int wm = warp % 4, wn = warp / 4;  // the warp's 16 P rows and 64 N columns
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int64_t step = 0; step < steps; ++step) {
    const int buf = static_cast<int>(step & 1);
    if (step + 1 < steps) {
      // the buffer written here was last read in the previous step, which
      // ended with a barrier
      copy_step(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (step * KT / SEG != in_w) {  // w's reads ended with the last step's barrier
      in_w = step * KT / SEG;
      carry = scan_segment(in_w * SEG, carry);
      set_weights(in_w * SEG);
    }
    __syncthreads();  // this step's rows (and w) are in shared memory
    const TX* xt = xs + buf * X_TILE;
    const TBC* bt = bs + buf * B_TILE;
    const float* ws = w + step * KT % SEG;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += 8) {
      Frag<4, false> a;  // A[p][j] = x[j][p] w[j]: rows g, g + 8; columns t4, t4 + 4
      const TX* xa = xt + (kk + t4) * LDX + 16 * wm + g;
      const float w0 = ws[kk + t4], w1 = ws[kk + t4 + 4];
      a.set(0, to_f32(xa[0]) * w0);
      a.set(1, to_f32(xa[8]) * w0);
      a.set(2, to_f32(xa[4 * LDX]) * w1);
      a.set(3, to_f32(xa[4 * LDX + 8]) * w1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Frag<2, BX> bf;  // B[j][n]: rows t4, t4 + 4; column g
        const TBC* bp = bt + (kk + t4) * LDB + 64 * wn + 8 * nt + g;
        bf.set(0, to_f32(bp[0]));
        bf.set(1, to_f32(bp[4 * LDB]));
        mma3(acc[nt], a, bf);
      }
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }

  float* out = st + ((b * H + h) * nc + c) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t p = p0 + 16 * wm + g + 8 * hh, n = n0 + 64 * wn + 8 * nt + 2 * t4;
      if (p >= P) continue;
      if (n < N) out[p * N + n] = acc[nt][2 * hh];
      if (n + 1 < N) out[p * N + n + 1] = acc[nt][2 * hh + 1];
    }
}

}  // namespace states

// ---- (b) state passing ----------------------------------------------------------

// One thread per V neighbouring (b, h, p, n) lanes: the state entering each
// chunk into sin (B,H,nc,3,P,N) as three bf16 planes, the state after the
// last chunk into final_state. A thread's loads of U chunks are all in
// flight before it stores.
template <int V>
__global__ void state_passing_kernel(const float* __restrict__ st,
                                     const float* __restrict__ a_cs, bf16* __restrict__ sin,
                                     float* __restrict__ final_state, int64_t BH, int64_t nc,
                                     int64_t chunk, int64_t PN) {
  constexpr int U = 8;
  const int64_t e = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) * V;
  if (e >= BH * PN) return;
  const int64_t bh = e / PN, k = e % PN;
  const float* s = st + bh * nc * PN + k;
  const float* a_last = a_cs + bh * nc * chunk + chunk - 1;
  Pack<float, V> run;
#pragma unroll
  for (int v = 0; v < V; ++v) run.v[v] = 0.f;
  for (int64_t c0 = 0; c0 < nc; c0 += U) {
    Pack<float, V> own[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) own[u] = load_pack<float, V>(s + (c0 + u) * PN);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nc) break;
      Pack<bf16, V> planes[3];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bf16 p3[3];
        split3(run.v[v], p3);
#pragma unroll
        for (int q = 0; q < 3; ++q) planes[q].v[v] = p3[q];
      }
      bf16* out = sin + ((bh * nc + c0 + u) * 3) * PN + k;
#pragma unroll
      for (int q = 0; q < 3; ++q) store_pack<bf16, V>(out + q * PN, planes[q]);
      const float decay = expf(a_last[(c0 + u) * chunk]);
#pragma unroll
      for (int v = 0; v < V; ++v) run.v[v] = run.v[v] * decay + own[u].v[v];
    }
  }
  store_pack<float, V>(final_state + e, run);
}

// ---- (c) chunk outputs ----------------------------------------------------------

namespace outputs {

constexpr int THREADS = 256;  // 8 warps, 16 output rows each
constexpr int TI = 128;       // output rows a block
constexpr int PT = 64;        // output columns (P) a block
constexpr int TJ = 64;        // chunk rows of B and x a step
constexpr int NK = 128;       // N columns of C, B and S_in in shared memory at a time
constexpr int LDX = PT + 4;   // x planes [j][p]: B loads at rows 2 t4 (+1) hit distinct banks

// Row strides for k-tiles of nk columns: the C and B tiles, and the S_in
// planes (bf16): fragment loads at (g ld + t4) or (g ld + 2 t4) hit
// distinct banks.
template <typename TBC>
__host__ __device__ constexpr int ld_bc(int nk) {
  return nk + (sizeof(TBC) == 2 ? 8 : 4);
}
__host__ __device__ constexpr int ld_s(int nk) { return nk + 8; }

// Shared memory: a k-tile of C; in one region either S_in's planes
// (carry-in) or a step's B k-tile and x (as read, then its TF32 hi in place
// and lo beside it, f32 x only); a over the tile's rows and the step's rows.
template <typename TX, typename TBC>
__host__ __device__ size_t region_bytes(int nk) {
  const size_t planes = sizeof(bf16) * 3 * PT * ld_s(nk);
  const size_t step = sizeof(TBC) * TJ * ld_bc<TBC>(nk) + sizeof(TX) * TJ * LDX +
                      (sizeof(TX) == 4 ? sizeof(uint32_t) * TJ * LDX : 0);
  return planes > step ? planes : step;
}
template <typename TX, typename TBC>
size_t smem_bytes(int nk) {
  return sizeof(TBC) * TI * ld_bc<TBC>(nk) + region_bytes<TX, TBC>(nk) +
         sizeof(float) * (TI + TJ);
}

// NP is N rounded up to 16, taken nk = min(NP, NK) columns at a time.
// RESIDENT (NP <= NK): one k-tile holds C's tile, which stays in shared
// memory for the whole block; else it is copied again with each B k-tile.
template <typename TX, typename TBC, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: 128 registers
    chunk_outputs_kernel(const TX* __restrict__ x, const float* __restrict__ a_cs,
                         const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                         const bf16* __restrict__ sin, float* __restrict__ y, int64_t L,
                         int64_t H, int64_t P, int64_t N, int NP, int nk, int64_t chunk,
                         int64_t n_it, int64_t bc_sb, int64_t bc_sl, int64_t bc_sh, int x_vec,
                         int bc_vec, int s_vec, int a_vec) {
  constexpr bool BX = std::is_same<TBC, bf16>::value;
  constexpr bool XX = std::is_same<TX, bf16>::value;
  const int ldc = ld_bc<TBC>(nk), lds = ld_s(nk);
  extern __shared__ __align__(16) uint8_t smem[];
  TBC* cs = reinterpret_cast<TBC*>(smem);            // TI x ldc: C rows of the tile
  uint8_t* region = smem + sizeof(TBC) * TI * ldc;
  bf16* sp = reinterpret_cast<bf16*>(region);        // 3 x (PT x lds): S_in's planes
  TBC* bs = reinterpret_cast<TBC*>(region);          // TJ x ldc: B rows of a step
  TX* xs = reinterpret_cast<TX*>(bs + TJ * ldc);     // TJ x LDX: x rows, then x's hi
  uint32_t* xl = reinterpret_cast<uint32_t*>(xs + TJ * LDX);  // TJ x LDX: x's lo
  float* ar = reinterpret_cast<float*>(region + region_bytes<TX, TBC>(nk));  // a of the rows
  float* ac = ar + TI;                               // a of the step's rows

  // consecutive blocks: the row tiles of one chunk, last (heaviest) first
  const int64_t nc = L / chunk;
  int64_t t = blockIdx.x;
  const int64_t i0 = (n_it - 1 - t % n_it) * TI;
  t /= n_it;
  const int64_t c = t % nc;
  const int64_t p0 = (t / nc) * PT;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t l0 = c * chunk;
  const int ti = static_cast<int>(min64(TI, chunk - i0));
  const float* a_chunk = a_cs + (b * H + h) * L + l0;
  const int n_kt = RESIDENT ? 1 : (NP + nk - 1) / nk;

  const TBC* c_rows = Cm + b * bc_sb + (l0 + i0) * bc_sl + h * bc_sh;
  auto copy_c = [&](int k_base) {
    copy_tile<TBC, THREADS>(cs, ldc, c_rows + k_base, bc_sl, TI, min(nk, NP - k_base), ti,
                            N - k_base, bc_vec);
  };
  if (RESIDENT) copy_c(0);
  copy_tile<float, THREADS>(ar, 0, a_chunk + i0, 0, 1, TI, 1, ti, a_vec);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column
  const int r0 = 16 * warp;               // the warp's first row in the tile
  float acc[8][4];                        // y: 16 rows x 64 columns
#pragma unroll
  for (int np = 0; np < 8; ++np)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[np][i] = 0.f;

  // carry-in: acc = exp(a[i]) C[i] . S_in[p], S_in = s1 + s2 + s3 (bf16)
  if (c > 0) {
    const bf16* s_in = sin + (((b * H + h) * nc + c) * 3 * P + p0) * N;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k_base = kt * nk, kw = RESIDENT ? NP : min(nk, NP - k_base);
      if (kt > 0) __syncthreads();  // the previous k-tile's reads are done
      if (!RESIDENT) copy_c(k_base);
      for (int q = 0; q < 3; ++q)
        copy_tile<bf16, THREADS>(sp + q * PT * lds, lds, s_in + q * P * N + k_base, N, PT, kw,
                                 P - p0, N - k_base, s_vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int k0 = 0; k0 < kw; k0 += 16) {
        // C rows g, g + 8; columns 2 t4 (+1), 2 t4 + 8 (+9): as bf16, or an
        // f32 C as three bf16 pieces
        uint32_t ca[3][4];
        const TBC* cr = cs + (r0 + g) * ldc + k0 + 2 * t4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const TBC* e = cr + (i % 2) * 8 * ldc + (i / 2) * 8;
          if constexpr (BX) {
            ca[0][i] = ld32(e);
          } else {
            bf16 lo[3], hi[3];
            split3(e[0], lo);
            split3(e[1], hi);
#pragma unroll
            for (int q = 0; q < 3; ++q) ca[q][i] = pack_bf16x2(__halves2bfloat162(lo[q], hi[q]));
          }
        }
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          // B[n][p] = S_in[p][n]: rows 2 t4 (+1), 2 t4 + 8 (+9); column g
          const bf16* sb = sp + (8 * np + g) * lds + k0 + 2 * t4;
          uint32_t s0[3], s1[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            s0[q] = ld32(sb + q * PT * lds);
            s1[q] = ld32(sb + q * PT * lds + 8);
          }
          if constexpr (!BX) {  // the pieces below 2^-24 of the product dropped
            mma_bf16(acc[np], ca[2], s0[0], s1[0]);
            mma_bf16(acc[np], ca[1], s0[1], s1[1]);
            mma_bf16(acc[np], ca[1], s0[0], s1[0]);
          }
          mma_bf16(acc[np], ca[0], s0[2], s1[2]);
          mma_bf16(acc[np], ca[0], s0[1], s1[1]);
          mma_bf16(acc[np], ca[0], s0[0], s1[0]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      const float e = r < ti ? exp_sfu(ar[r]) : 0.f;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        acc[np][2 * hh] *= e;
        acc[np][2 * hh + 1] *= e;
      }
    }
  }

  // intra-chunk: the lower-triangular tiles, j0 up to the block's last row
  for (int64_t j0 = 0; j0 < i0 + ti; j0 += TJ) {
    const int tj = static_cast<int>(min64(TJ, chunk - j0));
    // the warp's rows reach columns j <= i0 + r0 + 15 only: 8-column
    // blocks past them are skipped (all of them above the warp's diagonal)
    const int64_t reach = i0 + r0 + 16 - j0;
    const int nt_end = reach <= 0 ? 0 : static_cast<int>(min64(8, (reach + 7) / 8));

    // S = C B^T: 16 rows x 64 columns, a k-tile of N at a time
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k_base = kt * nk, kw = RESIDENT ? NP : min(nk, NP - k_base);
      __syncthreads();  // the previous k-tile's, step's or carry-in's reads are done
      if (!RESIDENT) copy_c(k_base);
      copy_tile<TBC, THREADS>(bs, ldc, Bm + b * bc_sb + (l0 + j0) * bc_sl + h * bc_sh + k_base,
                              bc_sl, TJ, kw, tj, N - k_base, bc_vec);
      if (kt == 0) {  // with the step's first k-tile: its x and a
        copy_tile<TX, THREADS>(xs, LDX, x + ((b * L + l0 + j0) * H + h) * P + p0, H * P, TJ, PT,
                               tj, P - p0, x_vec);
        copy_tile<float, THREADS>(ac, 0, a_chunk + j0, 0, 1, TJ, 1, tj, a_vec);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (!XX) {  // x as TF32 hi (in place) and lo, once for all warps
        if (kt == 0) {
          for (int e = threadIdx.x; e < TJ * PT; e += THREADS) {
            const int i = (e / PT) * LDX + e % PT;
            const uint32_t hi = tf32(xs[i]);
            xl[i] = tf32(xs[i] - __uint_as_float(hi));
            xs[i] = __uint_as_float(hi);
          }
          __syncthreads();
        }
      }
      if constexpr (BX) {
        for (int k0 = 0; k0 < kw; k0 += 16) {
          uint32_t a[4];  // rows g, g + 8; columns 2 t4 (+1), 2 t4 + 8 (+9)
          const bf16* ca = cs + (r0 + g) * ldc + k0 + 2 * t4;
          a[0] = ld32(ca);
          a[1] = ld32(ca + 8 * ldc);
          a[2] = ld32(ca + 8);
          a[3] = ld32(ca + 8 * ldc + 8);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nt_end) continue;
            const bf16* bp = bs + (8 * nt + g) * ldc + k0 + 2 * t4;  // B^T[n][j] = B[j][n]
            mma_bf16(s[nt], a, ld32(bp), ld32(bp + 8));
          }
        }
      } else {
        for (int k0 = 0; k0 < kw; k0 += 8) {
          Frag<4, false> a;  // rows g, g + 8; columns t4, t4 + 4
          const TBC* ca = cs + (r0 + g) * ldc + k0 + t4;
          a.set(0, to_f32(ca[0]));
          a.set(1, to_f32(ca[8 * ldc]));
          a.set(2, to_f32(ca[4]));
          a.set(3, to_f32(ca[8 * ldc + 4]));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nt_end) continue;
            Frag<2, false> bf;
            const TBC* bp = bs + (8 * nt + g) * ldc + k0 + t4;
            bf.set(0, to_f32(bp[0]));
            bf.set(1, to_f32(bp[4]));
            mma3(s[nt], a, bf);
          }
        }
      }
    }

    // scores = S * exp(a[i] - a[j]) where i >= j (inside the chunk), else 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = r0 + g + 8 * (e / 2), cj = 8 * nt + 2 * t4 + e % 2;
        s[nt][e] = ri < ti && cj < tj && i0 + ri >= j0 + cj
                       ? s[nt][e] * exp_sfu(ar[ri] - ac[cj])
                       : 0.f;
      }

    // acc += scores . x. A k-step of 8 columns takes the scores from S's
    // accumulator registers: logical column t4 is column 2 t4, t4 + 4 is
    // 2 t4 + 1, and x's rows are read in the same order.
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= nt_end) continue;
      Frag<4, false> a;
      a.set(0, s[q][0]);
      a.set(1, s[q][2]);
      a.set(2, s[q][1]);
      a.set(3, s[q][3]);
      const int row = (8 * q + 2 * t4) * LDX + g;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        Frag<2, XX> bf;
        if constexpr (XX) {
          bf.set(0, to_f32(xs[row + 8 * np]));
          bf.set(1, to_f32(xs[row + LDX + 8 * np]));
        } else {
          bf.hi[0] = __float_as_uint(xs[row + 8 * np]);
          bf.hi[1] = __float_as_uint(xs[row + LDX + 8 * np]);
          bf.lo[0] = xl[row + 8 * np];
          bf.lo[1] = xl[row + LDX + 8 * np];
        }
        mma3(acc[np], a, bf);
      }
    }
  }

  const bool pairs = P % 2 == 0;  // float2 stores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= ti) continue;
    float* out = y + ((b * L + l0 + i0 + r) * H + h) * P;
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      const int64_t p = p0 + 8 * np + 2 * t4;
      if (pairs && p + 1 < P) {
        *reinterpret_cast<float2*>(out + p) = make_float2(acc[np][2 * hh], acc[np][2 * hh + 1]);
      } else {
        if (p < P) out[p] = acc[np][2 * hh];
        if (p + 1 < P) out[p + 1] = acc[np][2 * hh + 1];
      }
    }
  }
}

}  // namespace outputs

template <typename TX, typename TBC>
int launch(const void* x, const void* dA, const void* Bm, const void* Cm, void* y, void* fin,
           void* a_cs, void* st, void* sin, int64_t Bsz, int64_t L, int64_t H, int64_t P,
           int64_t N, int64_t chunk, int64_t sb, int64_t sl, int64_t sh, cudaStream_t stream) {
  const int64_t nc = L / chunk;
  const int64_t NP = (N + 15) / 16 * 16;
  const int x_vec = P % 4 == 0 && aligned_to(x, 4 * sizeof(TX));
  const int bc_vec = N % 4 == 0 && sb % 4 == 0 && sl % 4 == 0 && sh % 4 == 0 &&
                     aligned_to(Bm, 4 * sizeof(TBC)) && aligned_to(Cm, 4 * sizeof(TBC));
  const auto* xt = static_cast<const TX*>(x);
  const auto* bm = static_cast<const TBC*>(Bm);
  auto* acs = static_cast<float*>(a_cs);
  auto* stf = static_cast<float*>(st);
  auto* sinb = static_cast<bf16*>(sin);

  // (a) chunk states
  {
    const int64_t n_pt = (P + states::PT - 1) / states::PT;
    const int64_t n_nt = (N + states::NT - 1) / states::NT;
    constexpr size_t bytes = states::smem_bytes<TX, TBC>();
    cudaError_t err = cudaFuncSetAttribute(states::chunk_states_kernel<TX, TBC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(nc * n_pt * n_nt), static_cast<unsigned>(H),
                    static_cast<unsigned>(Bsz));
    states::chunk_states_kernel<TX, TBC><<<grid, states::THREADS, bytes, stream>>>(
        xt, static_cast<const float*>(dA), bm, stf, acs, L, H, P, N, chunk, n_pt, n_nt, sb, sl,
        sh, x_vec, bc_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (b) state passing
  {
    const int64_t PN = P * N, lanes = Bsz * H * PN;
    constexpr int threads = 256;
    if (PN % 4 == 0) {
      state_passing_kernel<4><<<static_cast<unsigned>((lanes / 4 + threads - 1) / threads),
                                threads, 0, stream>>>(stf, acs, sinb, static_cast<float*>(fin),
                                                      Bsz * H, nc, chunk, PN);
    } else {
      state_passing_kernel<1><<<static_cast<unsigned>((lanes + threads - 1) / threads), threads,
                                0, stream>>>(stf, acs, sinb, static_cast<float*>(fin), Bsz * H,
                                             nc, chunk, PN);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (c) chunk outputs
  {
    const int64_t n_it = (chunk + outputs::TI - 1) / outputs::TI;
    const int64_t n_pt = (P + outputs::PT - 1) / outputs::PT;
    const int nk = static_cast<int>(min64(NP, outputs::NK));
    const size_t bytes = outputs::smem_bytes<TX, TBC>(nk);
    const auto kernel = NP <= outputs::NK ? outputs::chunk_outputs_kernel<TX, TBC, true>
                                          : outputs::chunk_outputs_kernel<TX, TBC, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(n_it * nc * n_pt), static_cast<unsigned>(H),
                    static_cast<unsigned>(Bsz));
    kernel<<<grid, outputs::THREADS, bytes, stream>>>(
        xt, acs, bm, static_cast<const TBC*>(Cm), sinb, static_cast<float*>(y), L, H, P, N,
        static_cast<int>(NP), nk, chunk, n_it, sb, sl, sh, x_vec, bc_vec, N % 4 == 0,
        chunk % 4 == 0 && L % 4 == 0);
    return cudaGetLastError();
  }
}

template <typename TX>
int dispatch_bc(int64_t bc_dtype, const void* x, const void* dA, const void* Bm,
                const void* Cm, void* y, void* fin, void* acs, void* st, void* sin, int64_t Bsz,
                int64_t L, int64_t H, int64_t P, int64_t N, int64_t chunk, int64_t sb,
                int64_t sl, int64_t sh, cudaStream_t s) {
  if (bc_dtype == kFloat32)
    return launch<TX, float>(x, dA, Bm, Cm, y, fin, acs, st, sin, Bsz, L, H, P, N, chunk, sb,
                             sl, sh, s);
  if (bc_dtype == kBFloat16)
    return launch<TX, bf16>(x, dA, Bm, Cm, y, fin, acs, st, sin, Bsz, L, H, P, N, chunk, sb,
                            sl, sh, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// Scratch the caller allocates: a_cs f32 (B, H, L); st f32 (B, H, L / chunk,
// P, N); sin bf16 (B, H, L / chunk, 3, P, N).
extern "C" int ssd_scan(const void* x, const void* dA, const void* Bm, const void* Cm,
                        void* y, void* fin, void* a_cs, void* st, void* sin, int64_t Bsz,
                        int64_t L, int64_t H, int64_t P, int64_t N, int64_t chunk,
                        int64_t bc_sb, int64_t bc_sl, int64_t bc_sh, int64_t x_dtype,
                        int64_t bc_dtype, void* stream) {
  using namespace repro_torch;
  if (chunk <= 0 || L % chunk) return cudaErrorInvalidValue;
  if (Bsz * H * P == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (L == 0) return cudaMemsetAsync(fin, 0, sizeof(float) * Bsz * H * P * N, s);  // no chunk
  if (N == 0) return cudaMemsetAsync(y, 0, sizeof(float) * Bsz * L * H * P, s);  // C . S = 0
  if (x_dtype == kFloat32)
    return dispatch_bc<float>(bc_dtype, x, dA, Bm, Cm, y, fin, a_cs, st, sin, Bsz, L, H, P, N,
                              chunk, bc_sb, bc_sl, bc_sh, s);
  if (x_dtype == kBFloat16)
    return dispatch_bc<bf16>(bc_dtype, x, dA, Bm, Cm, y, fin, a_cs, st, sin, Bsz, L, H, P, N,
                             chunk, bc_sb, bc_sl, bc_sh, s);
  return cudaErrorInvalidValue;
}
