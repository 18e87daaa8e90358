// Transpose SpMM: the gradient of the sparse input layer with respect to W,
// and the stable counting sort of the slots by row that it walks.
//
// Replaces: src/repro/kernels/spmm/spmm.py, function `spmm_grad_w` (Pallas
// body `_grad_w_kernel`), which walks the row-sorted slots one grid step at
// a time and keeps the output row in VMEM for the whole run of equal rows;
// and the `jnp.argsort` of the slots' rows before it (spmm.py:166).
//
// Computes, for every replica r and row n of W,
//   out[r, n, :] = sum over the slots s of replica r with idx[r, s] = n of
//                  val[r, s] * mask[r, s] * dh[r, s / K, :]
// in f32, summed in the order of the slots sorted by row (stable). Every
// row of `out` is written once, the rows no slot names as 0: the caller
// allocates `out` uninitialised. Masked slots are multiplied in with a
// scale of exactly 0 (the reference's `val * mask` is a select): a NaN in
// dh[b] reaches row idx[b, k].
//
// Deterministic: each output row is the sum of its run of sorted slots in
// a fixed order (sorted order within a chunk; a run's partial sums from the
// chunks it crosses in a fixed tree), with no float atomics. Two launches
// on the same inputs give bitwise-equal output.
//
// What bounds it on the H100: device-memory bytes. The function must write
// the dense (R, NF, H) f32 output (278 MB at the main shape) and read the
// slots and one dh row per distinct (replica, sample); it does one
// multiply-add per slot and column.
//
// What the design does about it:
// - The sort (`spmm_sort_rows`) is an LSD counting sort on the row id in
//   passes of at most 9 bits (two at NF = 135,909), 2,048 keys a block: a
//   histogram kernel counts pass 0's digits per block; each scatter kernel
//   turns the per-block counts into offsets (each block scans the table of
//   its replica itself), ranks its keys stably (warp by warp, `match.any`
//   for the lanes that share a digit) and writes (row, slot) pairs to their
//   places, counting the next pass's digits per destination block as it
//   goes (integer atomics: the counts, not their order, matter). Each pass
//   is stable, so the result is the order of a stable sort. Pass 0 also
//   flags each row a slot names (`named`, a byte a row).
// - Then one launch of two kinds of 128-thread block, interleaved so that
//   the latency of the one hides under the bandwidth of the other:
//   * zero blocks write the rows that no slot names, with streaming stores
//     (nothing reads them back): zero block j of replica r owns rows
//     [256 j, 256 j + 256) whose flag is clear, 64 consecutive rows a warp.
//     This is most of the output, and of the time.
//   * walk blocks sum the runs: the sorted slots are cut into chunks of
//     `chunk` slots, one block per (replica, chunk), the last chunks first.
//     The block stages its chunk's rows, sample ids (order / K) and scales
//     (val where mask, read through `order`) in shared memory, and compacts
//     them in order, dropping every zero-scale slot whose previous slot in
//     the chunk has the same row, the same sample and a zero scale: it
//     would add 0 * dh[sample] again, +-0 where dh is finite and NaN where
//     the kept slot already put NaN. A padding run of row 0 then costs a dh
//     gather per sample, not per slot. Warp 0 walks the kept slots in
//     order, each lane owning VEC consecutive columns, with 8 dh gathers in
//     flight: a run that starts and ends inside the chunk is written to
//     `out` directly; the part of a run that entered from the previous
//     chunk goes to head[chunk], the start of a run that leaves into the
//     next chunk to tail[chunk].
// - The carry pass: the block of the chunk where a leaving run starts adds
//   the heads of the chunks the run covers (four warps, a quarter of the
//   chunks each, in chunk order) and its tail, and writes the row.
// - So each row is written once: a row that slots name by the block of the
//   chunk where its run starts (in the walk, or in the carry pass when the
//   run leaves that chunk), any other row by the zero block of its range.
#include "common.cuh"

namespace repro_torch {
namespace {

// ---- the stable counting sort of the rows --------------------------------

// bytes of a replica's named-row flags: n_rows rounded up to 16
inline int64_t named_stride(int64_t n_rows) {
  return (n_rows + 15) / 16 * 16;
}

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kKeysPerThread = 8;
constexpr int kSortTile = kSortThreads * kKeysPerThread;  // keys a block
constexpr int kMaxRadix = 512;                            // 9-bit digits

// Pass 0's digit counts of each block's tile, counts[block][digit]
// (block = replica * n_tiles + tile), and zeros for the later passes'
// tables, which their previous scatter fills with atomics, and for the
// named-row flags (`named_vecs` 16-byte vectors), which pass 0 fills.
__global__ void __launch_bounds__(kSortThreads)
sort_histogram_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ counts,
                      uint4* __restrict__ named, int64_t named_vecs, int64_t S,
                      int64_t n_tiles, int radix, int passes) {
  __shared__ int hist[kMaxRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t block = blockIdx.x;
  // the named-row flags start clear: this block's share of them
  const int64_t share = (named_vecs + gridDim.x - 1) / gridDim.x;
  for (int64_t i = block * share + tid; i < min64((block + 1) * share, named_vecs);
       i += kSortThreads)
    named[i] = make_uint4(0u, 0u, 0u, 0u);
  const int64_t lo = (block % n_tiles) * kSortTile;
  const int32_t* kr = keys + (block / n_tiles) * S;
  for (int d = tid; d < radix; d += kSortThreads) hist[d] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int64_t i = lo + warp * (32 * kKeysPerThread) + j * 32 + lane;
    const int d = i < S ? kr[i] & (radix - 1) : -1;
    // one shared atomic per distinct digit of the warp: the padding's row 0
    // fills most of a tile
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  const int64_t table = static_cast<int64_t>(gridDim.x) * radix;
  int32_t* mine = counts + block * radix;
  for (int d = tid; d < radix; d += kSortThreads) {
    mine[d] = hist[d];
    for (int p = 1; p < passes; ++p) mine[p * table + d] = 0;
  }
}

// One pass: stable scatter of (key, value) pairs by the digit at `shift`.
// `vals` null means the value is the key's slot index (pass 0). Where
// `next_shift` >= 0, counts the next pass's digits into `next_counts` by
// the block of the destination. Where `named` is not null (pass 0), sets
// byte k of each replica's flags (`stride` bytes a replica) for each key k
// below n_rows.
__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
                    int32_t* __restrict__ dst_keys, int32_t* __restrict__ dst_vals,
                    const int32_t* __restrict__ counts, int32_t* __restrict__ next_counts,
                    uint8_t* __restrict__ named, int64_t stride, int64_t n_rows,
                    int64_t S, int64_t n_tiles, int radix, int shift, int next_shift) {
  __shared__ int s_hist[kSortWarps][kMaxRadix];  // per warp: digit counts, then offsets
  __shared__ int s_base[kMaxRadix];              // where each digit of the tile starts
  __shared__ int s_scan[kSortWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t block = blockIdx.x;
  const int64_t r = block / n_tiles, tile = block % n_tiles;

  // the tile's keys: warp w takes keys [256 w, 256 w + 256) in 8 rounds of
  // 32 (loaded first, so their latency overlaps the scan below)
  const int64_t lo = tile * kSortTile + warp * (32 * kKeysPerThread) + lane;
  const int32_t* kr = keys + r * S;
  const int32_t* vr = vals != nullptr ? vals + r * S : nullptr;
  int32_t key[kKeysPerThread], value[kKeysPerThread];
  int rank[kKeysPerThread], digit[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int64_t i = lo + j * 32;
    key[j] = i < S ? kr[i] : 0;
    value[j] = i < S ? (vr != nullptr ? vr[i] : static_cast<int32_t>(i)) : 0;
  }

  // 1. the start of each digit's keys of this tile in the replica's output:
  // the replica's keys of smaller digits, plus this digit's keys in earlier
  // tiles. Thread t takes digits 2t and 2t + 1 (radix is even).
  const int32_t* table = counts + r * n_tiles * radix;
  int before[2] = {0, 0}, total[2] = {0, 0};
  if (2 * tid < radix) {
#pragma unroll 32
    for (int64_t t = 0; t < n_tiles; ++t) {
      const int2 c = *reinterpret_cast<const int2*>(table + t * radix + 2 * tid);
      total[0] += c.x;
      total[1] += c.y;
      if (t < tile) {
        before[0] += c.x;
        before[1] += c.y;
      }
    }
  }
  for (int d = tid; d < kSortWarps * kMaxRadix; d += kSortThreads) (&s_hist[0][0])[d] = 0;
  int unused;
  const int smaller = block_exclusive_scan(total[0] + total[1], s_scan, unused);
  if (2 * tid < radix) {
    s_base[2 * tid] = smaller + before[0];
    s_base[2 * tid + 1] = smaller + total[0] + before[1];
  }

  // 2. stable ranks within the tile: a key's rank counts the keys of its
  // digit before it in its warp's range (earlier rounds, then lower lanes)
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j)
    digit[j] = lo + j * 32 < S ? (key[j] >> shift) & (radix - 1) : -1;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int d = digit[j];
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int seen = d >= 0 ? s_hist[warp][d] : 0;
    rank[j] = seen + __popc(peers & lower);
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) s_hist[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each digit's count in the warps before, in place
  for (int d = tid; d < radix; d += kSortThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = s_hist[w][d];
      s_hist[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

  // the rows the keys name (plain byte stores: every writer stores 1)
  if (named != nullptr) {
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j)
      if (digit[j] >= 0 && key[j] >= 0 && key[j] < n_rows) named[r * stride + key[j]] = 1;
  }

  // 3. scatter, and count the next pass's digits by destination block
  int32_t* dk = dst_keys + r * S;
  int32_t* dv = dst_vals + r * S;
  int32_t* next_table = next_shift >= 0 ? next_counts + r * n_tiles * radix : nullptr;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int d = digit[j];
    int bucket = -1;
    if (d >= 0) {
      const int pos = s_base[d] + s_hist[warp][d] + rank[j];
      dk[pos] = key[j];
      dv[pos] = value[j];
      if (next_table != nullptr)
        bucket = (pos / kSortTile) * radix + ((key[j] >> next_shift) & (radix - 1));
    }
    if (next_table != nullptr) {
      const unsigned peers = __match_any_sync(0xffffffffu, bucket);
      if (bucket >= 0 && lane == __ffs(peers) - 1) atomicAdd(next_table + bucket, __popc(peers));
    }
  }
}

// ---- the walk over the sorted slots --------------------------------------

constexpr int kGradThreads = 128;  // 4 warps: warp 0 walks a chunk; all 4 zero a row range
constexpr int kMaxChunk = 512;
constexpr int kGradInFlight = 8;   // dh rows (heads in the carry) a lane loads at once
constexpr int kZeroRows = 256;     // rows a zero block owns: 64 a warp
constexpr int kCarryWarps = 4;

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&acc)[VEC]) {
  Pack<float, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = acc[j];
  store_pack<float, VEC>(p, o);
}

// Zero block: rows [j * 256, j * 256 + 256) of replica r that no slot
// names (flag clear in `named`), each written with streaming stores
// (nothing reads them back); warp w takes 64 consecutive rows.
template <int VEC>
__device__ __forceinline__ void zero_unnamed_rows(const uint8_t* __restrict__ named,
                                                  float* __restrict__ out, int64_t r,
                                                  int64_t j, int64_t stride, int64_t NF,
                                                  int64_t H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = j * kZeroRows + warp * 64;
  const uint8_t* flags = named + r * stride + first;
  // bit i: row first + i is named or past NF
  const uint64_t used =
      __ballot_sync(0xffffffffu, first + lane >= NF || flags[lane]) |
      static_cast<uint64_t>(__ballot_sync(0xffffffffu, first + 32 + lane >= NF || flags[32 + lane]))
          << 32;
  for (int i = 0; i < 64; ++i) {
    if (used >> i & 1u) continue;
    float* o = out + (r * NF + first + i) * H;
    if constexpr (VEC == 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t c = lane; c < H / 4; c += 32) __stcs(reinterpret_cast<float4*>(o) + c, z);
    } else {
      for (int64_t c = lane; c < H; c += 32) __stcs(o + c, 0.f);
    }
  }
}

// Walk block: chunk c of replica r's sorted slots (see the file comment).
template <int VEC>
__device__ __forceinline__ void walk_chunk(const int32_t* __restrict__ rows,
                                           const int32_t* __restrict__ order,
                                           const float* __restrict__ val,
                                           const uint8_t* __restrict__ mask,
                                           const float* __restrict__ dh, float* __restrict__ out,
                                           float* __restrict__ head, float* __restrict__ tail,
                                           int64_t r, int64_t c, int64_t S, int64_t B,
                                           int64_t K, int64_t NF, int64_t H, int64_t chunk,
                                           int64_t n_chunks) {
  __shared__ int32_t s_row[kMaxChunk];   // the chunk's sorted slots
  __shared__ int32_t s_samp[kMaxChunk];
  __shared__ float s_scale[kMaxChunk];
  __shared__ int32_t k_row[kMaxChunk];   // the kept ones, in order
  __shared__ int32_t k_samp[kMaxChunk];
  __shared__ float k_scale[kMaxChunk];
  __shared__ int s_scan[kGradThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t block = r * n_chunks + c;  // head/tail slot of this (replica, chunk)
  const int64_t lo = c * chunk;
  const int64_t hi = min64(lo + chunk, S);
  const int n = static_cast<int>(hi - lo);
  const int32_t* rr = rows + r * S;
  const int32_t* orr = order + r * S;

  // 1. stage the chunk: row, sample and scale of each sorted slot
  for (int i = tid; i < n; i += kGradThreads) {
    const int32_t slot = orr[lo + i];
    s_row[i] = rr[lo + i];
    s_samp[i] = static_cast<int32_t>(slot / K);
    s_scale[i] = mask[r * S + slot] ? val[r * S + slot] : 0.f;
  }
  __syncthreads();

  // 2. keep all but the zero-scale slots that repeat the (row, sample) of a
  // zero-scale slot just before them; thread t takes consecutive slots
  constexpr int kPer = kMaxChunk / kGradThreads;
  const int per = (n + kGradThreads - 1) / kGradThreads;
  unsigned keep = 0;
  int n_keep = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid * per + j;
    if (j < per && i < n) {
      const bool repeat = i > 0 && s_scale[i] == 0.f && s_scale[i - 1] == 0.f &&
                          s_row[i] == s_row[i - 1] && s_samp[i] == s_samp[i - 1];
      if (!repeat) {
        keep |= 1u << j;
        ++n_keep;
      }
    }
  }
  int n_kept;
  int at = block_exclusive_scan(n_keep, s_scan, n_kept);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (keep >> j & 1u) {
      const int i = tid * per + j;
      k_row[at] = s_row[i];
      k_samp[at] = s_samp[i];
      k_scale[at] = s_scale[i];
      ++at;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 3. the walk over the kept slots, lane owning VEC columns
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * VEC;
  const bool has_col = col < H;
  const float* dr = dh + r * B * H + (has_col ? col : 0);
  float* outr = out + r * NF * H + col;
  bool in_head = lo > 0 && rr[lo - 1] == k_row[0];  // the run entered from the previous chunk
  int32_t cur = k_row[0];
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int e0 = 0; e0 < n_kept; e0 += kGradInFlight) {
    int32_t rw[kGradInFlight];
    float cs[kGradInFlight];
    Pack<float, VEC> d[kGradInFlight];
#pragma unroll
    for (int i = 0; i < kGradInFlight; ++i) {
      const int e = e0 + i;
      if (e < n_kept) {
        rw[i] = k_row[e];
        cs[i] = k_scale[e];
        d[i] = ldg_pack<float, VEC>(dr + static_cast<int64_t>(k_samp[e]) * H);
      }
    }
#pragma unroll
    for (int i = 0; i < kGradInFlight; ++i) {
      if (e0 + i < n_kept) {
        if (rw[i] != cur) {  // the run of `cur` ended inside this chunk
          if (has_col) {
            if (in_head)
              store_vec<VEC>(head + block * H + col, acc);
            else if (cur >= 0 && cur < NF)
              store_vec<VEC>(outr + static_cast<int64_t>(cur) * H, acc);
          }
          in_head = false;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
          cur = rw[i];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += cs[i] * d[i].v[j];
      }
    }
  }
  // the last run of the chunk
  if (has_col) {
    if (in_head) store_vec<VEC>(head + block * H + col, acc);
    else if (hi < S && rr[hi] == cur) store_vec<VEC>(tail + block * H + col, acc);
    else if (cur >= 0 && cur < NF) store_vec<VEC>(outr + static_cast<int64_t>(cur) * H, acc);
  }
}

// One launch, two kinds of block, interleaved so that both run at once:
// walk blocks (latency: gathers, shared-memory passes) and zero blocks
// (bandwidth: the rows no slot names). Walk blocks go over the chunks of
// all replicas from the last chunk down, the padding run's chunks last.
template <int VEC>
__global__ void __launch_bounds__(kGradThreads)
grad_w_rows_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ order,
                   const float* __restrict__ val, const uint8_t* __restrict__ mask,
                   const float* __restrict__ dh, const uint8_t* __restrict__ named,
                   float* __restrict__ out, float* __restrict__ head, float* __restrict__ tail,
                   int64_t R, int64_t S, int64_t B, int64_t K, int64_t NF, int64_t H,
                   int64_t chunk, int64_t n_chunks, int64_t stride, int64_t n_zero) {
  const int64_t n_walk = R * n_chunks;
  const int64_t both = min64(n_walk, n_zero);
  const int64_t bx = blockIdx.x;
  bool walk;
  int64_t id;
  if (bx < 2 * both) {
    walk = bx & 1;
    id = bx >> 1;
  } else {
    walk = n_walk > n_zero;
    id = bx - both;
  }
  if (walk) {
    walk_chunk<VEC>(rows, order, val, mask, dh, out, head, tail, id % R,
                    n_chunks - 1 - id / R, S, B, K, NF, H, chunk, n_chunks);
  } else if (blockIdx.y == 0) {  // the column blocks past the first write no zeros
    const int64_t per_replica = n_zero / R;
    zero_unnamed_rows<VEC>(named, out, id / per_replica, id % per_replica, stride, NF, H);
  }
}

// The run that starts in chunk c and leaves it: its tail plus the heads of
// the chunks it covers. Warp w adds a quarter of the heads in chunk order;
// the quarters are added to the tail in warp order.
template <int VEC>
__global__ void __launch_bounds__(32 * kCarryWarps)
grad_w_carry_kernel(const int32_t* __restrict__ rows, const float* __restrict__ head,
                    const float* __restrict__ tail, float* __restrict__ out, int64_t S,
                    int64_t NF, int64_t H, int64_t chunk, int64_t n_chunks) {
  __shared__ float s_part[kCarryWarps][32 * VEC];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int64_t block = blockIdx.x;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * VEC;
  const bool has_col = col < H;
  const int64_t r = block / n_chunks;
  const int64_t c = block % n_chunks;
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk;
  if (hi >= S) return;  // the replica's last chunk: nothing leaves it
  const int32_t* rr = rows + r * S;
  const int32_t row = rr[hi - 1];
  // only a run that starts in this chunk and leaves it is this block's
  if (rr[hi] != row || (lo > 0 && rr[lo - 1] == row)) return;

  // the last chunk the run reaches: the largest k > c whose first slot
  // holds `row` (the rows are sorted, so those k are c + 1, c + 2, ...),
  // searched 32 ways at a time: each lane probes one chunk of [a, b)
  int64_t a = c + 1, b = n_chunks;
  while (b - a > 1) {
    const int64_t step = (b - a + 31) / 32;
    const int64_t k = a + lane * step;
    const unsigned hit = __ballot_sync(0xffffffffu, k < b && rr[k * chunk] == row);
    const int64_t last = a + static_cast<int64_t>(31 - __clz(hit)) * step;  // lane 0 hits
    b = min64(b, last + step);
    a = last;
  }
  const int64_t quarter = (a - c + kCarryWarps - 1) / kCarryWarps;
  const int64_t k_lo = c + 1 + warp * quarter;
  const int64_t k_hi = min64(k_lo + quarter, a + 1);
  const float* hr = head + (r * n_chunks) * H + (has_col ? col : 0);

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kGradInFlight) {
    Pack<float, VEC> p[kGradInFlight];
#pragma unroll
    for (int i = 0; i < kGradInFlight; ++i)
      if (k0 + i < k_hi) p[i] = load_pack<float, VEC>(hr + (k0 + i) * H);
#pragma unroll
    for (int i = 0; i < kGradInFlight; ++i) {
      if (k0 + i < k_hi) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += p[i].v[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) s_part[warp][lane * VEC + j] = acc[j];
  __syncthreads();
  if (warp == 0 && has_col) {
    const Pack<float, VEC> t = load_pack<float, VEC>(tail + block * H + col);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = t.v[j];
    for (int w = 0; w < kCarryWarps; ++w) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += s_part[w][lane * VEC + j];
    }
    if (row >= 0 && row < NF) store_vec<VEC>(out + (r * NF + row) * H + col, acc);
  }
}

template <int VEC>
cudaError_t launch(const void* rows, const void* order, const void* val, const void* mask,
                   const void* dh, const void* named, void* out, void* head, void* tail,
                   int64_t R, int64_t S, int64_t B, int64_t K, int64_t NF, int64_t H,
                   int64_t chunk, cudaStream_t stream) {
  const int64_t n_chunks = (S + chunk - 1) / chunk;
  const int64_t n_zero = R * ((NF + kZeroRows - 1) / kZeroRows);
  // a lane owns VEC columns: H wider than 32 x VEC takes more blocks along y
  const auto col_blocks = static_cast<unsigned>(((H + VEC - 1) / VEC + 31) / 32);
  const auto* rows_p = static_cast<const int32_t*>(rows);
  grad_w_rows_kernel<VEC><<<dim3(static_cast<unsigned>(R * n_chunks + n_zero), col_blocks),
                            kGradThreads, 0, stream>>>(
      rows_p, static_cast<const int32_t*>(order), static_cast<const float*>(val),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(dh),
      static_cast<const uint8_t*>(named), static_cast<float*>(out), static_cast<float*>(head),
      static_cast<float*>(tail), R, S, B, K, NF, H, chunk, n_chunks, named_stride(NF), n_zero);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks < 2) return err;
  grad_w_carry_kernel<VEC><<<dim3(static_cast<unsigned>(R * n_chunks), col_blocks),
                             dim3(32, kCarryWarps), 0, stream>>>(
      rows_p, static_cast<const float*>(head), static_cast<const float*>(tail),
      static_cast<float*>(out), S, NF, H, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// keys (R,S) int32, each in [0, n_rows) and n_rows <= 2^min(passes * digit_bits, 31);
// rows/order (R,S) int32 out: each replica's keys in ascending order and
// the slot each came from, ties in slot order (the order of a stable sort).
// counts: passes x R x ceil(S/tile) x 2^digit_bits int32 scratch; tmp:
// 2 x R x S x min(passes - 1, 2) int32 scratch (the passes before the last
// ping-pong through it). named: null, or R x named_stride(n_rows) bytes
// out (n_rows rounded up to 16), byte k of replica r 1 where a key of r is
// k, else 0. `tile` must be the kernel's 2,048. All contiguous on the
// device of `stream`. Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int spmm_sort_rows(const void* keys, void* rows, void* order, void* counts,
                              void* tmp, void* named, int64_t R, int64_t S, int64_t n_rows,
                              int64_t digit_bits, int64_t passes, int64_t tile, void* stream) {
  using namespace repro_torch;
  if (R * S == 0) return cudaSuccess;
  if (tile != kSortTile || digit_bits < 2 || (1 << digit_bits) > kMaxRadix || passes < 1 ||
      passes * digit_bits > 32 || S > INT32_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (S + kSortTile - 1) / kSortTile;
  const int radix = 1 << digit_bits;
  const int64_t table = R * n_tiles * radix;
  const int64_t stride = named_stride(n_rows);
  auto* cnt = static_cast<int32_t*>(counts);
  auto* buf = static_cast<int32_t*>(tmp);
  auto* flags = static_cast<uint8_t*>(named);
  const auto grid = static_cast<unsigned>(R * n_tiles);
  sort_histogram_kernel<<<grid, kSortThreads, 0, s>>>(
      static_cast<const int32_t*>(keys), cnt, static_cast<uint4*>(named),
      named != nullptr ? R * stride / 16 : 0, S, n_tiles, radix, static_cast<int>(passes));
  cudaError_t err = cudaGetLastError();
  const int32_t* src_k = static_cast<const int32_t*>(keys);
  const int32_t* src_v = nullptr;
  for (int64_t p = 0; p < passes && err == cudaSuccess; ++p) {
    const bool last = p == passes - 1;
    int32_t* dst_k = last ? static_cast<int32_t*>(rows) : buf + (2 * (p % 2)) * R * S;
    int32_t* dst_v = last ? static_cast<int32_t*>(order) : buf + (2 * (p % 2) + 1) * R * S;
    sort_scatter_kernel<<<grid, kSortThreads, 0, s>>>(
        src_k, src_v, dst_k, dst_v, cnt + p * table, cnt + (p + 1) * table,
        p == 0 ? flags : nullptr, stride, n_rows, S, n_tiles, radix,
        static_cast<int>(p * digit_bits), last ? -1 : static_cast<int>((p + 1) * digit_bits));
    err = cudaGetLastError();
    src_k = dst_k;
    src_v = dst_v;
  }
  return err;
}

// rows/order (R,S) int32: each replica's slots sorted by row, stably, order
// the slot s = b * K + k each came from, and named the flags of the rows
// the slots name (all three from `spmm_sort_rows`); val (R,S) f32
// and mask (R,S) bool in slot order; dh (R,B,H) f32; out (R,NF,H) f32,
// uninitialised: every row is written; head/tail (R*ceil(S/chunk), H) f32
// scratch; chunk in [1, 512]. All contiguous on the device of `stream`.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int spmm_grad_w(const void* rows, const void* order, const void* named,
                           const void* val, const void* mask, const void* dh, void* out,
                           void* head, void* tail, int64_t R, int64_t S, int64_t B, int64_t K,
                           int64_t NF, int64_t H, int64_t chunk, void* stream) {
  using namespace repro_torch;
  if (R * NF * H == 0) return cudaSuccess;
  if (chunk <= 0 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (S == 0) return cudaMemsetAsync(out, 0, R * NF * H * sizeof(float), s);
  if (H % 4 == 0 && aligned_to(dh, 16) && aligned_to(out, 16) &&
      aligned_to(head, 16) && aligned_to(tail, 16))
    return launch<4>(rows, order, val, mask, dh, named, out, head, tail, R, S, B, K, NF, H,
                     chunk, s);
  return launch<1>(rows, order, val, mask, dh, named, out, head, tail, R, S, B, K, NF, H,
                   chunk, s);
}
