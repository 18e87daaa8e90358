// Helpers shared by the port's kernels: vector packs, f32 conversions and
// 64-bit min/max.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

// Storage dtype codes passed from the Python wrappers.
enum DType : int64_t { kFloat32 = 0, kBFloat16 = 1 };

// N consecutive elements loaded or stored with one vector access
// (16 bytes for 4 x f32, 8 bytes for 4 x bf16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, N>& x) {
  *reinterpret_cast<Pack<T, N>*>(p) = x;
}

// load_pack on the read-only data path (ld.global.nc): for inputs that no
// thread of the launch writes
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> ldg_pack(const T* p) {
  constexpr int kBytes = sizeof(T) * N;
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4 || kBytes == 2, "pack size");
  Pack<T, N> x;
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(&x) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(&x) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned*>(&x) = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    *reinterpret_cast<unsigned short*>(&x) = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return x;
}

// exclusive prefix sum of one int a thread over the block, in thread order;
// `total` gets the block's sum. Every thread of the block must call it;
// `scratch` holds one int a warp. Ends with a barrier, so `scratch` may be
// reused after it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch, int& total) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = (blockDim.x * blockDim.y + 31) / 32;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = scratch[w];
    if (w < warp) before += c;
    total += c;
  }
  __syncthreads();
  return before + incl - x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

inline bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---- PTX wrappers of the tensor-core kernels --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (about 2^-22 relative error; subnormal
// results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two bf16 values as one register of a fragment, x.x in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

}  // namespace repro_torch
