// Tile helpers shared by the kernels of csrc/: thread t of a block holds
// elements ITEMS * t .. ITEMS * t + ITEMS - 1 of its tile.
//
// A byte lane moves as one ITEMS-byte access per thread (ITEMS = 4 or
// 16), so a warp reads or writes 32 * ITEMS contiguous bytes.  With 16
// elements per thread an int32 lane goes out through a 16 KB shared
// staging tile: the thread side writes its 16 consecutive values, the
// global side is striped (int4 o = s * THREADS + t), so one warp store
// covers 512 contiguous bytes.  The staging index is XOR-swizzled so
// that neither side has bank conflicts: each quarter-warp phase of a
// 16-byte access touches 8 distinct 16-byte bank groups.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tileio {

// Byte e of a group held as words.
template <int W>
__device__ inline int byte_at(const uint32_t (&w)[W], int e) {
  return (w[e >> 2] >> (8 * (e & 3))) & 0xFF;
}

// The ITEMS bytes of lane p from element i0 (a multiple of ITEMS), 0 past
// n.  One vector load where the lane is 16-byte aligned (the caller's
// `aligned`, which must be uniform over the block) and the group whole.
template <int ITEMS>
__device__ inline void load_bytes(const void* p, long long i0, long long n,
                                  bool aligned, uint32_t (&w)[ITEMS / 4]) {
  static_assert(ITEMS == 4 || ITEMS == 16, "4 or 16 bytes per thread");
  const uint8_t* b = static_cast<const uint8_t*>(p);
  if (aligned && i0 + ITEMS <= n) {
    if constexpr (ITEMS == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(b + i0));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(b + i0));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    if (e % 4 == 0) w[e / 4] = 0;
    if (i0 + e < n) w[e / 4] |= (uint32_t)b[i0 + e] << (8 * (e % 4));
  }
}

// Writes ITEMS bytes to lane p at element i0, none at or past n; p must be
// 16-byte aligned.
template <int ITEMS>
__device__ inline void store_bytes(void* p, long long i0, long long n,
                                   const uint32_t (&w)[ITEMS / 4]) {
  static_assert(ITEMS == 4 || ITEMS == 16, "4 or 16 bytes per thread");
  uint8_t* b = static_cast<uint8_t*>(p);
  if (i0 + ITEMS <= n) {
    if constexpr (ITEMS == 16)
      *reinterpret_cast<uint4*>(b + i0) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint32_t*>(b + i0) = w[0];
    return;
  }
#pragma unroll
  for (int e = 0; e < ITEMS; ++e)
    if (i0 + e < n) b[i0 + e] = (uint8_t)(w[e / 4] >> (8 * (e % 4)));
}

// Where int4 q (0..3) of thread t's 16 values sits in the staging tile.
__device__ inline int stage_slot(int t, int q) {
  return t * 4 + (q ^ ((t >> 1) & 3));
}

// Writes thread t's 16 values r to the int32 lane dst over the tile of
// 16 * THREADS elements at `base`, none at or past n, through `stage`
// (THREADS * 4 int4); dst must be 16-byte aligned.  The caller syncs
// before this if `stage` is still being read; it contains the barrier
// between the two sides.
template <int THREADS>
__device__ inline void store_words(int32_t* dst, long long base, long long n,
                                   int4* stage, const int (&r)[16]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    stage[stage_slot(t, q)] =
        make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int o = s * THREADS + t;
    const int4 x = stage[stage_slot(o >> 2, o & 3)];
    const long long e = base + 4LL * o;
    if (e + 4 <= n) {
      *reinterpret_cast<int4*>(dst + e) = x;
    } else {
      if (e < n) dst[e] = x.x;
      if (e + 1 < n) dst[e + 1] = x.y;
      if (e + 2 < n) dst[e + 2] = x.z;
    }
  }
}

}  // namespace tileio
