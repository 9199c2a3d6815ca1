// Beneš static-permutation replay (B5), for Hopper.
//
// Replaces attic/benes.py: _benes_permute (_kernel).  The network on
// n2 = 2^k elements has 2k-1 stages; stage j has XOR distance
// d_j = 2^(k-1-j) for j < k and 2^(j-k+1) for j >= k, and computes
//
//   y[i] = bit (j % 8) of ctrl[j / 8][i]  ?  x[i ^ d_j]  :  x[i]
//
// Every element reads its own bit and every stage reads the values from
// before the stage, so the replay is exact for any control bytes, routed
// or not.  Reverse mode runs the stages in reverse order.
//
// Distances fall from 2^(k-1) to 1 and rise again, so the stages with
// d < TILE form one contiguous middle run.  One launch (benes_middle)
// runs that whole run with each block's TILE elements in shared memory;
// each thread first gathers its elements' control bits for the run into
// one 32-bit word.  Every other stage (d >= TILE) is one launch of
// benes_outer, a pass over device memory that handles 16 elements per
// thread with 16-byte loads and a byte-wise select.  At k = 22 that is
// 7 + 1 + 7 launches, ping-ponging between two buffers of n2 bytes.
//
// Bound: memory.  The function reads the payload once, the control
// table once ((2k-1+7)/8 bytes per element) and writes the output once;
// this design reads the payload twice and one control row per outer
// stage, most of it from L2 at n2 = 2^22.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOG_TILE = 15;
constexpr int TILE = 1 << LOG_TILE;    // 32 KB of int8 in shared memory
constexpr int MID_THREADS = 1024;
constexpr int PER = TILE / MID_THREADS;  // elements per thread
constexpr int OUTER_THREADS = 256;

__host__ __device__ inline long long stage_distance(int j, int k) {
  return j < k ? 1LL << (k - 1 - j) : 1LL << (j - k + 1);
}

// Stages j_lo..j_hi (d < tile) on blocks of `tile` elements; forward
// runs them in increasing j, reverse in decreasing j.
__global__ void __launch_bounds__(MID_THREADS)
benes_middle(const int8_t* in, int8_t* out, const uint8_t* ctrl, long long n2,
             int k, int tile, int j_lo, int j_hi, int reverse) {
  __shared__ int8_t sh[TILE];
  const long long base = (long long)blockIdx.x * tile;
  uint32_t bits[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * MID_THREADS;
    bits[e] = 0;
    if (i < tile) {
      sh[i] = in[base + i];
      for (int g = j_lo >> 3; g <= j_hi >> 3; ++g) {
        const uint32_t c = ctrl[g * n2 + base + i];
        const int j0 = g * 8 > j_lo ? g * 8 : j_lo;
        const int j1 = g * 8 + 7 < j_hi ? g * 8 + 7 : j_hi;
        for (int j = j0; j <= j1; ++j)
          bits[e] |= ((c >> (j & 7)) & 1u) << (j - j_lo);
      }
    }
  }
  __syncthreads();
  const int n_run = j_hi - j_lo + 1;
  for (int s = 0; s < n_run; ++s) {
    const int j = reverse ? j_hi - s : j_lo + s;
    const int d = (int)stage_distance(j, k);
    // the stage's results, four bytes to a register, until every
    // thread has read its partners' values from before the stage
    uint32_t y[PER / 4];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * MID_THREADS;
      uint8_t v = 0;
      if (i < tile)
        v = (uint8_t)((bits[e] >> (j - j_lo)) & 1u ? sh[i ^ d] : sh[i]);
      if (e % 4 == 0) y[e / 4] = 0;
      y[e / 4] |= (uint32_t)v << (8 * (e % 4));
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * MID_THREADS;
      if (i < tile) sh[i] = (int8_t)(y[e / 4] >> (8 * (e % 4)));
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * MID_THREADS;
    if (i < tile) out[base + i] = sh[i];
  }
}

__device__ inline uint32_t select_bytes(uint32_t a, uint32_t b, uint32_t c,
                                        int bit) {
  const uint32_t take = ((c >> bit) & 0x01010101u) * 0xffu;  // 0x00 or 0xff
  return (b & take) | (a & ~take);
}

// One stage with d >= TILE: 16 elements per thread (d and the thread's
// offset are multiples of 16, so partner chunks are whole and aligned).
__global__ void benes_outer(const int8_t* in, int8_t* out,
                            const uint8_t* ctrl_row, int bit, long long d,
                            long long n2) {
  const long long i =
      ((long long)blockIdx.x * OUTER_THREADS + threadIdx.x) * 16;
  if (i >= n2) return;
  const uint4 a = *reinterpret_cast<const uint4*>(in + i);
  const uint4 b = *reinterpret_cast<const uint4*>(in + (i ^ d));
  const uint4 c = *reinterpret_cast<const uint4*>(ctrl_row + i);
  uint4 y;
  y.x = select_bytes(a.x, b.x, c.x, bit);
  y.y = select_bytes(a.y, b.y, c.y, bit);
  y.z = select_bytes(a.z, b.z, c.z, bit);
  y.w = select_bytes(a.w, b.w, c.w, bit);
  *reinterpret_cast<uint4*>(out + i) = y;
}

}  // namespace

// Elements held in shared memory by one block of the middle run.
extern "C" int es_benes_tile() { return TILE; }

// Replays the 2k-1 stages on `in` (n2 = 2^k int8, left unchanged) into
// `out`, using `tmp` (n2 bytes) between stages.  ctrl is the packed
// ((2k-1+7)/8, n2) uint8 table.  All four buffers must be 16-byte
// aligned and distinct.  The number of launches is odd, so the first
// writes `out` and the last does too.
extern "C" int es_benes_permute(const void* in, void* out, void* tmp,
                                const void* ctrl, int k, int reverse,
                                void* stream) {
  if (k < 10 || k > 30 || ((uintptr_t)in | (uintptr_t)out |
                           (uintptr_t)tmp | (uintptr_t)ctrl) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n2 = 1LL << k;
  const int log_tile = k < LOG_TILE ? k : LOG_TILE;
  const int j_lo = k - log_tile, j_hi = k + log_tile - 2, last = 2 * k - 2;
  const uint8_t* c = (const uint8_t*)ctrl;
  const int8_t* src = (const int8_t*)in;
  int8_t* bufs[2] = {(int8_t*)out, (int8_t*)tmp};
  int w = 0;  // index of the buffer the next launch writes
  auto outer = [&](int j) {
    const unsigned blocks = (unsigned)(n2 / 16 / OUTER_THREADS);
    benes_outer<<<blocks, OUTER_THREADS, 0, st>>>(
        src, bufs[w], c + (long long)(j / 8) * n2, j % 8,
        stage_distance(j, k), n2);
    src = bufs[w];
    w ^= 1;
  };
  auto middle = [&]() {
    benes_middle<<<(unsigned)(n2 >> log_tile), MID_THREADS, 0, st>>>(
        src, bufs[w], c, n2, k, 1 << log_tile, j_lo, j_hi, reverse);
    src = bufs[w];
    w ^= 1;
  };
  if (!reverse) {
    for (int j = 0; j < j_lo; ++j) outer(j);
    middle();
    for (int j = j_hi + 1; j <= last; ++j) outer(j);
  } else {
    for (int j = last; j > j_hi; --j) outer(j);
    middle();
    for (int j = j_lo - 1; j >= 0; --j) outer(j);
  }
  return (int)cudaGetLastError();
}
