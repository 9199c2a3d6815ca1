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
// Bound: memory.  The function reads the payload once, the control
// table once ((2k-1+7)/8 bytes per element) and writes the output once:
// at k = 22 that is 3.46 MB + 25.2 MB + 4.19 MB, 0.0096 ms at 3.35 TB/s.
// The control table is 6x the payload, so no replay comes near a gather
// of the payload (0.019 ms on this card), which reads 3.46 MB of data
// and 27.7 MB of int64 indices that an L2 of 50 MB keeps.
//
// Design.  The stages run in a few passes, each one launch.  A block
// reads its tile once (16-byte loads), reads the matching bytes of each
// control row its stages need (at most 4 rows, kept in registers), runs
// its stages and writes its tile once.  Payload and control share byte
// lanes, so a stage is a byte-wise select on 32-bit words against the
// partner's words, and the control bits are never transposed.  The
// partner of a stage sits, by the stage's bit in the tile,
//
//   in the thread's own bytes (a byte or word swap),
//   in another lane of the warp (__shfl_xor_sync of its words), or
//   in another warp, through shared memory: one barrier a stage, with
//   two buffers so that a stage's writes never meet the previous stage's
//   reads.
//
// The middle pass takes 8 KB contiguous tiles, 512 threads x 16 bytes, so
// it runs every stage with d < 8 KB: 25 stages at k >= 13, 8 of them
// through shared memory (tile bits 0-3 in the thread, 4-8 across lanes,
// 9-12 across warps).  An outer pass takes a tile of 16 KB that is not
// contiguous: 2^col contiguous bytes in each of 2^nb segments, whose
// index is nb consecutive bits of the element index (col + nb = 14,
// col >= 5), 512 threads x 32 bytes, so every thread reads whole 32-byte
// sectors; it runs every stage on those nb bits.  At k = 22 the 9 stages
// on each side with d >= 8 KB take one outer pass each: 3 launches in
// all, against 15 before this design.  Blocks read and write only their
// own elements, so every pass after the first runs in place in `out`,
// and the first pass reads the unpadded payload, taking 0 past its end
// (no padding copy).  Three middle blocks (at most 42 registers, 16 KB
// of shared memory) or two outer blocks (64 registers, 32 KB) share an
// SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOG_TILE = 13;                   // a middle pass's tile
constexpr int THREADS = (1 << LOG_TILE) / 16;  // 512
constexpr int LOG_OUTER_TILE = LOG_TILE + 1;   // an outer pass's tile
constexpr int MAX_OUTER_BITS = LOG_OUTER_TILE - 5;  // 32-byte columns
constexpr unsigned FULL = 0xffffffffu;

// The stages j0, j0 + dir, ... (n_st of them), on the element bits that
// the tile covers: tile bits [0, col) are element bits [0, col), tile
// bits [col, col + nb) are element bits [b_lo, b_lo + nb).  Their control
// bits lie in rows row0 .. row0 + NROWS - 1.
struct Pass {
  int j0, n_st, dir;
  int col, b_lo, nb;
  int row0;
};

__device__ inline uint32_t select_bytes(uint32_t a, uint32_t b, uint32_t c,
                                        int bit) {
  const uint32_t take = ((c >> bit) & 0x01010101u) * 0xffu;  // 0x00 or 0xff
  return (b & take) | (a & ~take);
}

// The 16 partner bytes i ^ 2^lb (lb < 4) of the thread's own 16 bytes.
__device__ inline uint4 swap_within(uint4 a, int lb) {
  switch (lb) {
    case 0:
      return make_uint4(__byte_perm(a.x, 0, 0x2301), __byte_perm(a.y, 0, 0x2301),
                        __byte_perm(a.z, 0, 0x2301), __byte_perm(a.w, 0, 0x2301));
    case 1:
      return make_uint4(__byte_perm(a.x, 0, 0x1032), __byte_perm(a.y, 0, 0x1032),
                        __byte_perm(a.z, 0, 0x1032), __byte_perm(a.w, 0, 0x1032));
    case 2:
      return make_uint4(a.y, a.x, a.w, a.z);
    default:
      return make_uint4(a.z, a.w, a.x, a.y);
  }
}

// 16 bytes of `in` from element g on, 0 at and past n_in.
__device__ inline uint4 load16(const int8_t* in, long long n_in, long long g) {
  if (g + 16 <= n_in && ((uintptr_t)in & 15) == 0)
    return *reinterpret_cast<const uint4*>(in + g);
  // the payload's end, or a payload that is not 16-byte aligned
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (e % 4 == 0) w[e / 4] = 0;
    if (g + e < n_in) w[e / 4] |= (uint32_t)(uint8_t)in[g + e] << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One pass: `in` holds n_in valid bytes (0 beyond); `out` has n2.  `in`
// may be `out` (each block reads its elements before it writes them and
// no other block touches them).  A middle pass gives each thread 16
// contiguous bytes of an 8 KB tile; an outer pass gives it 32 (V = 2
// words), a whole 32-byte sector of its column, in a tile of 16 KB.
template <int NROWS, bool OUTER>
__device__ inline void run_pass(const int8_t* in, long long n_in, int8_t* out,
                                const uint8_t* __restrict__ ctrl, long long n2,
                                int k, const Pass& p) {
  constexpr int V = OUTER ? 2 : 1, LOG_V = OUTER ? 1 : 0;
  __shared__ uint4 sh[2][V][THREADS];
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  long long g;  // element index of the thread's first byte
  if (OUTER) {
    const int low = p.b_lo - p.col;  // block bits below the segment bits
    const long long base = ((blk & ((1LL << low) - 1)) << p.col) |
                           ((blk >> low) << (p.b_lo + p.nb));
    g = base | ((long long)(t >> (p.col - 5)) << p.b_lo) |
        ((t * 32) & ((1 << p.col) - 1));
  } else {
    g = (blk << p.col) + t * 16;
  }
  uint4 a[V], c[NROWS][V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = load16(in, n_in, g + 16 * v);
#pragma unroll
  for (int r = 0; r < NROWS; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v)
      c[r][v] = __ldg(reinterpret_cast<const uint4*>(
          ctrl + (p.row0 + r) * n2 + g + 16 * v));

  int s = 0, buf = 0;
#pragma unroll
  for (int r = 0; r < NROWS; ++r) {
    // rows in the order the stages run: forward up, reverse down
    const int row = p.dir > 0 ? r : NROWS - 1 - r;
    uint4 cw[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cw[v] = p.dir > 0 ? c[r][v] : c[NROWS - 1 - r][v];
    for (; s < p.n_st; ++s) {
      const int j = p.j0 + s * p.dir;
      if (j / 8 != p.row0 + row) break;
      const int gb = j < k ? k - 1 - j : j - k + 1;  // d_j = 2^gb
      const int lb = OUTER ? gb - p.b_lo + p.col : gb;  // its bit in the tile
      uint4 q[V];
      if (!OUTER && lb < 4) {  // an outer stage has lb >= col >= 5
        q[0] = swap_within(a[0], lb);
      } else if (lb < 9 + LOG_V) {
        const int m = 1 << (lb - 4 - LOG_V);
#pragma unroll
        for (int v = 0; v < V; ++v)
          q[v] = make_uint4(
              __shfl_xor_sync(FULL, a[v].x, m), __shfl_xor_sync(FULL, a[v].y, m),
              __shfl_xor_sync(FULL, a[v].z, m), __shfl_xor_sync(FULL, a[v].w, m));
      } else {  // the same branch in every thread of the block
#pragma unroll
        for (int v = 0; v < V; ++v) sh[buf][v][t] = a[v];
        __syncthreads();
#pragma unroll
        for (int v = 0; v < V; ++v) q[v] = sh[buf][v][t ^ (1 << (lb - 4 - LOG_V))];
        buf ^= 1;
      }
      const int bit = j & 7;
#pragma unroll
      for (int v = 0; v < V; ++v)
        a[v] = make_uint4(select_bytes(a[v].x, q[v].x, cw[v].x, bit),
                          select_bytes(a[v].y, q[v].y, cw[v].y, bit),
                          select_bytes(a[v].z, q[v].z, cw[v].z, bit),
                          select_bytes(a[v].w, q[v].w, cw[v].w, bit));
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    *reinterpret_cast<uint4*>(out + g + 16 * v) = a[v];
}

// Stages with d < TILE, on contiguous tiles.
template <int NROWS>
__global__ void __launch_bounds__(THREADS, 3)
benes_middle(const int8_t* in, long long n_in, int8_t* out,
             const uint8_t* __restrict__ ctrl, long long n2, int k, Pass p) {
  run_pass<NROWS, false>(in, n_in, out, ctrl, n2, k, p);
}

// Stages on nb consecutive bits >= LOG_TILE, on tiles of 2^nb segments.
template <int NROWS>
__global__ void __launch_bounds__(THREADS, 2)
benes_outer(const int8_t* in, long long n_in, int8_t* out,
            const uint8_t* __restrict__ ctrl, long long n2, int k, Pass p) {
  run_pass<NROWS, true>(in, n_in, out, ctrl, n2, k, p);
}

using PassKernel = void (*)(const int8_t*, long long, int8_t*,
                           const uint8_t*, long long, int, Pass);
// by the number of control rows a pass reads, 1 to 4
const PassKernel MIDDLE[] = {benes_middle<1>, benes_middle<2>,
                                 benes_middle<3>, benes_middle<4>};
const PassKernel OUTER[] = {benes_outer<1>, benes_outer<2>};

// Splits the stages js..je (forward order, all on one side of the
// middle) into passes of at most MAX_OUTER_BITS bits each, as even as
// possible, and appends them to `passes`.
int split_outer(int js, int je, int k, Pass* passes, int n) {
  const int bits = je - js + 1;
  if (bits <= 0) return n;
  const int parts = (bits + MAX_OUTER_BITS - 1) / MAX_OUTER_BITS;
  for (int i = 0, j = js; i < parts; ++i) {
    const int nb = bits / parts + (i < bits % parts);
    const int last = j + nb - 1;
    // the stages' element bits: k-1-j falling before the middle, j-k+1
    // rising after it; either way the group is nb consecutive bits
    const int b_lo = j < k ? k - 1 - last : j - k + 1;
    passes[n++] = Pass{j, nb, 1, LOG_OUTER_TILE - nb, b_lo, nb, j / 8};
    j = last + 1;
  }
  return n;
}

}  // namespace

// Replays the 2k-1 stages on `in` (n_in <= 2^k int8, read as 0 past its
// end, left unchanged) into `out` (2^k bytes, 16-byte aligned).  ctrl is
// the packed ((2k-1+7)/8, 2^k) uint8 table, 16-byte aligned.  `in` may
// have any alignment but must not overlap `out`.
extern "C" int es_benes_permute(const void* in, long long n_in, void* out,
                                const void* ctrl, int k, int reverse,
                                void* stream) {
  if (k < 10 || k > 30 || n_in < 0 || n_in > (1LL << k) ||
      (((uintptr_t)out | (uintptr_t)ctrl) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n2 = 1LL << k;
  const int log_tile = k < LOG_TILE ? k : LOG_TILE;
  const int outer_bits = k - log_tile;
  // the passes in forward order: outer stages 0..outer_bits-1, the middle
  // run, outer stages 2k-1-outer_bits..2k-2
  Pass passes[8];
  int np = split_outer(0, outer_bits - 1, k, passes, 0);
  const int mid_lo = outer_bits, mid_hi = outer_bits + 2 * log_tile - 2;
  passes[np++] = Pass{mid_lo, mid_hi - mid_lo + 1, 1, log_tile, log_tile, 0,
                      mid_lo / 8};
  np = split_outer(mid_hi + 1, 2 * k - 2, k, passes, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* src = (const int8_t*)in;
  long long n_src = n_in;
  for (int i = 0; i < np; ++i) {
    Pass p = passes[reverse ? np - 1 - i : i];
    const int j_last = p.j0 + p.n_st - 1;
    const int rows = j_last / 8 - p.j0 / 8 + 1;
    if (reverse) {
      p.j0 = j_last;
      p.dir = -1;
    }
    const bool outer = p.nb > 0;
    if (rows > (outer ? 2 : 4)) return (int)cudaErrorInvalidValue;
    const PassKernel kernel = (outer ? OUTER : MIDDLE)[rows - 1];
    const int log_t = outer ? LOG_OUTER_TILE : log_tile;
    kernel<<<(unsigned)(n2 >> log_t), outer ? THREADS : (1 << log_tile) / 16,
             0, st>>>(src, n_src, (int8_t*)out, (const uint8_t*)ctrl, n2, k, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = (const int8_t*)out;
    n_src = n2;
  }
  return (int)cudaSuccess;
}
