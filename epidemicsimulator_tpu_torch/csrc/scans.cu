// Run totals (B2) and the int8 cumsum (B3) of the fused step, and the
// two-phase int8 cumsum (B4), for Hopper.
//
// Replaces epidemicsimulator_tpu/ops/pallas_scans.py: run_totals_fused
// (_summary_kernel + _apply_kernel), cumsum_pallas (_cumsum_kernel) and
// _cumsum_pallas2 (its XLA block sums and _cumsum_apply_kernel).
// On the TPU the grid runs in order and cumsum_pallas carries its running
// total from block to block in SMEM.  Here blocks run in parallel.
//
// B2 is two passes over units of TILE (4,096) elements, behind one
// 16-byte memset (a ticket and a flag).  It is bound by memory: 1 +
// 2 * n_sets bytes read and 4 * n_sets written per element, 0.0134 ms
// for two sets at 3,457,142 on 3.35 TB/s.
//
//   reduce  each block reads its unit once (16-byte loads) and writes the
//           unit's aggregate: its sum and, per boundary set, the largest
//           unit-local exclusive prefix at a run start and the smallest
//           unit-local inclusive prefix at a run end; a unit with a
//           negative value sets the flag.  The last block to finish (the
//           ticket) joins the aggregates in order into each unit's
//           inclusive prefix: the offset and, per set, the largest start
//           prefix so far, 1,024 units per round.
//   apply   each block reads its unit again (from L2, mostly: the inputs
//           are 17 MB at 3,457,142) and writes the run totals through
//           the shared staging tile as 16-byte stores.  Its carry in is
//           the inclusive prefix of the unit before it; its carry from
//           the units after it (the smallest end prefix) comes from their
//           aggregates.  With no negative value in the lane the first
//           unit after it that holds an end of every set ends that walk
//           (prefixes only grow, so no later end is smaller): on the
//           step's masks, always the next unit.  Otherwise the walk runs
//           to the lane's end.  At most 64 registers, four blocks per SM.
//
// No block waits on another.  Measured on the H100 at 3,457,142, this
// was faster than taking the carries by decoupled look-back, in the apply
// pass or in the reduce pass (over units, or over groups of four units
// as B3's tiles), and than each apply block joining the aggregates
// before it: a look-back's rounds of L2 latency sat on every block's
// path, while the last block's one round sits on one.
//
// Within a unit, one block scan runs over a struct carrying the sum and,
// for both sets, the largest start prefix (forward) and the smallest end
// prefix (backward).  All these are combined in order:
// (s, mx, mn) then (s', mx', mn') is (s + s', max(mx, s + mx'),
// min(mn, s + mn')), with INT_MIN and INT_MAX for "no start" and "no end".

// B3 is one pass with decoupled look-back (Merrill and Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).  It
// is bound by memory: 1 byte read and 4 written per element, 0.094 ms at
// 63M on 3.35 TB/s.  What it does about that:
//
//   - every byte is read once, in 16-byte loads with neighbouring
//     threads on neighbouring addresses;
//   - the int32 results go through shared memory (16 KB, XOR-swizzled so
//     that neither side has bank conflicts) and out as 16-byte stores, so
//     one warp instruction writes 512 contiguous bytes;
//   - a block takes a tile of 16,384 elements as four sub-tiles of 4,096
//     (256 threads x 16), so each thread has four 16-byte loads in flight
//     and the look-back is short: 3,846 tiles at 63M, 212 at 3,457,142
//     (1.6 per SM, all in one wave).  Measured on the H100 against 4,096-
//     and 8,192-element tiles, it was the fastest at both sizes;
//   - the look-back reads a window of 128 descriptors per round, four
//     loads in flight per lane, so a tile far from the nearest finished
//     prefix walks back 128 tiles per L2 round trip;
//   - tiles are numbered by an atomic ticket, not blockIdx, so every tile
//     a block waits on belongs to a block that is already running: it
//     publishes its own sum before it looks back, so the wait ends;
//   - a tile publishes its state as one 64-bit word (flag in the high
//     half, the int32 value in the low), written and read with single
//     relaxed 64-bit accesses at GPU scope: a reader sees the flag and its
//     value together or neither, so no fence is needed between them;
//   - the descriptors and the ticket are zeroed in stream order by one
//     cudaMemsetAsync before each launch: two device operations per call,
//     no host sync, and nothing read from an earlier call.
//
// B4 is two passes over units of UNIT (16,384) elements, behind one
// 16-byte memset (its ticket); no block waits on another, which is what
// sets it apart from B3.  Its bound is B3's, 0.094 ms at 63M; two passes
// read the lane twice, and a lane larger than the 50 MB L2 is read twice
// from device memory, so no two-pass form goes below (2 * 63 + 252) MB /
// 3.35 TB/s = 0.113 ms there.  What it does about that:
//
//   reduce  each block reads its unit once (16-byte loads) and writes the
//           unit's sum; the last block to finish (the ticket) turns the
//           sums into each unit's inclusive prefix in place, 1,024 units
//           per round (scan_units, shared with B2's reduce).
//   apply   each block reads a unit again and writes its inclusive
//           cumsum from the prefix of the unit before it, as B3 writes a
//           tile once it has its prefix: 16 elements per thread in
//           16-byte loads, one block scan over the unit's four sub-tiles
//           at once (scan_tile), the int32 results staged through the
//           XOR-swizzled tile and written as 16-byte stores.  Its blocks
//           take the units from the last to the first, so that the first
//           of them find the lane's tail, which the reduce read last,
//           still in L2.
//
// Both grids are one block per unit, so the card is full from a few
// million elements up.  Measured on the H100 at 3,457,142 and 63M, each
// of these was slower or no faster: units of 4,096 and 8,192 (the reduce
// pays for the blocks) and of 32,768 (a little faster at 63M, slower at
// 3,457,142, where its 106 units leave SMs idle); a reduce block that sums several units with the next unit's
// loads in flight; a last block that scans 4,096 units per round; an
// L2::256B hint on the reduce's loads; the apply in the reduce's order;
// a block scan per sub-tile in place of scan_tile's one (B3 takes that
// one too).
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline int warp_sum(int x) {
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

// The generic block scan and the last block's scan of the units (B2 and
// B4) join values in order with join(a, b) ("a, then b") and move them
// across lanes with shfl_up; these are an int's, a sum.  B2's aggregate
// has its own below.
__device__ inline int join(int a, int b) { return a + b; }
__device__ inline int shfl_up(int a, int d) {
  return __shfl_up_sync(FULL, a, d);
}

// The exclusive join of the threads before this one, in thread order, and
// (in `total`) the whole block's; every thread must call.  smem holds
// WARPS values.
template <class T>
__device__ inline T block_scan(T x, T identity, T* smem, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl_up(x, d);
    if (lane >= d) x = join(o, x);
  }
  if (lane == 31) smem[warp] = x;
  T pre = shfl_up(x, 1);
  if (lane == 0) pre = identity;
  __syncthreads();
  for (int w = warp - 1; w >= 0; --w) pre = join(smem[w], pre);
  total = smem[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) total = join(total, smem[w]);
  __syncthreads();
  return pre;
}

// The last block's scan over nb units: load(p) gives unit p's aggregate,
// and store(p, x) takes x, the join of units 0 .. p, once all of the
// round's loads are done.  WINDOW units per round, LOOK per thread;
// every thread of the block must call.  (B3's look-back also reads LOOK
// descriptors per lane per round.)
constexpr int LOOK = 4;
constexpr int WINDOW = THREADS * LOOK;

template <class T, class Load, class Store>
__device__ void scan_units(int nb, T identity, Load load, Store store,
                           T* smem) {
  const int t = threadIdx.x;
  T carry = identity;
  for (int lo = 0; lo < nb; lo += WINDOW) {
    T y[LOOK], x = identity;
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int p = lo + LOOK * t + i;
      y[i] = p < nb ? load(p) : identity;
      x = join(x, y[i]);
    }
    T total;
    T pre = join(carry, block_scan(x, identity, smem, total));
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int p = lo + LOOK * t + i;
      pre = join(pre, y[i]);
      if (p < nb) store(p, pre);
    }
    carry = join(carry, total);
  }
}

// B3's tiles and B4's units: V sub-tiles of TILE elements, thread t
// holding elements 16t .. 16t + 15 of each, as bytes in four words.
template <int V>
__device__ inline void load_tile(const int8_t* v, long long base,
                                 long long n, bool aligned,
                                 uint32_t (&w)[V][4]) {
#pragma unroll
  for (int u = 0; u < V; ++u)
    tileio::load_bytes<ITEMS>(v, base + u * TILE + threadIdx.x * ITEMS, n,
                              aligned, w[u]);
}

__device__ inline int thread_sum(const uint32_t (&w)[4], int s = 0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s = __dp4a((int)w[q], 0x01010101, s);
  return s;
}

// In excl[u], the sum of the tile's elements before thread t's in
// sub-tile u; returns the tile's sum.  One block scan over all V
// sub-tiles at once: each warp scans V sums per lane, and every thread
// reads the V x WARPS warp totals after one barrier.  smem holds
// V * WARPS ints; every thread must call.
template <int V>
__device__ inline int scan_tile(const uint32_t (&w)[V][4], int (&excl)[V],
                                int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[V];
#pragma unroll
  for (int u = 0; u < V; ++u) incl[u] = thread_sum(w[u]);
  int own[V];
#pragma unroll
  for (int u = 0; u < V; ++u) own[u] = incl[u];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int y = __shfl_up_sync(FULL, incl[u], d);
      if (lane >= d) incl[u] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int u = 0; u < V; ++u) smem[u * WARPS + warp] = incl[u];
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    int before = 0, all = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int s = smem[u * WARPS + k];
      before += k < warp ? s : 0;
      all += s;
    }
    excl[u] = total + before + incl[u] - own[u];
    total += all;
  }
  return total;
}

// Writes prefix + the inclusive cumsum of the tile at `base` to out (none
// at or past n) through the staging tile.
template <int V>
__device__ inline void store_tile(const uint32_t (&w)[V][4],
                                  const int (&excl)[V], int prefix, int* out,
                                  long long base, long long n, int4* stage) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if (u > 0) __syncthreads();  // the previous sub-tile's reads are done
    int run = prefix + excl[u];
    int r[ITEMS];
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
      run += (int)(int8_t)tileio::byte_at(w[u], e);
      r[e] = run;
    }
    tileio::store_words<THREADS>(out, base + u * TILE, n, stage, r);
  }
}

// B3.  A tile's descriptor: 0 until the tile publishes, then a flag in
// the high 32 bits and an int32 in the low 32.
constexpr unsigned long long TILE_SUM = 1ull << 32;     // the tile's own sum
constexpr unsigned long long TILE_PREFIX = 2ull << 32;  // sum of tiles 0..t

__device__ inline void publish(unsigned long long* p, unsigned long long flag,
                               int value) {
  const unsigned long long w = flag | (uint32_t)value;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ inline unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// The exclusive prefix of tile `tile`, from the descriptors of the tiles
// before it; called by warp 0.  Each round reads a window of 32 x LOOK
// tiles, nearest first (lane l holds tiles end - LOOK*l - i), with LOOK
// independent loads in flight per lane, and stops at the nearest tile
// that holds its inclusive prefix (tiles before 0 read as prefix 0).
__device__ int look_back(const unsigned long long* desc, int tile) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int end = tile - 1;; end -= 32 * LOOK) {
    unsigned long long d[LOOK];
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int p = end - LOOK * lane - i;
      d[i] = p >= 0 ? peek(desc + p) : TILE_PREFIX;
    }
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int i = 0; i < LOOK; ++i) ready &= (d[i] >> 32) != 0;
      if (__all_sync(FULL, ready)) break;
#pragma unroll
      for (int i = 0; i < LOOK; ++i)
        if ((d[i] >> 32) == 0) d[i] = peek(desc + (end - LOOK * lane - i));
    }
    int first = LOOK;  // this lane's nearest tile with its prefix
#pragma unroll
    for (int i = LOOK - 1; i >= 0; --i)
      if ((d[i] >> 32) == 2) first = i;
    const unsigned done = __ballot_sync(FULL, first < LOOK);
    const int stop_lane = done ? __ffs(done) - 1 : 32;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < LOOK; ++i)
      if (lane < stop_lane || (lane == stop_lane && i <= first))
        sum += (int)(uint32_t)d[i];
    prefix += warp_sum(sum);
    if (done) return prefix;
  }
}

// One tile of VEC x TILE elements per block, as VEC sub-tiles of TILE;
// tiles are numbered in the order blocks start (the ticket), so tile t
// waits only on running blocks.
constexpr int VEC = 4;

__global__ void __launch_bounds__(THREADS)
cumsum_lookback(const int8_t* v, long long n, int* out,
                unsigned long long* desc, unsigned* ticket) {
  __shared__ int4 stage[TILE / 4];
  __shared__ int smem[VEC * WARPS];
  __shared__ int tile_sh, prefix_sh;
  const int t = threadIdx.x;
  if (t == 0) tile_sh = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = tile_sh;
  const long long base = (long long)tile * VEC * TILE;
  uint32_t w[VEC][4];
  int excl[VEC];
  load_tile<VEC>(v, base, n, ((uintptr_t)v & 15) == 0, w);
  const int total = scan_tile<VEC>(w, excl, smem);
  if (t < 32) {
    int prefix = 0;
    if (tile == 0) {
      if (t == 0) publish(desc, TILE_PREFIX, total);
    } else {
      if (t == 0) publish(desc + tile, TILE_SUM, total);
      prefix = look_back(desc, tile);
      if (t == 0) publish(desc + tile, TILE_PREFIX, prefix + total);
    }
    if (t == 0) prefix_sh = prefix;
  }
  __syncthreads();
  store_tile<VEC>(w, excl, prefix_sh, out, base, n, stage);
}

// B4.  A unit of UNIT_VEC x TILE elements per block in both passes.
constexpr int UNIT_VEC = 4;
constexpr int UNIT = UNIT_VEC * TILE;

// Pass 1: the sum of unit blockIdx.x into incl; then the last block to
// finish (an atomic ticket) turns incl into each unit's inclusive prefix.
__global__ void __launch_bounds__(THREADS)
cumsum_reduce(const int8_t* v, long long n, bool aligned, int* incl,
              unsigned* ticket, int nb) {
  __shared__ int smem[WARPS];
  __shared__ bool last;
  const int t = threadIdx.x;
  uint32_t w[UNIT_VEC][4];
  load_tile<UNIT_VEC>(v, (long long)blockIdx.x * UNIT, n, aligned, w);
  int s = 0;
#pragma unroll
  for (int u = 0; u < UNIT_VEC; ++u) s = thread_sum(w[u], s);
  s = warp_sum(s);
  if ((t & 31) == 0) smem[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) total += smem[k];
    incl[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)nb - 1;
  }
  __syncthreads();
  if (!last) return;
  scan_units(
      nb, 0, [&](int p) { return __ldcg(incl + p); },
      [&](int p, int x) { incl[p] = x; }, smem);
}

// Pass 2: the cumsum of unit nb - 1 - blockIdx.x from the inclusive
// prefix of the unit before it.
__global__ void __launch_bounds__(THREADS)
cumsum_apply(const int8_t* v, long long n, bool aligned, const int* incl,
             int* out, int nb) {
  __shared__ int4 stage[TILE / 4];
  __shared__ int smem[UNIT_VEC * WARPS];
  const int unit = nb - 1 - (int)blockIdx.x;
  const long long base = (long long)unit * UNIT;
  const int prefix = unit > 0 ? incl[unit - 1] : 0;
  uint32_t w[UNIT_VEC][4];
  int excl[UNIT_VEC];
  load_tile<UNIT_VEC>(v, base, n, aligned, w);
  scan_tile<UNIT_VEC>(w, excl, smem);
  store_tile<UNIT_VEC>(w, excl, prefix, out, base, n, stage);
}

// B2.  A unit of TILE elements; thread t holds elements 16t .. 16t + 15.
// Agg is a stretch of elements in order: its sum and, per set, the
// largest exclusive prefix at a start and the smallest inclusive prefix
// at an end, both relative to the stretch's first element (INT_MIN: no
// start, INT_MAX: no end).
template <int NSETS>
struct Agg {
  int s, mx[NSETS], mn[NSETS];
};

template <int NSETS>
__device__ inline Agg<NSETS> agg_identity() {
  Agg<NSETS> a;
  a.s = 0;
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    a.mx[k] = INT_MIN;
    a.mn[k] = INT_MAX;
  }
  return a;
}

// a, then b.
template <int NSETS>
__device__ inline Agg<NSETS> join(const Agg<NSETS>& a, const Agg<NSETS>& b) {
  Agg<NSETS> r;
  r.s = a.s + b.s;
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    r.mx[k] = b.mx[k] == INT_MIN ? a.mx[k] : max(a.mx[k], a.s + b.mx[k]);
    r.mn[k] = b.mn[k] == INT_MAX ? a.mn[k] : min(a.mn[k], a.s + b.mn[k]);
  }
  return r;
}

template <int NSETS>
__device__ inline Agg<NSETS> shfl_up(const Agg<NSETS>& a, int d) {
  Agg<NSETS> r;
  r.s = __shfl_up_sync(FULL, a.s, d);
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    r.mx[k] = __shfl_up_sync(FULL, a.mx[k], d);
    r.mn[k] = __shfl_up_sync(FULL, a.mn[k], d);
  }
  return r;
}

template <int NSETS>
__device__ inline Agg<NSETS> shfl_idx(const Agg<NSETS>& a, int src) {
  Agg<NSETS> r;
  r.s = __shfl_sync(FULL, a.s, src);
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    r.mx[k] = __shfl_sync(FULL, a.mx[k], src);
    r.mn[k] = __shfl_sync(FULL, a.mn[k], src);
  }
  return r;
}

template <int NSETS>
__device__ inline Agg<NSETS> shfl_down(const Agg<NSETS>& a, int d) {
  Agg<NSETS> r;
  r.s = __shfl_down_sync(FULL, a.s, d);
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    r.mx[k] = __shfl_down_sync(FULL, a.mx[k], d);
    r.mn[k] = __shfl_down_sync(FULL, a.mn[k], d);
  }
  return r;
}

// The whole warp's stretches in lane order, in lane 0; every lane must
// call.
template <int NSETS>
__device__ inline Agg<NSETS> warp_join(Agg<NSETS> a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Agg<NSETS> b = shfl_down(a, d);
    if (lane + d < 32) a = join(a, b);
  }
  return a;
}

struct RunMasks {
  const uint8_t* start[2];
  const uint8_t* end[2];
};

// The device memory of one call, in ints: the ticket and the negative
// flag (zeroed by the memset) and two pads, then per unit its aggregate
// (sum, largest start prefix and smallest end prefix per set) and its
// inclusive prefix (sum, largest start prefix per set).  Per-set arrays
// hold set k of unit u at k * nb + u.
struct RunMem {
  unsigned* ticket;
  int* negative;
  int *agg_s, *agg_mx, *agg_mn, *incl_s, *incl_mx;
  int nb;
};

// The scratch ints of a call with nb units.
__host__ __device__ inline long long run_scratch_ints(long long nb,
                                                      int nsets) {
  return 4 + nb * (2 + 3 * nsets);
}

template <int NSETS>
__device__ inline RunMem run_mem(int* scratch, int nb) {
  RunMem m;
  m.nb = nb;
  m.ticket = reinterpret_cast<unsigned*>(scratch);
  m.negative = scratch + 1;
  m.agg_s = scratch + 4;
  m.agg_mx = m.agg_s + nb;
  m.agg_mn = m.agg_mx + NSETS * nb;
  m.incl_s = m.agg_mn + NSETS * nb;
  m.incl_mx = m.incl_s + nb;
  return m;
}

// Loads thread t's 16 values and mask bytes of the unit at element i0.
template <int NSETS>
__device__ inline void load_unit(const int8_t* v, const RunMasks& m,
                                 long long i0, long long n, bool aligned,
                                 uint32_t (&V)[4], uint32_t (&S)[NSETS][4],
                                 uint32_t (&E)[NSETS][4]) {
  tileio::load_bytes<ITEMS>(v, i0, n, aligned, V);
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    tileio::load_bytes<ITEMS>(m.start[k], i0, n, aligned, S[k]);
    tileio::load_bytes<ITEMS>(m.end[k], i0, n, aligned, E[k]);
  }
}

// The Agg of thread t's 16 elements; `neg` is set if a value is negative.
template <int NSETS>
__device__ inline Agg<NSETS> thread_agg(const uint32_t (&V)[4],
                                        const uint32_t (&S)[NSETS][4],
                                        const uint32_t (&E)[NSETS][4],
                                        bool& neg) {
  Agg<NSETS> a = agg_identity<NSETS>();
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    const int x = (int)(int8_t)tileio::byte_at(V, e);
    neg |= x < 0;
#pragma unroll
    for (int k = 0; k < NSETS; ++k)
      if (tileio::byte_at(S[k], e)) a.mx[k] = max(a.mx[k], a.s);
    a.s += x;
#pragma unroll
    for (int k = 0; k < NSETS; ++k)
      if (tileio::byte_at(E[k], e)) a.mn[k] = min(a.mn[k], a.s);
  }
  return a;
}

// Pass 1: each unit's aggregate; then the last block to finish (an
// atomic ticket) turns the aggregates into each unit's inclusive prefix
// (sum and largest start prefix per set) by scan_units.  No block waits
// on another.
template <int NSETS>
__global__ void __launch_bounds__(THREADS)
runs_reduce(const int8_t* v, RunMasks m, long long n, bool aligned,
            int* scratch, int nb) {
  __shared__ Agg<NSETS> wagg[WARPS];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const RunMem mem = run_mem<NSETS>(scratch, nb);
  uint32_t V[4], S[NSETS][4], E[NSETS][4];
  load_unit<NSETS>(v, m, (long long)blockIdx.x * TILE + t * ITEMS, n,
                   aligned, V, S, E);
  bool neg = false;
  const Agg<NSETS> a = warp_join(thread_agg<NSETS>(V, S, E, neg));
  if (lane == 0) wagg[warp] = a;
  neg = __syncthreads_or(neg);
  if (t == 0) {
    Agg<NSETS> u = wagg[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) u = join(u, wagg[w]);
    const int b = blockIdx.x;
    mem.agg_s[b] = u.s;
#pragma unroll
    for (int k = 0; k < NSETS; ++k) {
      mem.agg_mx[k * nb + b] = u.mx[k];
      mem.agg_mn[k * nb + b] = u.mn[k];
    }
    if (neg) atomicOr(mem.negative, 1);
    __threadfence();
    last = atomicAdd(mem.ticket, 1u) == (unsigned)nb - 1;
  }
  __syncthreads();
  if (!last) return;
  scan_units(
      nb, agg_identity<NSETS>(),
      [&](int p) {
        Agg<NSETS> y = agg_identity<NSETS>();
        y.s = __ldcg(mem.agg_s + p);
#pragma unroll
        for (int k = 0; k < NSETS; ++k) y.mx[k] = __ldcg(mem.agg_mx + k * nb + p);
        return y;
      },
      [&](int p, const Agg<NSETS>& x) {
        mem.incl_s[p] = x.s;
#pragma unroll
        for (int k = 0; k < NSETS; ++k) mem.incl_mx[k * nb + p] = x.mx[k];
      },
      wagg);
}

// The units after `unit` joined in order, relative to the first element
// of unit + 1 (only the sum and mn matter), from the reduce pass's
// aggregates; every thread calls and gets it.  With no negative value in
// the lane, the first unit after `unit` that holds an end of every set
// ends the walk, since no later end can have a smaller prefix: that is
// almost always unit + 1, which every thread reads at once.  Otherwise
// the block joins the aggregates of WINDOW units per round.
template <int NSETS>
__device__ Agg<NSETS> runs_look_forward(const RunMem& mem, int unit,
                                        bool negative, Agg<NSETS>* smem) {
  const int t = threadIdx.x;
  Agg<NSETS> acc = agg_identity<NSETS>();
  if (unit + 1 >= mem.nb) return acc;
  acc.s = mem.agg_s[unit + 1];
  bool ends = true;
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    acc.mn[k] = mem.agg_mn[k * mem.nb + unit + 1];
    ends &= acc.mn[k] != INT_MAX;
  }
  for (int start = unit + 2; start < mem.nb && !(ends && !negative);
       start += WINDOW) {
    Agg<NSETS> x = agg_identity<NSETS>();
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int p = start + LOOK * t + i;
      if (p >= mem.nb) break;
      Agg<NSETS> y = agg_identity<NSETS>();
      y.s = mem.agg_s[p];
#pragma unroll
      for (int k = 0; k < NSETS; ++k) y.mn[k] = mem.agg_mn[k * mem.nb + p];
      x = join(x, y);
    }
    Agg<NSETS> total;
    block_scan(x, agg_identity<NSETS>(), smem, total);
    acc = join(acc, total);
    ends = true;
#pragma unroll
    for (int k = 0; k < NSETS; ++k) ends &= acc.mn[k] != INT_MAX;
  }
  return acc;
}

// Pass 2: the run totals of unit blockIdx.x, from the reduce pass's
// inclusive prefix of the unit before it and the aggregates of the units
// after.  At most 64 registers, so that four blocks share an SM.
template <int NSETS>
__global__ void __launch_bounds__(THREADS, 4)
runs_apply(const int8_t* v, RunMasks m, long long n, bool aligned,
           int* scratch, int nb, int* out0, int* out1) {
  __shared__ int4 stage[NSETS][TILE / 4];
  __shared__ Agg<NSETS> wagg[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const RunMem mem = run_mem<NSETS>(scratch, nb);
  const int unit = blockIdx.x;
  const long long base = (long long)unit * TILE;
  uint32_t V[4], S[NSETS][4], E[NSETS][4];
  load_unit<NSETS>(v, m, base + t * ITEMS, n, aligned, V, S, E);
  bool neg = false;
  const Agg<NSETS> a = thread_agg<NSETS>(V, S, E, neg);
  // the units before, as an absolute prefix, and the units after
  Agg<NSETS> before = agg_identity<NSETS>();
  if (unit > 0) {
    before.s = mem.incl_s[unit - 1];
#pragma unroll
    for (int k = 0; k < NSETS; ++k)
      before.mx[k] = mem.incl_mx[k * nb + unit - 1];
  }
  const Agg<NSETS> after =
      runs_look_forward<NSETS>(mem, unit, *mem.negative != 0, wagg);

  // one block scan, forward and backward at once
  Agg<NSETS> f = a, b = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Agg<NSETS> fu = shfl_up(f, d), bd = shfl_down(b, d);
    if (lane >= d) f = join(fu, f);
    if (lane + d < 32) b = join(b, bd);
  }
  if (lane == 31) wagg[warp] = f;
  Agg<NSETS> pre = shfl_up(f, 1), post = shfl_down(b, 1);
  if (lane == 0) pre = agg_identity<NSETS>();
  if (lane == 31) post = agg_identity<NSETS>();
  __syncthreads();
  for (int w = warp - 1; w >= 0; --w) pre = join(wagg[w], pre);
  for (int w = warp + 1; w < WARPS; ++w) post = join(post, wagg[w]);
  // pre: the unit's elements before this thread's, from the unit's first;
  // post: those after, from the next thread's first
  const int thread_end = pre.s + a.s;  // unit-local prefix after the thread
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    int r[ITEMS];
    // forward: the largest exclusive prefix at a start at or before i
    int p = pre.s, mx = pre.mx[k];
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
      if (tileio::byte_at(S[k], e)) mx = max(mx, p);
      p += (int)(int8_t)tileio::byte_at(V, e);
      r[e] = mx == INT_MIN ? before.mx[k] : max(before.mx[k], before.s + mx);
    }
    // backward: the smallest inclusive prefix at an end at or after i
    int mn = post.mn[k] == INT_MAX ? INT_MAX : thread_end + post.mn[k];
    if (after.mn[k] != INT_MAX)
      mn = min(mn, thread_end + post.s + after.mn[k]);
    p = thread_end;
#pragma unroll
    for (int e = ITEMS - 1; e >= 0; --e) {
      if (tileio::byte_at(E[k], e)) mn = min(mn, p);
      p -= (int)(int8_t)tileio::byte_at(V, e);
      r[e] = (mn == INT_MAX ? INT_MAX : before.s + mn) - r[e];
    }
    tileio::store_words<THREADS>(k == 0 ? out0 : out1, base, n,
                                        stage[k], r);
  }
}

template <int NSETS>
int run_totals(const int8_t* v, RunMasks m, long long n, bool aligned,
               int* scratch, int nb, int* out0, int* out1,
               cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, 4 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  runs_reduce<NSETS><<<nb, THREADS, 0, stream>>>(v, m, n, aligned, scratch,
                                                nb);
  runs_apply<NSETS><<<nb, THREADS, 0, stream>>>(v, m, n, aligned, scratch, nb,
                                               out0, out1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B3: out[i] = v[0] + ... + v[i] in int32, for n >= 1.  scratch holds
// (ceil(n / (VEC * TILE)) + 1) 64-bit words: the tiles' descriptors and
// the ticket, zeroed here in stream order before the launch.  out and
// scratch must be 16-byte aligned; v may have any alignment.
extern "C" int es_cumsum_i8(const void* v, void* out, void* scratch,
                            long long scratch_bytes, long long n,
                            void* stream) {
  const long long tiles = (n + VEC * TILE - 1) / (VEC * TILE);
  if (n <= 0 || tiles > 0x7fffffffLL || scratch_bytes < (tiles + 1) * 8 ||
      (((uintptr_t)out | (uintptr_t)scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* desc = (unsigned long long*)scratch;
  const cudaError_t err = cudaMemsetAsync(desc, 0, (tiles + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  cumsum_lookback<<<(unsigned)tiles, THREADS, 0, st>>>(
      (const int8_t*)v, n, (int*)out, desc, (unsigned*)(desc + tiles));
  return (int)cudaGetLastError();
}

// B2: for each of n_sets (1 or 2) boundary sets, the total of v (values
// >= 0) over the run that holds each element; the masks must describe
// whole runs (element 0 starts one, element n - 1 ends one).  With
// nb = ceil(n / 4096) units, scratch holds 4 + nb * (2 + 3 * n_sets)
// ints; its first 4 are zeroed here in stream order before the launches.
// out0, out1 and scratch must be 16-byte aligned; v and the masks may
// have any alignment.
extern "C" int es_run_totals_i8(const void* v, const void* start0,
                                const void* end0, const void* start1,
                                const void* end1, void* out0, void* out1,
                                void* scratch, long long scratch_bytes,
                                long long n, int n_sets, void* stream) {
  const long long nb = (n + TILE - 1) / TILE;
  if (n <= 0 || (n_sets != 1 && n_sets != 2) || nb > 0x0fffffffLL ||
      scratch_bytes < run_scratch_ints(nb, n_sets) * 4 ||
      (((uintptr_t)out0 | (uintptr_t)out1 | (uintptr_t)scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (((uintptr_t)v | (uintptr_t)start0 | (uintptr_t)end0 |
                         (uintptr_t)start1 | (uintptr_t)end1) & 15) == 0;
  RunMasks m = {{(const uint8_t*)start0, (const uint8_t*)start1},
                {(const uint8_t*)end0, (const uint8_t*)end1}};
  if (n_sets == 1)
    return run_totals<1>((const int8_t*)v, m, n, aligned, (int*)scratch,
                         (int)nb, (int*)out0, nullptr, (cudaStream_t)stream);
  return run_totals<2>((const int8_t*)v, m, n, aligned, (int*)scratch,
                       (int)nb, (int*)out0, (int*)out1, (cudaStream_t)stream);
}

// B4: out[i] = v[0] + ... + v[i] in int32, for n >= 1, in two passes
// over nb = ceil(n / UNIT) units.  scratch holds 4 + nb ints: the ticket
// and three pads, zeroed here in stream order before the launches, then
// each unit's sum, which the reduce pass turns into its inclusive prefix.
// out and scratch must be 16-byte aligned; v may have any alignment.
extern "C" int es_cumsum_i8_2phase(const void* v, void* out, void* scratch,
                                   long long scratch_bytes, long long n,
                                   void* stream) {
  const long long nb = (n + UNIT - 1) / UNIT;
  if (n <= 0 || nb > 0x7fffffffLL || scratch_bytes < (4 + nb) * 4 ||
      (((uintptr_t)out | (uintptr_t)scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((uintptr_t)v & 15) == 0;
  int* incl = (int*)scratch + 4;
  cumsum_reduce<<<(unsigned)nb, THREADS, 0, st>>>(
      (const int8_t*)v, n, aligned, incl, (unsigned*)scratch, (int)nb);
  cumsum_apply<<<(unsigned)nb, THREADS, 0, st>>>(
      (const int8_t*)v, n, aligned, incl, (int*)out, (int)nb);
  return (int)cudaGetLastError();
}
